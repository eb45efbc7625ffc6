"""The raft message types the step kernel and the router use.

A copy of the values of the reference's ``raftpb.MessageType`` that
``core/kernel.py`` and ``core/router.py`` read; the wire codec is not part
of this port's slice.
"""

from __future__ import annotations

import enum


class MessageType(enum.IntEnum):
    """Raft message algebra (the subset the device step handles)."""

    NOOP = 4
    SNAPSHOT_STATUS = 8
    UNREACHABLE = 9
    REPLICATE = 12
    REPLICATE_RESP = 13
    REQUEST_VOTE = 14
    REQUEST_VOTE_RESP = 15
    HEARTBEAT = 17
    HEARTBEAT_RESP = 18
    READ_INDEX_RESP = 20
    TIMEOUT_NOW = 24
    REQUEST_PREVOTE = 26
    REQUEST_PREVOTE_RESP = 27
