"""Raft-thesis client sessions: LRU of per-client cached responses.

Parity with ``internal/rsm/session.go``/``lrusession.go``: an LRU (capacity
LRU_MAX_SESSION_COUNT = 4096, internal/settings/hard.go) of
client_id → {series_id → cached Result}; duplicate series return the cached
response instead of re-applying; sessions serialize into every snapshot
(lrusession.go:93-152).
"""

from __future__ import annotations

import struct
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import BinaryIO

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.statemachine import Result

LRU_MAX_SESSION_COUNT = 4096


@dataclass
class Session:
    client_id: int
    responded_to: int = 0
    history: dict[int, Result] = field(default_factory=dict)

    def add_response(self, series_id: int, result: Result) -> None:
        if series_id in self.history:
            raise AssertionError("adding a duplicate response")
        self.history[series_id] = result

    def get_response(self, series_id: int) -> tuple[Result, bool]:
        r = self.history.get(series_id)
        return (r if r is not None else Result()), r is not None

    def has_responded(self, series_id: int) -> bool:
        return series_id <= self.responded_to

    def clear_to(self, responded_to: int) -> None:
        """Drop cached responses the client has acknowledged
        (session.go clearTo)."""
        if responded_to <= self.responded_to:
            return
        self.responded_to = responded_to
        for k in [k for k in self.history if k <= responded_to]:
            del self.history[k]

    # -- snapshot serialization -----------------------------------------

    def save(self, w: BinaryIO) -> None:
        w.write(struct.pack("<QQI", self.client_id, self.responded_to,
                            len(self.history)))
        for series_id in sorted(self.history):
            r = self.history[series_id]
            w.write(struct.pack("<QQI", series_id, r.value, len(r.data)))
            w.write(r.data)

    @staticmethod
    def load(r: BinaryIO) -> "Session":
        client_id, responded_to, n = struct.unpack("<QQI", r.read(20))
        s = Session(client_id=client_id, responded_to=responded_to)
        for _ in range(n):
            series_id, value, dlen = struct.unpack("<QQI", r.read(20))
            s.history[series_id] = Result(value=value, data=r.read(dlen))
        return s


class LRUSession:
    """The replicated session store (lrusession.go)."""

    def __init__(self, capacity: int = LRU_MAX_SESSION_COUNT) -> None:
        self.capacity = capacity
        self.sessions: OrderedDict[int, Session] = OrderedDict()

    def register_client_id(self, client_id: int) -> Result:
        """RegisterClientID entry — creates (or resets) the session."""
        self.sessions[client_id] = Session(client_id=client_id)
        self.sessions.move_to_end(client_id)
        self._evict()
        return Result(value=client_id)

    def unregister_client_id(self, client_id: int) -> Result:
        if client_id in self.sessions:
            del self.sessions[client_id]
            return Result(value=client_id)
        return Result(value=0)

    def get_session(self, client_id: int) -> Session | None:
        s = self.sessions.get(client_id)
        if s is not None:
            self.sessions.move_to_end(client_id)
        return s

    def _evict(self) -> None:
        while len(self.sessions) > self.capacity:
            self.sessions.popitem(last=False)

    # -- dedup entry point (statemachine.go update path) ------------------

    def update_required(self, e: pb.Entry) -> tuple[Result, bool, bool, Session | None]:
        """Returns (cached_result, has_cached, update_needed, session).

        Mirrors rsm's session lookup before applying a session-managed
        entry: an unknown session rejects the proposal; an already-responded
        series is a no-op; a cached series returns the cached result."""
        s = self.get_session(e.client_id)
        if s is None:
            return Result(), False, False, None
        if s.has_responded(e.series_id):
            return Result(), False, False, s
        r, ok = s.get_response(e.series_id)
        if ok:
            return r, True, False, s
        return Result(), False, True, s

    # -- snapshot serialization -----------------------------------------

    def save(self, w: BinaryIO) -> None:
        w.write(struct.pack("<I", len(self.sessions)))
        for client_id in self.sessions:  # LRU order preserved
            self.sessions[client_id].save(w)

    @staticmethod
    def load(r: BinaryIO, capacity: int = LRU_MAX_SESSION_COUNT) -> "LRUSession":
        (n,) = struct.unpack("<I", r.read(4))
        lru = LRUSession(capacity)
        for _ in range(n):
            s = Session.load(r)
            lru.sessions[s.client_id] = s
        return lru
