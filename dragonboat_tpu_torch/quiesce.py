"""Quiesce state machine — parity with the reference's ``quiesce.go``.

An idle shard (no proposals, reads, config changes, or non-heartbeat
messages for ``election_tick * 10`` ticks) enters quiesce: the raft engine
stops receiving real ticks (``Peer.quiesced_tick`` only advances the
logical clock, quiesce.go:43-54 + internal/raft/raft.go:650), so no
heartbeats or elections fire and thousands of idle shards cost nothing.
Any client activity or non-heartbeat message wakes the shard back up
(quiesce.go:60-77 ``record``).
"""

from __future__ import annotations

from dataclasses import dataclass

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.logger import get_logger

_LOG = get_logger("quiesce")


@dataclass
class QuiesceState:
    """Per-node quiesce bookkeeping (quiesce.go:24-34)."""

    shard_id: int = 0
    replica_id: int = 0
    election_tick: int = 0
    enabled: bool = False
    current_tick: int = 0
    quiesced_since: int = 0
    idle_since: int = 0
    exit_quiesce_tick: int = 0
    _new_quiesce_flag: bool = False

    def threshold(self) -> int:
        return self.election_tick * 10

    def quiesced(self) -> bool:
        return self.enabled and self.quiesced_since > 0

    def new_quiesce_state(self) -> bool:
        """True once per quiesce entry (quiesce.go:38-40 swap)."""
        flag, self._new_quiesce_flag = self._new_quiesce_flag, False
        return flag

    def tick(self) -> int:
        if not self.enabled:
            return 0
        self.current_tick += 1
        if not self.quiesced():
            if self.current_tick - self.idle_since > self.threshold():
                self._enter_quiesce()
        return self.current_tick

    def record(self, msg_type: pb.MessageType) -> None:
        """Client/raft activity observed — reset the idle clock and wake
        from quiesce.  Heartbeats are ignored while awake and during the
        election_tick grace window right after entering quiesce (trailing
        heartbeats from not-yet-quiesced peers); past the window they do
        wake the shard (quiesce.go:60-77)."""
        if not self.enabled:
            return
        if msg_type in (pb.MessageType.HEARTBEAT,
                        pb.MessageType.HEARTBEAT_RESP):
            if not self.quiesced() or self._new_to_quiesce():
                return
        self.idle_since = self.current_tick
        if self.quiesced():
            self._exit_quiesce()
            _LOG.info(
                "shard %d replica %d exited quiesce, msg %s, tick %d",
                self.shard_id, self.replica_id, msg_type.name,
                self.current_tick,
            )

    def _new_to_quiesce(self) -> bool:
        """Just entered quiesce: trailing heartbeats from peers that have
        not yet quiesced must not wake us (quiesce.go:84-89)."""
        return (self.quiesced()
                and self.current_tick - self.quiesced_since < self.election_tick)

    def _just_exited_quiesce(self) -> bool:
        return (not self.quiesced()
                and self.current_tick - self.exit_quiesce_tick < self.threshold())

    def try_enter_quiesce(self) -> None:
        """A peer's Quiesce message arrived (quiesce.go:96-104)."""
        if not self.enabled or self._just_exited_quiesce():
            return
        if not self.quiesced():
            self._enter_quiesce()

    def _enter_quiesce(self) -> None:
        self.quiesced_since = self.current_tick
        self.idle_since = self.current_tick
        self._new_quiesce_flag = True
        _LOG.info("shard %d replica %d entered quiesce",
                  self.shard_id, self.replica_id)

    def _exit_quiesce(self) -> None:
        self.quiesced_since = 0
        self.exit_quiesce_tick = self.current_tick
