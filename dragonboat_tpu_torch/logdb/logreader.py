"""LogReader — the raft core's read-side window over an ILogDB.

Parity with ``internal/logdb/logreader.go``: tracks (marker, length) over
the stable log, serves term()/entries() to the in-memory EntryLog, and is
advanced by Append/ApplySnapshot/Compact as the engine persists updates.
Implements the :class:`dragonboat_tpu_torch.core.logentry.ILogDBReader` protocol.
"""

from __future__ import annotations

import threading
from typing import Sequence

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.core.logentry import CompactedError, UnavailableError
from dragonboat_tpu_torch.raftio import ILogDB


class LogReader:
    def __init__(self, shard_id: int, replica_id: int, logdb: ILogDB) -> None:
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.logdb = logdb
        self._mu = threading.RLock()
        self._snapshot = pb.Snapshot()
        # parity logreader.go:74-80 (NewLogReader): markerIndex=0, length=1,
        # so first_index()==1 and a fresh node accepts the bootstrap entry 1
        self._marker = 0      # marker acts as a virtual entry (its term is known)
        self._length = 1
        self._marker_term = 0

    # -- ILogDBReader ----------------------------------------------------

    def first_index(self) -> int:
        with self._mu:
            return self._marker + 1

    def last_index(self) -> int:
        with self._mu:
            return self._marker + self._length - 1

    def term(self, index: int) -> int:
        with self._mu:
            if index == self._marker:
                return self._marker_term
            if index < self._marker:
                raise CompactedError(index)
            if index > self.last_index():
                raise UnavailableError(index)
            ents = self.logdb.iterate_entries(
                self.shard_id, self.replica_id, index, index + 1, 0
            )
            if not ents:
                raise UnavailableError(index)
            return ents[0].term

    def entries(self, low: int, high: int, max_size: int) -> list[pb.Entry]:
        with self._mu:
            if low <= self._marker:
                raise CompactedError(low)
            if high > self.last_index() + 1:
                raise UnavailableError(high)
            return self.logdb.iterate_entries(
                self.shard_id, self.replica_id, low, high, max_size
            )

    def snapshot(self) -> pb.Snapshot:
        with self._mu:
            return self._snapshot

    # -- engine-side advancement ----------------------------------------

    def set_range(self, first: int, length: int) -> None:
        """Extend the known stable range (logreader.go SetRange)."""
        if length == 0:
            return
        with self._mu:
            last = first + length - 1
            if last <= self.last_index():
                return
            if first > self.last_index() + 1:
                # gap: reset to the new range (snapshot install path)
                self._marker = first - 1
                self._length = length + 1
                return
            self._length = last - self._marker + 1

    def append(self, entries: Sequence[pb.Entry]) -> None:
        if not entries:
            return
        with self._mu:
            first = entries[0].index
            last = entries[-1].index
            if first > self.last_index() + 1:
                raise AssertionError(
                    f"missing log entry gap: {first} > {self.last_index() + 1}"
                )
            if last <= self._marker:
                return
            self._length = last - self._marker + 1

    def apply_snapshot(self, ss: pb.Snapshot) -> None:
        with self._mu:
            self._snapshot = ss
            self._marker = ss.index
            self._marker_term = ss.term
            self._length = 1

    def create_snapshot(self, ss: pb.Snapshot) -> None:
        """Record a locally-taken snapshot without resetting the window
        (logreader.go CreateSnapshot) — it becomes the payload of
        InstallSnapshot messages to lagging peers."""
        with self._mu:
            if ss.index < self._snapshot.index:
                return
            self._snapshot = ss

    def set_state(self, st: pb.State) -> None:
        pass  # state is persisted by the engine; nothing cached here

    def compact(self, index: int) -> None:
        """Advance marker after log compaction (logreader.go Compact)."""
        with self._mu:
            if index < self._marker:
                raise CompactedError(index)
            if index > self.last_index():
                raise UnavailableError(index)
            term = self.term(index)
            self._length -= index - self._marker
            self._marker = index
            self._marker_term = term
