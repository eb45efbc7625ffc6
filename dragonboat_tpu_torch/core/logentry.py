"""Host-side raft entry log: in-memory tier over a stable-storage reader.

Re-expression of the reference's two-tier log view
(``internal/raft/logentry.go:78`` entryLog, ``internal/raft/inmemory.go:30``
inMemory): ``committed``/``processed`` cursors over a merged view of
not-yet-stable in-memory entries and a stable LogDB window.  The TPU build
keeps this host-side structure for the slow path and host interop; the device
ring in :mod:`dragonboat_tpu_torch.core.kernel` holds the fixed-width mirror.
"""

from __future__ import annotations

from typing import Protocol, Sequence

from dragonboat_tpu_torch import raftpb as pb


class CompactedError(Exception):
    """Requested entries are no longer available (compacted away).

    Parity: internal/raft/logentry.go ErrCompacted."""


class UnavailableError(Exception):
    """Requested entries are beyond the last known index."""


class ILogDBReader(Protocol):
    """Read-side view the raft core has of stable storage.

    Parity: the raft.ILogDB interface at internal/raft/logentry.go:45."""

    def first_index(self) -> int: ...
    def last_index(self) -> int: ...
    def term(self, index: int) -> int: ...
    def entries(self, low: int, high: int, max_size: int) -> list[pb.Entry]: ...
    def snapshot(self) -> pb.Snapshot: ...
    def append(self, entries: Sequence[pb.Entry]) -> None: ...
    def apply_snapshot(self, ss: pb.Snapshot) -> None: ...


class InMemoryLogDB:
    """A trivial in-memory ILogDB reader used by tests and the loopback
    runtime (the model for the reference's TestLogDB fixture)."""

    def __init__(self) -> None:
        self._entries: list[pb.Entry] = []
        self._snapshot = pb.Snapshot()
        self._marker = 1  # index of _entries[0]

    def first_index(self) -> int:
        return self._marker

    def last_index(self) -> int:
        return self._marker + len(self._entries) - 1

    def term(self, index: int) -> int:
        if index == self._snapshot.index:
            return self._snapshot.term
        if index < self._marker:
            raise CompactedError(index)
        if index > self.last_index():
            raise UnavailableError(index)
        return self._entries[index - self._marker].term

    def entries(self, low: int, high: int, max_size: int) -> list[pb.Entry]:
        if low < self._marker:
            raise CompactedError(low)
        if high > self.last_index() + 1:
            raise UnavailableError(high)
        out = self._entries[low - self._marker : high - self._marker]
        if max_size > 0:
            size = 0
            for i, e in enumerate(out):
                size += pb.entry_size(e)
                if size > max_size and i > 0:
                    return out[:i]
        return list(out)

    def snapshot(self) -> pb.Snapshot:
        return self._snapshot

    def append(self, entries: Sequence[pb.Entry]) -> None:
        if not entries:
            return
        first = entries[0].index
        if first > self.last_index() + 1:
            raise ValueError(f"gap: {first} > {self.last_index() + 1}")
        if first < self._marker:
            entries = [e for e in entries if e.index >= self._marker]
            if not entries:
                return
            first = entries[0].index
        self._entries[first - self._marker :] = list(entries)

    def apply_snapshot(self, ss: pb.Snapshot) -> None:
        self._snapshot = ss
        self._marker = ss.index + 1
        self._entries = []

    def compact(self, index: int) -> None:
        if index < self._marker:
            return
        keep_from = index + 1 - self._marker
        self._entries = self._entries[keep_from:]
        self._marker = index + 1


class InMemory:
    """Sliding window of not-yet-stable entries.

    Parity: internal/raft/inmemory.go:30 (inMemory) — marker/savedTo GC,
    snapshot intake, merge with truncation."""

    def __init__(self, last_index: int) -> None:
        self.marker = last_index + 1
        self.entries: list[pb.Entry] = []
        self.saved_to = last_index
        self.snapshot: pb.Snapshot | None = None

    def get_snapshot_index(self) -> int | None:
        return self.snapshot.index if self.snapshot is not None else None

    def get_entries(self, low: int, high: int) -> list[pb.Entry]:
        if low > high or low < self.marker:
            raise CompactedError(low)
        upper = self.marker + len(self.entries)
        if high > upper:
            raise UnavailableError(high)
        return self.entries[low - self.marker : high - self.marker]

    def get_last_index(self) -> int | None:
        if self.entries:
            return self.entries[-1].index
        if self.snapshot is not None:
            return self.snapshot.index
        return None

    def has_entries_to_save(self) -> bool:
        return bool(self.entries_to_save())

    def entries_to_save(self) -> list[pb.Entry]:
        idx = self.saved_to + 1
        if idx - self.marker > len(self.entries):
            return []
        if idx < self.marker:
            idx = self.marker
        return self.entries[idx - self.marker :]

    def saved_log_to(self, index: int, term: int) -> None:
        if index < self.marker:
            return
        if not self.entries:
            return
        if index > self.entries[-1].index:
            return
        if self.entries[index - self.marker].term != term:
            return
        self.saved_to = index

    def saved_snapshot_to(self, index: int) -> None:
        if self.snapshot is not None and self.snapshot.index == index:
            self.snapshot = None

    def applied_log_to(self, index: int) -> None:
        """GC entries at or below the applied index (they are stable and
        applied, so the in-mem tier no longer needs them)."""
        if index < self.marker or not self.entries:
            return
        if index > self.saved_to:
            # never drop unsaved entries
            index = self.saved_to
        if index < self.marker:
            return
        new_marker = index + 1
        self.entries = self.entries[new_marker - self.marker :]
        self.marker = new_marker

    def merge(self, ents: Sequence[pb.Entry]) -> None:
        if not ents:
            return
        first = ents[0].index
        self.saved_to = min(self.saved_to, first - 1)
        if first == self.marker + len(self.entries):
            self.entries.extend(ents)
        elif first <= self.marker:
            self.marker = first
            self.entries = list(ents)
        else:
            self.entries = self.entries[: first - self.marker]
            self.entries.extend(ents)

    def restore(self, ss: pb.Snapshot) -> None:
        self.snapshot = ss
        self.marker = ss.index + 1
        self.entries = []
        self.saved_to = ss.index


class EntryLog:
    """The merged two-tier log view — parity with
    internal/raft/logentry.go:78 (entryLog)."""

    def __init__(self, logdb: ILogDBReader) -> None:
        self.logdb = logdb
        self.inmem = InMemory(logdb.last_index())
        self.committed = logdb.first_index() - 1
        self.processed = logdb.first_index() - 1

    # -- index/term resolution across tiers (logentry.go:97-156) --

    def first_index(self) -> int:
        idx = self.inmem.get_snapshot_index()
        if idx is not None:
            return idx + 1
        return self.logdb.first_index()

    def last_index(self) -> int:
        idx = self.inmem.get_last_index()
        if idx is not None:
            return idx
        return self.logdb.last_index()

    def term(self, index: int) -> int:
        if index == 0:
            return 0
        first, last = self.first_index(), self.last_index()
        if index < first - 1:
            raise CompactedError(index)
        if index > last:
            raise UnavailableError(index)
        snap_idx = self.inmem.get_snapshot_index()
        if snap_idx is not None and index == snap_idx:
            assert self.inmem.snapshot is not None
            return self.inmem.snapshot.term
        if self.inmem.entries and index >= self.inmem.marker:
            return self.inmem.entries[index - self.inmem.marker].term
        return self.logdb.term(index)

    def last_term(self) -> int:
        return self.term(self.last_index())

    def match_term(self, index: int, term: int) -> bool:
        try:
            return self.term(index) == term
        except (CompactedError, UnavailableError):
            return False

    def up_to_date(self, index: int, term: int) -> bool:
        """Vote restriction — parity with logentry.go:381 (upToDate)."""
        last_term = self.last_term()
        if term > last_term:
            return True
        if term == last_term:
            return index >= self.last_index()
        return False

    # -- reads --

    def get_entries(self, low: int, high: int, max_size: int = 0) -> list[pb.Entry]:
        if low > high:
            raise ValueError(f"low {low} > high {high}")
        if low < self.first_index():
            raise CompactedError(low)
        if high > self.last_index() + 1:
            raise UnavailableError(high)
        if low == high:
            return []
        in_marker = self.inmem.marker
        out: list[pb.Entry] = []
        if low < in_marker:
            out = self.logdb.entries(low, min(high, in_marker), 0)
        if high > in_marker and (not out or out[-1].index + 1 >= in_marker):
            lo = max(low, in_marker)
            out = out + self.inmem.get_entries(lo, high)
        if max_size > 0:
            size = 0
            for i, e in enumerate(out):
                size += pb.entry_size(e)
                if size > max_size and i > 0:
                    return out[:i]
        return out

    def entries_from(self, low: int, max_size: int = 0) -> list[pb.Entry]:
        if low > self.last_index():
            return []
        return self.get_entries(low, self.last_index() + 1, max_size)

    def get_committed_entries(self, low: int, high: int, max_size: int) -> list[pb.Entry]:
        """Parity: logentry.go:280 (getCommittedEntries) for LogQuery."""
        if low < self.first_index() or low > self.committed:
            raise CompactedError(low)
        high = min(high, self.committed + 1)
        if low == high:
            return []
        return self.get_entries(low, high, max_size)

    def entries_to_apply(self, limit: int = 0) -> list[pb.Entry]:
        """Committed-but-not-processed entries, paginated —
        parity with logentry.go:268 (getEntriesToApply)."""
        if self.processed < self.committed:
            return self.get_entries(self.processed + 1, self.committed + 1, limit)
        return []

    def has_entries_to_apply(self) -> bool:
        return self.committed > self.processed

    def has_entries_to_save(self) -> bool:
        return self.inmem.has_entries_to_save()

    def entries_to_save(self) -> list[pb.Entry]:
        return self.inmem.entries_to_save()

    # -- writes --

    def append(self, entries: Sequence[pb.Entry]) -> None:
        if not entries:
            return
        if entries[0].index <= self.committed:
            raise AssertionError(
                f"appending over committed entries: {entries[0].index} <= {self.committed}"
            )
        self.inmem.merge(entries)

    def get_conflict_index(self, entries: Sequence[pb.Entry]) -> int:
        for e in entries:
            if not self.match_term(e.index, e.term):
                return e.index
        return 0

    def try_append(self, index: int, entries: Sequence[pb.Entry]) -> bool:
        """Append with conflict resolution — parity with logentry.go:296."""
        conflict = self.get_conflict_index(entries)
        if conflict != 0:
            if conflict <= self.committed:
                raise AssertionError(
                    f"entry {conflict} conflicts with committed entry {self.committed}"
                )
            self.append(list(entries)[conflict - index - 1 :])
            return True
        return False

    def commit_to(self, index: int) -> None:
        if index <= self.committed:
            return
        if index > self.last_index():
            raise AssertionError(
                f"commitTo {index} > lastIndex {self.last_index()}"
            )
        self.committed = index

    def try_commit(self, index: int, term: int) -> bool:
        """Quorum commit with the current-term-only rule —
        parity with logentry.go:395 and the p8 raft-paper restriction."""
        if index <= self.committed:
            return False
        try:
            lterm = self.term(index)
        except CompactedError:
            lterm = 0
        if lterm == term:
            self.commit_to(index)
            return True
        return False

    def commit_update(self, uc: pb.UpdateCommit) -> None:
        """Advance stable/processed/applied cursors — parity with
        logentry.go:351 (commitUpdate)."""
        if uc.stable_log_to > 0:
            self.inmem.saved_log_to(uc.stable_log_to, uc.stable_log_term)
        if uc.stable_snapshot_to > 0:
            self.inmem.saved_snapshot_to(uc.stable_snapshot_to)
        if uc.processed > 0:
            if uc.processed < self.processed or uc.processed > self.committed:
                raise AssertionError(
                    f"invalid processed {uc.processed}, "
                    f"current {self.processed}, committed {self.committed}"
                )
            self.processed = uc.processed
        if uc.last_applied > 0:
            if uc.last_applied > self.committed or uc.last_applied > self.processed:
                raise AssertionError(
                    f"invalid last_applied {uc.last_applied}, "
                    f"processed {self.processed}, committed {self.committed}"
                )
            self.inmem.applied_log_to(uc.last_applied)

    def restore(self, ss: pb.Snapshot) -> None:
        self.inmem.restore(ss)
        if ss.index < self.committed:
            raise AssertionError("committed moving backwards on restore")
        self.committed = ss.index
        self.processed = ss.index

    def get_uncommitted_size(self) -> int:
        if self.committed >= self.last_index():
            return 0
        ents = self.get_entries(self.committed + 1, self.last_index() + 1)
        return sum(pb.entry_size(e) for e in ents)

    def snapshot(self) -> pb.Snapshot:
        if self.inmem.snapshot is not None:
            return self.inmem.snapshot
        return self.logdb.snapshot()
