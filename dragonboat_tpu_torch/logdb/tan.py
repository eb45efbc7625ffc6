"""tan — the durable raft-log engine (file-backed ILogDB).

Re-expression of the reference's purpose-built log engine
(``internal/tan/db.go:97-173`` write path, ``index.go:37-56`` in-memory
index, ``compaction.go`` whole-file compaction): WAL-style append-only log
files holding checksummed records, an in-memory per-node index rebuilt by
replaying the files on open, and compaction that deletes whole obsolete
files after re-homing any still-live node metadata.

Differences from the reference, deliberate:

- one record = one ``pb.Update`` batch (state + entries + optional snapshot
  metadata), matching the engine's batched ``save_raft_state`` shape — the
  ``[G]``-batch from the device kernel lands as a run of records followed by
  ONE fsync (raftio/logdb.go:78-83 single-writer contract);
- node metadata (latest state / snapshot / bootstrap) is re-appended to the
  active file before an old file is deleted, replacing tan's
  versionSet/manifest machinery with a self-describing log;
- a torn final record (crash mid-write) is truncated away on open; a bad
  checksum anywhere earlier is corruption and refuses to open.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Sequence

from dragonboat_tpu_torch import flight
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch import telemetry
from dragonboat_tpu_torch.raftio import ILogDB, NodeInfo, RaftState

# write-path latency lives in the process-global registry: tan shards are
# module-scoped single writers, not per-NodeHost objects, and a scrape
# wants the host-wide durability picture in one family
_SAVE_US = telemetry.GLOBAL.histogram(
    "logdb.save_us", help="save_raft_state batch latency (append+fsync), us")
_FSYNC_US = telemetry.GLOBAL.histogram(
    "logdb.fsync_us", help="fsync latency at the durability point, us")

MAGIC = 0x7A4E0002
_HDR = struct.Struct("<III")          # magic, payload length, crc32

# record types
R_UPDATE = 1       # state + entries (+ snapshot meta) for one node
R_BOOTSTRAP = 2
R_SNAPSHOT = 3
R_COMPACT = 4      # compaction floor advance
R_REMOVE = 5       # node data removed
R_META = 6         # re-homed node metadata (pre file-deletion checkpoint)

_KEY = struct.Struct("<BQQ")          # rectype, shard_id, replica_id


class CorruptLogError(OSError):
    """A record failed its checksum — the log is damaged.

    An OSError subclass so a corrupt read hit at RUNTIME (not open)
    routes through the engine workers' storage-failure path into the
    NodeHost controlled crash, instead of being retried forever by the
    generic exception guard."""


class _RangeIndex:
    """Range-based entry index (reference ``index.go:37-56`` indexEntry):
    one appended record covering entries ``[first..last]`` costs ONE tuple
    ``(first, last, fileno, offset)`` — not one dict slot per entry.  The
    entries inside a record are contiguous, so the ordinal of index ``i``
    is just ``i - first``.  Compaction keeps record-aligned ranges and a
    visibility ``floor``: indexes at or below the floor read as absent,
    and fully-covered ranges are dropped; a range straddling the floor
    keeps its original ``first`` so the ordinal math stays valid.
    """

    __slots__ = ("_r", "floor")

    def __init__(self) -> None:
        # sorted by first, non-overlapping: [first, last, fileno, offset]
        self._r: list[list[int]] = []
        self.floor = 0

    def __bool__(self) -> bool:
        return any(r[1] > self.floor for r in self._r)

    def add(self, first: int, last: int, fileno: int, off: int) -> None:
        """Index one record; conflict-overwrite truncates any stale
        suffix at or above ``first`` (raft log overwrite semantics)."""
        r = self._r
        while r and r[-1][0] >= first:
            r.pop()
        if r and r[-1][1] >= first:
            r[-1][1] = first - 1
        r.append([first, last, fileno, off])

    def get(self, i: int) -> tuple[int, int, int] | None:
        """index -> (fileno, record offset, ordinal within record)."""
        if i <= self.floor:
            return None
        r = self._r
        lo, hi = 0, len(r)
        while lo < hi:
            mid = (lo + hi) // 2
            if r[mid][0] <= i:
                lo = mid + 1
            else:
                hi = mid
        if lo == 0:
            return None
        first, last, fileno, off = r[lo - 1]
        if i > last:
            return None
        return fileno, off, i - first

    def compact(self, floor: int) -> None:
        if floor <= self.floor:
            return
        self.floor = floor
        self._r = [r for r in self._r if r[1] > floor]

    def contiguous_count(self, start: int) -> int:
        """Number of consecutively-present entries from ``start``."""
        if start <= self.floor:
            return 0
        count, expect = 0, start
        for first, last, _, _ in self._r:
            if last < expect:
                continue
            if first > expect:
                break
            count += last - expect + 1
            expect = last + 1
        return count

    def filenos(self) -> set[int]:
        return {r[2] for r in self._r if r[1] > self.floor}


@dataclass
class _Node:
    state: pb.State = field(default_factory=pb.State)
    snapshot: pb.Snapshot = field(default_factory=pb.Snapshot)
    bootstrap: pb.Bootstrap | None = None
    entries: _RangeIndex = field(default_factory=_RangeIndex)
    max_index: int = 0
    removed: bool = False


def _enc_update(ud: pb.Update) -> bytes:
    buf = bytearray()
    st = pb.encode_state(ud.state)
    buf += struct.pack("<I", len(st))
    buf += st
    buf += struct.pack("<I", len(ud.entries_to_save))
    for e in ud.entries_to_save:
        pb.encode_entry(e, buf)
    if ud.snapshot.is_empty():
        buf += b"\x00"
    else:
        buf += b"\x01"
        pb.encode_snapshot(ud.snapshot, buf)
    return bytes(buf)


def _dec_update(shard_id: int, replica_id: int, data: bytes) -> pb.Update:
    mv = memoryview(data)
    (nstate,) = struct.unpack_from("<I", mv, 0)
    off = 4
    state = pb.decode_state(bytes(mv[off:off + nstate]))
    off += nstate
    (n_ent,) = struct.unpack_from("<I", mv, off)
    off += 4
    ents = []
    for _ in range(n_ent):
        e, off = pb.decode_entry(mv, off)
        ents.append(e)
    snapshot = pb.Snapshot()
    if mv[off] == 1:
        snapshot, _ = pb.decode_snapshot(mv, off + 1)
    return pb.Update(shard_id=shard_id, replica_id=replica_id, state=state,
                     entries_to_save=tuple(ents), snapshot=snapshot)


class TanLogDB(ILogDB):
    """File-backed ILogDB; one instance owns one directory."""

    def __init__(self, root_dir: str, max_file_size: int = 64 << 20,
                 fs=None, recovery_mode: str = "strict") -> None:
        from dragonboat_tpu_torch.vfs import default_fs

        if recovery_mode not in ("strict", "quarantine"):
            raise ValueError(f"unknown recovery_mode {recovery_mode!r}")
        self.fs = fs if fs is not None else default_fs()
        self.root = root_dir
        self.max_file_size = max_file_size
        # "strict": a bad checksum in a non-tail file refuses to open
        # (the historical behavior).  "quarantine": truncate the file at
        # the corruption, record it in ``quarantined``, and clamp each
        # node's persisted commit to what is still contiguously present —
        # the node then reopens behind the shard and the leader re-
        # replicates (or snapshots) it back, instead of a dead replica.
        self.recovery_mode = recovery_mode
        self.quarantined: list[str] = []
        self.fs.makedirs(self.root)
        self._mu = threading.RLock()
        self._nodes: dict[tuple[int, int], _Node] = {}
        # fileno -> set of node keys whose latest metadata lives there
        self._file_meta: dict[int, set[tuple[int, int]]] = {}
        # fileno -> set of node keys with indexed entries there
        self._file_entries: dict[int, set[tuple[int, int]]] = {}
        self._readers: dict[int, object] = {}
        self._active_fileno = 0
        self._active = None
        self._closed = False
        self._recover()
        if self._active is None:
            self._open_active(self._next_fileno())

    # -- file plumbing ---------------------------------------------------

    def _path(self, fileno: int) -> str:
        return os.path.join(self.root, f"log-{fileno:08d}.tan")

    def _lognames(self) -> list[int]:
        out = []
        for fn in self.fs.listdir(self.root):
            if fn.startswith("log-") and fn.endswith(".tan"):
                out.append(int(fn[4:-4]))
        return sorted(out)

    def _next_fileno(self) -> int:
        names = self._lognames()
        return (names[-1] + 1) if names else 1

    def _open_active(self, fileno: int) -> None:
        self._active_fileno = fileno
        self._active = self.fs.open(self._path(fileno), "ab")

    def _reader(self, fileno: int):
        f = self._readers.get(fileno)
        if f is None:
            f = self._readers[fileno] = self.fs.open(self._path(fileno), "rb")
        return f

    def _append(self, rectype: int, shard_id: int, replica_id: int,
                body: bytes) -> tuple[int, int]:
        """Append one framed record; returns (fileno, offset)."""
        payload = _KEY.pack(rectype, shard_id, replica_id) + body
        frame = _HDR.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload
        if self._active.tell() + len(frame) > self.max_file_size \
                and self._active.tell() > 0:
            self._rotate()
        off = self._active.tell()
        self._active.write(frame)
        return self._active_fileno, off

    def _rotate(self) -> None:
        self.fs.fsync(self._active)
        self._active.close()
        self._open_active(self._active_fileno + 1)

    def _sync(self) -> None:
        """THE fsync (engine.go:1343 SaveRaftState durability point)."""
        t0 = time.perf_counter()
        self.fs.fsync(self._active)
        _FSYNC_US.observe((time.perf_counter() - t0) * 1e6)

    # -- recovery --------------------------------------------------------

    def _recover(self) -> None:
        files = self._lognames()
        for i, fileno in enumerate(files):
            last_file = i == len(files) - 1
            self._replay_file(fileno, truncate_tail=last_file)
        if files:
            # resume appending to the newest file
            self._open_active(files[-1])
        if self.quarantined:
            self._clamp_after_quarantine()

    def _clamp_after_quarantine(self) -> None:
        """Quarantine dropped records, so a node's persisted commit may
        point past the entries still on disk — the in-core log asserts
        ``commit <= last_index`` on load.  Clamp each commit to the
        contiguous range actually present; raft re-commits the rest once
        the leader re-replicates (committed-entry durability lives on
        the quorum, not this replica)."""
        for key, n in self._nodes.items():
            if n.removed:
                continue
            avail = n.snapshot.index + n.entries.contiguous_count(
                n.snapshot.index + 1)
            if n.state.commit > avail:
                n.state = pb.State(term=n.state.term, vote=n.state.vote,
                                   commit=avail)

    def _replay_file(self, fileno: int, truncate_tail: bool) -> None:
        """Single-pass scan + validate of a whole log file — the frame walk
        runs in C when available (native/dbtpu_native.c dbtpu_tan_scan),
        the record decode stays in Python (it builds the index)."""
        from dragonboat_tpu_torch import native

        path = self._path(fileno)
        with self.fs.open(path, "rb") as f:
            buf = f.read()
        recs, scan_end, torn = native.tan_scan(buf, MAGIC)
        for off, poff, plen in recs:
            self._apply_record(fileno, off, buf[poff:poff + plen])
        if torn:
            if truncate_tail:
                with self.fs.open(path, "r+b") as tf:
                    tf.truncate(scan_end)
                return
            if self.recovery_mode == "quarantine":
                with self.fs.open(path, "r+b") as tf:
                    tf.truncate(scan_end)
                self.quarantined.append(f"{path}@{scan_end}")
                flight.record(flight.QUARANTINE, path=path,
                              truncated_at=scan_end)
                return
            raise CorruptLogError(
                f"{path}@{scan_end}: bad record in non-tail log file")

    def _apply_record(self, fileno: int, off: int, payload: bytes) -> None:
        rectype, shard_id, replica_id = _KEY.unpack_from(payload, 0)
        body = payload[_KEY.size:]
        key = (shard_id, replica_id)
        n = self._nodes.setdefault(key, _Node())
        if rectype in (R_UPDATE, R_META):
            ud = _dec_update(shard_id, replica_id, body)
            if not ud.state.is_empty():
                n.state = ud.state
            if not ud.snapshot.is_empty():
                n.snapshot = ud.snapshot
            if ud.entries_to_save:
                first = ud.entries_to_save[0].index
                tail = ud.entries_to_save[-1].index
                n.entries.add(first, tail, fileno, off)
                n.max_index = tail
            self._file_meta.setdefault(fileno, set()).add(key)
            if ud.entries_to_save:
                self._file_entries.setdefault(fileno, set()).add(key)
            n.removed = False
        elif rectype == R_BOOTSTRAP:
            n.bootstrap = pb.decode_bootstrap(body)
            n.removed = False
            self._file_meta.setdefault(fileno, set()).add(key)
        elif rectype == R_SNAPSHOT:
            ss, _ = pb.decode_snapshot(memoryview(body), 0)
            if ss.index >= n.snapshot.index:
                n.snapshot = ss
            self._file_meta.setdefault(fileno, set()).add(key)
        elif rectype == R_COMPACT:
            (floor,) = struct.unpack("<Q", body)
            n.entries.compact(floor)
        elif rectype == R_REMOVE:
            self._nodes[key] = _Node(removed=True)

    # -- read side -------------------------------------------------------

    def _read_record(self, fileno: int, off: int) -> pb.Update:
        f = self._reader(fileno)
        f.seek(off)
        magic, ln, crc = _HDR.unpack(f.read(_HDR.size))
        payload = f.read(ln)
        if magic != MAGIC or zlib.crc32(payload) != crc:
            raise CorruptLogError(f"{self._path(fileno)}@{off}")
        rectype, shard_id, replica_id = _KEY.unpack_from(payload, 0)
        return _dec_update(shard_id, replica_id, payload[_KEY.size:])

    # -- ILogDB ----------------------------------------------------------

    def name(self) -> str:
        return "tan"

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
            if self._active is not None:
                try:
                    self._sync()
                finally:
                    self._active.close()
            for f in self._readers.values():
                f.close()
            self._readers.clear()

    def list_node_info(self) -> list[NodeInfo]:
        with self._mu:
            return [NodeInfo(s, r) for (s, r), n in self._nodes.items()
                    if not n.removed]

    def save_bootstrap_info(self, shard_id, replica_id, bootstrap) -> None:
        with self._mu:
            fileno, _ = self._append(R_BOOTSTRAP, shard_id, replica_id,
                                     pb.encode_bootstrap(bootstrap))
            self._sync()
            key = (shard_id, replica_id)
            self._nodes.setdefault(key, _Node()).bootstrap = bootstrap
            self._file_meta.setdefault(fileno, set()).add(key)

    def get_bootstrap_info(self, shard_id, replica_id):
        with self._mu:
            n = self._nodes.get((shard_id, replica_id))
            return n.bootstrap if n and not n.removed else None

    def save_raft_state(self, updates: Sequence[pb.Update],
                        worker_id: int) -> None:
        """Batch append + ONE fsync (raftio/logdb.go:78-83)."""
        t0 = time.perf_counter()
        with self._mu:
            wrote = False
            for ud in updates:
                if ud.state.is_empty() and not ud.entries_to_save \
                        and ud.snapshot.is_empty():
                    continue
                fileno, off = self._append(
                    R_UPDATE, ud.shard_id, ud.replica_id, _enc_update(ud))
                self._apply_record_index(fileno, off, ud)
                wrote = True
            if wrote:
                self._sync()
        if wrote:
            _SAVE_US.observe((time.perf_counter() - t0) * 1e6)

    def _apply_record_index(self, fileno: int, off: int,
                            ud: pb.Update) -> None:
        key = (ud.shard_id, ud.replica_id)
        n = self._nodes.setdefault(key, _Node())
        if not ud.state.is_empty():
            n.state = ud.state
        if not ud.snapshot.is_empty():
            n.snapshot = ud.snapshot
        if ud.entries_to_save:
            first = ud.entries_to_save[0].index
            tail = ud.entries_to_save[-1].index
            n.entries.add(first, tail, fileno, off)
            n.max_index = tail
            self._file_entries.setdefault(fileno, set()).add(key)
        self._file_meta.setdefault(fileno, set()).add(key)
        n.removed = False

    def iterate_entries(self, shard_id, replica_id, low, high, max_size):
        with self._mu:
            n = self._nodes.get((shard_id, replica_id))
            if n is None or n.removed:
                return []
            out, size = [], 0
            rec_cache: dict[tuple[int, int], pb.Update] = {}
            for i in range(low, high):
                loc = n.entries.get(i)
                if loc is None:
                    break
                fileno, off, ordinal = loc
                ud = rec_cache.get((fileno, off))
                if ud is None:
                    ud = rec_cache[(fileno, off)] = self._read_record(
                        fileno, off)
                e = ud.entries_to_save[ordinal]
                size += pb.entry_size(e)
                if out and max_size and size > max_size:
                    break
                out.append(e)
            return out

    def read_raft_state(self, shard_id, replica_id, last_index):
        with self._mu:
            n = self._nodes.get((shard_id, replica_id))
            if n is None or n.removed:
                return None
            if n.state.is_empty() and not n.entries and n.snapshot.is_empty():
                return None
            first = n.snapshot.index + 1
            count = n.entries.contiguous_count(first)
            return RaftState(state=n.state, first_index=first,
                             entry_count=count)

    def remove_entries_to(self, shard_id, replica_id, index):
        with self._mu:
            key = (shard_id, replica_id)
            n = self._nodes.get(key)
            if n is None:
                return
            self._append(R_COMPACT, shard_id, replica_id,
                         struct.pack("<Q", index))
            self._sync()
            n.entries.compact(index)
            self._gc_files()

    def compact_entries_to(self, shard_id, replica_id, index):
        self.remove_entries_to(shard_id, replica_id, index)

    def _gc_files(self) -> None:
        """Delete whole log files with no live index references
        (tan compaction.go), re-homing live node metadata first."""
        live: dict[int, set[tuple[int, int]]] = {}
        for key, n in self._nodes.items():
            if n.removed:
                continue
            for fileno in n.entries.filenos():
                live.setdefault(fileno, set()).add(key)
        for fileno in self._lognames():
            if fileno == self._active_fileno:
                continue
            if live.get(fileno):
                continue
            # re-home the latest metadata of nodes whose meta lives here
            for key in sorted(self._file_meta.get(fileno, ())):
                n = self._nodes.get(key)
                if n is None or n.removed:
                    continue
                meta = pb.Update(shard_id=key[0], replica_id=key[1],
                                 state=n.state, snapshot=n.snapshot)
                mf, moff = self._append(R_META, key[0], key[1],
                                        _enc_update(meta))
                self._file_meta.setdefault(mf, set()).add(key)
                if n.bootstrap is not None:
                    bf, _ = self._append(R_BOOTSTRAP, key[0], key[1],
                                         pb.encode_bootstrap(n.bootstrap))
                    self._file_meta.setdefault(bf, set()).add(key)
            self._sync()
            r = self._readers.pop(fileno, None)
            if r is not None:
                r.close()
            self.fs.remove(self._path(fileno))
            self._file_meta.pop(fileno, None)
            self._file_entries.pop(fileno, None)

    def save_snapshots(self, updates):
        with self._mu:
            wrote = False
            for ud in updates:
                if ud.snapshot.is_empty():
                    continue
                buf = bytearray()
                pb.encode_snapshot(ud.snapshot, buf)
                fileno, _ = self._append(R_SNAPSHOT, ud.shard_id,
                                         ud.replica_id, bytes(buf))
                key = (ud.shard_id, ud.replica_id)
                n = self._nodes.setdefault(key, _Node())
                if ud.snapshot.index >= n.snapshot.index:
                    n.snapshot = ud.snapshot
                self._file_meta.setdefault(fileno, set()).add(key)
                wrote = True
            if wrote:
                self._sync()

    def get_snapshot(self, shard_id, replica_id):
        with self._mu:
            n = self._nodes.get((shard_id, replica_id))
            if n is None or n.removed or n.snapshot.is_empty():
                return None
            return n.snapshot

    def remove_node_data(self, shard_id, replica_id):
        with self._mu:
            self._append(R_REMOVE, shard_id, replica_id, b"")
            self._sync()
            self._nodes[(shard_id, replica_id)] = _Node(removed=True)
            self._gc_files()

    def import_snapshot(self, snapshot: pb.Snapshot, replica_id: int) -> None:
        """Rebuild a node from an exported snapshot (tools/import.go:134)."""
        with self._mu:
            key = (snapshot.shard_id, replica_id)
            self._append(R_REMOVE, snapshot.shard_id, replica_id, b"")
            n = _Node()
            n.state = pb.State(term=snapshot.term, vote=0,
                               commit=snapshot.index)
            n.snapshot = snapshot
            n.bootstrap = pb.Bootstrap(
                addresses=dict(snapshot.membership.addresses), join=False)
            self._nodes[key] = n
            meta = pb.Update(shard_id=snapshot.shard_id,
                             replica_id=replica_id, state=n.state,
                             snapshot=snapshot)
            fileno, _ = self._append(R_META, snapshot.shard_id, replica_id,
                                     _enc_update(meta))
            self._file_meta.setdefault(fileno, set()).add(key)
            self._append(R_BOOTSTRAP, snapshot.shard_id, replica_id,
                         pb.encode_bootstrap(n.bootstrap))
            self._sync()


class TanLogDBFactory:
    """config.LogDBFactory equivalent for NodeHostConfig."""

    def __init__(self, root_dir: str, max_file_size: int = 64 << 20,
                 recovery_mode: str = "strict") -> None:
        self.root_dir = root_dir
        self.max_file_size = max_file_size
        self.recovery_mode = recovery_mode

    def create(self) -> TanLogDB:
        return TanLogDB(self.root_dir, self.max_file_size,
                        recovery_mode=self.recovery_mode)
