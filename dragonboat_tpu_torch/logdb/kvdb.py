"""KVLogDB — ILogDB over the OrderedKV sorted-string engine.

The reference's default logdb lays raft state out as sorted keys in a
Pebble KV store (``internal/logdb/kv_logdb.go``, key scheme in
``internal/logdb/key.go``): entries under big-endian (shard, replica,
index) keys so a range scan walks the log in order, plus point keys for
hard state, snapshot, bootstrap and the max-index watermark.  This is the
same design point re-derived over :class:`~dragonboat_tpu_torch.logdb.kv.OrderedKV`
(tan.py is the OTHER reference engine — purpose-built log files).

Semantics match MemLogDB/TanLogDB (the contract suite in tests/test_kvdb.py
runs the same scenarios as tests/test_tan.py):

- conflict overwrite: a save batch starting at ``first`` invalidates every
  stored entry at or above it — recorded by moving the max-index watermark
  down; stale higher-index keys are ignored by reads and physically dropped
  at compaction (the reference deletes them in the same write batch;
  with an LSM a watermark costs one point write instead of N deletes);
- ``remove_entries_to`` advances a per-node floor key consulted by reads;
  physical reclamation happens in ``compact_entries_to`` via the engine's
  compaction filter (parity: logdb.go compaction taskQueue).
"""

from __future__ import annotations

import struct
import threading
from typing import Sequence

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.logdb.kv import FlushError, OrderedKV
from dragonboat_tpu_torch.raftio import ILogDB, NodeInfo, RaftState

# key prefixes — big-endian fields keep lexicographic == numeric order
_K_BOOTSTRAP = 0x01
_K_STATE = 0x02
_K_SNAPSHOT = 0x03
_K_MAXINDEX = 0x04
_K_FLOOR = 0x05
_K_ENTRY = 0x10

_NODE = struct.Struct(">BQQ")         # prefix, shard, replica
_ENTRY = struct.Struct(">BQQQ")       # prefix, shard, replica, index


def _nk(prefix: int, shard_id: int, replica_id: int) -> bytes:
    return _NODE.pack(prefix, shard_id, replica_id)


def _ek(shard_id: int, replica_id: int, index: int) -> bytes:
    return _ENTRY.pack(_K_ENTRY, shard_id, replica_id, index)


def _u64(v: int) -> bytes:
    return struct.pack(">Q", v)


class KVLogDB(ILogDB):
    """ILogDB over one OrderedKV directory (single writer; the sharded
    wrapper provides per-partition concurrency)."""

    def __init__(self, root_dir: str, fs=None,
                 memtable_bytes: int = 4 << 20, max_ssts: int = 6) -> None:
        self._mu = threading.RLock()
        # (shard, replica) -> entry floor; mirrors the _K_FLOOR keys so the
        # compaction filter runs without KV reads from inside the engine
        self._floors: dict[tuple[int, int], int] = {}
        self._maxidx: dict[tuple[int, int], int] = {}
        self.kv = OrderedKV(root_dir, fs=fs, memtable_bytes=memtable_bytes,
                            max_ssts=max_ssts,
                            compaction_filter=self._drop_key)
        for k, v in self.kv.scan(bytes([_K_FLOOR]), bytes([_K_FLOOR + 1])):
            _, s, r = _NODE.unpack(k)
            self._floors[(s, r)] = struct.unpack(">Q", v)[0]
        for k, v in self.kv.scan(bytes([_K_MAXINDEX]), bytes([_K_MAXINDEX + 1])):
            _, s, r = _NODE.unpack(k)
            self._maxidx[(s, r)] = struct.unpack(">Q", v)[0]

    def _drop_key(self, key: bytes) -> bool:
        if key[0] != _K_ENTRY:
            return False
        _, s, r, idx = _ENTRY.unpack(key)
        if idx <= self._floors.get((s, r), 0):
            return True
        return idx > self._maxidx.get((s, r), 1 << 62)

    # -- ILogDB ---------------------------------------------------------

    def name(self) -> str:
        return "kv"

    def close(self) -> None:
        self.kv.close()

    def list_node_info(self) -> list[NodeInfo]:
        seen = set()
        for k, _ in self.kv.scan(bytes([_K_BOOTSTRAP]), bytes([_K_MAXINDEX + 1])):
            _, s, r = _NODE.unpack(k)
            seen.add((s, r))
        return [NodeInfo(s, r) for (s, r) in sorted(seen)]

    def save_bootstrap_info(self, shard_id, replica_id, bootstrap) -> None:
        self.kv.put(_nk(_K_BOOTSTRAP, shard_id, replica_id),
                    pb.encode_bootstrap(bootstrap))

    def get_bootstrap_info(self, shard_id, replica_id):
        raw = self.kv.get(_nk(_K_BOOTSTRAP, shard_id, replica_id))
        return None if raw is None else pb.decode_bootstrap(raw)

    def save_raft_state(self, updates: Sequence[pb.Update],
                        worker_id: int = 0) -> None:
        puts = []
        marks: dict[tuple[int, int], int] = {}
        with self._mu:
            for ud in updates:
                key = (ud.shard_id, ud.replica_id)
                if not ud.state.is_empty():
                    puts.append((_nk(_K_STATE, *key),
                                 pb.encode_state(ud.state)))
                if not ud.snapshot.is_empty():
                    buf = bytearray()
                    pb.encode_snapshot(ud.snapshot, buf)
                    puts.append((_nk(_K_SNAPSHOT, *key), bytes(buf)))
                if ud.entries_to_save:
                    for e in ud.entries_to_save:
                        buf = bytearray()
                        pb.encode_entry(e, buf)
                        puts.append((_ek(*key, e.index), bytes(buf)))
                    # the overwrite watermark: entries above the batch tail
                    # are dead even if their keys still exist
                    marks[key] = ud.entries_to_save[-1].index
                    puts.append((_nk(_K_MAXINDEX, *key), _u64(marks[key])))
            # the new watermark must be visible BEFORE the write: the
            # write itself may trigger a memtable flush + compaction, and
            # the compaction filter would otherwise drop this very
            # batch's entries as above-watermark stale keys (a compaction
            # can only fire after the WAL append+fsync succeeded, so the
            # batch is durable by the time the filter consults the mark).
            # A write that never reached the WAL rolls the memory view
            # back to match disk; a FlushError means the batch itself IS
            # durable (WAL fsync preceded the flush), so the marks stand.
            prev = {k: self._maxidx.get(k) for k in marks}
            self._maxidx.update(marks)
            try:
                self.kv.write_batch(puts, sync=True)
            except FlushError:
                raise
            except BaseException as exc:
                if getattr(exc, "batch_durable", False):
                    # a KeyboardInterrupt/SystemExit escaping the
                    # post-fsync flush: the batch IS on disk — rolling
                    # the marks back would let a later compaction drop
                    # this batch's own entries as above-watermark while
                    # the durable _K_MAXINDEX key still claims them
                    raise
                for k, v in prev.items():
                    if v is None:
                        self._maxidx.pop(k, None)
                    else:
                        self._maxidx[k] = v
                raise

    def iterate_entries(self, shard_id, replica_id, low, high, max_size):
        key = (shard_id, replica_id)
        with self._mu:
            hi = min(high, self._maxidx.get(key, 0) + 1)
            floor = self._floors.get(key, 0)
        out, size, expect = [], 0, low
        if low <= floor:
            return out
        for k, raw in self.kv.scan(_ek(shard_id, replica_id, low),
                                   _ek(shard_id, replica_id, max(hi, low))):
            idx = _ENTRY.unpack(k)[3]
            if idx != expect:
                break                      # gap: contiguous run ends
            e, _ = pb.decode_entry(memoryview(raw), 0)
            size += pb.entry_size(e)
            if out and max_size and size > max_size:
                break
            out.append(e)
            expect += 1
        return out

    def read_raft_state(self, shard_id, replica_id, last_index):
        key = (shard_id, replica_id)
        raw_state = self.kv.get(_nk(_K_STATE, *key))
        snapshot = self.get_snapshot(shard_id, replica_id)
        with self._mu:
            maxidx = self._maxidx.get(key, 0)
        first = (snapshot.index if snapshot is not None else 0) + 1
        count = 0
        if maxidx >= first:
            run = self.iterate_entries(shard_id, replica_id, first,
                                       maxidx + 1, 0)
            count = len(run)
        if raw_state is None and snapshot is None and count == 0:
            return None
        state = (pb.decode_state(raw_state)
                 if raw_state is not None else pb.State())
        return RaftState(state=state, first_index=first, entry_count=count)

    def remove_entries_to(self, shard_id, replica_id, index):
        key = (shard_id, replica_id)
        with self._mu:
            if index <= self._floors.get(key, 0):
                return
            # floor moves only after the key is durable: a failed put
            # must not leave reads (or a later compaction) ahead of disk
            # — unlike the save-path watermark, nothing in this write
            # depends on the new floor being visible mid-flush.  A
            # FlushError means the put itself landed, so the floor moves.
            try:
                self.kv.put(_nk(_K_FLOOR, *key), _u64(index))
            except BaseException as exc:
                # FlushError (and a batch_durable-tagged interrupt)
                # means the put itself landed, so the floor moves
                if isinstance(exc, FlushError) or getattr(
                        exc, "batch_durable", False):
                    self._floors[key] = index
                raise
            self._floors[key] = index

    def compact_entries_to(self, shard_id, replica_id, index):
        self.remove_entries_to(shard_id, replica_id, index)
        self.kv.compact()                  # physical reclamation

    def save_snapshots(self, updates) -> None:
        puts = []
        for ud in updates:
            if not ud.snapshot.is_empty():
                buf = bytearray()
                pb.encode_snapshot(ud.snapshot, buf)
                puts.append((_nk(_K_SNAPSHOT, ud.shard_id, ud.replica_id),
                             bytes(buf)))
        if puts:
            self.kv.write_batch(puts, sync=True)

    def get_snapshot(self, shard_id, replica_id):
        raw = self.kv.get(_nk(_K_SNAPSHOT, shard_id, replica_id))
        if raw is None:
            return None
        ss, _ = pb.decode_snapshot(memoryview(raw), 0)
        return None if ss.is_empty() else ss

    def remove_node_data(self, shard_id, replica_id) -> None:
        key = (shard_id, replica_id)
        with self._mu:
            dels = [_nk(p, *key) for p in
                    (_K_BOOTSTRAP, _K_STATE, _K_SNAPSHOT, _K_MAXINDEX,
                     _K_FLOOR)]
            dels += [k for k, _ in self.kv.scan(_ek(*key, 0),
                                                _ek(*key, (1 << 64) - 1))]
            try:
                self.kv.write_batch([], dels, sync=True)
            except BaseException as exc:
                # the deletion batch IS durable on FlushError and on a
                # KeyboardInterrupt/SystemExit tagged batch_durable by
                # the post-fsync flush — the in-memory books must drop
                # with it or a re-added node would inherit a stale
                # floor/watermark over fresh entries
                if isinstance(exc, FlushError) or getattr(
                        exc, "batch_durable", False):
                    self._floors.pop(key, None)
                    self._maxidx.pop(key, None)
                raise
            self._floors.pop(key, None)
            self._maxidx.pop(key, None)

    def import_snapshot(self, snapshot: pb.Snapshot, replica_id: int) -> None:
        key = (snapshot.shard_id, replica_id)
        with self._mu:
            self.remove_node_data(snapshot.shard_id, replica_id)
            buf = bytearray()
            pb.encode_snapshot(snapshot, buf)
            st = pb.State(term=snapshot.term, vote=0, commit=snapshot.index)
            boot = pb.Bootstrap(
                addresses=dict(snapshot.membership.addresses), join=False)
            self.kv.write_batch([
                (_nk(_K_SNAPSHOT, *key), bytes(buf)),
                (_nk(_K_STATE, *key), pb.encode_state(st)),
                (_nk(_K_BOOTSTRAP, *key), pb.encode_bootstrap(boot)),
            ], sync=True)


class KVLogDBFactory:
    """config.LogDBFactory equivalent for NodeHostConfig."""

    def __init__(self, root_dir: str, fs=None) -> None:
        self.root_dir = root_dir
        self.fs = fs

    def create(self) -> KVLogDB:
        return KVLogDB(self.root_dir, fs=self.fs)
