"""Sharded LogDB — N single-writer tan partitions whose fsyncs overlap.

Parity with the reference's ``internal/logdb/sharded.go:34-80`` ShardedDB:
the log engine is split into ``num_shards`` independent single-writer
databases so that concurrent step workers flushing different partitions
never serialize on one file or one lock.  Routing is the single fixed
hash ``partition(shard_id) = shard_id % num_shards`` (the reference's
``internal/server/partition.go:59`` folds the worker count in as well,
but that pins a pure concurrency knob into the data layout — here only
``num_shards`` shapes the directory, so ``ExecShards`` stays freely
tunable on existing dirs).  The step workers hash shards the same way
(``shard_id % W``), so whenever the worker-pool size divides
``num_shards`` each partition is appended by exactly one worker — the
single-writer-per-worker contract of ``raftio/logdb.go:78-83`` — and W
workers fsync W different files concurrently; when it doesn't divide,
two workers may share a partition and its internal lock keeps that safe.

Deliberate differences from the reference:

- the reference panics when one ``SaveRaftState`` batch spans partitions
  (``sharded.go getParititionID``) because its callers are per-worker.
  Here the batched device engine legitimately saves a ``[G]``-lane batch
  covering many partitions in ONE call (engine/kernel_engine.py step
  loop), so a spanning batch is grouped per partition and the partition
  flushes run **in parallel** on a small pool — the fsyncs overlap in
  the device queue instead of paying P serial flush round-trips.
- the shard count is pinned by a ``TANSHARDS`` marker file instead of a
  manifest binary-format stamp; reopening with a different geometry is
  refused (the partition hash would silently mis-route reads).
- a legacy unsharded layout (``log-*.tan`` directly in the root, the
  pre-round-4 format) is migrated in place on open by replaying the old
  engine and re-saving every node into its home partition.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

from dragonboat_tpu_torch import lifecycle
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.logdb.tan import TanLogDB
from dragonboat_tpu_torch.raftio import ILogDB, NodeInfo, RaftState

_MARKER = "TANSHARDS"


class ShardGeometryError(Exception):
    """The on-disk partition count does not match the configuration."""


class ShardedLogDB(ILogDB):
    """``num_shards`` TanLogDB partitions under one root directory."""

    def __init__(self, root_dir: str, num_shards: int = 16,
                 max_file_size: int = 64 << 20, fs=None,
                 engine: str = "tan",
                 recovery_mode: str = "strict") -> None:
        from dragonboat_tpu_torch.vfs import default_fs

        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if engine not in ("tan", "kv"):
            raise ValueError(f"unknown logdb engine {engine!r}")
        self.fs = fs if fs is not None else default_fs()
        self.root = root_dir
        self.num_shards = num_shards
        self.engine = engine
        self.recovery_mode = recovery_mode
        self.fs.makedirs(self.root)
        # refuse a legacy layout under a non-tan engine BEFORE the marker
        # is written: a persisted "kv" marker over tan data would make the
        # directory unopenable under either engine
        if self.engine != "tan" and self._legacy_files():
            raise ShardGeometryError(
                f"{self.root}: legacy flat tan layout cannot migrate to "
                f"engine {self.engine!r}; open it as tan")
        self._check_marker()
        self._migrate_legacy(max_file_size)

        def make_part(path: str):
            if engine == "kv":
                from dragonboat_tpu_torch.logdb.kvdb import KVLogDB

                return KVLogDB(path, fs=self.fs)
            return TanLogDB(path, max_file_size=max_file_size, fs=self.fs,
                            recovery_mode=recovery_mode)

        self._parts = [
            make_part(os.path.join(self.root, f"part-{i:02d}"))
            for i in range(num_shards)
        ]
        # corruption sites quarantined by the tan partitions on open
        # (always empty under engine="kv" or recovery_mode="strict")
        self.quarantined: list[str] = [
            q for p in self._parts
            for q in getattr(p, "quarantined", ())]
        # flush pool for batches that span partitions (device engine):
        # sized to the partition count, NOT cpu_count — these tasks block
        # in fsync, they do not compute
        self._pool = ThreadPoolExecutor(
            max_workers=min(num_shards, 16),
            thread_name_prefix="tanshard-flush")
        self._closed = False
        self._close_mu = threading.Lock()

    # -- geometry --------------------------------------------------------

    def _marker_path(self) -> str:
        return os.path.join(self.root, _MARKER)

    def _legacy_files(self) -> list[str]:
        """Pre-sharding flat tan log files directly in the root."""
        return [fn for fn in self.fs.listdir(self.root)
                if fn.startswith("log-") and fn.endswith(".tan")]

    def _check_marker(self) -> None:
        mp = self._marker_path()
        if self.fs.exists(mp):
            with self.fs.open(mp, "rb") as f:
                fields = f.read().decode("ascii").split()
            want = fields[0]
            # pre-engine markers carried only the count: they are tan dirs
            want_engine = fields[1] if len(fields) > 1 else "tan"
            if want != str(self.num_shards):
                raise ShardGeometryError(
                    f"{self.root}: on-disk shard count {want} != "
                    f"configured {self.num_shards}")
            if want_engine != self.engine:
                raise ShardGeometryError(
                    f"{self.root}: on-disk engine {want_engine!r} != "
                    f"configured {self.engine!r}")
        else:
            with self.fs.open(mp, "wb") as f:
                # count alone on line 1: an older (count-only) parser
                # that int()s the first line still reaches its geometry
                # error path instead of a raw ValueError; whitespace
                # split here reads both layouts
                f.write(f"{self.num_shards}\n{self.engine}\n"
                        .encode("ascii"))
                self.fs.fsync(f)

    @staticmethod
    def stored_shard_count(root_dir: str, fs) -> int | None:
        """The shard count pinned in ``root_dir``, or None if the dir was
        never opened by a ShardedLogDB (tools open existing dirs with
        whatever geometry the owning NodeHost pinned)."""
        mp = os.path.join(root_dir, _MARKER)
        if not fs.exists(mp):
            return None
        with fs.open(mp, "rb") as f:
            return int(f.read().decode("ascii").split()[0])

    def _migrate_legacy(self, max_file_size: int) -> None:
        """Fold a pre-sharding flat layout into the partition dirs."""
        legacy = self._legacy_files()
        if not legacy:
            return
        old = TanLogDB(self.root, max_file_size=max_file_size, fs=self.fs)
        try:
            tmp_parts: dict[int, TanLogDB] = {}

            def part_for(shard_id: int) -> TanLogDB:
                pid = self._pid(shard_id)
                db = tmp_parts.get(pid)
                if db is None:
                    db = tmp_parts[pid] = TanLogDB(
                        os.path.join(self.root, f"part-{pid:02d}"),
                        max_file_size=max_file_size, fs=self.fs)
                return db

            for ni in old.list_node_info():
                dst = part_for(ni.shard_id)
                bs = old.get_bootstrap_info(ni.shard_id, ni.replica_id)
                if bs is not None:
                    dst.save_bootstrap_info(ni.shard_id, ni.replica_id, bs)
                ss = old.get_snapshot(ni.shard_id, ni.replica_id)
                rs = old.read_raft_state(ni.shard_id, ni.replica_id, 0)
                ents: list[pb.Entry] = []
                if rs is not None and rs.entry_count:
                    ents = old.iterate_entries(
                        ni.shard_id, ni.replica_id, rs.first_index,
                        rs.first_index + rs.entry_count, 0)
                dst.save_raft_state([pb.Update(
                    shard_id=ni.shard_id, replica_id=ni.replica_id,
                    state=(rs.state if rs is not None else pb.State()),
                    entries_to_save=tuple(ents),
                    snapshot=(ss if ss is not None else pb.Snapshot()),
                )], worker_id=0)
            for db in tmp_parts.values():
                db.close()
        finally:
            old.close()
        for fn in legacy:
            self.fs.remove(os.path.join(self.root, fn))

    def _pid(self, shard_id: int) -> int:
        return shard_id % self.num_shards

    def _part(self, shard_id: int) -> ILogDB:
        return self._parts[self._pid(shard_id)]

    # -- ILogDB ----------------------------------------------------------

    def name(self) -> str:
        return f"sharded-{self.engine}-{self.num_shards}"

    def close(self) -> None:
        with self._close_mu:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=True)
        for p in self._parts:
            p.close()

    def list_node_info(self) -> list[NodeInfo]:
        out: list[NodeInfo] = []
        for p in self._parts:
            out.extend(p.list_node_info())
        return out

    def save_bootstrap_info(self, shard_id, replica_id, bootstrap) -> None:
        self._part(shard_id).save_bootstrap_info(
            shard_id, replica_id, bootstrap)

    def get_bootstrap_info(self, shard_id, replica_id):
        return self._part(shard_id).get_bootstrap_info(shard_id, replica_id)

    def save_raft_state(self, updates: Sequence[pb.Update],
                        worker_id: int) -> None:
        """One partition -> direct append+fsync under that partition's
        lock (the per-worker fast path); a spanning batch -> grouped
        appends flushed in parallel (one future per touched partition)."""
        groups: dict[int, list[pb.Update]] = {}
        for ud in updates:
            groups.setdefault(self._pid(ud.shard_id), []).append(ud)
        if not groups:
            return
        if len(groups) == 1:
            pid, uds = next(iter(groups.items()))
            self._parts[pid].save_raft_state(uds, worker_id)
        else:
            futs = [self._pool.submit(self._parts[pid].save_raft_state,
                                      uds, worker_id)
                    for pid, uds in groups.items()]
            for fu in futs:
                fu.result()
        # lifecycle: entries in this batch are durable NOW — stamp the
        # sampled ones after every touched partition has fsynced
        if lifecycle.TRACER.enabled:
            for ud in updates:
                for e in ud.entries_to_save:
                    if e.key:
                        lifecycle.TRACER.stamp(e.key, lifecycle.STAGE_FSYNC)

    def iterate_entries(self, shard_id, replica_id, low, high, max_size):
        return self._part(shard_id).iterate_entries(
            shard_id, replica_id, low, high, max_size)

    def read_raft_state(self, shard_id, replica_id, last_index):
        return self._part(shard_id).read_raft_state(
            shard_id, replica_id, last_index)

    def remove_entries_to(self, shard_id, replica_id, index):
        self._part(shard_id).remove_entries_to(shard_id, replica_id, index)

    def compact_entries_to(self, shard_id, replica_id, index):
        self._part(shard_id).compact_entries_to(shard_id, replica_id, index)

    def save_snapshots(self, updates):
        groups: dict[int, list[pb.Update]] = {}
        for ud in updates:
            groups.setdefault(self._pid(ud.shard_id), []).append(ud)
        for pid, uds in groups.items():
            self._parts[pid].save_snapshots(uds)

    def get_snapshot(self, shard_id, replica_id):
        return self._part(shard_id).get_snapshot(shard_id, replica_id)

    def remove_node_data(self, shard_id, replica_id):
        self._part(shard_id).remove_node_data(shard_id, replica_id)

    def import_snapshot(self, snapshot: pb.Snapshot,
                        replica_id: int) -> None:
        self._part(snapshot.shard_id).import_snapshot(snapshot, replica_id)


class ShardedLogDBFactory:
    """config.LogDBFactory equivalent producing the sharded engine."""

    def __init__(self, root_dir: str, num_shards: int = 16,
                 max_file_size: int = 64 << 20, fs=None,
                 engine: str = "tan",
                 recovery_mode: str = "strict") -> None:
        self.root_dir = root_dir
        self.num_shards = num_shards
        self.max_file_size = max_file_size
        self.fs = fs
        self.engine = engine
        self.recovery_mode = recovery_mode

    def create(self) -> ShardedLogDB:
        return ShardedLogDB(self.root_dir, self.num_shards,
                            self.max_file_size, fs=self.fs,
                            engine=self.engine,
                            recovery_mode=self.recovery_mode)
