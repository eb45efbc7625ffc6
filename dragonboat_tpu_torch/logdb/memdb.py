"""In-memory ILogDB engine.

Functional parity with the reference's logdb semantics (state+entries+
snapshot per (shard, replica), batched SaveRaftState, iterate/compact) with
Python dict storage — the loopback/test engine, and the semantic reference
for the tan file engine.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Sequence

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.raftio import ILogDB, NodeInfo, RaftState


@dataclass
class _NodeStore:
    state: pb.State = field(default_factory=pb.State)
    entries: dict[int, pb.Entry] = field(default_factory=dict)
    snapshot: pb.Snapshot = field(default_factory=pb.Snapshot)
    bootstrap: pb.Bootstrap | None = None
    max_index: int = 0


class MemLogDB(ILogDB):
    def __init__(self) -> None:
        self._mu = threading.RLock()
        self._nodes: dict[tuple[int, int], _NodeStore] = {}
        self._closed = False

    def _node(self, shard_id: int, replica_id: int) -> _NodeStore:
        key = (shard_id, replica_id)
        st = self._nodes.get(key)
        if st is None:
            st = self._nodes[key] = _NodeStore()
        return st

    # -- ILogDB ---------------------------------------------------------

    def name(self) -> str:
        return "mem"

    def close(self) -> None:
        self._closed = True

    def list_node_info(self) -> list[NodeInfo]:
        with self._mu:
            return [NodeInfo(s, r) for (s, r) in self._nodes]

    def save_bootstrap_info(self, shard_id, replica_id, bootstrap) -> None:
        with self._mu:
            self._node(shard_id, replica_id).bootstrap = bootstrap

    def get_bootstrap_info(self, shard_id, replica_id):
        with self._mu:
            return self._node(shard_id, replica_id).bootstrap

    def save_raft_state(self, updates: Sequence[pb.Update], worker_id: int) -> None:
        """Batched durable write — parity raftio/logdb.go:78-83 (the one
        fsync per step-slot in the engine pipeline)."""
        with self._mu:
            for ud in updates:
                st = self._node(ud.shard_id, ud.replica_id)
                if not ud.state.is_empty():
                    st.state = ud.state
                if not ud.snapshot.is_empty():
                    st.snapshot = ud.snapshot
                if ud.entries_to_save:
                    # conflict overwrite: a batch starting at `first`
                    # invalidates every previously-stored entry at or above
                    # it, regardless of term (the reference overwrites by
                    # index unconditionally on the save path)
                    first = ud.entries_to_save[0].index
                    for i in list(st.entries):
                        if i >= first:
                            del st.entries[i]
                    for e in ud.entries_to_save:
                        st.entries[e.index] = e
                    st.max_index = max(st.entries) if st.entries else 0

    def iterate_entries(self, shard_id, replica_id, low, high, max_size):
        with self._mu:
            st = self._node(shard_id, replica_id)
            out, size = [], 0
            for i in range(low, high):
                e = st.entries.get(i)
                if e is None:
                    break
                size += pb.entry_size(e)
                if out and max_size and size > max_size:
                    break
                out.append(e)
            return out

    def read_raft_state(self, shard_id, replica_id, last_index):
        with self._mu:
            st = self._node(shard_id, replica_id)
            if st.state.is_empty() and not st.entries and st.snapshot.is_empty():
                return None
            first = st.snapshot.index + 1
            count = 0
            i = first
            while i in st.entries:
                count += 1
                i += 1
            return RaftState(state=st.state, first_index=first, entry_count=count)

    def remove_entries_to(self, shard_id, replica_id, index):
        with self._mu:
            st = self._node(shard_id, replica_id)
            for i in list(st.entries):
                if i <= index:
                    del st.entries[i]

    def compact_entries_to(self, shard_id, replica_id, index):
        self.remove_entries_to(shard_id, replica_id, index)

    def save_snapshots(self, updates):
        with self._mu:
            for ud in updates:
                if not ud.snapshot.is_empty():
                    self._node(ud.shard_id, ud.replica_id).snapshot = ud.snapshot

    def get_snapshot(self, shard_id, replica_id):
        with self._mu:
            ss = self._node(shard_id, replica_id).snapshot
            return None if ss.is_empty() else ss

    def remove_node_data(self, shard_id, replica_id):
        with self._mu:
            self._nodes.pop((shard_id, replica_id), None)

    def import_snapshot(self, snapshot: pb.Snapshot, replica_id: int) -> None:
        with self._mu:
            st = self._node(snapshot.shard_id, replica_id)
            st.snapshot = snapshot
            st.entries.clear()
            st.state = pb.State(
                term=snapshot.term, vote=0, commit=snapshot.index
            )
