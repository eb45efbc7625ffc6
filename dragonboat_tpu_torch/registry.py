"""Node registry: (shard, replica) → address resolution.

Parity with ``internal/registry/registry.go:36`` (static Registry).  The
gossip-based dynamic registry (gossip.go) is a later phase; the seam is the
same INodeRegistry interface.
"""

from __future__ import annotations

import threading

from dragonboat_tpu_torch.raftio import INodeRegistry


class Registry(INodeRegistry):
    def __init__(self, stream_connections: int = 4) -> None:
        self.mu = threading.RLock()
        self.addr: dict[tuple[int, int], str] = {}
        self.stream_connections = stream_connections

    def add(self, shard_id: int, replica_id: int, url: str) -> None:
        with self.mu:
            self.addr[(shard_id, replica_id)] = url

    def remove(self, shard_id: int, replica_id: int) -> None:
        with self.mu:
            self.addr.pop((shard_id, replica_id), None)

    def remove_shard(self, shard_id: int) -> None:
        with self.mu:
            for k in [k for k in self.addr if k[0] == shard_id]:
                del self.addr[k]

    def resolve(self, shard_id: int, replica_id: int) -> tuple[str, str]:
        with self.mu:
            addr = self.addr.get((shard_id, replica_id))
        if addr is None:
            raise KeyError(f"no address for shard {shard_id} replica {replica_id}")
        # connection key spreads (shard, replica) pairs over StreamConnections
        # parallel sockets per peer pair (registry.go:79-85)
        key = f"{addr}-{(shard_id * 31 + replica_id) % self.stream_connections}"
        return addr, key
