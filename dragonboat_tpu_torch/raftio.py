"""raftio — the storage/transport/observability plugin seams.

Parity with the reference's ``raftio/`` package: ILogDB (logdb.go:61-110),
ITransport + connection types (transport.go:54-80), INodeRegistry
(registry.go), and the event listener interfaces (listener.go:33,59).
These are THE seams the survey says must be reproduced (SURVEY §1).
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass
from typing import Callable, Protocol, Sequence

from dragonboat_tpu_torch import raftpb as pb


@dataclass(frozen=True)
class NodeInfo:
    shard_id: int
    replica_id: int


@dataclass(frozen=True)
class RaftState:
    state: pb.State
    first_index: int
    entry_count: int


class ILogDB(abc.ABC):
    """Persistent log storage — parity raftio/logdb.go:61-110.

    save_raft_state carries the single-writer-per-worker contract of the
    reference (:78-83): the engine calls it with a batch of Updates from one
    step slot; the implementation must make them durable before returning."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def list_node_info(self) -> list[NodeInfo]: ...

    @abc.abstractmethod
    def save_bootstrap_info(self, shard_id: int, replica_id: int,
                            bootstrap: pb.Bootstrap) -> None: ...

    @abc.abstractmethod
    def get_bootstrap_info(self, shard_id: int,
                           replica_id: int) -> pb.Bootstrap | None: ...

    @abc.abstractmethod
    def save_raft_state(self, updates: Sequence[pb.Update],
                        worker_id: int) -> None: ...

    @abc.abstractmethod
    def iterate_entries(self, shard_id: int, replica_id: int, low: int,
                        high: int, max_size: int) -> list[pb.Entry]: ...

    @abc.abstractmethod
    def read_raft_state(self, shard_id: int, replica_id: int,
                        last_index: int) -> RaftState | None: ...

    @abc.abstractmethod
    def remove_entries_to(self, shard_id: int, replica_id: int,
                          index: int) -> None: ...

    @abc.abstractmethod
    def compact_entries_to(self, shard_id: int, replica_id: int,
                           index: int) -> None: ...

    @abc.abstractmethod
    def save_snapshots(self, updates: Sequence[pb.Update]) -> None: ...

    @abc.abstractmethod
    def get_snapshot(self, shard_id: int,
                     replica_id: int) -> pb.Snapshot | None: ...

    @abc.abstractmethod
    def remove_node_data(self, shard_id: int, replica_id: int) -> None: ...

    @abc.abstractmethod
    def import_snapshot(self, snapshot: pb.Snapshot,
                        replica_id: int) -> None: ...


class IConnection(Protocol):
    """Message-batch connection — raftio/transport.go."""

    def close(self) -> None: ...
    def send_message_batch(self, batch: pb.MessageBatch) -> None: ...


class ISnapshotConnection(Protocol):
    def close(self) -> None: ...
    def send_chunk(self, chunk: dict) -> None: ...


class ITransport(abc.ABC):
    """Raft transport — parity raftio/transport.go:54-80."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def start(self) -> None: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def get_connection(self, target: str) -> IConnection: ...

    @abc.abstractmethod
    def get_snapshot_connection(self, target: str) -> ISnapshotConnection: ...


MessageHandler = Callable[[pb.MessageBatch], None]
ChunkHandler = Callable[[dict], bool]


class INodeRegistry(abc.ABC):
    """Address resolution — parity raftio/registry.go."""

    @abc.abstractmethod
    def add(self, shard_id: int, replica_id: int, url: str) -> None: ...

    @abc.abstractmethod
    def remove(self, shard_id: int, replica_id: int) -> None: ...

    @abc.abstractmethod
    def remove_shard(self, shard_id: int) -> None: ...

    @abc.abstractmethod
    def resolve(self, shard_id: int, replica_id: int) -> tuple[str, str]:
        """Returns (address, connection key)."""


# ---------------------------------------------------------------------------
# event listeners (raftio/listener.go)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeaderInfo:
    shard_id: int
    replica_id: int
    term: int
    leader_id: int


@dataclass(frozen=True)
class CampaignInfo:
    shard_id: int
    replica_id: int
    term: int


@dataclass(frozen=True)
class SnapshotInfo:
    shard_id: int
    replica_id: int
    from_: int
    index: int
    term: int


@dataclass(frozen=True)
class EntryInfo:
    shard_id: int
    replica_id: int
    index: int


@dataclass(frozen=True)
class ReplicationInfo:
    shard_id: int
    replica_id: int
    from_: int
    index: int
    term: int


@dataclass(frozen=True)
class ProposalInfo:
    shard_id: int
    replica_id: int
    entries: tuple[pb.Entry, ...]


@dataclass(frozen=True)
class ReadIndexInfo:
    shard_id: int
    replica_id: int


@dataclass(frozen=True)
class NodeHostInfoEvent:
    node_host_id: str
    raft_address: str
    region: str = ""


class IRaftEventListener(Protocol):
    """Leader-changed callbacks — raftio/listener.go:33."""

    def leader_updated(self, info: LeaderInfo) -> None: ...


class ISystemEventListener(Protocol):
    """16-event system listener — raftio/listener.go:59-76."""

    def node_host_shutting_down(self) -> None: ...
    def node_unloaded(self, info: NodeInfo) -> None: ...
    def node_deleted(self, info: NodeInfo) -> None: ...
    def node_ready(self, info: NodeInfo) -> None: ...
    def membership_changed(self, info: NodeInfo) -> None: ...
    def connection_established(self, addr: str, snapshot: bool) -> None: ...
    def connection_failed(self, addr: str, snapshot: bool) -> None: ...
    def send_snapshot_started(self, info: SnapshotInfo) -> None: ...
    def send_snapshot_completed(self, info: SnapshotInfo) -> None: ...
    def send_snapshot_aborted(self, info: SnapshotInfo) -> None: ...
    def snapshot_received(self, info: SnapshotInfo) -> None: ...
    def snapshot_recovered(self, info: SnapshotInfo) -> None: ...
    def snapshot_created(self, info: SnapshotInfo) -> None: ...
    def snapshot_compacted(self, info: SnapshotInfo) -> None: ...
    def log_compacted(self, info: EntryInfo) -> None: ...
    def log_db_compacted(self, info: EntryInfo) -> None: ...
