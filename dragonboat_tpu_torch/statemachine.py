"""User state-machine plugin interfaces.

Parity with the reference's ``statemachine/`` package: IStateMachine
(rsm.go:142), IConcurrentStateMachine (concurrent.go:45) and
IOnDiskStateMachine (disk.go:56).  Applications implement one of these and
register a factory with NodeHost.start_replica; linearizable writes arrive
via update(), linearizable reads via lookup() after a ReadIndex round.

The TPU build adds a fourth, device-native kind: IDeviceStateMachine — an
RSM whose update step is itself a JAX kernel over committed entry lanes
(the north star's fused on-device rsm-apply); the engine batches committed
entries into fixed lanes and applies them without leaving the device.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import BinaryIO, Callable, Iterable, Protocol, Sequence

from dragonboat_tpu_torch import raftpb as pb


@dataclass(frozen=True)
class Result:
    """Result of an update — parity statemachine/rsm.go Result."""

    value: int = 0
    data: bytes = b""


@dataclass(frozen=True)
class Entry:
    """Entry visible to user SMs — (index, cmd, result)."""

    index: int
    cmd: bytes
    result: Result = field(default_factory=Result)


@dataclass(frozen=True)
class SnapshotFile:
    file_id: int
    filepath: str
    metadata: bytes


class ISnapshotFileCollection(Protocol):
    def add_file(self, file_id: int, path: str, metadata: bytes) -> None: ...


class IStateMachine(abc.ABC):
    """Regular in-memory SM — statemachine/rsm.go:142.  The framework
    serializes update/lookup/save_snapshot with an RWMutex discipline."""

    @abc.abstractmethod
    def update(self, entry: Entry) -> Result: ...

    @abc.abstractmethod
    def lookup(self, query: object) -> object: ...

    @abc.abstractmethod
    def save_snapshot(self, w: BinaryIO, files: ISnapshotFileCollection,
                      done: Callable[[], bool]) -> None: ...

    @abc.abstractmethod
    def recover_from_snapshot(self, r: BinaryIO, files: Sequence[SnapshotFile],
                              done: Callable[[], bool]) -> None: ...

    def close(self) -> None:  # optional
        return None


class IConcurrentStateMachine(abc.ABC):
    """Concurrent SM — statemachine/concurrent.go:45: batched updates,
    concurrent lookups, and prepare/save snapshot split."""

    @abc.abstractmethod
    def update(self, entries: list[Entry]) -> list[Entry]: ...

    @abc.abstractmethod
    def lookup(self, query: object) -> object: ...

    @abc.abstractmethod
    def prepare_snapshot(self) -> object: ...

    @abc.abstractmethod
    def save_snapshot(self, ctx: object, w: BinaryIO,
                      files: ISnapshotFileCollection,
                      done: Callable[[], bool]) -> None: ...

    @abc.abstractmethod
    def recover_from_snapshot(self, r: BinaryIO, files: Sequence[SnapshotFile],
                              done: Callable[[], bool]) -> None: ...

    def close(self) -> None:
        return None


class IOnDiskStateMachine(abc.ABC):
    """On-disk SM — statemachine/disk.go:56: owns its own durable state,
    opens to its persisted index, and streams snapshots."""

    @abc.abstractmethod
    def open(self, stopc: Callable[[], bool]) -> int:
        """Open the SM and return the index of the last applied entry."""

    @abc.abstractmethod
    def update(self, entries: list[Entry]) -> list[Entry]: ...

    @abc.abstractmethod
    def lookup(self, query: object) -> object: ...

    @abc.abstractmethod
    def sync(self) -> None: ...

    @abc.abstractmethod
    def prepare_snapshot(self) -> object: ...

    @abc.abstractmethod
    def save_snapshot(self, ctx: object, w: BinaryIO,
                      done: Callable[[], bool]) -> None: ...

    @abc.abstractmethod
    def recover_from_snapshot(self, r: BinaryIO,
                              done: Callable[[], bool]) -> None: ...

    def close(self) -> None:
        return None


class IDeviceStateMachine(abc.ABC):
    """TPU-native SM: apply is a device kernel over committed entry lanes.

    No reference analog — this is the fused rsm-apply path from
    BASELINE.json's north star.  Implementations provide pure functions the
    engine jits and batches across shards."""

    @abc.abstractmethod
    def init_state(self, num_shards: int) -> object:
        """Device pytree holding per-shard SM state."""

    @abc.abstractmethod
    def apply_kernel(self, sm_state: object, cmd_lanes: object,
                     valid_mask: object) -> tuple[object, object]:
        """(new_state, (results, ok)) — vmapped over shards by the
        engine.  ``ok`` is a per-lane bool: False on a valid lane means
        the SM rejected the command (results values are free-form, so
        status must not be encoded in them)."""

    @abc.abstractmethod
    def lookup(self, sm_state: object, shard_slot: int, query: object) -> object: ...


CreateStateMachineFunc = Callable[[int, int], IStateMachine]
CreateConcurrentStateMachineFunc = Callable[[int, int], IConcurrentStateMachine]
CreateOnDiskStateMachineFunc = Callable[[int, int], IOnDiskStateMachine]


def sm_type_of(sm: object) -> pb.StateMachineType:
    if isinstance(sm, IOnDiskStateMachine):
        return pb.StateMachineType.ON_DISK
    if isinstance(sm, IConcurrentStateMachine):
        return pb.StateMachineType.CONCURRENT
    return pb.StateMachineType.REGULAR
