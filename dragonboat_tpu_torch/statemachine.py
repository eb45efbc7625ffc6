"""The device-native state-machine interface ``DeviceKV`` implements."""

from __future__ import annotations

import abc


class IDeviceStateMachine(abc.ABC):
    """A state machine whose apply step is a device kernel over committed
    entry lanes, batched across every shard row."""

    @abc.abstractmethod
    def init_state(self, num_shards: int, device=None) -> object:
        """Per-shard state as a dict of ``[G, ...]`` tensors."""

    @abc.abstractmethod
    def apply_kernel(self, sm_state: object, cmd_lanes: object,
                     valid_mask: object) -> tuple[object, object]:
        """(new_state, (results, ok)).  ``ok`` is a per-lane bool: False
        on a valid lane means the machine rejected the command (result
        values are free-form, so status is not encoded in them)."""

    @abc.abstractmethod
    def lookup(self, sm_state: object, shard_slot: int,
               query: object) -> object: ...
