"""Carry state between the reference's numpy form and the port's tensors.

The reference's structures (``KernelParams``, ``ShardState``, ``Inbox``,
``StepInput``, ``StepOutput`` and the ``DeviceKV`` state dict) reach this
module as plain dicts of numpy arrays (or, for ``KernelParams``, of field
values): the caller does the JAX-side ``np.asarray``.  This module imports
nothing of the reference package.  Every leaf of the kernel state is int32
or bool, so a conversion either keeps the dtype exactly or raises.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from dragonboat_tpu_torch.core.kstate import Inbox, ShardState, StepInput, StepOutput
from dragonboat_tpu_torch.core.params import KernelParams
from dragonboat_tpu_torch.devices import resolve_device

_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.bool_): torch.bool}

STRUCTS = {c.__name__: c for c in (ShardState, Inbox, StepInput, StepOutput)}


def kernel_params_from(fields: Mapping[str, object]) -> KernelParams:
    """KernelParams from a mapping of every field name to its value (for
    example ``dataclasses.asdict`` of the reference's)."""
    names = {f.name for f in dataclasses.fields(KernelParams)}
    if set(fields) != names:
        raise ValueError(f"KernelParams fields differ: {sorted(set(fields) ^ names)}")
    return KernelParams(**dict(fields))


def kernel_params_to_dict(kp: KernelParams) -> dict[str, object]:
    return dataclasses.asdict(kp)


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """An int32 or bool numpy array as a tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"kernel leaves are int32 or bool, got {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def from_numpy(struct: type[NamedTuple] | str,
               fields: Mapping[str, np.ndarray | None], device=None):
    """One of the port's state structs from a dict of every field name to
    a numpy array (or None for an absent optional field)."""
    cls = STRUCTS[struct] if isinstance(struct, str) else struct
    if set(fields) != set(cls._fields):
        raise ValueError(
            f"{cls.__name__} fields differ: {sorted(set(fields) ^ set(cls._fields))}")
    dev = resolve_device(device)
    return cls(**{k: None if v is None else tensor_from_numpy(v, dev)
                  for k, v in fields.items()})


def to_numpy(struct: NamedTuple) -> dict[str, np.ndarray | None]:
    """A port struct as a dict of field name to numpy array (or None)."""
    return {k: None if v is None else tensor_to_numpy(v)
            for k, v in zip(struct._fields, struct)}


def kv_state_from_numpy(state: Mapping[str, np.ndarray], device=None) -> dict:
    """The DeviceKV state dict (keys, vals, count) as tensors."""
    if set(state) != {"keys", "vals", "count"}:
        raise ValueError(f"DeviceKV state keys: {sorted(state)}")
    dev = resolve_device(device)
    return {k: tensor_from_numpy(v, dev) for k, v in state.items()}


def kv_state_to_numpy(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: tensor_to_numpy(v) for k, v in state.items()}


def diff_leaves(ref: Mapping[str, np.ndarray | None],
                got: Mapping[str, np.ndarray | None]) -> list[str]:
    """Names of the leaves where two numpy dicts differ in presence,
    dtype, shape or any value (empty when they are bitwise equal)."""
    bad = sorted(set(ref) ^ set(got))
    for k in sorted(set(ref) & set(got)):
        a, b = ref[k], got[k]
        if a is None or b is None:
            if (a is None) != (b is None):
                bad.append(k)
        elif a.dtype != b.dtype or not np.array_equal(a, b):
            bad.append(k)
    return bad
