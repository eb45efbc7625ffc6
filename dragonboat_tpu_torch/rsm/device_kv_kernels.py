"""K3: DeviceKV's apply window as one hand-written CUDA kernel.

Counterpart of the reference's ``rsm/device_kv_pallas.py``.  ``apply_window``
has ``DeviceKV.apply_kernel``'s semantics: a CPU tensor takes that
sequential plain arm; a CUDA tensor launches ``csrc/kv_apply.cu``, which
stages each shard's table row in shared memory, runs the AB commands
serially there and writes the row back — one read and one write of the
``[G, T]`` table per call instead of the plain arm's 2 * AB full passes.
"""

from __future__ import annotations

import torch

from dragonboat_tpu_torch import kernels
from dragonboat_tpu_torch.rsm.device_kv import DeviceKV

I32 = torch.int32
# 2 * T int32 of shared memory per block, within Hopper's 227 KB opt-in
MAX_TABLE_CAP = 16384


def apply_window(kv: DeviceKV, sm_state: dict, cmd_lanes: torch.Tensor,
                 valid_mask: torch.Tensor):
    """Apply ``[G, AB, 2]`` (key, value) commands where ``valid_mask
    [G, AB]`` holds; returns (state, (results [G, AB] i32, ok [G, AB]
    bool)), bit-identical to ``kv.apply_kernel``.

    On the card the state's ``keys``, ``vals`` and ``count`` tensors are
    updated IN PLACE and the same dict is returned: a caller that needs
    the state before the apply copies it first.  On the CPU the plain arm
    returns new tensors and leaves the input state as it was."""
    keys, vals, count = sm_state["keys"], sm_state["vals"], sm_state["count"]
    if not kernels.use_kernel(keys, vals, count, cmd_lanes, valid_mask):
        return kv.apply_kernel(sm_state, cmd_lanes, valid_mask)
    G, T = keys.shape
    AB = cmd_lanes.shape[1]
    if T != kv.table_cap or T > MAX_TABLE_CAP:
        raise ValueError(f"table width {T}: kernel takes table_cap "
                         f"{kv.table_cap} <= {MAX_TABLE_CAP}")
    kernels.require(keys, "keys", I32, (G, T))
    kernels.require(vals, "vals", I32, (G, T))
    kernels.require(count, "count", I32, (G,))
    kernels.require(cmd_lanes, "cmd_lanes", I32, (G, AB, 2))
    kernels.require(valid_mask, "valid_mask", torch.bool, (G, AB))
    results = torch.empty((G, AB), dtype=I32, device=keys.device)
    ok = torch.empty((G, AB), dtype=torch.bool, device=keys.device)
    if G == 0 or AB == 0:
        return sm_state, (results, ok)
    rc = kernels.library().dbt_kv_apply(
        keys.data_ptr(), vals.data_ptr(), count.data_ptr(),
        cmd_lanes.data_ptr(), valid_mask.data_ptr(), results.data_ptr(),
        ok.data_ptr(), G, T, kv.probe_depth, AB, int(kv.hash_keys),
        kernels.stream_ptr(keys.device))
    kernels.check_launch(rc, "kv_apply")
    return sm_state, (results, ok)
