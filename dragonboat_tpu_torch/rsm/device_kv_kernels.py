"""K3: DeviceKV's apply window as one hand-written CUDA kernel.

Counterpart of the reference's ``rsm/device_kv_pallas.py``.  ``apply_window``
has ``DeviceKV.apply_kernel``'s semantics: a CPU tensor takes that
sequential plain arm; a CUDA tensor launches ``csrc/kv_apply.cu``, where
one warp owns one shard row: it loads the row's commands once, gathers
only the keys of their probe windows, applies every command at once when
no earlier write lands in a later command's window (else runs them in
order on a shared-memory image of the windows), and writes back only the
slots it wrote.
"""

from __future__ import annotations

import torch

from dragonboat_tpu_torch import kernels
from dragonboat_tpu_torch.rsm.device_kv import DeviceKV

I32 = torch.int32
# the kernel keeps a 4 * T byte image of each row in shared memory
MAX_TABLE_CAP = 16384
# commands of a row are held in registers, at most 8 per lane
MAX_APPLY_BATCH = 256


def apply_window(kv: DeviceKV, sm_state: dict, cmd_lanes: torch.Tensor,
                 valid_mask: torch.Tensor, *,
                 serial_rows: torch.Tensor | None = None):
    """Apply ``[G, AB, 2]`` (key, value) commands where ``valid_mask
    [G, AB]`` holds; returns (state, (results [G, AB] i32, ok [G, AB]
    bool)), bit-identical to ``kv.apply_kernel``.

    On the card the state's ``keys``, ``vals`` and ``count`` tensors are
    updated IN PLACE and the same dict is returned: a caller that needs
    the state before the apply copies it first.  On the CPU the plain arm
    returns new tensors and leaves the input state as it was.

    ``serial_rows``, a ``[G]`` uint8 tensor on the card, receives the
    kernel's branch per row: 1 where the row's commands ran in order, 0
    where they were applied at once.  The plain arm has no branches and
    does not take it."""
    keys, vals, count = sm_state["keys"], sm_state["vals"], sm_state["count"]
    extra = () if serial_rows is None else (serial_rows,)
    if not kernels.use_kernel(keys, vals, count, cmd_lanes, valid_mask, *extra):
        if serial_rows is not None:
            raise ValueError("serial_rows is written by the CUDA kernel only")
        return kv.apply_kernel(sm_state, cmd_lanes, valid_mask)
    G, T = keys.shape
    AB = cmd_lanes.shape[1]
    if T != kv.table_cap or T > MAX_TABLE_CAP:
        raise ValueError(f"table width {T}: kernel takes table_cap "
                         f"{kv.table_cap} <= {MAX_TABLE_CAP}")
    if AB > MAX_APPLY_BATCH:
        raise ValueError(f"apply batch {AB}: kernel takes <= {MAX_APPLY_BATCH}")
    kernels.require(keys, "keys", I32, (G, T))
    kernels.require(vals, "vals", I32, (G, T))
    kernels.require(count, "count", I32, (G,))
    kernels.require(cmd_lanes, "cmd_lanes", I32, (G, AB, 2))
    kernels.require(valid_mask, "valid_mask", torch.bool, (G, AB))
    if serial_rows is not None:
        kernels.require(serial_rows, "serial_rows", torch.uint8, (G,))
    if cmd_lanes.data_ptr() % 8:
        raise ValueError("cmd_lanes: kernel reads (key, value) pairs 8-byte aligned")
    results = torch.empty((G, AB), dtype=I32, device=keys.device)
    ok = torch.empty((G, AB), dtype=torch.bool, device=keys.device)
    if G == 0 or AB == 0:
        return sm_state, (results, ok)
    with kernels.on(keys.device):
        rc = kernels.library().dbt_kv_apply(
            keys.data_ptr(), vals.data_ptr(), count.data_ptr(),
            cmd_lanes.data_ptr(), valid_mask.data_ptr(), results.data_ptr(),
            ok.data_ptr(),
            None if serial_rows is None else serial_rows.data_ptr(),
            G, T, kv.probe_depth, AB, int(kv.hash_keys),
            kernels.stream_ptr(keys.device))
    kernels.check_launch(rc, "kv_apply")
    return sm_state, (results, ok)
