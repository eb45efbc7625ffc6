"""Where the slice's step time goes on the card.

Usage (from the repository root, on a machine with a CUDA card)::

    python3 -m dragonboat_tpu_torch.profile_slice

Builds the ``chip_smoke.py`` slice (``sm_params(3)``, a direct-mapped
1024-slot DeviceKV per replica), elects, then

1. times full_step_sm under both ring-read lowerings (``onehot_reads``
   True, the device default, and False), in alternating windows from the
   same evolving state (the lowerings are bitwise identical, so the
   state does not depend on the order);
2. traces ``PROFILED_STEPS`` steps with ``torch.profiler`` and reports the
   device-busy share of the window (the sum of CUDA kernel durations
   over the window's wall time; one stream, so kernels do not overlap),
   kernel launches per step and the kernels that take the most device
   time.

Prints one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time

import torch

from dragonboat_tpu_torch import bench_loop as bl
from dragonboat_tpu_torch.devices import resolve_device

GROUPS = 8192          # the chip_smoke.py slice: 8192 groups x 3 replicas
PROFILED_STEPS = 6
WINDOW_STEPS = 10      # steps per timed window, four windows in all


def _timed_steps(kp, kv, carry, n: int) -> tuple[list[float], tuple]:
    state, box, kv_state = carry
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, box, kv_state, _r, _o = bl.full_step_sm(
            kp, 3, kv, state, box, kv_state, True, True)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out, (state, box, kv_state)


def main() -> dict:
    dev = resolve_device(None)
    kp = bl.sm_params(3, dev)
    state, box = bl.elect_all(kp, 3, bl.make_cluster(kp, GROUPS, 3, device=dev))
    kv, kv_state = bl.make_device_sm(GROUPS, 3, 1024, device=dev)
    carry = (state, box, kv_state)
    _, carry = _timed_steps(kp, kv, carry, 3)  # warm the allocator

    lowerings = {"onehot": kp, "gather": dataclasses.replace(kp, onehot_reads=False)}
    step_ms: dict[str, list[float]] = {k: [] for k in lowerings}
    for name in ("onehot", "gather", "gather", "onehot"):
        ms, carry = _timed_steps(lowerings[name], kv, carry, WINDOW_STEPS)
        step_ms[name] += ms

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, carry = _timed_steps(kp, kv, carry, PROFILED_STEPS)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv_: -sum(kv_[1]))[:10]
    result = {
        "device": torch.cuda.get_device_name(0),
        "groups": GROUPS, "replicas": 3,
        "step_ms_median": {k: statistics.median(v) for k, v in step_ms.items()},
        "profiled_steps": PROFILED_STEPS,
        "window_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us if wall_us else None,
        "kernel_launches_per_step": len(kernels) / PROFILED_STEPS,
        "top_kernels_ms_per_step": [
            {"name": n[:80], "ms": sum(v) / 1e3 / PROFILED_STEPS,
             "launches": len(v) / PROFILED_STEPS} for n, v in top],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
