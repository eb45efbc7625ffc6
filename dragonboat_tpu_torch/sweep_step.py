"""Step-time sensitivity sweep on the port.

The port's counterpart of the reference's ``scripts/sweep_step.py``.
Measures steady-state step_ms for the self-driving bench loop
(``bench_loop.run_steps``, one graph replay a step on the card) across
kernel-geometry variations to locate the hot dimension (K inbox slots, E
entry lanes, CAP ring, B proposal width, G lanes), with the reference's
base geometry and variations and its printed line.  Usage:

    python -m dragonboat_tpu_torch.sweep_step [quick] [--device DEVICE]

``--device`` names the device (default: the CUDA card; with no card it
raises).  Each geometry's graphs are dropped after its line, so the
sweep holds one geometry's buffers at a time.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from dragonboat_tpu_torch import bench_loop, graphs
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.devices import resolve_device

#: the reference's base geometry and its variations, in its order.  Its
#: K=4 and K=2 variations are left out: the router refuses an inbox below
#: its fixed slot layout, and the reference's run stops there.
BASE = dict(groups=1024, cap=256, k=10, e=16, b=16)
VARIATIONS = (
    dict(groups=256), dict(groups=4096), dict(e=4), dict(e=1, b=1),
    dict(cap=64), dict(cap=1024), dict(b=4),
)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(groups, cap=256, k=None, e=16, b=16, steps=20, replicas=3,
            device=None) -> dict:
    """One geometry: elect, warm (capture) the timed loop, time it; prints
    the reference's line and returns its numbers."""
    dev = resolve_device(device)
    k = k if k is not None else 5 * (replicas - 1)
    # geometry overrides on top of bench_params so the sweep inherits
    # every device-picked lowering flag (onehot_reads) instead of
    # hand-copying the pick
    kp = dataclasses.replace(
        bench_loop.bench_params(replicas, dev),
        log_cap=cap, inbox_cap=k, msg_entries=e, proposal_cap=b,
        readindex_cap=4, apply_batch=2 * b, compaction_overhead=2 * b,
    )
    state = bench_loop.make_cluster(kp, groups, replicas, device=dev)
    t0 = time.time()
    state, box = bench_loop.elect_all(kp, replicas, state)
    elect_s = time.time() - t0
    # warm-up: the timed variant's capture
    state, box = bench_loop.run_steps(kp, replicas, steps, True, True, state, box)
    _sync(dev)
    t0 = time.time()
    state, box = bench_loop.run_steps(kp, replicas, steps, True, True, state, box)
    _sync(dev)
    dt = time.time() - t0
    leaders = int((state.role.cpu() == KP.LEADER).sum())
    step_ms = dt / steps * 1e3
    wps = groups * b / (dt / steps)
    print(f"G={groups:<6} CAP={cap:<5} K={k:<3} E={e:<3} B={b:<3} "
          f"step_ms={step_ms:8.2f}  writes/s={wps:>12,.0f}  "
          f"(elect {elect_s:.1f}s, leaders {leaders})", flush=True)
    del state, box
    graphs.clear()
    return {"groups": groups, "cap": cap, "k": k, "e": e, "b": b,
            "step_ms": step_ms, "writes_per_s": wps,
            "elect_s": elect_s, "leaders": leaders}


def sweep(quick: bool = False, device=None, **base) -> list[dict]:
    """The reference's sweep: the base geometry, then (unless ``quick``)
    each variation of it.  ``base`` overrides the base geometry's
    entries (the tests run it at a small G)."""
    dev = resolve_device(device)
    print(f"backend: {'gpu' if dev.type == 'cuda' else 'cpu'}", flush=True)
    geom = {**BASE, **base}
    rows = [measure(**geom, device=dev)]
    if not quick:
        rows += [measure(**{**geom, **v}, device=dev) for v in VARIATIONS]
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = None
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    sweep(quick=bool(argv) and argv[0] == "quick", device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
