#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dragonboat_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each printing one line (any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the three CUDA kernels (csrc/*.cu) with nvcc;
3. kernels: K1, K2 and K3 against their plain PyTorch arms on the card at
   the slice's shapes, bitwise, with CUDA-event times, the bytes bound and
   (where one PyTorch call computes the same function) that call's time;
   K3 also over the cases of ``K3_CASES`` (one ``[k3case]`` line each, with
   the rows that took its serial branch), beside the one-pass range apply
   and the bound of two full passes over the table (what a whole-row
   design moves); K1 and K2 beside the launch floor, K2 on one row;
4. parity: the kernel path against the plain path on the card at
   1024 groups x 3, and the card against the CPU at 64 groups x 3, over
   elect_all + 40 run_steps_sm steps, every state and table leaf equal;
5. slice: 8192 groups x 3 replicas with a 1024-slot DeviceKV per replica,
   elect_all, a timed window of run_steps_sm steps, a settle, and the
   read-back of every replica's applied write; launch counts of every
   kernel are taken over this phase alone;
6. the ``kernels`` JSON line, then the final ``{"ok": true, ...}`` line.

Every number the run takes is printed on these lines.  Needs no network
and no JAX, and takes no arguments.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
NONTENSOR_OPS_PER_S = 67e12    # H100 SXM peak outside the tensor cores
SEED = 20261017
SLICE_GROUPS, REPLICAS, TABLE_CAP = 8192, 3, 1024
PARITY_GROUPS, CPU_GROUPS, PARITY_STEPS = 1024, 64, 40
WINDOW_STEPS, SETTLE_STEPS = 200, 8


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(tag: str, **kw) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps: int = 20, per_replay: int = 20,
            use_graph: bool = True) -> tuple[float, str]:
    """Device time of one ``fn()`` call in ms and how it was taken.

    A CUDA graph holding ``per_replay`` calls is replayed ``reps`` times
    between CUDA events (median over replays, divided by the calls), so a
    microsecond kernel is not measured as the host's enqueue time.  A
    capture that fails raises.  Only a caller that asks for it
    (``use_graph=False``, for a call long enough that the enqueue time
    does not matter) gets eager timing, taken the same way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if use_graph:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(per_replay):
                fn()
        run, how = graph.replay, "graph"
    else:
        def run():
            for _ in range(per_replay):
                fn()
        how = "eager"
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_replay)
    return statistics.median(times), how


def _times(torch, kernel_fn, plain_fn, library_fn, plain_graph=True) -> dict:
    """ms / plain_ms / library_ms of one kernel row, with the method."""
    out, how = {}, {}
    for key, fn in (("ms", kernel_fn), ("plain_ms", plain_fn),
                    ("library_ms", library_fn)):
        if fn is None:
            out[key] = None
            continue
        graphed = key != "plain_ms" or plain_graph
        out[key], how[key] = cuda_ms(torch, fn, use_graph=graphed,
                                     per_replay=20 if graphed else 2)
    out["timing"] = how
    return out


def bound(nbytes: int, nops: int) -> tuple[float, str]:
    """Least time the card could take (ms) and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / NONTENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return {"nvidia_smi": line, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from dragonboat_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    say("build", seconds=time.perf_counter() - t0,
        library=kernels.library_path().name)


def _k1(torch, dev, gen) -> dict:
    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    G, P = SLICE_GROUPS * REPLICAS, REPLICAS
    match = torch.randint(0, 1 << 20, (G, P), generator=gen, dtype=torch.int32).to(dev)
    voting = torch.ones((G, P), dtype=torch.bool, device=dev)
    quorum = torch.full((G,), P // 2 + 1, dtype=torch.int32, device=dev)
    got, ref = fk.quorum_match(match, voting, quorum), fk.quorum_match_plain(match, voting, quorum)
    torch.cuda.synchronize()
    mism = int((got != ref).sum())
    # ties, a zero-voter row and every quorum 1..P at P = 8
    G2, P2 = 4096, 8
    m2 = torch.randint(0, 6, (G2, P2), generator=gen, dtype=torch.int32).to(dev)
    v2 = (torch.rand((G2, P2), generator=gen) < 0.7).to(dev)
    v2[0] = False
    q2 = torch.randint(1, P2 + 1, (G2,), generator=gen, dtype=torch.int32).to(dev)
    got2, ref2 = fk.quorum_match(m2, v2, q2), fk.quorum_match_plain(m2, v2, q2)
    torch.cuda.synchronize()
    mism += int((got2 != ref2).sum())
    # library yardstick: kthvalue on the masked rows; k = nv - q + 1 is
    # the same on every row here (3 voters, quorum 2)
    mv = torch.where(voting, match, 2**31 - 1)
    k = P - (P // 2 + 1) + 1
    lib_ref = torch.kthvalue(mv, k, dim=1).values
    check(bool((lib_ref == ref).all()), "K1 kthvalue yardstick disagrees")
    b_ms, b_by = bound(G * (4 * P + P + 4) + 4 * G, G * (3 * P * P + 4 * P))
    return {
        "name": "quorum_match", "route": "cuda",
        "source": "dragonboat_tpu_torch/csrc/quorum_match.cu",
        "replaces": "dragonboat_tpu/parallel/fabric_pallas.py:177",
        "shape": f"match [{G}, {P}] i32, voting [{G}, {P}] bool, quorum [{G}] i32",
        "mismatches": mism,
        "max_abs_err": max(max_abs_err(torch, got, ref), max_abs_err(torch, got2, ref2)),
        "bound_ms": b_ms, "bound_by": b_by,
        **_times(torch, lambda: fk.quorum_match(match, voting, quorum),
                 lambda: fk.quorum_match_plain(match, voting, quorum),
                 lambda: torch.kthvalue(mv, k, dim=1)),
    }


def _k2(torch, dev, gen) -> dict:
    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    # route(): vals = src_field.reshape(N*R, K), idx[(n, s), t] = lane
    G, K, M = SLICE_GROUPS * REPLICAS, 5 * (REPLICAS - 1), REPLICAS
    vals = torch.randint(-(1 << 20), 1 << 20, (G, K), generator=gen,
                         dtype=torch.int32).to(dev)
    idx = torch.randint(0, K + 1, (G, M), generator=gen, dtype=torch.int32).to(dev)
    got, ref = fk.gather_lanes(vals, idx), fk.gather_lanes_plain(vals, idx)
    sv = torch.tensor([[7, 8, 9, 10]], dtype=torch.int32, device=dev)
    si = torch.tensor([[4, 2, 4, 0]], dtype=torch.int32, device=dev)
    sent = fk.gather_lanes(sv, si)
    torch.cuda.synchronize()
    check(sent.tolist() == [[0, 9, 0, 7]], f"K2 sentinel case gave {sent.tolist()}")
    mism = int((got != ref).sum())
    # library yardstick: torch.gather on the same rows with in-range
    # indexes (a sentinel index would fault in torch.gather)
    idx_in = idx.clamp(max=K - 1).long()
    b_ms, b_by = bound(G * K * 4 + G * M * 4 + G * M * 4, G * M * 2)
    return {
        "name": "gather_lanes", "route": "cuda",
        "source": "dragonboat_tpu_torch/csrc/gather_lanes.cu",
        "replaces": "dragonboat_tpu/parallel/fabric_pallas.py:101",
        "shape": f"vals [{G}, {K}] i32, idx [{G}, {M}] i32",
        "mismatches": mism, "max_abs_err": max_abs_err(torch, got, ref),
        "bound_ms": b_ms, "bound_by": b_by,
        **_times(torch, lambda: fk.gather_lanes(vals, idx),
                 lambda: fk.gather_lanes_plain(vals, idx),
                 lambda: torch.gather(vals, 1, idx_in)),
    }


# K3's cases: (name, table_cap, probe_depth, apply batch, hash_keys, rows,
# command keys, table fill, fill share, share of rows with no valid lane).
# "direct" is the main path's window and the timed one; the others reach
# the kernel's serial branch and every edge of the semantics.
K3_CASES = (
    ("direct", TABLE_CAP, 8, 64, False, SLICE_GROUPS * REPLICAS, "contiguous", "own", 0.0, 0.0),
    ("hashed", TABLE_CAP, 8, 64, True, SLICE_GROUPS * REPLICAS, "random", "random", 0.9, 0.0),
    ("duplicates", TABLE_CAP, 8, 64, True, 4096, "duplicates", "random", 0.5, 0.0),
    ("overlap", TABLE_CAP, 8, 64, False, 4096, "alias", "alias", 0.5, 0.0),
    ("wrap_t64_ab40", 64, 8, 40, False, 4096, "wrap", "own", 0.5, 0.25),
    ("edges_d1", 64, 1, 64, False, 4096, "edges", "alias", 0.3, 0.1),
    ("d40_ab40", 256, 40, 40, True, 4096, "dense", "random", 0.8, 0.1),
    ("wide", None, 8, 64, False, 1024, "mixed", "own", 0.5, 0.0),
)
INT_MAX = 2**31 - 1


def _k3_inputs(torch, gen, T, AB, G, hash_keys, keys_mode, fill, share, dead):
    """A table and a window of commands for one case, on the host."""
    I32 = torch.int32
    slot = torch.arange(T, dtype=torch.int64)[None, :]
    if fill == "own":          # a direct-mapped slot holds its own key
        tk = slot.expand(G, T) + 1
    elif fill == "alias":      # or one of its aliases, key + n * T
        tk = slot + T * torch.randint(0, 3, (G, T), generator=gen) + 1
    else:
        tk = torch.randint(1, 1 << 16, (G, T), generator=gen)
    keys0 = torch.where(torch.rand((G, T), generator=gen) < share, tk, 0).to(I32)
    j = torch.arange(AB, dtype=torch.int64)[None, :]
    first = torch.randint(0, T, (G, 1), generator=gen)
    if keys_mode == "wrap":    # windows that run from T - 1 over to 0
        first = T - 1 - torch.randint(0, AB // 2, (G, 1), generator=gen)
    contiguous = (first + j) & (T - 1)
    alias = contiguous + T * torch.randint(0, 3, (G, AB), generator=gen)
    if keys_mode in ("contiguous", "wrap"):
        ck = contiguous
    elif keys_mode == "alias":
        ck = alias
    elif keys_mode == "mixed":     # even rows contiguous, odd rows aliased
        ck = torch.where(torch.arange(G)[:, None] % 2 == 0, contiguous, alias)
    elif keys_mode == "random":
        ck = torch.randint(-2, 1 << 16, (G, AB), generator=gen)
    elif keys_mode == "dense":
        ck = torch.randint(-2, 2 * T, (G, AB), generator=gen)
    elif keys_mode == "duplicates":  # three keys per row, each written often
        few = torch.randint(0, 1 << 16, (G, 3), generator=gen)
        ck = torch.gather(few, 1, torch.randint(0, 3, (G, AB), generator=gen))
    else:                          # "edges": INT_MAX (stored as INT_MIN), negatives
        pool = torch.tensor([INT_MAX, INT_MAX - T, -(2**31), -1, 0, T - 1, 1])
        ck = pool[torch.randint(0, len(pool), (G, AB), generator=gen)]
    cv = torch.randint(-5, 1 << 20, (G, AB), generator=gen)
    valid = torch.rand((G, AB), generator=gen) < 0.9
    valid[torch.rand((G,), generator=gen) < dead] = False
    state0 = {
        "keys": keys0,
        "vals": torch.randint(-1000, 1000, (G, T), generator=gen, dtype=I32),
        "count": (keys0 != 0).sum(dim=1, dtype=I32),
    }
    return state0, torch.stack([ck, cv], dim=-1).to(I32), valid


def _k3_case(torch, dev, gen, case) -> dict:
    """One K3 case: the kernel against the sequential plain arm, bitwise,
    with the rows that took the kernel's serial branch."""
    from dragonboat_tpu_torch.rsm.device_kv import DeviceKV
    from dragonboat_tpu_torch.rsm.device_kv_kernels import MAX_TABLE_CAP, apply_window

    name, T, D, AB, hashed, G, keys_mode, fill, share, dead = case
    T = T or MAX_TABLE_CAP
    kv = DeviceKV(table_cap=T, probe_depth=D, hash_keys=hashed)
    state0, cmds, valid = _k3_inputs(torch, gen, T, AB, G, hashed, keys_mode,
                                     fill, share, dead)
    state0 = {k: v.to(dev) for k, v in state0.items()}
    cmds, valid = cmds.to(dev).contiguous(), valid.to(dev)
    serial = torch.full((G,), 7, dtype=torch.uint8, device=dev)
    st_k, (rk, okk) = apply_window(kv, {k: v.clone() for k, v in state0.items()},
                                   cmds, valid, serial_rows=serial)
    st_p, (rp, okp) = kv.apply_kernel(state0, cmds, valid)
    torch.cuda.synchronize()
    mism = sum(int((st_k[f] != st_p[f]).sum()) for f in st_k)
    mism += int((rk != rp).sum()) + int((okk != okp).sum())
    err = max(max_abs_err(torch, st_k[f], st_p[f]) for f in st_k)
    err = max(err, max_abs_err(torch, rk, rp), max_abs_err(torch, okk, okp))
    check(bool((serial <= 1).all()), f"K3 case {name}: serial_rows not written on every row")
    # the window applied again and again to one copy of the table, in place
    work = {k: v.clone() for k, v in state0.items()}
    ms, _how = cuda_ms(torch, lambda: apply_window(kv, work, cmds, valid))
    out = {"case": name, "table_cap": T, "probe_depth": D, "apply_batch": AB,
           "hashed": hashed, "rows": G, "mismatches": mism, "max_abs_err": err,
           "rejects": int((valid & ~okp).sum()),
           "serial_rows": int(serial.sum()), "accepted": int(okp.sum()),
           "ms_in_place": ms}
    say("k3case", **out)
    return {**out, "kv": kv, "state0": state0, "cmds": cmds, "valid": valid}


def _k3_bytes(torch, kv, cmds, valid, accepted: int) -> tuple[int, int]:
    """Bytes and operations one apply window needs when its rows apply at
    once (the kernel's parallel branch, where no slot is written twice):
    the commands and valid flags in, results and ok out, count read and
    written, the keys of the distinct slots the active commands' probe
    windows cover (a stored value is never read), and the key and value
    of each accepted command's slot."""
    G, AB = valid.shape
    T, D = kv.table_cap, kv.probe_depth
    key = cmds[..., 0]
    active = valid & (key >= 0)
    home = kv.home_slot(key.reshape(-1)).reshape(G, AB)
    win = (home[..., None] + torch.arange(D, dtype=torch.int32, device=key.device)) & (T - 1)
    covered = torch.zeros((G, T + 1), dtype=torch.bool, device=key.device)
    covered.scatter_(1, torch.where(active[..., None], win, T).reshape(G, -1).long(), True)
    window_slots = int(covered[:, :T].sum())
    n_active = int(active.sum())
    nbytes = (G * AB * 8 + G * AB + G * AB * 4 + G * AB + 2 * G * 4
              + window_slots * 4 + accepted * 8)
    return nbytes, n_active * (3 * D + 12)


def _k3(torch, dev, gen) -> dict:
    from dragonboat_tpu_torch.rsm.device_kv_kernels import apply_window

    cases = [_k3_case(torch, dev, gen, c) for c in K3_CASES]
    by = {c["case"]: c for c in cases}
    mism = sum(c["mismatches"] for c in cases)
    err = max(c["max_abs_err"] for c in cases)
    check(by["hashed"]["rejects"] > 0, "K3 hashed case exercised no rejects")
    check(by["direct"]["serial_rows"] == 0, "K3 main-path window took the serial branch")
    for name in ("overlap", "duplicates"):
        check(by[name]["serial_rows"] > 0, f"K3 case {name} never took the serial branch")
    # time the main path's direct-mapped window
    direct = by["direct"]
    kv, state0, cmds, valid = direct["kv"], direct["state0"], direct["cmds"], direct["valid"]
    work = {k: v.clone() for k, v in state0.items()}
    G, T = state0["keys"].shape
    AB = cmds.shape[1]
    b_ms, b_by = bound(*_k3_bytes(torch, kv, cmds, valid, direct["accepted"]))
    # the bound of a whole-row design: two full passes over the [G, T] table
    full_ms, _ = bound(
        2 * (2 * G * T * 4) + 2 * G * 4 + G * AB * 8 + G * AB + G * AB * 4 + G * AB,
        G * AB * (3 * kv.probe_depth + 12))
    # second yardstick: the reference's default device-SM path applies a
    # direct-mapped window in one pass (apply_kernel_range); it must agree
    # with the kernel on this contiguous window
    first, rvals = cmds[:, 0, 0].contiguous(), cmds[:, :, 1].contiguous()
    st_r, (rr, okr) = kv.apply_kernel_range(state0, first, rvals, valid)
    st_k, (rk, okk) = apply_window(kv, {k: v.clone() for k, v in state0.items()},
                                   cmds, valid)
    torch.cuda.synchronize()
    mism += sum(int((st_r[f] != st_k[f]).sum()) for f in st_k)
    mism += int((rr != rk).sum()) + int((okr != okk).sum())
    range_ms, range_how = cuda_ms(
        torch, lambda: kv.apply_kernel_range(state0, first, rvals, valid))
    times = _times(torch, lambda: apply_window(kv, work, cmds, valid),
                   lambda: kv.apply_kernel(state0, cmds, valid), None,
                   plain_graph=False)
    times["timing"]["range_ms"] = range_how
    return {
        "name": "kv_apply", "route": "cuda",
        "source": "dragonboat_tpu_torch/csrc/kv_apply.cu",
        "replaces": "dragonboat_tpu/rsm/device_kv_pallas.py:141",
        "shape": f"table [{G}, {T}] i32 x2, cmds [{G}, {AB}, 2] i32, direct-mapped",
        "mismatches": mism, "max_abs_err": err,
        "rejects": {c["case"]: c["rejects"] for c in cases},
        "serial_rows": {c["case"]: c["serial_rows"] for c in cases},
        "bound_ms": b_ms, "bound_by": b_by, "full_table_bound_ms": full_ms,
        "range_ms": range_ms, "range_over_kernel": range_ms / times["ms"], **times,
    }


def _launch_floor_ms(torch, dev) -> float:
    """K2 on one row ([1, 8] -> [1, 4]): the time of a launch that does
    next to no work, read beside K1's and K2's times."""
    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    vals = torch.arange(8, dtype=torch.int32, device=dev)[None, :]
    idx = torch.tensor([[1, 8, 3, 0]], dtype=torch.int32, device=dev)
    return cuda_ms(torch, lambda: fk.gather_lanes(vals, idx))[0]


def phase_kernels(torch, dev) -> list[dict]:
    gen = torch.Generator().manual_seed(SEED)
    rows = [_k1(torch, dev, gen), _k2(torch, dev, gen), _k3(torch, dev, gen)]
    floor_ms = _launch_floor_ms(torch, dev)
    for r in rows[:2]:
        r["launch_floor_ms"] = floor_ms
    for r in rows:
        if "range_ms" in r:
            extra = {k: r[k] for k in ("full_table_bound_ms", "range_ms", "range_over_kernel")}
            extra.update({k: json.dumps(r[k], separators=(",", ":"))
                          for k in ("rejects", "serial_rows")})
        else:
            extra = {"launch_floor_ms": r["launch_floor_ms"]}
        say("kernel", name=r["name"], mismatches=r["mismatches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], **extra,
            timing=json.dumps(r["timing"], separators=(",", ":")))
    for r in rows:
        check(r["mismatches"] == 0, f"{r['name']}: {r['mismatches']} mismatches")
    return rows


def _drive(groups: int, dev, steps: int):
    from dragonboat_tpu_torch import bench_loop as bl

    kp = bl.sm_params(REPLICAS, dev)
    state, box = bl.elect_all(kp, REPLICAS, bl.make_cluster(kp, groups, REPLICAS, device=dev))
    kv, kv_state = bl.make_device_sm(groups, REPLICAS, TABLE_CAP, device=dev)
    state, box, kv_state, rej = bl.run_steps_sm(
        kp, REPLICAS, kv, steps, True, True, state, box, kv_state)
    return state, kv_state, int(rej)


def _diff(torch, a_state, a_kv, b_state, b_kv) -> list[str]:
    bad = [f for f, x, y in zip(a_state._fields, a_state, b_state)
           if (x is None) != (y is None)
           or (x is not None and not torch.equal(x.cpu(), y.cpu()))]
    bad += [f"kv.{k}" for k in a_kv if not torch.equal(a_kv[k].cpu(), b_kv[k].cpu())]
    return bad


def phase_parity(torch, dev) -> None:
    from dragonboat_tpu_torch import kernels

    t0 = time.perf_counter()
    sk, kvk, rk = _drive(PARITY_GROUPS, dev, PARITY_STEPS)
    with kernels.plain_arms():
        sp, kvp, rp = _drive(PARITY_GROUPS, dev, PARITY_STEPS)
    bad = _diff(torch, sk, kvk, sp, kvp)
    check(not bad and rk == rp == 0,
          f"kernel path != plain path at {PARITY_GROUPS}x3: {bad} rejects {rk}/{rp}")
    sg, kvg, rg = _drive(CPU_GROUPS, dev, PARITY_STEPS)
    sc, kvc, rc = _drive(CPU_GROUPS, torch.device("cpu"), PARITY_STEPS)
    bad = _diff(torch, sg, kvg, sc, kvc)
    check(not bad and rg == rc == 0,
          f"card != CPU at {CPU_GROUPS}x3: {bad} rejects {rg}/{rc}")
    applied = int(kvk["count"].sum())
    check(applied > 0, "parity run applied nothing")
    say("parity", kernel_vs_plain=f"{PARITY_GROUPS}x{REPLICAS} equal",
        card_vs_cpu=f"{CPU_GROUPS}x{REPLICAS} equal", steps=PARITY_STEPS,
        table_entries=applied, seconds=time.perf_counter() - t0)


def phase_slice(torch, dev) -> dict:
    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch import kernels
    from dragonboat_tpu_torch.core import params as KP

    N, R, T = SLICE_GROUPS, REPLICAS, TABLE_CAP
    kp = bl.sm_params(R, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, box = bl.elect_all(kp, R, bl.make_cluster(kp, N, R, device=dev))
    kv, kv_state = bl.make_device_sm(N, R, T, device=dev)
    torch.cuda.synchronize()
    elect_s = time.perf_counter() - t0

    def leader_commit(st):
        c = st.committed.reshape(N, R).to(torch.int64)
        lead = st.role.reshape(N, R) == KP.LEADER
        return torch.where(lead, c, 0).max(dim=1).values

    c0 = leader_commit(state)
    rej = torch.zeros((), dtype=torch.int32, device=dev)
    step_ms = []
    w0 = time.perf_counter()
    for _ in range(WINDOW_STEPS):
        a = time.perf_counter()
        state, box, kv_state, r, _ = bl.full_step_sm(
            kp, R, kv, state, box, kv_state, True, True)
        rej = rej + r
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - a) * 1e3)
    window_s = time.perf_counter() - w0
    committed = int((leader_commit(state) - c0).sum())
    state, box, kv_state, rej2 = bl.run_steps_sm(
        kp, R, kv, SETTLE_STEPS, True, False, state, box, kv_state)
    rejected = int(rej) + int(rej2)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()

    # read-back on every replica of every group
    applied = state.applied.cpu().numpy()
    lv = state.lv.cpu().numpy()
    check(rejected == 0, f"{rejected} committed writes rejected")
    check(bool((applied > 0).all()), "a replica never applied")
    G = N * R
    rows = np.arange(G)
    check(bool((lv[rows, applied & (kp.log_cap - 1)] == applied).all()),
          "lv ring does not hold the applied entry's own index")
    cpu_kv = {k: v.cpu() for k, v in kv_state.items()}
    for g in range(G):
        got = kv.lookup(cpu_kv, g, int(applied[g]) & (T - 1))
        check(got == int(applied[g]), f"row {g}: table holds {got}, applied {applied[g]}")
    keys = kv_state["keys"].reshape(N, R, T)
    vals = kv_state["vals"].reshape(N, R, T)
    ap = state.applied.reshape(N, R)
    eq_groups = (ap == ap[:, :1]).all(dim=1)
    same = ((keys == keys[:, :1]).all(dim=2).all(dim=1)
            & (vals == vals[:, :1]).all(dim=2).all(dim=1))
    check(bool(same[eq_groups].all()), "replicas with equal applied hold different tables")
    check(int(eq_groups.sum()) > 0, "no group had equal applied cursors")
    stats = {
        "groups": N, "replicas": R, "rows": G, "table_cap": T,
        "window_steps": WINDOW_STEPS, "window_s": window_s,
        "committed_writes": committed,
        "committed_writes_per_s": committed / window_s,
        "step_ms_median": statistics.median(step_ms),
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "rejected_writes": rejected, "elect_s": elect_s,
        "peak_bytes": peak, "readback_rows": G,
        "groups_equal_applied": int(eq_groups.sum()),
        "launches": launches,
    }
    say("slice", **{k: (json.dumps(v, separators=(",", ":"))
                        if isinstance(v, dict) else v) for k, v in stats.items()})
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(launches["kv_apply"] == WINDOW_STEPS + SETTLE_STEPS,
          f"kv_apply launched {launches['kv_apply']} times in "
          f"{WINDOW_STEPS + SETTLE_STEPS} device-SM steps")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card", file=sys.stderr)
        return 2
    try:
        import dragonboat_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"dragonboat_tpu_torch not importable ({e}); run from the repo root",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    device = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch, dev)
    phase_parity(torch, dev)
    launches = phase_slice(torch, dev)
    for r in rows:
        r["launches"] = launches[r["name"]]
    say("total", seconds=time.perf_counter() - t0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(device["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
