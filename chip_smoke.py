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
   K1 also at the NodeHost path's shape [1024, 5] with the engine's mix
   of inputs (absent peers, 0-5 voters, quorums 1-5, ties), timed;
4. parity: the kernel path against the plain path on the card at
   1024 groups x 3, and the card against the CPU at 64 groups x 3, over
   elect_all + 40 run_steps_sm steps, every state and table leaf equal;
5. slice: 8192 groups x 3 replicas with a 1024-slot DeviceKV per replica,
   elect_all, a timed window of run_steps_sm steps, a settle, and the
   read-back of every replica's applied write; launch counts of every
   kernel are taken over this phase alone;
6. nodehost: the port's NodeHost as a user runs it — three hosts in this
   process over the chan transport, ``auto_run=True``, the reference's
   ExpertConfig and EngineConfig (kernel_log_cap 1024, kernel_num_peers 5,
   kernel_capacity 1024) with the three decimated device reductions off,
   1024 device-resident shards x 3 replicas (election_rtt 10,
   heartbeat_rtt 1): elect every shard, 4 asynchronous writes per shard,
   every write acknowledged, the last value read back from all 3 replicas
   of every shard (stale_read) and through the leader on a sample
   (sync_read); engine step ms over the whole cell and over the write
   window; K1's launches over this cell alone, and K1 against its plain
   arm on a sample of the inputs the engine's step gave it; then one more
   write per shard with host 1's engine step split into thread CPU time
   and waiting, and one under torch.profiler for the device's busy time
   per engine step; then the
   same at
   kernel_pipeline_depth 1 with 64 shards (overlapped steps > 0); then a
   short manual-drive script (auto_run=False, one shard) run on the card
   and on the CPU, every engine state leaf and every replica's applied
   index and contents equal after every round;
7. the ``kernels`` JSON line, then the final ``{"ok": true, ...}`` line.

Every number the run takes is printed on these lines.  Needs no network
and no JAX, and takes no arguments.  ``--compare-workers [ROUNDS]`` runs
only phases 1, 2 and the 1024 x 3 NodeHost cell, under the reference's
EngineConfig and under a single step worker, in turn, ROUNDS times each.
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
NH_SHARDS, NH_WRITES, NH_DEPTH1_SHARDS, NH_SAMPLE_READS = 1024, 4, 64, 32
NH_PARITY_ROUNDS = 24
# K1 on the NodeHost path: kernel_capacity rows x kernel_num_peers
ENGINE_G, ENGINE_P = 1024, 5
K1_TAP_EVERY, K1_TAP_KEEP = 25, 16


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


def _k1_bytes(G: int, P: int) -> int:
    return G * (4 * P + P + 4) + 4 * G


def _k1_ops(G: int, P: int) -> int:
    return G * (3 * P * P + 4 * P)


def _k1_engine_inputs(torch, dev, gen):
    """K1's inputs as the engine's step gives them, at [ENGINE_G,
    ENGINE_P]: mostly 3 voters of 5 with the absent peers anywhere in the
    row, also 5, 4, 2 and 1 voters and a row with none; quorum
    nv // 2 + 1 (the step's rule) on 3 rows of 4 and any of 1..5 on the
    rest; match values with ties on half the rows."""
    G, P = ENGINE_G, ENGINE_P
    pick = torch.multinomial(torch.tensor([0.0, 0.05, 0.1, 0.6, 0.1, 0.15]),
                             G, replacement=True, generator=gen)
    nv = pick.to(torch.int64)
    nv[0] = 0
    order = torch.rand((G, P), generator=gen).argsort(dim=1)
    voting = order < nv[:, None]
    match = torch.randint(0, 1 << 20, (G, P), generator=gen, dtype=torch.int32)
    ties = torch.randint(0, 3, (G, P), generator=gen, dtype=torch.int32)
    match = torch.where((torch.arange(G) % 2 == 1)[:, None], ties, match)
    quorum = (voting.sum(dim=1) // 2 + 1).to(torch.int32)
    anyq = torch.randint(1, P + 1, (G,), generator=gen, dtype=torch.int32)
    quorum = torch.where(torch.arange(G) % 4 == 3, anyq, quorum)
    return match.to(dev), voting.to(dev), quorum.to(dev)


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
    # the NodeHost path's shape and mix of inputs
    m3, v3, q3 = _k1_engine_inputs(torch, dev, gen)
    got3, ref3 = fk.quorum_match(m3, v3, q3), fk.quorum_match_plain(m3, v3, q3)
    torch.cuda.synchronize()
    mism3 = int((got3 != ref3).sum())
    mism += mism3
    # library yardstick: kthvalue on the masked rows; k = nv - q + 1 is
    # the same on every row here (3 voters, quorum 2)
    mv = torch.where(voting, match, 2**31 - 1)
    k = P - (P // 2 + 1) + 1
    lib_ref = torch.kthvalue(mv, k, dim=1).values
    check(bool((lib_ref == ref).all()), "K1 kthvalue yardstick disagrees")
    b_ms, b_by = bound(_k1_bytes(G, P), _k1_ops(G, P))
    e_ms, e_by = bound(_k1_bytes(ENGINE_G, ENGINE_P), _k1_ops(ENGINE_G, ENGINE_P))
    engine = {
        "shape": f"match [{ENGINE_G}, {ENGINE_P}] i32, voting [{ENGINE_G}, "
                 f"{ENGINE_P}] bool, quorum [{ENGINE_G}] i32",
        "mismatches": mism3, "max_abs_err": max_abs_err(torch, got3, ref3),
        "rows_by_voters": json.dumps(
            torch.bincount(v3.sum(dim=1).cpu(), minlength=ENGINE_P + 1).tolist()),
        "bound_ms": e_ms, "bound_by": e_by,
        # kthvalue takes one k for every row; these rows' k vary
        **_times(torch, lambda: fk.quorum_match(m3, v3, q3),
                 lambda: fk.quorum_match_plain(m3, v3, q3), None),
    }
    return {
        "name": "quorum_match", "route": "cuda",
        "source": "dragonboat_tpu_torch/csrc/quorum_match.cu",
        "replaces": "dragonboat_tpu/parallel/fabric_pallas.py:177",
        "shape": f"match [{G}, {P}] i32, voting [{G}, {P}] bool, quorum [{G}] i32",
        "mismatches": mism,
        "max_abs_err": max(max_abs_err(torch, got, ref), max_abs_err(torch, got2, ref2),
                           engine["max_abs_err"]),
        "bound_ms": b_ms, "bound_by": b_by, "engine_shape": engine,
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
        if "engine_shape" in r:
            say("k1_engine_shape", **r["engine_shape"])
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


_KV_CLASS = []


def _kv_sm(shard_id, replica_id):
    """The KV state machine the nodehost phase serves: cmd "key=value",
    lookup by key, snapshot the whole dict.  The class is made at first
    use: this script imports the port only once it knows a card is
    present."""
    if not _KV_CLASS:
        import struct

        from dragonboat_tpu_torch.statemachine import IStateMachine, Result

        class KV(IStateMachine):
            def __init__(self):
                self.kv = {}

            def update(self, entry):
                k, v = entry.cmd.decode().split("=", 1)
                self.kv[k] = v
                return Result(value=len(self.kv))

            def lookup(self, query):
                return self.kv.get(query)

            def save_snapshot(self, w, files, done):
                data = "\n".join(f"{k}={v}" for k, v in sorted(self.kv.items()))
                w.write(struct.pack("<I", len(data)))
                w.write(data.encode())

            def recover_from_snapshot(self, r, files, done):
                (n,) = struct.unpack("<I", r.read(4))
                data = r.read(n).decode()
                self.kv = dict(x.split("=", 1) for x in data.split("\n") if x)

        _KV_CLASS.append(KV)
    return _KV_CLASS[0]()


def _nh_hosts(tag, shards, dev, depth=0, auto_run=True, one_worker=False,
              **expert):
    """Three NodeHosts over the chan transport with ``shards``
    device-resident shards x 3 replicas; the reference's EngineConfig
    unless ``one_worker`` asks for a single step worker."""
    from dragonboat_tpu_torch.config import (
        Config,
        EngineConfig,
        ExpertConfig,
        NodeHostConfig,
    )
    from dragonboat_tpu_torch.nodehost import NodeHost

    addrs = {r: f"{tag}-{r}" for r in (1, 2, 3)}
    hosts = {}
    for r, addr in addrs.items():
        if one_worker:
            expert["engine"] = EngineConfig(exec_shards=1, apply_shards=1)
        ex = ExpertConfig(fleet_stats_every=0, health_top_k=0,
                          invariant_probe=False, kernel_pipeline_depth=depth,
                          **expert)
        hosts[r] = NodeHost(NodeHostConfig(raft_address=addr,
                                           rtt_millisecond=10, expert=ex),
                            auto_run=auto_run, device=dev)
    for sid in range(1, shards + 1):
        for r, nh in hosts.items():
            nh.start_replica(addrs, False, _kv_sm, Config(
                shard_id=sid, replica_id=r, election_rtt=10, heartbeat_rtt=1,
                device_resident=True))
    return hosts


def _nh_leaders(hosts, shards) -> dict:
    """shard -> the leader all three hosts agree on (shards without one
    are left out)."""
    out = {}
    for sid in range(1, shards + 1):
        ids = {nh.get_leader_id(sid) for nh in hosts.values()}
        if len(ids) == 1:
            lid, ok = ids.pop()
            if ok and lid in hosts:
                out[sid] = lid
    return out


def _nh_serve(hosts, shards, deadline_s=300.0) -> dict:
    """Elect every shard, write NH_WRITES values per shard asynchronously,
    wait for every acknowledgement, read the last value back from every
    replica and through the leader on a sample."""
    from dragonboat_tpu_torch.request import RequestResultCode

    t0 = time.perf_counter()
    leaders = {}
    while len(leaders) < shards:
        check(time.perf_counter() - t0 < deadline_s,
              f"only {len(leaders)} of {shards} shards elected a leader")
        time.sleep(0.2)
        leaders = _nh_leaders(hosts, shards)
    elect_s = time.perf_counter() - t0
    timers = [nh.kernel_engine._step_timer.samples for nh in hosts.values()]
    check(all(len(t) < t.maxlen for t in timers), "step timer ring wrapped")
    marks = [len(t) for t in timers]

    def send_write(sid, w):
        nh = hosts[leaders[sid]]
        return nh.propose(nh.get_noop_session(sid), f"w={sid}.{w}".encode(),
                          timeout_s=120)

    w0 = time.perf_counter()
    pending = {(sid, w): send_write(sid, w) for sid in range(1, shards + 1)
               for w in range(NH_WRITES)}
    acked, retried = 0, 0
    while pending:
        check(time.perf_counter() - w0 < deadline_s,
              f"{len(pending)} writes never acknowledged")
        again = {}
        for key, rs in pending.items():
            r = rs.wait(120)
            if r.code == RequestResultCode.COMPLETED:
                acked += 1
                continue
            check(r.code == RequestResultCode.DROPPED,
                  f"write {key} ended {r.code.name}")
            # dropped by a leadership change: a client retries on the
            # shard's current leader
            retried += 1
            leaders.update(_nh_leaders(hosts, shards))
            again[key] = send_write(*key)
        pending = again
    write_s = time.perf_counter() - w0
    check(all(len(t) < t.maxlen for t in timers), "step timer ring wrapped")
    # engine step ms: over the whole run (election included), and over
    # the write window alone
    steps = [x / 1e3 for t in timers for x in t]
    w_steps = [x / 1e3 for t, m in zip(timers, marks) for x in list(t)[m:]]
    # the last write of every shard, on every replica (stale_read is local)
    want = {sid: f"{sid}.{NH_WRITES - 1}" for sid in range(1, shards + 1)}
    r0 = time.perf_counter()
    while True:
        stale = [(sid, r) for sid in want for r, nh in hosts.items()
                 if nh.stale_read(sid, "w") != want[sid]]
        if not stale:
            break
        check(time.perf_counter() - r0 < 60,
              f"{len(stale)} replicas never applied the last write: {stale[:4]}")
        time.sleep(0.1)
    leaders = _nh_leaders(hosts, shards)
    sample = sorted(leaders)[:: max(1, len(leaders) // NH_SAMPLE_READS)]
    for sid in sample:
        got = hosts[leaders[sid]].sync_read(sid, "w", timeout_s=60)
        check(got == want[sid], f"shard {sid}: sync_read {got!r} != {want[sid]!r}")
    return {"elect_s": elect_s, "writes": shards * NH_WRITES,
            "acked": acked, "retried": retried, "write_s": write_s,
            "writes_per_s": acked / write_s,
            "step_ms_p50": float(np.percentile(steps, 50)),
            "step_ms_p90": float(np.percentile(steps, 90)),
            "step_samples": len(steps),
            "write_step_ms_p50": float(np.percentile(w_steps, 50)),
            "write_step_ms_p90": float(np.percentile(w_steps, 90)),
            "write_step_samples": len(w_steps),
            "stale_read_replicas": len(want) * len(hosts),
            "sync_read_sample": len(sample)}


def _tap_k1(store: list):
    """Route the step's K1 call through a tap that clones the inputs of
    every K1_TAP_EVERY-th call (up to K1_TAP_KEEP) into ``store`` before
    it launches; returns the function that takes the tap out."""
    from dragonboat_tpu_torch.core import kernel as K

    orig, seen = K.quorum_match, [0]

    def tap(match, voting, quorum):
        seen[0] += 1
        if seen[0] % K1_TAP_EVERY == 1 and len(store) < K1_TAP_KEEP:
            store.append((match.clone(), voting.clone(), quorum.clone()))
        return orig(match, voting, quorum)

    K.quorum_match = tap
    return lambda: setattr(K, "quorum_match", orig)


def _k1_tapped(torch, taps) -> dict:
    """K1 against its plain arm on the inputs the engine path gave it."""
    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    check(len(taps) > 0, "no K1 call was tapped on the NodeHost path")
    shapes = sorted({tuple(m.shape) for m, _, _ in taps})
    mism = err = 0
    for m, v, q in taps:
        got, ref = fk.quorum_match(m, v, q), fk.quorum_match_plain(m, v, q)
        mism += int((got != ref).sum())
        err = max(err, max_abs_err(torch, got, ref))
    return {"k1_tapped_calls": len(taps),
            "k1_tapped_shapes": json.dumps([list(x) for x in shapes]),
            "k1_tapped_mismatches": mism, "k1_tapped_max_abs_err": err}


def _device_busy(prof) -> dict:
    """Device time of a torch.profiler run: total, and the ops that took
    the most of it."""
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / 1e6, ev.count, ev.key))
    rows.sort(reverse=True)
    return {"device_busy_s": sum(r[0] for r in rows),
            "device_top": [[k[:48], t, n] for t, n, k in rows[:6]]}


class _TimedLock:
    """A lock's stand-in that adds each thread's wait to acquire it."""

    def __init__(self, lock) -> None:
        self.lock, self.waits = lock, {}

    def __enter__(self):
        import threading

        t = time.perf_counter()
        self.lock.acquire()
        tid = threading.get_ident()
        self.waits[tid] = self.waits.get(tid, 0.0) + time.perf_counter() - t
        return self

    def __exit__(self, *exc) -> None:
        self.lock.release()


def _nh_write_round(hosts, leaders, key: str) -> tuple[int, int]:
    """One asynchronous write of ``key`` per shard on its leader, waited
    for together: (writes, acknowledged)."""
    from dragonboat_tpu_torch.request import RequestResultCode

    pend = []
    for sid, lid in leaders.items():
        nh = hosts[lid]
        pend.append(nh.propose(nh.get_noop_session(sid),
                               f"{key}={sid}".encode(), timeout_s=120))
    return len(pend), sum(rs.wait(120).code == RequestResultCode.COMPLETED
                          for rs in pend)


def _nh_profile(torch, hosts, shards) -> dict:
    """Where the engine step's time goes, over more rounds of one
    asynchronous write per shard (after the timed window, so the probes'
    cost stays out of the timed numbers).

    Rounds 1-3 time each host-1 step_all call that had work: its wall
    time, its wait for the engines' shared step lock
    (KernelEngine._step_mu: the other engines' turns) and its thread's
    CPU time; the rest is waiting for the GIL or the device.  Round 4
    runs under torch.profiler (which slows the host several-fold) for
    the device's busy time per engine step, all three engines."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from dragonboat_tpu_torch.engine.kernel_engine import KernelEngine

    leaders = _nh_leaders(hosts, shards)
    eng = hosts[1].kernel_engine
    orig, walls, cpus, waits = eng.step_all, [], [], []
    step_mu = KernelEngine._step_mu
    timed_mu = _TimedLock(step_mu)

    def timed():
        tid = threading.get_ident()
        w, c = time.perf_counter(), time.thread_time()
        l0 = timed_mu.waits.get(tid, 0.0)
        ran = orig()
        if ran:
            walls.append(time.perf_counter() - w)
            cpus.append(time.thread_time() - c)
            waits.append(timed_mu.waits.get(tid, 0.0) - l0)
        return ran

    KernelEngine._step_mu = timed_mu
    eng.step_all = timed
    t0 = time.perf_counter()
    try:
        rounds = [_nh_write_round(hosts, leaders, f"p{i}") for i in range(3)]
        writes, acked = (sum(x) for x in zip(*rounds))
    finally:
        del eng.step_all
        KernelEngine._step_mu = step_mu
    wall = sum(walls)
    out = {"writes": writes, "acked": acked,
           "split_window_s": time.perf_counter() - t0,
           "split_steps": len(walls), "step_wall_s": wall,
           "step_lock_wait_s": sum(waits), "step_thread_cpu_s": sum(cpus),
           "step_other_wait_s": wall - sum(waits) - sum(cpus)}

    timers = [nh.kernel_engine._step_timer.samples for nh in hosts.values()]
    n0 = sum(len(t) for t in timers)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t1 = time.perf_counter()
    with prof:
        w2, a2 = _nh_write_round(hosts, leaders, "q")
        torch.cuda.synchronize()
    steps = sum(len(t) for t in timers) - n0
    out.update(writes=writes + w2, acked=acked + a2,
               device_window_s=time.perf_counter() - t1, device_steps=steps,
               **_device_busy(prof))
    out["device_ms_per_step"] = out["device_busy_s"] * 1e3 / max(1, steps)
    return out


def _nh_close(hosts) -> None:
    for nh in hosts.values():
        nh.close()


def _nh_parity_run(dev, tag) -> list:
    """One manual-drive script (auto_run=False, one shard, the reference
    engine tests' geometry) on ``dev``: per round, every host's engine
    state and every replica's (applied index, contents)."""
    import itertools

    from dragonboat_tpu_torch import convert
    from dragonboat_tpu_torch import request as req

    # restart the process-wide request counters: the ReadIndex ctx each
    # run stages lands in the device state
    req.PendingProposal._seq = itertools.count(1)
    req.PendingReadIndex._ctx = itertools.count(1)
    hosts = _nh_hosts(tag, 1, dev, auto_run=False, kernel_log_cap=256,
                      kernel_capacity=8, kernel_apply_batch=16,
                      kernel_compaction_overhead=16)
    rng = np.random.default_rng(SEED)
    trace = []
    try:
        for _ in range(NH_PARITY_ROUNDS):
            kind, val, rid = (int(rng.integers(0, 3)), int(rng.integers(0, 100)),
                              int(rng.integers(1, 4)))
            lead = _nh_leaders(hosts, 1).get(1, 0)
            if kind == 1 and lead:
                nh = hosts[lead]
                nh.propose(nh.get_noop_session(1), f"k{val % 7}={val}".encode(),
                           timeout_s=2)
            elif kind == 2:
                hosts[rid].read_index(1, timeout_s=2)
            for nh in hosts.values():
                nh.tick_all()
                nh.tick_all()
            for nh in hosts.values():
                nh.run_once()
            trace.append([(convert.to_numpy(nh.kernel_engine.state),
                           nh.nodes[1].sm.get_last_applied(),
                           dict(nh.nodes[1].sm.sm.kv)) for nh in hosts.values()])
    finally:
        _nh_close(hosts)
    return trace


def _nh_cell(torch, dev, tag, one_worker=False, taps=None) -> dict:
    """The NodeHost cell at NH_SHARDS x 3: admit, elect, write, read
    back; launch counts and peak memory over it alone."""
    from dragonboat_tpu_torch import kernels

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    untap = _tap_k1(taps) if taps is not None else None
    try:
        hosts = _nh_hosts(tag, NH_SHARDS, dev, one_worker=one_worker)
        admit_s = time.perf_counter() - t0
        try:
            st = _nh_serve(hosts, NH_SHARDS)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
            peak = torch.cuda.max_memory_allocated()
            prof = _nh_profile(torch, hosts, NH_SHARDS) if taps is not None else None
        finally:
            _nh_close(hosts)
    finally:
        if untap is not None:
            untap()
    return {"engine": "one step worker" if one_worker else "EngineConfig()",
            "admit_s": admit_s, **st, "k1_launches": launches["quorum_match"],
            "launches": json.dumps(launches, separators=(",", ":")),
            "max_memory_allocated": peak, "profile": prof,
            "seconds": time.perf_counter() - t0}


def phase_nodehost(torch, dev, smi: str) -> int:
    from dragonboat_tpu_torch import convert

    tag = f"smk{time.monotonic_ns()}"
    taps: list = []
    st = _nh_cell(torch, dev, tag, taps=taps)
    prof = st.pop("profile")
    tapped = _k1_tapped(torch, taps)
    say("nodehost", shards=NH_SHARDS, replicas=3, hosts=3, **st, **tapped,
        card=json.dumps(smi))
    say("nodehost_profile", **{k: json.dumps(v) if isinstance(v, list) else v
                               for k, v in prof.items()})
    check(st["acked"] == NH_SHARDS * NH_WRITES, "not every write acknowledged")
    check(st["k1_launches"] > 0, "K1 was not launched on the NodeHost path")
    check(tapped["k1_tapped_mismatches"] == 0,
          "K1 disagrees with its plain arm on the NodeHost path's inputs")
    check(prof["acked"] == prof["writes"], "profiled writes not all acknowledged")
    k1 = st["k1_launches"]

    t1 = time.perf_counter()
    hosts = _nh_hosts(f"{tag}d1", NH_DEPTH1_SHARDS, dev, depth=1)
    try:
        d1 = _nh_serve(hosts, NH_DEPTH1_SHARDS)
        overlapped = sum(nh.events.metrics.snapshot().get(
            "engine.pipeline.overlapped", 0) for nh in hosts.values())
    finally:
        _nh_close(hosts)
    say("nodehost_depth1", shards=NH_DEPTH1_SHARDS, **d1,
        overlapped=overlapped, seconds=time.perf_counter() - t1)
    check(d1["acked"] == NH_DEPTH1_SHARDS * NH_WRITES,
          "depth 1: not every write acknowledged")
    check(overlapped > 0, "depth 1: no step overlapped")

    t2 = time.perf_counter()
    cpu = _nh_parity_run(torch.device("cpu"), f"{tag}pc")
    card = _nh_parity_run(dev, f"{tag}pg")
    for i, (a, b) in enumerate(zip(cpu, card)):
        for r, ((sa, ap_a, kv_a), (sb, ap_b, kv_b)) in enumerate(zip(a, b)):
            bad = convert.diff_leaves(sa, sb)
            check(not bad, f"card != CPU at round {i}, host {r + 1}: {bad}")
            check((ap_a, kv_a) == (ap_b, kv_b),
                  f"card != CPU SM at round {i}, host {r + 1}")
    applied = max(x[1] for x in card[-1])
    check(applied > 0, "parity script applied nothing")
    say("nodehost_parity", rounds=NH_PARITY_ROUNDS, card_vs_cpu="equal",
        applied=applied, seconds=time.perf_counter() - t2)
    return k1


def compare_workers(torch, dev, rounds: int) -> int:
    """``python3 chip_smoke.py --compare-workers [ROUNDS]``: the NodeHost
    cell under the reference's EngineConfig and under one step worker, in
    turn, ROUNDS times each (2 unless given), one line per run.  Not part
    of the default run."""
    tag = f"cmp{time.monotonic_ns()}"
    for i, one in enumerate((False, True) * rounds):
        st = _nh_cell(torch, dev, f"{tag}-{i}", one_worker=one)
        st.pop("profile")
        say("nodehost_compare", run=i, **st)
        check(st["acked"] == NH_SHARDS * NH_WRITES, "not every write acknowledged")
    return 0


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
    if sys.argv[1:2] == ["--compare-workers"]:
        return compare_workers(torch, dev, int((sys.argv[2:] or ["2"])[0]))
    rows = phase_kernels(torch, dev)
    phase_parity(torch, dev)
    launches = phase_slice(torch, dev)
    phase_nodehost(torch, dev, device["nvidia_smi"])
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
