#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dragonboat_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each printing one line (any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the three CUDA kernels (csrc/*.cu) with nvcc;
3. kernels: every entry of K1, K2 and K3 against its plain PyTorch arm
   on the card at the slice's shapes, bitwise, with CUDA-event times, the
   bytes bound and (where one PyTorch call computes the same function)
   that call's time; K3 also over the cases of ``K3_CASES`` (one
   ``[k3case]`` line each, with the rows that took its serial branch),
   beside the one-pass range apply and the bound of two full passes over
   the table (what a whole-row design moves); K1 and K2 beside the launch
   floor, K2 on one row.  K1's entries: ``quorum_match`` (the TPU
   kernel's signature, also at the NodeHost path's shape [1024, 5] with
   the engine's mix of inputs: absent peers, 0-5 voters, quorums 1-5,
   ties) and ``commit_quorum`` (the step's, voting and quorum from the
   kinds; all voters at [24576, 3], random kinds with 0-5 voters at
   [1024, 5], ties at P = 8), beside the step's path before it (the eager
   mask and count, then ``quorum_match``).  K2's: ``gather_lanes`` (the
   TPU kernel's signature) and ``gather_lanes_multi`` on the six fields
   and two lanes of a real route at 8192 x 3, beside the route's pick
   before it (twelve ``gather_lanes`` launches with their transposes and
   casts) and 12 x the one-field time;
4. parity: the kernel path against the plain path on the card at
   1024 groups x 3, and the card against the CPU at 64 groups x 3, over
   elect_all + 40 run_steps_sm steps, every state and table leaf equal;
5. slice: 8192 groups x 3 replicas with a 1024-slot DeviceKV per replica,
   elect_all, a timed window of run_steps_sm steps, PROFILE_STEPS more
   under torch.profiler (CUDA launches per step, beside the 10,807 the
   step made before K1 and K2 took their batched entries), a
   settle, and the read-back of every replica's applied write; launch
   counts of every kernel are taken over this phase alone: exactly 16 K1
   (the count a CPU step at this geometry makes) and 1 K2 launches per
   step, one K3 per device-SM step;
6. loops: the rest of ``bench_loop`` at ``bench.py``'s default shapes on
   a device, one line per loop, each with its K1/K2/K3 launches (counts
   reset before the loop's driven steps) and the host syncs of an untimed
   pass under CUDA's sync debug mode "warn" (per step, by call site; a
   sync in ``bench_loop.py`` fails the phase, and so does a control
   ``.item()`` that does not count as one sync): on one 8192 x 3 cluster
   the commit-latency loop (10 settle + 100 timed steps, width 32, no
   reads; p50/p99/p99.9 in steps and ms, histogram total = leader
   releases) ``[loops_latency]``, the ReadIndex mix (100 steps; ctx/s,
   writes/s, ops/s) ``[loops_mixed]`` and the membership wave (3 rounds of
   cc_step + 3 steps, the gate released by the host; every accepted CC
   committed, the compaction floor advanced) ``[loops_wave]``; the served
   9:1 mix on a fresh 8192 x 3 device-SM cluster (warm 3 + 1, 100 timed;
   0 rejects, K3 once a step) ``[loops_served]``; the election storm at
   10,000 x 3 with pre-vote (10 ticks, 30 steps at drop 0.25, clean chunks
   of 10 until exactly one leader per group, at most 400)
   ``[loops_storm]``; one shard for 200 steps ``[loops_single]``.  Each
   loop must launch exactly 16 K1 and 1 K2 per step it drove.  Each
   line also holds K1 and K2 (the step's ``commit_quorum`` and the
   route's ``gather_lanes_multi``), bitwise, against their plain arms on
   the inputs of every 37th call the loop made (its own shapes: 24,576
   rows, 30,000 for the storm, 3 for the single shard).  Then every loop card
   against CPU at 64 x 3 and kernels against plain arms at 1024 x 3,
   every leaf equal ``[loops_parity]`` (the pipelined loops are the
   serial ones at 2n, so they are not driven apart);
7. nodehost: the port's NodeHost as a user runs it — three hosts in this
   process over the chan transport, ``auto_run=True``, the reference's
   default ExpertConfig and EngineConfig (kernel_log_cap 1024,
   kernel_num_peers 5, kernel_capacity 1024; the fleet, health and
   invariant reductions every 10 steps, top 8, the probe on) with
   ``enable_metrics``, 1024 device-resident shards x 3 replicas
   (election_rtt 10, heartbeat_rtt 1): elect every shard, 4 asynchronous
   writes per shard, every write acknowledged, the last value read back
   from all 3 replicas of every shard (stale_read) and through the leader
   on a sample (sync_read); engine step ms over the whole cell and over
   the write window; each reduction tick's and the capacity tick's host
   ms over the cell; K1's launches over this cell alone, split into the
   step's (``commit_quorum``, exactly as many per engine step as a CPU
   step at the engine's geometry makes: 21) and the
   invariant probe's (``quorum_match``), and K1 against its plain arm on a
   sample of the inputs each call site gave it ``[nodehost]``.  Then, on
   every host: ``/metrics`` (the leader counts sum to 1024), ``/healthz``
   200, ``/debug/groups`` and ``/debug/group/<id>`` through the port's
   validators (the device row equal to ``health_row``), no invariant
   violation seen, every reduction and capacity tick taken
   ``[nodehost_endpoints]``; the four reductions on one engine's
   snapshot, card against CPU (plain arms) and the recount oracles, every
   output and digest leaf equal ``[nodehost_reductions]``; each tick run
   alone with the engines paused, host ms and device ms (torch.profiler)
   ``[nodehost_reduction_cost]``; one more write per shard with host 1's
   engine step split into thread CPU time and waiting, and one under
   torch.profiler for the device's busy time per engine step; then the
   same cell at kernel_pipeline_depth 1 with 64 shards (overlapped steps >
   0); then a short manual-drive script (auto_run=False, one shard) run on
   the card and on the CPU, every engine state leaf, every reduction
   snapshot and every replica's applied index and contents equal after
   every round;
8. the ``kernels`` JSON line, one row per kernel with the numbers of the
   entry the main path launches (launches: phase 5's), then the final
   ``{"ok": true, ...}`` line.

Every number the run takes is printed on these lines.  Needs no network
and no JAX, and takes no arguments.  ``--compare-workers [ROUNDS]`` runs
only phases 1, 2 and the 1024 x 3 NodeHost cell, under the reference's
EngineConfig and under a single step worker, in turn, ROUNDS times each.
``--compare-reductions [ROUNDS]`` runs only phases 1, 2 and the same cell
with the three reductions on (the default ExpertConfig) and off, in turn,
ROUNDS times each.
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
# phase 6, the bench loops at bench.py's defaults on a device: 8192
# groups, write width = proposal_cap (32), A2 and B 100 steps (max(40,
# 200 // 2)), chunk 3 (max(2, min(25, 25 * 1024 // 8192))), the wave's
# period max(4, chunk) over 3 rounds, the storm at 10,000 groups (10
# ticks, 30 steps at drop 0.25, seed 42, clean chunks of 10 up to 400),
# one shard for 200 steps in chunks of 25
LOOP_GROUPS, LOOP_WW, LOOP_CHUNK = 8192, 32, 3
LAT_SETTLE, LAT_STEPS, MIXED_STEPS = 10, 100, 100
CC_ROUNDS, CC_PERIOD = 3, 4
STORM_GROUPS, STORM_TICKS, STORM_STEPS, STORM_DROP, STORM_SEED = 10000, 10, 30, 0.25, 42
RECOVERY_CHUNK, RECOVERY_MAX = 10, 400
SINGLE_STEPS, SINGLE_CHUNK = 200, 25
# the loops' parity: every loop card against CPU at CPU_GROUPS x 3 and
# kernels against plain arms at PARITY_GROUPS x 3, LOOP_PARITY_STEPS each;
# K1 and K2 held against their plain arms on the inputs of every
# LOOP_TAP_EVERY-th call in each loop's own run (up to TAP_KEEP); a step
# calls K1 16 times and K2 12 times, so a prime stride lands on different
# call sites and spreads the taps over the first ~37 steps (past the
# storm's 10 ticks into its drops)
LOOP_PARITY_STEPS, LOOP_TAP_EVERY = 16, 37
# untimed steps of each loop under CUDA's sync debug mode
SYNC_PASS_STEPS = 2
NH_SHARDS, NH_WRITES, NH_DEPTH1_SHARDS, NH_SAMPLE_READS = 1024, 4, 64, 32
NH_PARITY_ROUNDS = 24
# K1 on the NodeHost path: kernel_capacity rows x kernel_num_peers
ENGINE_G, ENGINE_P = 1024, 5
K1_TAP_EVERY, TAP_KEEP = 25, 16
# K2 launches per route (one gather_lanes_multi); K1 launches per step
# are counted on a CPU step at the path's geometry (_k1_calls_per_step):
# 16 at the bench's inbox_cap 10, more at the engine's wider inbox
K2_PER_ROUTE = 1
# phase 5's steps under torch.profiler, and the CUDA launches per step
# at 8192 x 3 before K1 and K2 took their batched entries
# (profile_slice.py on an H100; PERF.md section 5)
PROFILE_STEPS, LAUNCHES_PER_STEP_BEFORE = 6, 10807
# the entry of each kernel that the main path launches
MAIN_PATH_ENTRIES = ("commit_quorum", "gather_lanes_multi", "kv_apply")
# the ExpertConfig switches that turn the three decimated reductions off
REDUCTIONS_OFF = dict(fleet_stats_every=0, health_top_k=0,
                      invariant_probe=False)
# the engine's decimated ticks, timed in the cell and run alone
TICKS = ("_collect_fleet_stats", "_collect_health", "_collect_invariants",
         "_collect_capacity")
COST_REPS = 5


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
        "name": "quorum_match", "kernel": "quorum_match", "route": "cuda",
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


def _commit_engine_kinds(torch, gen):
    """Peer kinds as the NodeHost path's step sees them, at [ENGINE_G,
    ENGINE_P]: 0-5 voters a row (mostly 3), some of them witnesses, the
    other slots absent or non-voting, in any order; row 0 has none."""
    from dragonboat_tpu_torch.core import params as KP

    G, P = ENGINE_G, ENGINE_P
    nv = torch.multinomial(torch.tensor([0.05, 0.05, 0.1, 0.55, 0.1, 0.15]),
                           G, replacement=True, generator=gen)
    nv[0] = 0
    voter = torch.rand((G, P), generator=gen).argsort(dim=1) < nv[:, None]
    witness = torch.rand((G, P), generator=gen) < 0.2
    other = torch.rand((G, P), generator=gen) < 0.5
    return torch.where(voter, torch.where(witness, KP.K_WITNESS, KP.K_VOTER),
                       torch.where(other, KP.K_NON_VOTING, KP.K_ABSENT)).to(torch.int32)


def _commit_path_before(match, kind):
    """The step's commit-rule call before commit_quorum: the voting mask
    and the quorum built by eager launches, then quorum_match."""
    import torch

    from dragonboat_tpu_torch.core import params as KP
    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    voting = (kind == KP.K_VOTER) | (kind == KP.K_WITNESS)
    return fk.quorum_match(match, voting, voting.sum(dim=1, dtype=torch.int32) // 2 + 1)


def _commit_bytes(G: int, P: int) -> int:
    return G * (4 * P + 4 * P + 4)


def _commit_ops(G: int, P: int) -> int:
    return G * (3 * P * P + 6 * P)


def _k1_commit(torch, dev, gen) -> dict:
    """K1's batched entry, commit_quorum(match, kind): all voters at the
    slice's [24576, 3] (the timed case), random kinds at [24576, 3] and at
    the NodeHost path's [1024, 5], ties and every kind at P = 8."""
    from dragonboat_tpu_torch.core import params as KP
    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    G, P = SLICE_GROUPS * REPLICAS, REPLICAS
    match = torch.randint(0, 1 << 20, (G, P), generator=gen, dtype=torch.int32).to(dev)
    kind = torch.full((G, P), KP.K_VOTER, dtype=torch.int32, device=dev)
    cases = [(match, kind)]
    mixed = torch.randint(KP.K_ABSENT, KP.K_WITNESS + 1, (G, P), generator=gen,
                          dtype=torch.int32).to(dev)
    cases.append((match, mixed))
    m8 = torch.randint(0, 6, (4096, 8), generator=gen, dtype=torch.int32).to(dev)
    k8 = torch.randint(KP.K_ABSENT, KP.K_WITNESS + 1, (4096, 8), generator=gen,
                       dtype=torch.int32).to(dev)
    k8[0] = KP.K_NON_VOTING
    cases.append((m8, k8))
    m5 = _k1_engine_inputs(torch, dev, gen)[0]
    k5 = _commit_engine_kinds(torch, gen).to(dev)
    cases.append((m5, k5))
    mism, err = [], 0
    for m, k in cases:
        got, ref = fk.commit_quorum(m, k), fk.commit_quorum_plain(m, k)
        torch.cuda.synchronize()
        mism.append(int((got != ref).sum()))
        err = max(err, max_abs_err(torch, got, ref))
    before = _commit_path_before
    check(bool((before(match, kind) == fk.commit_quorum_plain(match, kind)).all()),
          "the step's previous commit path disagrees with commit_quorum's plain arm")
    b_ms, b_by = bound(_commit_bytes(G, P), _commit_ops(G, P))
    e_ms, e_by = bound(_commit_bytes(ENGINE_G, ENGINE_P), _commit_ops(ENGINE_G, ENGINE_P))
    voters = ((k5 == KP.K_VOTER) | (k5 == KP.K_WITNESS)).sum(dim=1)
    engine = {
        "shape": f"match [{ENGINE_G}, {ENGINE_P}] i32, kind [{ENGINE_G}, {ENGINE_P}] i32",
        "mismatches": mism[3], "rows_by_voters": json.dumps(
            torch.bincount(voters.cpu(), minlength=ENGINE_P + 1).tolist()),
        "bound_ms": e_ms, "bound_by": e_by,
        "before_ms": cuda_ms(torch, lambda: before(m5, k5))[0],
        **_times(torch, lambda: fk.commit_quorum(m5, k5),
                 lambda: fk.commit_quorum_plain(m5, k5), None),
    }
    return {
        "name": "commit_quorum", "kernel": "quorum_match", "route": "cuda",
        "source": "dragonboat_tpu_torch/csrc/quorum_match.cu",
        "replaces": "dragonboat_tpu/parallel/fabric_pallas.py:177",
        "shape": f"match [{G}, {P}] i32, kind [{G}, {P}] i32",
        "mismatches": sum(mism), "mismatches_by_case": json.dumps(mism),
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        "engine_shape": engine,
        # the step's path before: the mask and count launches, then K1
        "before_ms": cuda_ms(torch, lambda: before(match, kind))[0],
        # kthvalue takes one k for every row and no mask: no single
        # PyTorch call computes the function
        **_times(torch, lambda: fk.commit_quorum(match, kind),
                 lambda: fk.commit_quorum_plain(match, kind), None),
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
        "name": "gather_lanes", "kernel": "gather_lanes", "route": "cuda",
        "source": "dragonboat_tpu_torch/csrc/gather_lanes.cu",
        "replaces": "dragonboat_tpu/parallel/fabric_pallas.py:101",
        "shape": f"vals [{G}, {K}] i32, idx [{G}, {M}] i32",
        "mismatches": mism, "max_abs_err": max_abs_err(torch, got, ref),
        "bound_ms": b_ms, "bound_by": b_by,
        **_times(torch, lambda: fk.gather_lanes(vals, idx),
                 lambda: fk.gather_lanes_plain(vals, idx),
                 lambda: torch.gather(vals, 1, idx_in)),
    }


def _pick_before(fields, lanes):
    """The route's response pick before gather_lanes_multi: per lane and
    field, the field as [(n, s), K] i32, the lane transposed into a
    contiguous [(n, s), t] index, one gather_lanes launch, the result
    transposed back and cast to the field's dtype."""
    import torch

    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    N, Rt, Rs = lanes[0].shape

    def pick(f, lane):
        vals = f.reshape(N * Rs, -1).to(torch.int32).contiguous()
        idx = lane.transpose(1, 2).reshape(N * Rs, Rt).contiguous()
        got = fk.gather_lanes(vals, idx).reshape(N, Rs, Rt).transpose(1, 2)
        return got.to(f.dtype)

    return tuple(tuple(pick(f, lane) for f in fields) for lane in lanes)


def _route_pick_inputs(torch, dev):
    """The six response fields and two lanes the route handed K2 on the
    second self-driving step with proposals after elect_all, 8192 x 3."""
    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch.core import router

    kp = bl.sm_params(REPLICAS, dev)
    state, box = bl.elect_all(kp, REPLICAS, bl.make_cluster(kp, SLICE_GROUPS, REPLICAS,
                                                            device=dev))
    rec, untap = _tap(router, "gather_lanes_multi", 1)
    try:
        for _ in range(2):
            state, box, _out = bl.full_step(kp, REPLICAS, state, box, True, True)
    finally:
        untap()
    check(rec["calls"] == 2, f"two routes called gather_lanes_multi {rec['calls']} times")
    return rec["inputs"][-1]


def _k2_multi(torch, dev) -> dict:
    """K2's batched entry, gather_lanes_multi(fields, lanes), on the
    inputs of a real route at 8192 x 3."""
    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    fields, lanes = _route_pick_inputs(torch, dev)
    got = _flat(fk.gather_lanes_multi(fields, lanes))
    ref = _flat(fk.gather_lanes_multi_plain(fields, lanes))
    old = _flat(_pick_before(fields, lanes))
    torch.cuda.synchronize()
    mism = sum(int((a != b).sum()) for a, b in zip(got, ref))
    mism += sum(int((a != b).sum()) for a, b in zip(got, old))
    mism += sum(a.dtype != b.dtype or a.shape != b.shape for a, b in zip(got, ref))
    err = max(max_abs_err(torch, a, b) for a, b in zip(got, ref))
    K = fields[0].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (*fields, *lanes, *got))
    N, Rt, Rs = lanes[0].shape
    b_ms, b_by = bound(nbytes, N * Rt * Rs * len(lanes) * (2 + 2 * len(fields)))
    return {
        "name": "gather_lanes_multi", "kernel": "gather_lanes", "route": "cuda",
        "source": "dragonboat_tpu_torch/csrc/gather_lanes.cu",
        "replaces": "dragonboat_tpu/parallel/fabric_pallas.py:101",
        "shape": (f"{len(fields)} fields [{fields[0].shape[0]}, {K}] "
                  f"({', '.join(str(f.dtype).replace('torch.', '') for f in fields)}), "
                  f"{len(lanes)} lanes [{N}, {Rt}, {Rs}] i32"),
        "mismatches": mism, "max_abs_err": err, "bytes": nbytes,
        "lanes_in_use": json.dumps([int((lane < K).sum()) for lane in lanes]),
        "lane_positions": N * Rt * Rs,
        "bound_ms": b_ms, "bound_by": b_by,
        # the route's pick before: twelve launches of the one-field entry
        # with their index transposes and casts
        "before_ms": cuda_ms(torch, lambda: _pick_before(fields, lanes))[0],
        **_times(torch, lambda: fk.gather_lanes_multi(fields, lanes),
                 lambda: fk.gather_lanes_multi_plain(fields, lanes), None),
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
        "name": "kv_apply", "kernel": "kv_apply", "route": "cuda",
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
    rows = [_k1(torch, dev, gen), _k1_commit(torch, dev, gen), _k2(torch, dev, gen),
            _k2_multi(torch, dev), _k3(torch, dev, gen)]
    floor_ms = _launch_floor_ms(torch, dev)
    by = {r["name"]: r for r in rows}
    # the route's twelve one-field launches, timed in this call
    by["gather_lanes_multi"]["single_x12_ms"] = 12 * by["gather_lanes"]["ms"]
    for r in rows:
        if r["kernel"] != "kv_apply":
            r["launch_floor_ms"] = floor_ms
    for r in rows:
        if "range_ms" in r:
            extra = {k: r[k] for k in ("full_table_bound_ms", "range_ms", "range_over_kernel")}
            extra.update({k: json.dumps(r[k], separators=(",", ":"))
                          for k in ("rejects", "serial_rows")})
        else:
            extra = {k: r[k] for k in ("launch_floor_ms", "before_ms", "single_x12_ms",
                                       "mismatches_by_case", "bytes", "lanes_in_use",
                                       "lane_positions", "shape") if k in r}
        if "shape" in extra:
            extra["shape"] = json.dumps(extra["shape"])
        if "engine_shape" in r:
            say("k1_engine_shape", entry=r["name"], **r["engine_shape"])
        say("kernel", name=r["name"], kernel=r["kernel"], mismatches=r["mismatches"],
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


def _leaves(tag: str, x) -> dict:
    """Every tensor leaf of a nest of NamedTuples, dicts, tuples and
    tensors, by path, copied to the host (None leaves are left out)."""
    import torch

    out = {}
    if isinstance(x, torch.Tensor):
        out[tag] = x.detach().cpu()
    elif hasattr(x, "_fields"):
        for k, v in zip(x._fields, x):
            out.update(_leaves(f"{tag}.{k}", v))
    elif isinstance(x, dict):
        for k, v in x.items():
            out.update(_leaves(f"{tag}.{k}", v))
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            out.update(_leaves(f"{tag}[{i}]", v))
    return out


def _leaf_diff(torch, a: dict, b: dict) -> list[str]:
    bad = sorted(set(a) ^ set(b))
    return bad + [k for k in a if k in b and (a[k].dtype != b[k].dtype
                                              or not torch.equal(a[k], b[k]))]


def phase_parity(torch, dev) -> None:
    from dragonboat_tpu_torch import kernels

    t0 = time.perf_counter()
    sk, kvk, rk = _drive(PARITY_GROUPS, dev, PARITY_STEPS)
    with kernels.plain_arms():
        sp, kvp, rp = _drive(PARITY_GROUPS, dev, PARITY_STEPS)
    bad = _leaf_diff(torch, _leaves("", (sk, kvk)), _leaves("", (sp, kvp)))
    check(not bad and rk == rp == 0,
          f"kernel path != plain path at {PARITY_GROUPS}x3: {bad} rejects {rk}/{rp}")
    sg, kvg, rg = _drive(CPU_GROUPS, dev, PARITY_STEPS)
    sc, kvc, rc = _drive(CPU_GROUPS, torch.device("cpu"), PARITY_STEPS)
    bad = _leaf_diff(torch, _leaves("", (sg, kvg)), _leaves("", (sc, kvc)))
    check(not bad and rg == rc == 0,
          f"card != CPU at {CPU_GROUPS}x3: {bad} rejects {rg}/{rc}")
    applied = int(kvk["count"].sum())
    check(applied > 0, "parity run applied nothing")
    say("parity", kernel_vs_plain=f"{PARITY_GROUPS}x{REPLICAS} equal",
        card_vs_cpu=f"{CPU_GROUPS}x{REPLICAS} equal", steps=PARITY_STEPS,
        table_entries=applied, seconds=time.perf_counter() - t0)


def phase_slice(torch, dev) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch import kernels
    from dragonboat_tpu_torch.core import params as KP

    N, R, T = SLICE_GROUPS, REPLICAS, TABLE_CAP
    kp = bl.sm_params(R, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls, uncount = _count_steps()
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
    # the same step under torch.profiler: CUDA launches per step
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        for _ in range(PROFILE_STEPS):
            state, box, kv_state, r, _ = bl.full_step_sm(
                kp, R, kv, state, box, kv_state, True, True)
            rej = rej + r
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_step = len(on_card) / PROFILE_STEPS
    state, box, kv_state, rej2 = bl.run_steps_sm(
        kp, R, kv, SETTLE_STEPS, True, False, state, box, kv_state)
    rejected = int(rej) + int(rej2)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    uncount()
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
        "launches": launches, "steps": calls["step"], "routes": calls["route"],
        "k1_per_step": _k1_calls_per_step(kp),
        "profiled_steps": PROFILE_STEPS, "kernel_launches_per_step": per_step,
        "kernel_launches_per_step_before": LAUNCHES_PER_STEP_BEFORE,
        "fewer_than_before": LAUNCHES_PER_STEP_BEFORE - per_step,
        "profiled_device_ms_per_step":
            sum(e.time_range.elapsed_us() for e in on_card) / 1e3 / PROFILE_STEPS,
    }
    say("slice", **{k: (json.dumps(v, separators=(",", ":"))
                        if isinstance(v, dict) else v) for k, v in stats.items()})
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    sm_steps = WINDOW_STEPS + PROFILE_STEPS + SETTLE_STEPS
    _check_path_launches("slice", launches, calls, kp, k3=sm_steps)
    return launches


# ---------------------------------------------------------------------------
# phase 6: the rest of bench_loop at bench.py's shapes
# ---------------------------------------------------------------------------


def _sync_pass(torch, fn, steps: int) -> dict:
    """Run ``fn()`` (``steps`` steps of one loop, result discarded) under
    CUDA's sync debug mode "warn" and count the host syncs it makes.  Each
    sync's site is the innermost frame of this checkout on the stack when
    the warning is raised, beside the innermost frame of all."""
    import collections
    import os
    import traceback
    import warnings

    root = os.path.dirname(os.path.abspath(__file__))
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        # the mode's own prototype notice is not a sync
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if os.path.basename(f.filename) != "warnings.py"]
        ours = [f for f in stack if f.filename.startswith(root + os.sep)]
        where = (f"{os.path.relpath(ours[-1].filename, root)}:{ours[-1].lineno}"
                 if ours else "?")
        sites[f"{where} ({os.path.basename(stack[-1].filename)}:{stack[-1].lineno})"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = sum(sites.values())
    check(not any(site.startswith("dragonboat_tpu_torch/bench_loop.py") for site in sites),
          f"the loop code syncs with the host: {dict(sites)}")
    return {"syncs_per_step": n / steps,
            "first_sync": json.dumps(next(iter(sites), None)),
            "sync_sites": json.dumps(dict(sites), separators=(",", ":"))}


def _count_calls(module, attr: str, counts: dict, thread: int | None = None):
    """Count the calls of ``module.attr`` (a function its callers look up
    there) in ``counts[attr]``, only those made in ``thread`` when one is
    given; returns the function that takes the counter out."""
    import threading

    orig = getattr(module, attr)
    counts[attr] = 0

    def counted(*args, **kw):
        if thread is None or threading.get_ident() == thread:
            counts[attr] += 1
        return orig(*args, **kw)

    setattr(module, attr, counted)
    return lambda: setattr(module, attr, orig)


def _count_steps():
    """Count the steps and routes the bench loops call (``bench_loop``'s
    ``step`` and ``route``); returns the live counts and the function that
    takes the counters out."""
    from dragonboat_tpu_torch import bench_loop as bl

    counts: dict = {}
    undo = [_count_calls(bl, attr, counts) for attr in ("step", "route")]
    return counts, lambda: [u() for u in undo]


def _k1_calls_per_step(kp) -> int:
    """K1 calls one step makes at ``kp``'s geometry, counted on a
    one-shard step on the CPU in this thread (engines may be stepping in
    others): the commit rule runs once per inbox slot whose family takes
    responses or appends, and once after the append, whatever the data
    (the eager step takes every branch under masks)."""
    import threading

    import numpy as np

    from dragonboat_tpu_torch.core import kernel as K
    from dragonboat_tpu_torch.core.kstate import empty_inbox, empty_input, init_state

    P = kp.num_peers
    ids = np.arange(1, P + 1, dtype=np.int32)
    st = init_state(kp, P, ids, ids, device="cpu")
    counts: dict = {}
    uncount = _count_calls(K, "commit_quorum", counts, threading.get_ident())
    try:
        K.step(kp, st, empty_inbox(kp, P, "cpu"), empty_input(kp, P, "cpu"))
    finally:
        uncount()
    return counts["commit_quorum"]


def _check_path_launches(name: str, launches: dict, calls, kp,
                         k3: int | None = None) -> int:
    """Exactly _k1_calls_per_step(kp) K1 launches per step and
    K2_PER_ROUTE K2 launches per route, one route per step, and K3 ``k3``
    times (0 off the device-SM path); returns K1's launches per step."""
    steps, routes = calls["step"], calls["route"]
    per_step = _k1_calls_per_step(kp)
    check(steps > 0 and routes == steps, f"{name}: {steps} steps, {routes} routes")
    check(launches["quorum_match"] == per_step * steps,
          f"{name}: {launches['quorum_match']} K1 launches in {steps} steps, "
          f"not {per_step} a step")
    check(launches["gather_lanes"] == K2_PER_ROUTE * routes,
          f"{name}: {launches['gather_lanes']} K2 launches in {routes} routes, "
          f"not {K2_PER_ROUTE} a route")
    if k3 is not None:
        check(launches["kv_apply"] == k3,
              f"{name}: kv_apply launched {launches['kv_apply']} times in {k3} steps")
    else:
        check(launches["kv_apply"] == 0, f"{name}: kv_apply launched off the device-SM path")
    return per_step


def _loop_taps():
    """Tap K1 and K2 where the step and the router call them, every
    LOOP_TAP_EVERY-th call, and count the loop's steps and routes; returns
    the records, the counts and the untap function."""
    from dragonboat_tpu_torch.core import kernel as K
    from dragonboat_tpu_torch.core import router

    k1, untap1 = _tap(K, "commit_quorum", LOOP_TAP_EVERY)
    k2, untap2 = _tap(router, "gather_lanes_multi", LOOP_TAP_EVERY)
    calls, uncount = _count_steps()

    def untap():
        untap1()
        untap2()
        uncount()

    return (k1, k2), calls, untap


def _loop_held(torch, name: str, taps) -> dict:
    """K1 and K2 against their plain arms, bitwise, on the inputs the loop
    gave them (run after the loop's launch counts were read)."""
    k1, k2 = taps
    out = {**_tapped(torch, k1["inputs"], "k1_held", "commit_quorum"),
           **_tapped(torch, k2["inputs"], "k2_held", "gather_lanes_multi")}
    for k in ("k1_held", "k2_held"):
        check(out[f"{k}_mismatches"] == 0,
              f"{name}: {k[:2].upper()} differs from its plain arm on the loop's inputs")
    return out


def _pctile(hist, q: float):
    """bench.py's percentile (in steps) from the latency histogram."""
    h = np.asarray(hist, np.int64)
    c = h.cumsum()
    if c[-1] == 0:
        return None
    return int(np.searchsorted(c, q * c[-1], side="left"))


def _leader_sum(torch, t, lead) -> int:
    return int(torch.where(lead, t.to(torch.int64), 0).sum())


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _loops_cluster(torch, dev):
    """Phases A2, B and D on one elected 8192 x 3 cluster, in bench.py's
    order: latency (no reads), the ReadIndex mix, the membership wave."""
    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch import kernels
    from dragonboat_tpu_torch.core import params as KP

    N, R, WW = LOOP_GROUPS, REPLICAS, LOOP_WW
    G = N * R
    kp = bl.bench_params(R, dev)
    (state, box), elect_s = _timed(torch, lambda: bl.elect_all(
        kp, R, bl.make_cluster(kp, N, R, device=dev)))
    lead = state.role == KP.LEADER
    check(bool(lead.reshape(N, R).any(dim=1).all()), "a group has no leader after elect_all")
    stamp, hist, reads = bl.lat_init(kp, G, device=dev)

    # A2: commit latency
    syncs = _sync_pass(torch, lambda: bl.run_steps_lat(
        kp, R, SYNC_PASS_STEPS, WW, False, True, True, 0, state, box,
        stamp.clone(), hist.clone(), reads.clone()), SYNC_PASS_STEPS)
    kernels.reset_launches()
    taps, calls, untap = _loop_taps()
    try:
        state, box, stamp, hist, reads = bl.run_steps_lat(
            kp, R, LAT_SETTLE, WW, False, True, True, 0, state, box, stamp, hist, reads)
        now = LAT_SETTLE
        h0 = hist.to(torch.int64)
        a0 = _leader_sum(torch, state.processed, lead)
        (state, box, stamp, hist, reads), dt = _timed(torch, lambda: bl.run_steps_lat(
            kp, R, LAT_STEPS, WW, False, True, True, now, state, box, stamp, hist, reads))
        now += LAT_STEPS
        launches = dict(kernels.launches)
    finally:
        untap()
    held = _loop_held(torch, "loops_latency", taps)
    dh = (hist.to(torch.int64) - h0).cpu().numpy()
    released = _leader_sum(torch, state.processed, lead) - a0
    step_ms = dt / LAT_STEPS * 1e3
    pct = {name: _pctile(dh, q) for name, q in (("p50", 0.5), ("p99", 0.99), ("p99.9", 0.999))}
    say("loops_latency", groups=N, replicas=R, write_width=WW, settle_steps=LAT_SETTLE,
        steps=LAT_STEPS, elect_s=elect_s, window_s=dt, step_ms=step_ms,
        released=released, hist_total=int(dh.sum()),
        **{f"{k}_steps": v for k, v in pct.items()},
        **{f"{k}_ms": (None if v is None else v * step_ms) for k, v in pct.items()},
        launches=json.dumps(launches, separators=(",", ":")), **held, **syncs)
    check(int(dh.sum()) == released > 0,
          f"latency histogram holds {int(dh.sum())} releases, leaders released {released}")
    _check_path_launches("loops_latency", launches, calls, kp)

    # B: the 9:1 ReadIndex mix, permits
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    syncs = _sync_pass(torch, lambda: bl.run_steps_mixed(
        kp, R, SYNC_PASS_STEPS, WW, now, state, box, zero), SYNC_PASS_STEPS)
    kernels.reset_launches()
    c0 = _leader_sum(torch, state.committed, lead)
    taps, calls, untap = _loop_taps()
    try:
        (state, box, ctx), dt = _timed(torch, lambda: bl.run_steps_mixed(
            kp, R, MIXED_STEPS, WW, now, state, box, zero))
        launches = dict(kernels.launches)
    finally:
        untap()
    now += MIXED_STEPS
    held = _loop_held(torch, "loops_mixed", taps)
    writes = _leader_sum(torch, state.committed, lead) - c0
    ctx = int(ctx)
    rb = 9 * WW
    say("loops_mixed", groups=N, write_width=WW, steps=MIXED_STEPS, window_s=dt,
        step_ms=dt / MIXED_STEPS * 1e3, read_ctx=ctx, read_ctx_per_s=ctx / dt,
        read_batch_per_ctx=rb, writes=writes, writes_per_s=writes / dt,
        ops_per_s=(writes + min(ctx * rb, 9 * writes)) / dt,
        launches=json.dumps(launches, separators=(",", ":")), **held, **syncs)
    check(ctx > 0 and writes > 0, f"mixed loop: {ctx} ctxs, {writes} writes")
    _check_path_launches("loops_mixed", launches, calls, kp)

    # D: the membership wave with compaction under load; the host plays
    # the engine and releases the one-in-flight gate before each wave
    syncs = _sync_pass(torch, lambda: bl.cc_step(kp, R, state, box), 1)

    def waves():
        nonlocal state, box
        out = []
        for _ in range(CC_ROUNDS):
            state = state._replace(pending_cc=torch.zeros_like(state.pending_cc))
            state, box, acc, idx = bl.cc_step(kp, R, state, box)
            out.append((acc, idx))
            state, box = bl.run_steps(kp, R, CC_PERIOD - 1, True, True, state, box)
        return out

    kernels.reset_launches()
    taps, calls, untap = _loop_taps()
    try:
        state, box, _acc, _idx = bl.cc_step(kp, R, state, box)
        state, box = bl.run_steps(kp, R, CC_PERIOD - 1, True, True, state, box)
        snap0 = _leader_sum(torch, state.snap_index, lead)
        c0 = _leader_sum(torch, state.committed, lead)
        wave_out, dt = _timed(torch, waves)
        launches = dict(kernels.launches)
    finally:
        untap()
    held = _loop_held(torch, "loops_wave", taps)
    committed = state.committed
    cc_acc = sum(int(a.sum()) for a, _ in wave_out)
    cc_done = sum(int((a & (committed >= i)).sum()) for a, i in wave_out)
    writes = _leader_sum(torch, state.committed, lead) - c0
    advance = _leader_sum(torch, state.snap_index, lead) - snap0
    steps = CC_ROUNDS * CC_PERIOD
    say("loops_wave", groups=N, rounds=CC_ROUNDS, period=CC_PERIOD, cc_accepted=cc_acc,
        cc_committed=cc_done, window_s=dt, step_ms=dt / steps * 1e3, writes=writes,
        writes_per_s=writes / dt, compaction_floor_advance=advance,
        launches=json.dumps(launches, separators=(",", ":")), **held, **syncs)
    check(cc_acc > 0, "no config change was accepted")
    check(cc_done == cc_acc, f"{cc_acc - cc_done} of {cc_acc} accepted CCs not committed")
    check(advance > 0, "the compaction floor did not advance under the wave")
    _check_path_launches("loops_wave", launches, calls, kp)


def _loops_served(torch, dev):
    """B2: the 9:1 mix with every read served from the device table, on a
    fresh device-SM cluster: warm chunk and remainder, then the window."""
    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch import kernels
    from dragonboat_tpu_torch.core import params as KP

    N, R, WW, T = LOOP_GROUPS, REPLICAS, LOOP_WW, TABLE_CAP
    kp = bl.sm_params(R, dev)
    (state, box), elect_s = _timed(torch, lambda: bl.elect_all(
        kp, R, bl.make_cluster(kp, N, R, device=dev)))
    lead = state.role == KP.LEADER
    kv, kv_state = bl.make_device_sm(N, R, T, device=dev)
    z = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    carry = [z(), z(), z()]
    syncs = _sync_pass(torch, lambda: bl.run_steps_mixed_sm(
        kp, R, kv, SYNC_PASS_STEPS, WW, 0, state, box,
        {k: v.clone() for k, v in kv_state.items()}, z(), z(), z()), SYNC_PASS_STEPS)
    kernels.reset_launches()
    taps, calls, untap = _loop_taps()
    try:
        now = 0
        for n in (min(LOOP_CHUNK, MIXED_STEPS), MIXED_STEPS % LOOP_CHUNK):
            state, box, kv_state, *carry = bl.run_steps_mixed_sm(
                kp, R, kv, n, WW, now, state, box, kv_state, *carry)
            now += n
        c0, r0 = _leader_sum(torch, state.committed, lead), int(carry[0])
        (state, box, kv_state, *carry), dt = _timed(torch, lambda: bl.run_steps_mixed_sm(
            kp, R, kv, MIXED_STEPS, WW, now, state, box, kv_state, *carry))
        launches = dict(kernels.launches)
    finally:
        untap()
    held = _loop_held(torch, "loops_served", taps)
    writes = _leader_sum(torch, state.committed, lead) - c0
    served = (int(carry[0]) - r0) * 9 * WW
    rejects, checksum = int(carry[2]), int(carry[1])
    steps = now + MIXED_STEPS
    say("loops_served", groups=N, table_cap=T, table="direct-mapped", write_width=WW,
        warm_steps=now, steps=MIXED_STEPS, elect_s=elect_s, window_s=dt,
        step_ms=dt / MIXED_STEPS * 1e3, writes=writes, writes_per_s=writes / dt,
        reads_served=served, reads_served_per_s=served / dt,
        ops_per_s=(writes + min(served, 9 * writes)) / dt, read_checksum=checksum,
        rejected_writes=rejects, launches=json.dumps(launches, separators=(",", ":")),
        **held, **syncs)
    check(rejects == 0, f"{rejects} committed writes rejected in the served mix")
    check(served > 0 and checksum != 0, f"served mix: {served} reads, checksum {checksum}")
    _check_path_launches("loops_served", launches, calls, kp, k3=steps)


def _loops_storm(torch, dev):
    """C: 10,000 groups with pre-vote, 10 ticks, the storm, then clean
    chunks until exactly one leader per group."""
    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch import kernels
    from dragonboat_tpu_torch.core import params as KP
    from dragonboat_tpu_torch.core.kstate import empty_inbox

    N, R = STORM_GROUPS, REPLICAS
    kp = bl.bench_params(R, dev)
    state = bl.make_cluster(kp, N, R, device=dev)
    state = state._replace(pre_vote=torch.ones_like(state.pre_vote))
    box = empty_inbox(kp, N * R, dev)
    syncs = _sync_pass(torch, lambda: bl.run_steps_storm(
        kp, R, SYNC_PASS_STEPS, STORM_DROP, STORM_SEED, state, box), SYNC_PASS_STEPS)
    kernels.reset_launches()
    taps, calls, untap = _loop_taps()
    try:
        state, box = bl.run_steps(kp, R, STORM_TICKS, True, False, state, box)
        (state, box), storm_s = _timed(torch, lambda: bl.run_steps_storm(
            kp, R, STORM_STEPS, STORM_DROP, STORM_SEED, state, box))
        leaders = (state.role.reshape(N, R) == KP.LEADER).sum(dim=1)
        coverage = float((leaders > 0).float().mean())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done, recovered = 0, None
        while done < RECOVERY_MAX:
            state, box = bl.run_steps(kp, R, RECOVERY_CHUNK, True, False, state, box)
            done += RECOVERY_CHUNK
            leaders = (state.role.reshape(N, R) == KP.LEADER).sum(dim=1)
            if bool((leaders == 1).all()):
                recovered = done
                break
        dt = time.perf_counter() - t0
        launches = dict(kernels.launches)
    finally:
        untap()
    held = _loop_held(torch, "loops_storm", taps)
    step_ms = dt / done * 1e3
    say("loops_storm", groups=N, replicas=R, ticks=STORM_TICKS, storm_steps=STORM_STEPS,
        drop_p=STORM_DROP, seed=STORM_SEED, storm_s=storm_s,
        storm_step_ms=storm_s / STORM_STEPS * 1e3,
        leader_coverage_after_storm=coverage,
        post_recovery_coverage=float((leaders == 1).float().mean()),
        recovery_steps=recovered, recovery_s=dt, recovery_step_ms=step_ms,
        recovery_ms=None if recovered is None else step_ms * recovered,
        max_term=int(state.term.max()),
        launches=json.dumps(launches, separators=(",", ":")), **held, **syncs)
    check(recovered is not None,
          f"the storm did not recover to one leader per group in {RECOVERY_MAX} steps")
    _check_path_launches("loops_storm", launches, calls, kp)


def _loops_single(torch, dev):
    """E: one 3-replica shard, the write loop in chunks of 25."""
    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch import kernels
    from dragonboat_tpu_torch.core import params as KP

    R = REPLICAS
    kp = bl.bench_params(R, dev)
    state, box = bl.elect_all(kp, R, bl.make_cluster(kp, 1, R, device=dev))
    lead = state.role == KP.LEADER
    syncs = _sync_pass(torch, lambda: bl.run_steps(
        kp, R, SYNC_PASS_STEPS, True, True, state, box), SYNC_PASS_STEPS)

    def window():
        nonlocal state, box
        for _ in range(SINGLE_STEPS // SINGLE_CHUNK):
            state, box = bl.run_steps(kp, R, SINGLE_CHUNK, True, True, state, box)

    kernels.reset_launches()
    taps, calls, untap = _loop_taps()
    try:
        state, box = bl.run_steps(kp, R, SINGLE_CHUNK, True, True, state, box)
        c0 = _leader_sum(torch, state.committed, lead)
        _, dt = _timed(torch, window)
        launches = dict(kernels.launches)
    finally:
        untap()
    held = _loop_held(torch, "loops_single", taps)
    writes = _leader_sum(torch, state.committed, lead) - c0
    say("loops_single", groups=1, replicas=R, warm_steps=SINGLE_CHUNK, steps=SINGLE_STEPS,
        window_s=dt, step_ms=dt / SINGLE_STEPS * 1e3, writes=writes,
        writes_per_s=writes / dt, launches=json.dumps(launches, separators=(",", ":")),
        **held, **syncs)
    check(writes > 0, "the single shard committed nothing")
    _check_path_launches("loops_single", launches, calls, kp)


def _loops_drive(torch, groups: int, dev, steps: int) -> dict:
    """Every loop of this phase at ``groups`` x 3 on ``dev``, ``steps``
    steps each, from clusters made the same way: the storm from a cold
    start (the port's own draw), latency with reads, the mix and two
    waves on one elected cluster, the served mix on both table kinds.
    Returns every leaf by loop."""
    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch.core.kstate import empty_inbox
    from dragonboat_tpu_torch.rsm.device_kv import DeviceKV

    R, WW = REPLICAS, LOOP_WW
    G = groups * R
    z = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    out = {}
    kp = bl.bench_params(R, dev)
    st = bl.make_cluster(kp, groups, R, device=dev)
    st = st._replace(pre_vote=torch.ones_like(st.pre_vote))
    out.update(_leaves("storm", bl.run_steps_storm(
        kp, R, steps, STORM_DROP, STORM_SEED, st, empty_inbox(kp, G, dev))))
    st, bx = bl.elect_all(kp, R, bl.make_cluster(kp, groups, R, device=dev))
    st, bx, *lat = bl.run_steps_lat(kp, R, steps, WW, True, True, True, 0, st, bx,
                                    *bl.lat_init(kp, G, device=dev))
    out.update(_leaves("latency", (st, bx, lat)))
    st, bx, rd = bl.run_steps_mixed(kp, R, steps, WW, steps, st, bx, z())
    out.update(_leaves("mixed", (st, bx, rd)))
    for w in range(2):
        st = st._replace(pending_cc=torch.zeros_like(st.pending_cc))
        st, bx, acc, idx = bl.cc_step(kp, R, st, bx)
        st, bx = bl.run_steps(kp, R, CC_PERIOD - 1, True, True, st, bx)
        out.update(_leaves(f"wave{w}", (st, bx, acc, idx)))
    kps = bl.sm_params(R, dev)
    st, bx = bl.elect_all(kps, R, bl.make_cluster(kps, groups, R, device=dev))
    for hashed in (False, True):
        kv = DeviceKV(table_cap=TABLE_CAP, hash_keys=hashed)
        out.update(_leaves("served_hashed" if hashed else "served_direct",
                           bl.run_steps_mixed_sm(kps, R, kv, steps, WW, 0, st, bx,
                                                 kv.init_state(G, dev), z(), z(), z())))
    return out


def _loops_parity(torch, dev) -> None:
    from dragonboat_tpu_torch import kernels

    t0 = time.perf_counter()
    S = LOOP_PARITY_STEPS
    card = _loops_drive(torch, CPU_GROUPS, dev, S)
    cpu = _loops_drive(torch, CPU_GROUPS, torch.device("cpu"), S)
    bad_cpu = _leaf_diff(torch, card, cpu)
    kern = _loops_drive(torch, PARITY_GROUPS, dev, S)
    with kernels.plain_arms():
        plain = _loops_drive(torch, PARITY_GROUPS, dev, S)
    bad_plain = _leaf_diff(torch, kern, plain)
    say("loops_parity", card_vs_cpu=f"{CPU_GROUPS}x{REPLICAS}",
        kernel_vs_plain=f"{PARITY_GROUPS}x{REPLICAS}", steps=S, leaves=len(card),
        card_vs_cpu_diff=json.dumps(bad_cpu), kernel_vs_plain_diff=json.dumps(bad_plain),
        seconds=time.perf_counter() - t0)
    check(not bad_cpu, f"loops: card != CPU at {CPU_GROUPS}x3: {bad_cpu}")
    check(not bad_plain, f"loops: kernels != plain arms at {PARITY_GROUPS}x3: {bad_plain}")


def phase_loops(torch, dev) -> None:
    t0 = time.perf_counter()
    # the sync counter's control: one .item() must count as one sync
    control = _sync_pass(torch, lambda: int(torch.ones((), device=dev)), 1)
    check(control["syncs_per_step"] == 1,
          f"sync debug mode missed a .item(): {control['sync_sites']}")
    _loops_cluster(torch, dev)
    _loops_served(torch, dev)
    _loops_storm(torch, dev)
    _loops_single(torch, dev)
    _loops_parity(torch, dev)
    say("loops", seconds=time.perf_counter() - t0,
        sync_control=control["sync_sites"])


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
              reductions=True, metrics=False, **expert):
    """Three NodeHosts over the chan transport with ``shards``
    device-resident shards x 3 replicas; the reference's ExpertConfig
    (the reductions on unless ``reductions`` is False) and EngineConfig
    (unless ``one_worker`` asks for a single step worker)."""
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
        if not reductions:
            expert.update(REDUCTIONS_OFF)
        ex = ExpertConfig(kernel_pipeline_depth=depth, **expert)
        hosts[r] = NodeHost(NodeHostConfig(raft_address=addr,
                                           rtt_millisecond=10, expert=ex,
                                           enable_metrics=metrics),
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
    readback_s = time.perf_counter() - r0
    r1 = time.perf_counter()
    leaders = _nh_leaders(hosts, shards)
    sample = sorted(leaders)[:: max(1, len(leaders) // NH_SAMPLE_READS)]
    # sync_read's ReadIndex round on every sampled shard's leader, issued
    # together as a client with many shards would (one after another,
    # each waits several steps of three engines taking turns)
    reads = {sid: hosts[leaders[sid]].read_index(sid, 60) for sid in sample}
    for sid, rs in reads.items():
        rs.get(60)
        got = hosts[leaders[sid]].read_local_node(sid, "w")
        check(got == want[sid], f"shard {sid}: sync_read {got!r} != {want[sid]!r}")
    return {"readback_s": readback_s,
            "sync_read_s": time.perf_counter() - r1,
            "elect_s": elect_s, "writes": shards * NH_WRITES,
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


def _clone(x):
    """A copy of a tensor or of a nest of lists and tuples of them."""
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x.clone()


def _flat(x) -> list:
    """The tensors of a nest of lists and tuples, in order."""
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return [x]


def _tap(module, attr: str, every: int):
    """Route ``module.attr``, a kernel wrapper as a call site imported it
    (K1's ``commit_quorum`` in core/kernel and ``quorum_match`` in
    core/invariants, K2's ``gather_lanes_multi`` in core/router), through a
    tap that counts every call and clones the inputs of every
    ``every``-th call (up to TAP_KEEP) before it launches; returns the
    tap's record and the function that takes the tap out."""
    orig, rec = getattr(module, attr), {"calls": 0, "inputs": []}

    def tap(*args):
        rec["calls"] += 1
        if (rec["calls"] - 1) % every == 0 and len(rec["inputs"]) < TAP_KEEP:
            rec["inputs"].append(_clone(args))
        return orig(*args)

    setattr(module, attr, tap)
    return rec, lambda: setattr(module, attr, orig)


def _tapped(torch, taps, key: str, kernel: str = "quorum_match") -> dict:
    """A kernel entry against its plain arm on the inputs one call site
    gave it: every output equal in value, dtype and shape."""
    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    check(len(taps) > 0, f"no {kernel} call was tapped ({key})")
    fn, plain = getattr(fk, kernel), getattr(fk, kernel + "_plain")
    shapes = sorted({tuple(_flat(args)[0].shape) for args in taps})
    mism = err = 0
    for args in taps:
        for got, ref in zip(_flat(fn(*args)), _flat(plain(*args)), strict=True):
            mism += int((got != ref).sum()) + (got.dtype != ref.dtype
                                               or got.shape != ref.shape)
            err = max(err, max_abs_err(torch, got, ref))
    return {f"{key}_calls": len(taps),
            f"{key}_shapes": json.dumps([list(x) for x in shapes]),
            f"{key}_mismatches": mism, f"{key}_max_abs_err": err}


def _time_ticks(store: dict):
    """Time every engine's decimated ticks (KernelEngine's TICKS methods,
    wrapped on the class): host ms of each call into ``store``; returns
    the function that takes the wrappers out."""
    from dragonboat_tpu_torch.engine.kernel_engine import KernelEngine

    origs = {name: getattr(KernelEngine, name) for name in TICKS}

    def wrap(name, fn):
        def timed(self):
            t = time.perf_counter()
            try:
                return fn(self)
            finally:
                store.setdefault(name, []).append(
                    (time.perf_counter() - t) * 1e3)
        return timed

    for name, fn in origs.items():
        setattr(KernelEngine, name, wrap(name, fn))
    return lambda: [setattr(KernelEngine, n, f) for n, f in origs.items()]


def _tick_stats(store: dict) -> dict:
    """Per tick kind: calls, median and p90 host ms."""
    out = {}
    for name in TICKS:
        ms = store.get(name, [])
        short = name.replace("_collect_", "")
        out[f"{short}_ticks"] = len(ms)
        out[f"{short}_host_ms_p50"] = float(np.percentile(ms, 50)) if ms else None
        out[f"{short}_host_ms_p90"] = float(np.percentile(ms, 90)) if ms else None
    return out


def _scrape(addr: str, path: str):
    """(status, body) of one GET on a host's metrics endpoint."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{addr}{path}", timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _leader_gauge(text: str) -> int:
    line = 'fleet_role_count{role="leader"} '
    return sum(int(float(x[len(line):])) for x in text.splitlines()
               if x.startswith(line))


def _nh_endpoints(hosts, shards, deadline_s=120.0) -> dict:
    """Every host's metrics endpoint after the writes settled: the leader
    gauges sum to ``shards`` (the fleet stats are decimated: wait for a
    tick that saw every leader), /healthz answers 200, /debug/groups and
    /debug/group/<id> pass the port's validators, the device row equals
    the engine's health_row (both read with the engines paused), no
    invariant violation was ever seen, every tick kind ran."""
    from dragonboat_tpu_torch.core import health
    from dragonboat_tpu_torch.engine.kernel_engine import KernelEngine

    t0 = time.perf_counter()
    while True:
        gauges = [_leader_gauge(_scrape(nh.metrics_address, "/metrics")[1]
                                .decode()) for nh in hosts.values()]
        if sum(gauges) == shards:
            break
        check(time.perf_counter() - t0 < deadline_s,
              f"/metrics leader gauges {gauges} never summed to {shards}")
        time.sleep(1.0)
    gauge_s = time.perf_counter() - t0
    for r, nh in hosts.items():
        status, body = _scrape(nh.metrics_address, "/healthz")
        if status != 200:
            say("nodehost_healthz_degraded", host=r, status=status,
                body=body.decode()[:2000])
        check(status == 200, f"host {r}: /healthz answered {status}")
    groups = shard_count = 0
    for r, nh in hosts.items():
        status, body = _scrape(nh.metrics_address, "/debug/groups")
        check(status == 200, f"host {r}: /debug/groups answered {status}")
        shard_count = health.validate_info(json.loads(body))
        check(shard_count == shards, f"host {r}: /debug/groups lists {shard_count}")
        groups += 1
    sid = shards // 2
    rows_equal = 0
    for r, nh in hosts.items():
        eng = nh.kernel_engine
        with KernelEngine._step_mu:
            status, body = _scrape(nh.metrics_address, f"/debug/group/{sid}")
            row = eng.health_row(eng.by_shard[sid].lane)
        check(status == 200, f"host {r}: /debug/group/{sid} answered {status}")
        info = json.loads(body)
        health.validate_shard_info(info)
        check(info["device"] == row, f"host {r}: device row {info['device']} != {row}")
        rows_equal += 1
    seqs = []
    for r, nh in hosts.items():
        eng = nh.kernel_engine
        last = eng.last_invariants
        check(last is not None and last["total"] == 0
              and last["violations_seen"] == 0,
              f"host {r}: invariant violations {last}")
        seqs.append((eng._health_seq, eng._inv_seq, eng._capacity_seq))
        check(min(seqs[-1]) > 0, f"host {r}: a reduction never ticked {seqs[-1]}")
    return {"leader_gauges": json.dumps(gauges), "gauge_wait_s": gauge_s,
            "healthz_200": len(hosts), "debug_groups_valid": groups,
            "debug_group_rows_equal": rows_equal,
            "violations_seen": 0,
            "ticks_health_inv_capacity": json.dumps(seqs)}


def _struct_np(struct) -> dict:
    return {f: v.detach().cpu().numpy() for f, v in zip(struct._fields, struct)}


def _nh_reductions_vs_cpu(torch, hosts) -> dict:
    """The four reductions on one engine's snapshot (state, inbox, both
    digests), on the card and again on CPU copies (plain arms), and the
    recount oracles on the host: every output and digest leaf equal.  On
    the card they run under CUDA's sync debug mode "error" (the engines
    paused): a pass that waited for the device anywhere but in its one
    fetch, which comes after, would raise."""
    from dragonboat_tpu_torch import convert
    from dragonboat_tpu_torch.core import fleet, health
    from dragonboat_tpu_torch.core import invariants as inv
    from dragonboat_tpu_torch.engine.kernel_engine import KernelEngine

    eng = hosts[1].kernel_engine
    with KernelEngine._step_mu, eng.mu:
        state = type(eng.state)(*(None if v is None else v.clone()
                                  for v in eng.state))
        inbox = eng._fleet_inbox_from()
        hd = type(eng._health_digest)(*(v.clone() for v in eng._health_digest))
        idg = type(eng._inv_digest)(*(v.clone() for v in eng._inv_digest))
        th, k = eng.health_thresholds, eng.health_top_k
    cpu = torch.device("cpu")

    def on(dev):
        s = type(state)(*(None if v is None else v.to(dev) for v in state))
        b = inbox.to(dev)
        h = type(hd)(*(v.to(dev) for v in hd))
        i = type(idg)(*(v.to(dev) for v in idg))
        rep, hdig = health.fleet_health(s, b, h, thresholds=th, k=k)
        irep, idig = inv.check_invariants(s, i)
        rows = [health.shard_row(s, b, hdig, g, thresholds=th)
                for g in range(0, eng.capacity, max(1, eng.capacity // 64))]
        return {"fleet": fleet.fleet_stats(s, b), "health": rep,
                "health_digest": hdig, "inv": irep, "inv_digest": idig,
                "rows": rows}

    with KernelEngine._step_mu:
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card = on(state.term.device)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    host = on(cpu)
    torch.cuda.synchronize()
    leaves = 0
    for key in ("fleet", "health", "health_digest", "inv", "inv_digest"):
        bad = convert.diff_leaves(_struct_np(host[key]), _struct_np(card[key]))
        check(not bad, f"reduction {key}: card != CPU at {bad}")
        leaves += len(host[key])
    for a, b in zip(host["rows"], card["rows"]):
        bad = convert.diff_leaves(_struct_np(a), _struct_np(b))
        check(not bad, f"shard_row: card != CPU at {bad}")
        leaves += len(a)
    np_state = type(state)(*(None if v is None else v.cpu().numpy()
                             for v in state))
    rec, rec_digest = health.recount(np_state, inbox.cpu().numpy(),
                                     type(hd)(*(v.cpu().numpy() for v in hd)),
                                     thresholds=th, k=k)
    check(health.report_to_dict(card["health"]) == rec, "fleet_health != recount")
    check({f: v.tolist() for f, v in _struct_np(card["health_digest"]).items()}
          == rec_digest, "health digest != recount")
    irec, irec_digest = inv.recount(np_state, type(idg)(*(v.cpu().numpy()
                                                          for v in idg)))
    check(inv.report_to_dict(card["inv"]) == irec, "check_invariants != recount")
    check({f: v.tolist() for f, v in _struct_np(card["inv_digest"]).items()}
          == irec_digest, "invariant digest != recount")
    return {"lanes": eng.capacity, "leaves_equal": leaves,
            "shard_rows": len(card["rows"]), "recount": "equal",
            "card_sync_debug": "error, none raised",
            "anomalous": rec["anomalous"], "violations": irec["total"],
            "checked": irec["checked"]}


def _nh_reduction_cost(torch, hosts) -> dict:
    """Each decimated tick run alone on host 1's engine, the engines
    paused (the shared step lock held): host ms per call (the wall time of
    a call, its own fetch included, after a synchronize), and device ms
    per call (the kernels inside a torch.profiler range around it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from dragonboat_tpu_torch.engine.kernel_engine import KernelEngine

    eng = hosts[1].kernel_engine
    out = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with KernelEngine._step_mu, eng.mu:
        for name in TICKS:
            fn = getattr(eng, name)
            fn()
            ms = []
            for _ in range(COST_REPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                ms.append((time.perf_counter() - t) * 1e3)
            out[f"{name.replace('_collect_', '')}_host_ms"] = statistics.median(ms)
        with prof:
            for name in TICKS:
                for _ in range(COST_REPS):
                    with record_function(f"tick{name}"):
                        getattr(eng, name)()
            torch.cuda.synchronize()
    dev_us = {}
    for ev in prof.events():
        if ev.name.startswith("tick_collect_") and ev.device_type == DeviceType.CPU:
            dev_us[ev.name] = dev_us.get(ev.name, 0.0) + ev.device_time_total
    for name in TICKS:
        out[f"{name.replace('_collect_', '')}_device_ms"] = \
            dev_us.get(f"tick{name}", 0.0) / 1e3 / COST_REPS
    out["reps"] = COST_REPS
    return out


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


def _reduction_snapshots(eng) -> tuple:
    """An engine's reduction results and digests, as host values."""
    digests = tuple(None if d is None else _struct_np(d)
                    for d in (eng._health_digest, eng._inv_digest))
    return (eng.last_fleet, eng.last_health, eng.last_invariants,
            eng._inv_seq) + digests


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
                           dict(nh.nodes[1].sm.sm.kv),
                           _reduction_snapshots(nh.kernel_engine))
                          for nh in hosts.values()])
    finally:
        _nh_close(hosts)
    return trace


def _nh_cell(torch, dev, tag, one_worker=False, reductions=True,
             full=False) -> dict:
    """The NodeHost cell at NH_SHARDS x 3: admit, elect, write, read
    back; launch counts (split into K1's call sites), peak memory and the
    decimated ticks' host ms over it alone.  ``full`` adds, after the
    counts are read, the K1 taps' comparison, the endpoint checks, the
    reductions card against CPU, their cost alone and the profile."""
    from dragonboat_tpu_torch import kernels
    from dragonboat_tpu_torch.core import invariants as inv
    from dragonboat_tpu_torch.core import kernel as K
    from dragonboat_tpu_torch.engine import kernel_engine

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    ticks: dict = {}
    step_tap, untap_step = _tap(K, "commit_quorum", K1_TAP_EVERY)
    probe_tap, untap_probe = _tap(inv, "quorum_match", 1)
    # the engines' steps: each engine binds these two at construction
    engine_steps: dict = {}
    uncount = [_count_calls(kernel_engine, attr, engine_steps)
               for attr in ("kernel_step", "kernel_step_donated")]
    untime = _time_ticks(ticks)

    def restore():
        untap_step()
        untap_probe()
        for u in uncount:
            u()
        untime()

    extra = {}
    try:
        hosts = _nh_hosts(tag, NH_SHARDS, dev, one_worker=one_worker,
                          reductions=reductions, metrics=full)
        admit_s = time.perf_counter() - t0
        try:
            try:
                st = _nh_serve(hosts, NH_SHARDS)
                torch.cuda.synchronize()
                launches = dict(kernels.launches)
                calls = (step_tap["calls"], probe_tap["calls"],
                         sum(engine_steps.values()))
                tick_stats = _tick_stats(ticks)
                peak = torch.cuda.max_memory_allocated()
            finally:
                restore()
            k1_per_step = _k1_calls_per_step(hosts[1].kernel_engine.kp)
            if full:
                extra["k1"] = {
                    **_tapped(torch, step_tap["inputs"], "k1_tapped", "commit_quorum"),
                    **_tapped(torch, probe_tap["inputs"], "k1_probe_tapped")}
                extra["endpoints"] = _nh_endpoints(hosts, NH_SHARDS)
                extra["reductions"] = _nh_reductions_vs_cpu(torch, hosts)
                extra["cost"] = _nh_reduction_cost(torch, hosts)
                extra["profile"] = _nh_profile(torch, hosts, NH_SHARDS)
        finally:
            _nh_close(hosts)
    finally:
        restore()
    return {"engine": "one step worker" if one_worker else "EngineConfig()",
            "reductions": "on" if reductions else "off",
            "admit_s": admit_s, **st, **tick_stats,
            "k1_launches": launches["quorum_match"],
            "k1_step_calls": calls[0], "k1_probe_calls": calls[1],
            "engine_steps": calls[2], "k1_per_engine_step": k1_per_step,
            "launches": json.dumps(launches, separators=(",", ":")),
            "max_memory_allocated": peak, "extra": extra,
            "seconds": time.perf_counter() - t0}


def phase_nodehost(torch, dev, smi: str) -> int:
    from dragonboat_tpu_torch import convert

    tag = f"smk{time.monotonic_ns()}"
    st = _nh_cell(torch, dev, tag, full=True)
    extra = st.pop("extra")
    say("nodehost", shards=NH_SHARDS, replicas=3, hosts=3, **st, **extra["k1"],
        card=json.dumps(smi))
    say("nodehost_endpoints", **extra["endpoints"])
    say("nodehost_reductions", card_vs_cpu="equal", **extra["reductions"])
    say("nodehost_reduction_cost", **extra["cost"], card=json.dumps(smi))
    prof = extra["profile"]
    say("nodehost_profile", **{k: json.dumps(v) if isinstance(v, list) else v
                               for k, v in prof.items()})
    check(st["acked"] == NH_SHARDS * NH_WRITES, "not every write acknowledged")
    check(st["k1_step_calls"] > 0, "K1 was not launched by the engine's step")
    check(st["k1_probe_calls"] > 0, "K1 was not launched by the invariant probe")
    check(st["k1_step_calls"] + st["k1_probe_calls"] == st["k1_launches"],
          "K1's launches are not the step's and the probe's calls")
    check(st["k1_step_calls"] == st["k1_per_engine_step"] * st["engine_steps"],
          f"{st['k1_step_calls']} K1 launches by the engines' {st['engine_steps']} "
          f"steps, not {st['k1_per_engine_step']} a step")
    for key in ("k1_tapped_mismatches", "k1_probe_tapped_mismatches"):
        check(extra["k1"][key] == 0, f"K1 disagrees with its plain arm ({key})")
    check(prof["acked"] == prof["writes"], "profiled writes not all acknowledged")
    k1 = st["k1_launches"]

    t1 = time.perf_counter()
    hosts = _nh_hosts(f"{tag}d1", NH_DEPTH1_SHARDS, dev, depth=1)
    admit_s = time.perf_counter() - t1
    try:
        d1 = _nh_serve(hosts, NH_DEPTH1_SHARDS)
        overlapped = sum(nh.events.metrics.snapshot().get(
            "engine.pipeline.overlapped", 0) for nh in hosts.values())
        d1_inv = [nh.kernel_engine.last_invariants for nh in hosts.values()]
    finally:
        c0 = time.perf_counter()
        _nh_close(hosts)
    say("nodehost_depth1", shards=NH_DEPTH1_SHARDS, admit_s=admit_s, **d1,
        overlapped=overlapped,
        violations_seen=sum(d["violations_seen"] for d in d1_inv if d),
        close_s=time.perf_counter() - c0, seconds=time.perf_counter() - t1)
    check(d1["acked"] == NH_DEPTH1_SHARDS * NH_WRITES,
          "depth 1: not every write acknowledged")
    check(overlapped > 0, "depth 1: no step overlapped")
    check(all(d is not None and d["violations_seen"] == 0 for d in d1_inv),
          f"depth 1: invariant probe {d1_inv}")

    t2 = time.perf_counter()
    cpu = _nh_parity_run(torch.device("cpu"), f"{tag}pc")
    card = _nh_parity_run(dev, f"{tag}pg")
    for i, (a, b) in enumerate(zip(cpu, card)):
        for r, ((sa, ap_a, kv_a, ra), (sb, ap_b, kv_b, rb)) in enumerate(zip(a, b)):
            bad = convert.diff_leaves(sa, sb)
            check(not bad, f"card != CPU at round {i}, host {r + 1}: {bad}")
            check((ap_a, kv_a) == (ap_b, kv_b),
                  f"card != CPU SM at round {i}, host {r + 1}")
            check(ra[:4] == rb[:4], f"card != CPU reductions at round {i}, host {r + 1}")
            for da, db in zip(ra[4:], rb[4:]):
                check((da is None) == (db is None)
                      and (da is None or not convert.diff_leaves(da, db)),
                      f"card != CPU digests at round {i}, host {r + 1}")
    applied = max(x[1] for x in card[-1])
    check(applied > 0, "parity script applied nothing")
    probes = card[-1][0][3][3]
    check(probes > 0, "parity script took no reduction tick")
    say("nodehost_parity", rounds=NH_PARITY_ROUNDS, card_vs_cpu="equal",
        applied=applied, probe_ticks=probes, seconds=time.perf_counter() - t2)
    return k1


def compare_workers(torch, dev, rounds: int) -> int:
    """``python3 chip_smoke.py --compare-workers [ROUNDS]``: the NodeHost
    cell under the reference's EngineConfig and under one step worker, in
    turn, ROUNDS times each (2 unless given), one line per run.  Not part
    of the default run."""
    tag = f"cmp{time.monotonic_ns()}"
    for i, one in enumerate((False, True) * rounds):
        st = _nh_cell(torch, dev, f"{tag}-{i}", one_worker=one)
        st.pop("extra")
        say("nodehost_compare", run=i, **st)
        check(st["acked"] == NH_SHARDS * NH_WRITES, "not every write acknowledged")
    return 0


def compare_reductions(torch, dev, rounds: int) -> int:
    """``python3 chip_smoke.py --compare-reductions [ROUNDS]``: the
    NodeHost cell with the three reductions on (the default ExpertConfig)
    and off, in turn, ROUNDS times each (2 unless given), one line per
    run.  Not part of the default run."""
    tag = f"cmr{time.monotonic_ns()}"
    for i, on in enumerate((True, False) * rounds):
        st = _nh_cell(torch, dev, f"{tag}-{i}", reductions=on)
        st.pop("extra")
        say("nodehost_reductions_compare", run=i, **st)
        check(st["acked"] == NH_SHARDS * NH_WRITES, "not every write acknowledged")
        check((st["k1_probe_calls"] > 0) == on, "probe launches do not match the setting")
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
    if sys.argv[1:2] == ["--compare-reductions"]:
        return compare_reductions(torch, dev, int((sys.argv[2:] or ["2"])[0]))
    rows = phase_kernels(torch, dev)
    phase_parity(torch, dev)
    launches = phase_slice(torch, dev)
    phase_loops(torch, dev)
    phase_nodehost(torch, dev, device["nvidia_smi"])
    say("total", seconds=time.perf_counter() - t0)
    # one row per kernel: the numbers of the entry the main path launches
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": r["kernel"], "entry": r["name"], "launches": launches[r["kernel"]],
         **{k: r[k] for k in keys}}
        for r in rows if r["name"] in MAIN_PATH_ENTRIES]}))
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
