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
5. slice: first ``[graph_slice]``, the step graphed against eager (the
   compiled entries of ``dragonboat_tpu_torch.graphs`` replay one CUDA
   graph per geometry; ``graphs.eager()`` runs the eager bodies): from
   one elected 8192 x 3 device-SM state, GRAPH_STEPS ``full_step_sm``
   steps on each arm in lockstep with every state, box, table and output
   leaf equal after every step, one capture (taken under CUDA's sync
   debug mode "error"), K1/K2/K3 launches per graphed step counted
   through replays, step ms of both arms, torch.profiler's device-busy
   share and each kernel's in-graph device time, peak memory of both, and
   a latency-loop and a storm window graphed against eager.  Then 8192
   groups x 3 replicas with a 1024-slot DeviceKV per replica (graphed),
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
   sample of the inputs each call site gave it, and the host ms of the
   engine step's phases (staging, copy-in and replay, output pass)
   ``[nodehost]``; the same cell with the engines' eager bodies, its
   step p50/p90 beside the graphed cell's ``[nodehost_eager]``.  Then, on
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
8. mesh: the mesh serving path (``parallel/ici.py``, ``MeshDispatch``,
   ``MeshEngine``) at ``bench.py``'s ``run_mesh_pipeline_ab`` shape, 1024
   groups x 3 replicas on a (g=1, r=3) mesh with every position on the
   card: elect, then 30 self-driving ``ici_serve_step``s with an open cut
   mask on the card and, from the same state, on the CPU, every state,
   box and output leaf equal after every step; exactly 16 K1 launches (a
   CPU step's count at this geometry) and 1 K2 launch per serve step; K1
   and K2 against their plain arms on inputs tapped from those steps
   ``[mesh_parity]``.  The depth-0 against depth-1 A/B of
   ``run_mesh_pipeline_ab`` (non-donating against donating entry and
   their staging protocols, windows interleaved, median of 3 per arm;
   40 micro-steps a window, cut from bench.py's 120 for the time limit):
   micro-step ms and committed writes/s on leader rows ``[mesh_ab]``.
   The NodeHost mesh cell: three hosts share ``MeshSpec(g_size=1,
   replicas=3, n_local=1024)`` with ``Config(mesh_resident=True)`` over
   the chan transport and the reference's default ExpertConfig, on the
   engine's default grid (one device on a machine with fewer than 3
   cards); 1024
   shards x 3 replicas, 4 writes per shard, every write acknowledged and
   the last read back from all 3,072 replicas (then the same serve with
   the engine's eager bodies, ``[mesh_eager]``); the fabric census's p50
   commit host hops 0.0 and all six link classes ``resident``; K1 (step
   and invariant probe) and K2 launches counted exactly over the cell and
   tapped against their plain arms; then one link of shard 1 cut with
   ``set_link_hub_served`` (both directions ``hub``, a write still
   commits and reaches the cut follower) and healed (``resident`` again,
   another write commits) ``[mesh_nodehost]``; the same cell at
   kernel_pipeline_depth 1 with 64 shards (overlapped steps > 0)
   ``[mesh_depth1]``; phase 7's manual-drive script on a one-group mesh,
   card against CPU, every engine state leaf, reduction snapshot and
   replica equal after every round ``[mesh_nodehost_parity]``; K1's and
   K2's entries timed on the cell's inputs ``[mesh_kernel]``;
9. verify: the verification harnesses on the card.  The model checker
   (``dragonboat_tpu_torch.model_check``) at the fast scope on the card
   and on the CPU in this process: zero violations, the scope complete,
   the same states, transitions and digest of the explored set; K1
   launched exactly step calls x a CPU step's count at the scope's
   geometry and equal to its plain arm on tapped inputs; the double_vote
   mutation caught on the card; wall seconds of each run
   ``[verify_model_check]``.  ``run_schedule`` (``dragonboat_tpu_torch
   .chaos``) with seed 7 mesh-resident and, under ``--verify`` only, the
   reference's fast seeds 1, 7, 9, 13, 25 on device-resident shards at
   depth 0 and seed 1 at depth 1, each with the report ok,
   writes acknowledged, the plan equal to ``FaultPlan.generate``, K1
   launched (K2 too on the mesh) and both equal to their plain arms on
   tapped inputs ``[verify_chaos]``; the detector differential at seed 1
   ``[verify_detector]``; with ``--verify`` ``run_hotspot(11)``
   ``[verify_hotspot]``.  A live device-resident cluster serving the
   model checker's commit_without_quorum kernel trips
   ``leader_commit_quorum`` (violations seen, the flight recorder's edge,
   /healthz 503), and its engines' step EWMA is still above the
   reference's idle step, the reason every run of the runner here takes
   one time scale (x10) on its windows ``[verify_probe]``.  With
   ``--verify``: seed 7's plan (partition, kill, delay) on 1024
   device-resident shards x 3 (phase 7's cell; halved
   while a run takes over 180 s), 2 asynchronous writes a shard before
   the first fault and after the heal, every acknowledged write in the
   journals of all three replicas, the journals equal ``[verify_wide]``;
   K1's and K2's entries timed on the path's inputs ``[verify_kernel]``;
10. gossip_tcp: phase 7's cell (cut to GT_SHARDS = 512 device-resident
   shards x 3 for the time limit; the reference's default ExpertConfig,
   rtt 10 ms) on three NodeHosts over
   ``TCPTransportFactory()`` on loopback ports, replicas named by
   NodeHostID through gossip (each host's gossip seeded with the
   others'): every registry the gossip one and resolving every
   NodeHostID, every shard elected, every write acknowledged, the last
   read back from every replica and through the leader, the history of
   the writes and leader reads (``history.HistoryRecorder``)
   linearizable; elect s, writes/s, engine step p50/p90, K1 launches per
   engine step (exactly as many as a CPU step at the engine's geometry
   makes) and K1 against its plain arm on tapped inputs
   ``[gossip_tcp]``; then the lint driver's passes with their dynamic
   legs on the card, no cached verdict (RS005's model checker launching
   K1, the transfer leg under the CUDA sync guard, KC007 on card
   tensors): each pass's findings (all 0) and wall seconds ``[lint]``;
   K1's entry timed on the cell's inputs ``[gossip_tcp_kernel]``;
11. scale: ``scripts/scale_100k.py``'s two rungs on the port
   (``dragonboat_tpu_torch.scale_100k``) at their full width, never
   cut.  Phase A at SCALE_GROUPS = 100,000 groups x 3 (300,000 rows,
   ``bench_params(3)``, two calls of 5 steps): the rung's PHASE_A fields
   (predicted = measured bytes, one capture and no retrace, step ms), the
   capture's seconds, the peak device bytes through the capture and
   through the replays, exactly 16 K1 and 1 K2 launches a step, K1 and K2
   held bitwise against their plain arms on inputs tapped from the rung
   ([300000, 3]; six [300000, 10] fields by two [100000, 3, 3] lanes),
   then from the rung's final state one graphed step against one eager
   step, every leaf (the graph dropped first, so the card holds one
   arm's temporaries at a time) ``[scale_a]``.  Phase B at 100,000
   device-resident shards on one NodeHost (the default ExpertConfig with
   kernel_capacity 100,000, MemLogDB, a null state machine, auto_run off):
   every PHASE_B field (predicted = measured bytes, one capture and no
   retrace, 100,000 leaders, 1,000 proposals queued, committed_total =
   2 x shards + proposals), the engine step over the election pump, the
   host ms of the step's phases (the output pass), K1 exactly as many an
   engine step as a CPU step at the engine's geometry makes (21), plus
   the invariant probe's, held against its plain arm on tapped inputs,
   and no K2 ``[scale_b]``; the kernels' entries timed on the rungs'
   inputs ``[scale_kernel]``;
12. mesh_split: the split mesh (``parallel/ici.py`` with a device grid:
   each position's rows its own tensors on its own device), forced onto
   the one card, and on one card a position where the process sees at
   least ``g * r`` (``[mesh_split_devices]`` prints the count; a
   ``[mesh_split_cards]`` line says where separate cards were not run).
   Under ``--mesh`` first the transfer pass's guarded step loop (its
   split mesh on two cards where there are two) and the placement check
   (PS002) ``[mesh_split_guard]``; the default run leaves them to phase
   10's ``[lint]``.  Then at MESH_GROUPS groups on phase 8's (g=1, r=3)
   and the reference's (g=2, r=4) geometry: elect on the
   one-device mesh, then MESH_PARITY_STEPS serve steps (the last
   SPLIT_CUT_STEPS with one link cut at both ends) one device and split
   graphed in lockstep, at (g=1, r=3) the last SPLIT_EAGER_STEPS also
   split eager from the graphed arm's state, every state, box and output
   leaf equal after every step, every split piece on its position's
   device with its rows after every step, K1 (a step's count) and K2
   (one) launched exactly once per position a serve step and held
   against their plain arms on tapped inputs, then the micro-step ms of
   both layouts through ``serve_step`` (3 interleaved windows of
   SPLIT_AB_STEPS, medians; the seconds of the election, the lockstep
   and the windows apart) ``[mesh_split]``; then phase 8's NodeHost
   mesh cell on the split layout (every write acknowledged and read back
   from all replicas, the link cut and healed, launches counted per
   position) ``[mesh_split_nodehost]``; K1's and K2's entries timed on
   the cell's inputs ``[mesh_split_kernel]``;
13. ops: the membership and log-lifecycle operations on device- and
   mesh-resident shards.  ``dragonboat_tpu_torch.lockstep``'s drive
   (``auto_run=False``, the reference engine tests' geometry, the
   reductions on) with the port on the CPU against the port on the card:
   its KernelEngine script (a witness added after the leader lane's ring
   compacted and caught up through the stripped witness snapshot, a
   voter closed, a leader transfer, a snapshot request, a restart from
   tan directories) ``[ops_parity]`` and its mesh script on a (g=2, r=4)
   mesh (a follower read, a transfer, a snapshot, a restart, then a
   witness that escalates the group off the mesh and a restart that mesh
   admission refuses) ``[ops_parity_mesh]``, every engine state leaf,
   reduction snapshot, replica and witness log equal after every round.
   Then ``auto_run=True`` on the card: 2 device-resident voters and a
   host witness, 10 writes, the witness's log METADATA only, a voter
   closed, 5 writes committed without eviction, then the stripped
   witness snapshot after compaction ``[ops_witness]``; pipeline depth 1
   on tan directories: 30 writes, compaction, a restart with every write
   read back on every replica, the pending step context drained, then
   the reference's partition monkey, its history linearizable
   ``[ops_depth1]``; the (g=2, r=4) mesh on the one-device layout: a
   restart from disk, the witness escalation, the admission refusal on
   restart ``[ops_mesh]``; in every cell K1's launches exactly a CPU
   step's count per engine step (the card's steps alone where the CPU
   runs beside it), K1 (and in the mesh cells K2, once a serve step)
   bitwise equal to its plain arm on tapped inputs.  Then the three user
   examples (``dragonboat_tpu_torch.examples``) as subprocesses on the
   card, ``multigroup_device`` at its 32 shards ``[ops_examples]``; K1's
   and K2's entries timed on the cells' inputs ``[ops_kernel]``;
14. the ``kernels`` JSON line, one row per kernel with the numbers of the
   entry the main path launches (``path`` "slice": launches phase 5's;
   ``path`` "mesh": launches phase 8's NodeHost cell's; ``path``
   "verify": launches phase 9's; ``path`` "gossip_tcp": launches phase
   10's cell's; ``path`` "scale": launches phase 11's phase A; ``path``
   "scale_b": K1's launches in phase 11's phase B; ``path``
   "mesh_split": launches phase 12's NodeHost cell's; ``path`` "ops":
   K1's launches in phase 13's witness and depth-1 cells; ``path``
   "ops_mesh": launches phase 13's mesh cell's), then the final
   ``{"ok": true, ...}`` line.

Every number the run takes is printed on these lines.  Needs no network
and no JAX, and takes no arguments.  ``--compare-workers [ROUNDS]`` runs
only phases 1, 2 and the 1024 x 3 NodeHost cell, under the reference's
EngineConfig and under a single step worker, in turn, ROUNDS times each.
``--compare-reductions [ROUNDS]`` runs only phases 1, 2 and the same cell
with the three reductions on (the default ExpertConfig) and off, in turn,
ROUNDS times each.  ``--compare-turns [ROUNDS]`` runs only phases 1, 2 and
the same cell graphed with the engines' shared step lock and with a null
lock in its place, in turn, ROUNDS times each.  ``--mesh`` runs only
phases 1, 2, 8 and 12 (on a machine with ``g * r`` cards phase 12 runs
the split mesh on them too); ``--verify`` only phases 1, 2 and 9, with
every fast seed, the depth-1 schedule, the hotspot and the wide
schedule; ``--gossip [SHARDS]`` only phases 1, 2
and 10, its cell at SHARDS shards (GT_SHARDS unless given); ``--scale
[GROUPS]`` only phases 1, 2 and 11, at GROUPS (SCALE_GROUPS unless
given); ``--ops`` only phases 1, 2 and 13.
"""

from __future__ import annotations

import contextlib
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
# phase 5's eager-against-graphed check: lockstep steps per arm, timed
# steps per arm (two interleaved windows), profiled steps per arm, and the
# latency and storm windows
GRAPH_STEPS, GRAPH_TIMED, GRAPH_PROFILED, GRAPH_WINDOW = 20, 20, 3, 10
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
# phase 8, the mesh serving path at bench.py's run_mesh_pipeline_ab shape:
# 1024 groups x 3 replicas on a (g=1, r=3) mesh; serve steps card against
# CPU; the A/B's window cut from bench.py's 120 micro-steps to 40 for the
# script's time limit
MESH_GROUPS, MESH_PARITY_STEPS, MESH_AB_STEPS = 1024, 30, 40
MESH_ELECT_MAX, MESH_SETTLE, MESH_DEPTH1_SHARDS = 400, 6, 64
# phase 12, the split mesh at MESH_GROUPS groups: phase 8's (g=1, r=3)
# and the reference's 8-device (g=2, r=4); of phase 8's
# MESH_PARITY_STEPS serve steps, the last SPLIT_CUT_STEPS with one link
# cut at both ends; SPLIT_AB_STEPS micro-steps a timing window (phase 8
# takes MESH_AB_STEPS: at (2, 4) a split micro-step took 172-226 ms on
# an H100)
SPLIT_GEOMETRIES, SPLIT_CUT_STEPS, SPLIT_AB_STEPS = ((1, 3), (2, 4)), 10, 10
# the eager arm joins at SPLIT_EAGER_GEOMETRY (phase 8's and the NodeHost
# cell's) for the last SPLIT_EAGER_STEPS serve steps, from the graphed
# arm's state; it runs the same per-position bodies at (2, 4), where an
# eager serve step is 8 eager steps, for the script's time limit
SPLIT_EAGER_GEOMETRY, SPLIT_EAGER_STEPS = (1, 3), 10
# phase 9, the verification harnesses: the reference's chaos_fast seeds
# (--verify runs them at depth 0; it alone also runs the depth-1 and the
# wide schedules and the hotspot, for the time limit: with the depth-1
# and wide schedules in it the whole script took 1233.280934844 s on an
# H100, phase 9 392.875281027 s of it).  One scale for
# every wall-clock window of the runner (and the hotspot's host-hot
# threshold, 30 ms x the scale): the reference's windows and threshold
# are set for its compiled step, idle at 10-15 ms (REF_IDLE_STEP_US),
# and the port's eager engine step at the chaos cluster's geometry takes
# ~0.2 s on the card; the probe fails the phase once the idle step is
# down to the reference's, when the scale must go (ROADMAP item 17).
# Then the K1 tap stride in the model checker's batched steps, the
# probe's cluster seed, and the wide schedule: seed 7's plan at 1024
# shards x 3 (phase 7's cell), WIDE_WRITES writes a shard before the
# first fault and after the heal, a pause after each plan step, halved
# while over the limit
VERIFY_SEEDS = (1, 7, 9, 13, 25)
CHAOS_TIME_SCALE, REF_IDLE_STEP_US = 10.0, 15_000
MC_TAP_EVERY, PROBE_SEED, PROBE_IDLE_S = 23, 41, 8.0
WIDE_SHARDS, WIDE_WRITES, WIDE_SEED, WIDE_STEP_S, WIDE_LIMIT_S = 1024, 2, 7, 1.0, 180.0
# phase 10, phase 7's cell (device-resident shards x 3, the reference's
# default ExpertConfig, rtt 10 ms, NH_WRITES writes a shard) on three
# NodeHosts that name each other by NodeHostID through gossip, over the
# TCP transport on loopback ports; cut from phase 7's 1024 shards to 512
# for the script's time limit: on an H100 the cell took 19.9 s at 256
# shards, 55.9 s at 512 and 220.3 s at 1024 (engine step p50 160, 541
# and 1,252 ms, the output pass most of it: the hub flushes every
# message as its own TCP frame from the engine's thread)
GT_SHARDS = 512
# phase 11, the 100k-group capacity rungs of scripts/scale_100k.py on the
# port (dragonboat_tpu_torch.scale_100k) at their full width, never cut:
# phase A at SCALE_GROUPS x 3 with its SCALE_STEPS of 5 steps a timed call,
# phase B at SCALE_GROUPS device-resident shards on one NodeHost with its
# wave of proposals to shards 1-1000
SCALE_GROUPS, SCALE_A_STEPS, SCALE_WAVE = 100_000, 5, 1000
# phase 13, the membership and log-lifecycle operations: the lockstep
# drive's script seed of each case ((a) KernelEngine, (c) mesh), the
# witness cell's writes (the reference's 10 with the witness, 5 with a
# voter down, 60 before the stripped snapshot), the depth-1 cell's (the
# reference's 30), the monkey's least partition seconds and completed
# operations a window, and the multigroup example's shards (its
# default, the reference's 32)
OPS_SEEDS = {False: 3, True: 11}
OPS_WITNESS_WRITES, OPS_SOLO_WRITES, OPS_STRIP_WRITES = 10, 5, 60
OPS_D1_WRITES, OPS_MONKEY_S, OPS_MONKEY_OPS = 30, 2.0, 4
OPS_EXAMPLE_SHARDS = 32
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


def _k2_bytes(fields, lanes, outs) -> int:
    """Bytes gather_lanes_multi must move on these inputs: the lanes read
    and the outputs written once, and of each field only the elements the
    lanes pick, each distinct (row, column) once (the sentinel K picks
    nothing).  A route picks at most 6 of a row's 10 slots, so the whole
    fields are not what the function needs."""
    import torch

    N, Rt, Rs = lanes[0].shape
    K = fields[0].shape[1]
    dev = lanes[0].device
    row = (torch.arange(N, device=dev)[:, None, None] * Rs
           + torch.arange(Rs, device=dev)[None, None, :]).expand(N, Rt, Rs)
    keys = torch.cat([(row * K + lane.long())[(lane >= 0) & (lane < K)]
                      for lane in lanes])
    picked = int(torch.unique(keys).numel())
    return (picked * sum(f.element_size() for f in fields)
            + sum(t.numel() * t.element_size() for t in (*lanes, *outs)))


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
    nbytes = _k2_bytes(fields, lanes, got)
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

    _graph_slice(torch, dev)
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


def _same(torch, a, b) -> list[int]:
    """Indexes of the leaves of two trees that differ (value, dtype or
    shape), compared on the device; a different leaf count is [-1]."""
    from dragonboat_tpu_torch import graphs

    la, lb = graphs.leaves_of(a), graphs.leaves_of(b)
    if len(la) != len(lb):
        return [-1]
    return [i for i, (x, y) in enumerate(zip(la, lb))
            if x.dtype != y.dtype or not torch.equal(x, y)]


def _kernel_device_us(prof) -> dict:
    """Mean device us of each hand kernel's launches in a profile."""
    out = {}
    for ev in prof.key_averages():
        for name, key in (("quorum_match", "quorum"), ("gather_lanes", "gather_lanes"),
                          ("kv_apply", "kv_apply")):
            if key in ev.key and ev.count:
                t = getattr(ev, "self_device_time_total", None)
                if t is None:
                    t = getattr(ev, "self_cuda_time_total", 0)
                if t > 0:
                    out[name] = t / ev.count
    return out


def _graph_slice(torch, dev) -> dict:
    """Phase 5's step eager (``graphs.eager()``) against graphed: from one
    elected 8192 x 3 device-SM state, GRAPH_STEPS full_step_sm steps on
    each arm in lockstep, every state, box, table and output leaf equal
    after every step; one capture for the geometry (taken under CUDA's
    sync debug mode "error"); K1, K2 and K3 launches per graphed step
    counted through replays; step ms of each arm (interleaved windows),
    torch.profiler's device-busy share and each kernel's in-graph device
    time, peak memory of each arm; then a latency-loop and a storm window
    graphed against eager (the clock and the draw counter are graph
    inputs)."""
    from torch.profiler import ProfilerActivity, profile

    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch import graphs, kernels

    N, R, T = SLICE_GROUPS, REPLICAS, TABLE_CAP
    t0 = time.perf_counter()
    kp = bl.sm_params(R, dev)
    state, box = bl.elect_all(kp, R, bl.make_cluster(kp, N, R, device=dev))
    kv, kv_state = bl.make_device_sm(N, R, T, device=dev)
    entry = bl.full_step_sm
    arms = {a: graphs.fresh((state, box, kv_state)) for a in ("eager", "graphed")}
    launched = {a: dict.fromkeys(kernels.launches, 0) for a in arms}
    peak = {}
    bad = []

    def one(arm, strict=False):
        st, bx, kvs = arms[arm]
        torch.cuda.synchronize()
        kernels.reset_launches()
        with contextlib.ExitStack() as stack:
            if arm == "eager":
                stack.enter_context(graphs.eager())
            if strict:
                # the capture: any host sync in it raises
                torch.cuda.set_sync_debug_mode("error")
                stack.callback(torch.cuda.set_sync_debug_mode, "default")
            res = entry(kp, R, kv, st, bx, kvs, True, True)
        torch.cuda.synchronize()
        for k, v in kernels.launches.items():
            launched[arm][k] += v
        arms[arm] = res[:3]
        return res

    graphs.clear()
    calls, uncount = _count_steps(regraph=False)
    try:
        size0 = entry._cache_size()
        for i in range(GRAPH_STEPS):
            if i == 0:
                torch.cuda.reset_peak_memory_stats()
                g = one("graphed", strict=True)
                peak["capture"] = torch.cuda.max_memory_allocated()
            else:
                g = one("graphed")
            e = one("eager")
            diff = _same(torch, e, g)
            if diff:
                bad.append((i, diff[:6]))
        captures = entry._cache_size() - size0
        gl = dict(launched["graphed"])
    finally:
        uncount()
    steps_graphed = calls["step"] - GRAPH_STEPS
    ms = {"eager": [], "graphed": []}
    for _ in range(2):
        for arm in ("eager", "graphed"):
            torch.cuda.reset_peak_memory_stats()
            for _ in range(GRAPH_TIMED // 2):
                a = time.perf_counter()
                one(arm)
                ms[arm].append((time.perf_counter() - a) * 1e3)
            peak[arm] = max(peak.get(arm, 0), torch.cuda.max_memory_allocated())
    # device busy share: the profiler's device ms per step over the
    # unprofiled step ms of the timed windows (the profiler slows the
    # host, most of all the eager arm's ~10k launches a step)
    busy, kernel_us = {}, {}
    for arm in ("eager", "graphed"):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with prof:
            for _ in range(GRAPH_PROFILED):
                one(arm)
        dev_ms = _device_busy(prof)["device_busy_s"] * 1e3 / GRAPH_PROFILED
        busy[arm] = {"device_ms_per_step": dev_ms,
                     "busy_share": dev_ms / statistics.median(ms[arm])}
        kernel_us[arm] = _kernel_device_us(prof)
    # a latency window and a storm window: clock and draw counter in graph
    G = N * R
    lat_args = (kp, R, GRAPH_WINDOW, LOOP_WW, True, True, True, 3, state, box)
    with graphs.eager():
        lat_e = bl.run_steps_lat(*lat_args, *bl.lat_init(kp, G, device=dev))
    lat_g = bl.run_steps_lat(*lat_args, *bl.lat_init(kp, G, device=dev))
    storm_args = (kp, R, GRAPH_WINDOW, STORM_DROP, STORM_SEED, state, box)
    with graphs.eager():
        storm_e = bl.run_steps_storm(*storm_args)
    storm_g = bl.run_steps_storm(*storm_args)
    lat_bad, storm_bad = _same(torch, lat_e, lat_g), _same(torch, storm_e, storm_g)
    released = int(lat_g[3].sum())
    graphs.clear()
    per_step = _k1_calls_per_step(kp)
    out = {"groups": N, "replicas": R, "steps_each_arm": GRAPH_STEPS,
           "leaf_mismatches": json.dumps(bad[:4]), "captures": captures,
           "graphed_steps_counted": steps_graphed,
           "graphed_launches": json.dumps(gl, separators=(",", ":")),
           "k1_per_step": per_step,
           "eager_step_ms": statistics.median(ms["eager"]),
           "graphed_step_ms": statistics.median(ms["graphed"]),
           "eager_over_graphed": statistics.median(ms["eager"])
           / statistics.median(ms["graphed"]),
           "step_ms_windows": json.dumps({a: [round(x, 3) for x in v]
                                          for a, v in ms.items()}),
           "eager_device_ms_per_step": busy["eager"]["device_ms_per_step"],
           "graphed_device_ms_per_step": busy["graphed"]["device_ms_per_step"],
           "eager_busy_share": busy["eager"]["busy_share"],
           "graphed_busy_share": busy["graphed"]["busy_share"],
           "kernel_device_us": json.dumps(kernel_us, separators=(",", ":")),
           "eager_peak_bytes": peak["eager"], "graphed_peak_bytes": peak["graphed"],
           "capture_peak_bytes": peak["capture"],
           "latency_window_steps": GRAPH_WINDOW, "latency_released": released,
           "latency_leaf_mismatches": json.dumps(lat_bad),
           "storm_window_steps": GRAPH_WINDOW,
           "storm_leaf_mismatches": json.dumps(storm_bad),
           "seconds": time.perf_counter() - t0}
    say("graph_slice", **out)
    check(not bad, f"graph_slice: graphed != eager at steps {bad[:4]}")
    check(captures == 1, f"graph_slice: {captures} captures for one geometry")
    check(steps_graphed == GRAPH_STEPS, f"graph_slice: {steps_graphed} graphed steps counted")
    check(gl["quorum_match"] == per_step * GRAPH_STEPS
          and gl["gather_lanes"] == K2_PER_ROUTE * GRAPH_STEPS
          and gl["kv_apply"] == GRAPH_STEPS,
          f"graph_slice: launches {gl} over {GRAPH_STEPS} replays")
    check(not lat_bad and released > 0, f"graph_slice: latency window differs {lat_bad}")
    check(not storm_bad, f"graph_slice: storm window differs {storm_bad}")
    return out


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


def _count_calls(module, attr: str, counts: dict, thread: int | None = None,
                 regraph: bool = True, cuda_only: bool = False):
    """Count the calls of ``module.attr`` (a function its callers look up
    there) in ``counts[attr]``, only those made in ``thread`` when one is
    given, only those on card tensors with ``cuda_only``; returns the
    function that takes the counter out.  A call inside a compiled
    entry's graph counts at every replay (``graphs.tally``).  With
    ``regraph`` the module-level graphs are dropped when the counter goes
    in and when it comes out, so the graphs replayed in between are
    captured with it."""
    import threading

    from dragonboat_tpu_torch import graphs

    orig = getattr(module, attr)
    counts[attr] = 0

    def bump():
        counts[attr] += 1

    def counted(*args, **kw):
        if ((thread is None or threading.get_ident() == thread)
                and (not cuda_only or _on_card(args))):
            graphs.tally(bump)
        return orig(*args, **kw)

    if regraph:
        graphs.clear()
    setattr(module, attr, counted)

    def undo():
        setattr(module, attr, orig)
        if regraph:
            graphs.clear()

    return undo


def _count_steps(regraph: bool = True):
    """Count the steps and routes the bench loops call (``bench_loop``'s
    ``step`` and ``route``); returns the live counts and the function that
    takes the counters out."""
    from dragonboat_tpu_torch import bench_loop as bl

    counts: dict = {}
    undo = [_count_calls(bl, attr, counts, regraph=regraph)
            for attr in ("step", "route")]
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
    uncount = _count_calls(K, "commit_quorum", counts, threading.get_ident(),
                           regraph=False)
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
              reductions=True, metrics=False, mesh=False, mesh_devices=None,
              **expert):
    """Three NodeHosts over the chan transport with ``shards``
    device-resident shards x 3 replicas; the reference's ExpertConfig
    (the reductions on unless ``reductions`` is False) and EngineConfig
    (unless ``one_worker`` asks for a single step worker).  ``mesh``
    places the shards on one shared MeshEngine instead, a (g=1, r=3)
    mesh of ``shards`` groups (``MeshSpec``, ``mesh_resident``), its
    positions on ``mesh_devices`` (the engine's default grid unless
    given)."""
    from dragonboat_tpu_torch.config import (
        Config,
        EngineConfig,
        ExpertConfig,
        MeshSpec,
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
        if mesh:
            expert["mesh"] = MeshSpec(name=tag, g_size=1, replicas=3,
                                      n_local=shards)
        ex = ExpertConfig(kernel_pipeline_depth=depth, **expert)
        hosts[r] = NodeHost(NodeHostConfig(raft_address=addr,
                                           rtt_millisecond=10, expert=ex,
                                           enable_metrics=metrics),
                            auto_run=auto_run, device=dev,
                            mesh_devices=mesh_devices)
    for sid in range(1, shards + 1):
        for r, nh in hosts.items():
            nh.start_replica(addrs, False, _kv_sm, Config(
                shard_id=sid, replica_id=r, election_rtt=10, heartbeat_rtt=1,
                device_resident=not mesh, mesh_resident=mesh))
    return hosts


def _nh_engines(hosts) -> list:
    """The hosts' device engines, each once (mesh hosts share one)."""
    out = []
    for nh in hosts.values():
        eng = nh.kernel_engine or nh.mesh_engine
        if all(eng is not e for e in out):
            out.append(eng)
    return out


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


def _nh_serve(hosts, shards, deadline_s=300.0, history=None) -> dict:
    """Elect every shard, write NH_WRITES values per shard asynchronously,
    wait for every acknowledgement, read the last value back from every
    replica and through the leader on a sample.  ``history`` (a
    ``history.HistoryRecorder``) records every write attempt and every
    read through the leader, one register per shard."""
    from dragonboat_tpu_torch.request import RequestResultCode

    t0 = time.perf_counter()
    leaders = {}
    while len(leaders) < shards:
        check(time.perf_counter() - t0 < deadline_s,
              f"only {len(leaders)} of {shards} shards elected a leader")
        time.sleep(0.2)
        leaders = _nh_leaders(hosts, shards)
    elect_s = time.perf_counter() - t0
    timers = [eng._step_timer.samples for eng in _nh_engines(hosts)]
    check(all(len(t) < t.maxlen for t in timers), "step timer ring wrapped")
    marks = [len(t) for t in timers]

    ops = {}

    def send_write(sid, w):
        nh = hosts[leaders[sid]]
        if history is not None:
            ops[(sid, w)] = history.invoke(leaders[sid], "write", str(sid),
                                           f"{sid}.{w}")
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
                if history is not None:
                    history.complete(ops[key])
                acked += 1
                continue
            check(r.code == RequestResultCode.DROPPED,
                  f"write {key} ended {r.code.name}")
            if history is not None:
                history.fail(ops[key])
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
    read_ops = {sid: history.invoke(leaders[sid], "read", str(sid))
                for sid in sample} if history is not None else {}
    reads = {sid: hosts[leaders[sid]].read_index(sid, 60) for sid in sample}
    for sid, rs in reads.items():
        rs.get(60)
        got = hosts[leaders[sid]].read_local_node(sid, "w")
        if history is not None:
            history.complete(read_ops[sid], got)
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


def _on_card(args) -> bool:
    """Whether a call's arguments hold a tensor on the card."""
    return any(getattr(t, "is_cuda", False) for t in _flat(args))


def _tap(module, attr: str, every: int, cuda_only: bool = False):
    """Route ``module.attr``, a kernel wrapper as a call site imported it
    (K1's ``commit_quorum`` in core/kernel and ``quorum_match`` in
    core/invariants, K2's ``gather_lanes_multi`` in core/router), through a
    tap that counts every call and clones the inputs of every
    ``every``-th call (up to TAP_KEEP) before it launches; returns the
    tap's record and the function that takes the tap out (``cuda_only``:
    calls on CPU tensors pass untapped and uncounted).  In a graph the
    call's inputs are copied inside the graph, and every replay counts
    the call and clones that copy when its turn comes; the module-level
    graphs are dropped when the tap goes in and when it comes out."""
    from dragonboat_tpu_torch import graphs

    orig, rec = getattr(module, attr), {"calls": 0, "inputs": []}

    def record(args):
        rec["calls"] += 1
        if (rec["calls"] - 1) % every == 0 and len(rec["inputs"]) < TAP_KEEP:
            rec["inputs"].append(_clone(args))

    def tap(*args):
        if cuda_only and not _on_card(args):
            return orig(*args)
        held = _clone(args) if graphs.capturing() else args
        graphs.tally(lambda: record(held))
        return orig(*args)

    graphs.clear()
    setattr(module, attr, tap)

    def untap():
        setattr(module, attr, orig)
        graphs.clear()

    return rec, untap


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


SPANS = ("kernel_engine.stage", "kernel_engine.step",
         "kernel_engine.process_outputs")


def _time_spans(store: dict):
    """Time the engines' step phases: every ``annotate`` range of
    KernelEngine.step_all (staging; copy-in and replay or the eager step;
    the output pass), host ms of each into ``store``; returns the
    function that takes the timer out."""
    import contextlib

    from dragonboat_tpu_torch.engine import kernel_engine as ke

    orig = ke.annotate

    @contextlib.contextmanager
    def timed(name):
        t = time.perf_counter()
        try:
            with orig(name):
                yield
        finally:
            store.setdefault(name, []).append((time.perf_counter() - t) * 1e3)

    ke.annotate = timed
    return lambda: setattr(ke, "annotate", orig)


def _span_stats(store: dict) -> dict:
    """Per step phase (staging; the step: copy-in and replay, or the eager
    body; the output pass): calls, median and mean host ms."""
    out = {}
    for name, short in zip(SPANS, ("stage", "dispatch", "outputs")):
        ms = store.get(name, [])
        out[f"{short}_calls"] = len(ms)
        out[f"{short}_host_ms_p50"] = float(np.percentile(ms, 50)) if ms else None
        out[f"{short}_host_ms_mean"] = float(np.mean(ms)) if ms else None
    return out


class _NullLock:
    """KernelEngine._step_mu's stand-in for a run without the engines'
    turns (``--compare-turns``)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


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
        # the serial engine's staged inbox is a host array (the
        # reductions upload it, as the reference's jit does)
        inbox = torch.as_tensor(eng._fleet_inbox_from(), device=eng.device)
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
    spans: dict = {}
    unspan = _time_spans(spans)
    t0 = time.perf_counter()
    try:
        rounds = [_nh_write_round(hosts, leaders, f"p{i}") for i in range(3)]
        writes, acked = (sum(x) for x in zip(*rounds))
    finally:
        unspan()
        del eng.step_all
        KernelEngine._step_mu = step_mu
    wall = sum(walls)
    out = {"writes": writes, "acked": acked,
           "split_window_s": time.perf_counter() - t0,
           "split_steps": len(walls), "step_wall_s": wall,
           "step_lock_wait_s": sum(waits), "step_thread_cpu_s": sum(cpus),
           "step_other_wait_s": wall - sum(waits) - sum(cpus),
           **{f"graphed_{k}": v for k, v in _span_stats(spans).items()}}

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
    """Close the hosts and wait for every engine and step-worker thread
    of theirs to end: ``close()`` joins each for at most 5 s, and a
    thread still inside a step would land that step's kernel calls in the
    next cell's counts (its step counter is the old cell's, its K1 tap
    the new one's)."""
    for nh in hosts.values():
        nh.close()
    threads = [t for nh in hosts.values()
               for t in (nh._engine_thread, *nh._workers) if t is not None]
    deadline = time.monotonic() + 120.0
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    check(not alive, f"host threads still running 120 s after close: {alive}")


def _reduction_snapshots(eng) -> tuple:
    """An engine's reduction results and digests, as host values."""
    digests = tuple(None if d is None else _struct_np(d)
                    for d in (eng._health_digest, eng._inv_digest))
    return (eng.last_fleet, eng.last_health, eng.last_invariants,
            eng._inv_seq) + digests


def _snapshots_equal(ra, rb, where) -> None:
    """Two ``_reduction_snapshots`` equal: results and digests."""
    from dragonboat_tpu_torch import convert

    check(ra[:4] == rb[:4], f"card != CPU reductions at {where}")
    for da, db in zip(ra[4:], rb[4:]):
        check((da is None) == (db is None)
              and (da is None or not convert.diff_leaves(da, db)),
              f"card != CPU digests at {where}")


def _nh_parity_run(dev, tag, mesh=False) -> list:
    """One manual-drive script (auto_run=False, one shard, the reference
    engine tests' geometry; ``mesh``: on a one-group mesh) on ``dev``:
    per round, every host's engine state and every replica's (applied
    index, contents)."""
    import itertools

    from dragonboat_tpu_torch import convert
    from dragonboat_tpu_torch import request as req

    # restart the process-wide request counters: the ReadIndex ctx each
    # run stages lands in the device state
    req.PendingProposal._seq = itertools.count(1)
    req.PendingReadIndex._ctx = itertools.count(1)
    hosts = _nh_hosts(tag, 1, dev, auto_run=False, mesh=mesh,
                      kernel_log_cap=256, kernel_capacity=8,
                      kernel_apply_batch=16, kernel_compaction_overhead=16)
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
            trace.append([(convert.to_numpy(eng._dispatch.join(eng.state)),
                           nh.nodes[1].sm.get_last_applied(),
                           dict(nh.nodes[1].sm.sm.kv),
                           _reduction_snapshots(eng))
                          for nh in hosts.values()
                          for eng in [nh.kernel_engine or nh.mesh_engine]])
    finally:
        _nh_close(hosts)
    return trace


def _nh_cell(torch, dev, tag, one_worker=False, reductions=True,
             full=False, eager=False, turns=True) -> dict:
    """The NodeHost cell at NH_SHARDS x 3: admit, elect, write, read
    back; launch counts (split into K1's call sites), peak memory, the
    decimated ticks' and the step phases' host ms over it alone.
    ``full`` adds, after the counts are read, the K1 taps' comparison, the
    endpoint checks, the reductions card against CPU, their cost alone
    and the profile.  ``eager`` runs the engines' eager bodies
    (``graphs.eager()``); ``turns=False`` swaps the engines' shared step
    lock for a null lock."""
    from dragonboat_tpu_torch import graphs

    with contextlib.ExitStack() as stack:
        if eager:
            stack.enter_context(graphs.eager())
        if not turns:
            stack.enter_context(_step_lock(_NullLock()))
        out = _nh_cell_run(torch, dev, tag, one_worker, reductions, full)
    out.update(steps="eager" if eager else "graphed",
               turns="shared step lock" if turns else "none")
    return out


@contextlib.contextmanager
def _step_lock(lock):
    from dragonboat_tpu_torch.engine.kernel_engine import KernelEngine

    saved = KernelEngine._step_mu
    KernelEngine._step_mu = lock
    try:
        yield
    finally:
        KernelEngine._step_mu = saved


def _nh_cell_run(torch, dev, tag, one_worker, reductions, full) -> dict:
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
    spans: dict = {}
    unspan = _time_spans(spans)

    def restore():
        untap_step()
        untap_probe()
        for u in uncount:
            u()
        untime()
        unspan()

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
                span_stats = _span_stats(spans)
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
            "admit_s": admit_s, **st, **tick_stats, **span_stats,
            "k1_launches": launches["quorum_match"],
            "k1_step_calls": calls[0], "k1_probe_calls": calls[1],
            "engine_steps": calls[2], "k1_per_engine_step": k1_per_step,
            "launches": json.dumps(launches, separators=(",", ":")),
            "max_memory_allocated": peak, "extra": extra,
            "seconds": time.perf_counter() - t0}


def _nh_parity(torch, dev, tag, mesh=False) -> dict:
    """The manual-drive script on the CPU and on the card: every engine
    state leaf, every reduction snapshot and every replica's applied
    index and contents equal after every round."""
    from dragonboat_tpu_torch import convert

    t2 = time.perf_counter()
    cpu = _nh_parity_run(torch.device("cpu"), f"{tag}pc", mesh)
    card = _nh_parity_run(dev, f"{tag}pg", mesh)
    for i, (a, b) in enumerate(zip(cpu, card)):
        for r, ((sa, ap_a, kv_a, ra), (sb, ap_b, kv_b, rb)) in enumerate(zip(a, b)):
            bad = convert.diff_leaves(sa, sb)
            check(not bad, f"card != CPU at round {i}, host {r + 1}: {bad}")
            check((ap_a, kv_a) == (ap_b, kv_b),
                  f"card != CPU SM at round {i}, host {r + 1}")
            _snapshots_equal(ra, rb, f"round {i}, host {r + 1}")
    applied = max(x[1] for x in card[-1])
    check(applied > 0, "parity script applied nothing")
    probes = card[-1][0][3][3]
    check(probes > 0, "parity script took no reduction tick")
    return {"rounds": NH_PARITY_ROUNDS, "card_vs_cpu": "equal", "applied": applied,
            "probe_ticks": probes, "seconds": time.perf_counter() - t2}


def phase_nodehost(torch, dev, smi: str) -> int:
    tag = f"smk{time.monotonic_ns()}"
    st = _nh_cell(torch, dev, tag, full=True)
    extra = st.pop("extra")
    say("nodehost", shards=NH_SHARDS, replicas=3, hosts=3, **st, **extra["k1"],
        card=json.dumps(smi))
    say("nodehost_endpoints", **extra["endpoints"])
    say("nodehost_reductions", card_vs_cpu="equal", **extra["reductions"])
    say("nodehost_reduction_cost", **extra["cost"], card=json.dumps(smi))
    prof = extra["profile"]
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

    # the same cell with the engines' eager bodies, in this call
    ea = _nh_cell(torch, dev, f"{tag}e", eager=True)
    ea.pop("extra")
    say("nodehost_eager", shards=NH_SHARDS, replicas=3, hosts=3, **ea,
        graphed_step_ms_p50=st["step_ms_p50"], graphed_step_ms_p90=st["step_ms_p90"],
        card=json.dumps(smi))
    check(ea["acked"] == NH_SHARDS * NH_WRITES, "eager cell: not every write acknowledged")
    check(ea["k1_step_calls"] == ea["k1_per_engine_step"] * ea["engine_steps"],
          "eager cell: K1 launches are not 21 an engine step")
    # the host ms of the engine step's phases: the graphed cell's profile
    # rounds, and the whole eager cell
    prof.update({f"eager_{k}": ea[k] for k in _span_stats({})})
    say("nodehost_profile", **{k: json.dumps(v) if isinstance(v, list) else v
                               for k, v in prof.items()})

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

    say("nodehost_parity", **_nh_parity(torch, dev, tag))
    return k1


# ---------------------------------------------------------------------------
# phase 8: the mesh serving path (parallel/ici.py, MeshDispatch, MeshEngine)
# ---------------------------------------------------------------------------


def _mesh_cluster(torch, dev):
    """The reference bench's mesh shape on ``dev``: bench_params(3),
    MESH_GROUPS groups on a (g=1, r=3) mesh, every position on ``dev``."""
    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch.parallel import ici

    kp = bl.bench_params(REPLICAS, dev)
    cl, st, box = ici.make_ici_cluster(kp, 1, REPLICAS, MESH_GROUPS, device=dev)
    cut = torch.zeros((cl.total_rows, kp.num_peers), dtype=torch.bool, device=dev)
    return kp, cl, st, box, cut


def _mesh_leaders(torch, cl, st) -> int:
    """Groups with a leader in a whole state; block-major rows: replica
    ir of group ig * n_local + n is row (ig * R + ir) * n_local + n."""
    from dragonboat_tpu_torch.core import params as KP

    lead = (st.role == KP.LEADER).reshape(cl.g_size, cl.replicas, cl.n_local)
    return int(lead.any(dim=1).sum())


def _mesh_elect(torch, kp, cl, st, box, cut):
    """Serve steps without proposals until every group has a leader,
    then MESH_SETTLE more; returns state, box and the steps taken."""
    from dragonboat_tpu_torch.parallel import ici

    n = 0
    while _mesh_leaders(torch, cl, st) < cl.num_groups:
        check(n < MESH_ELECT_MAX, f"mesh: {_mesh_leaders(torch, cl, st)} of "
              f"{cl.num_groups} groups elected in {n} steps")
        st, box, _ = ici.ici_serve_step(
            cl, st, box, ici.self_driving_input(kp, st, propose=False), cut)
        n += 1
    for _ in range(MESH_SETTLE):
        st, box, _ = ici.ici_serve_step(
            cl, st, box, ici.self_driving_input(kp, st, propose=False), cut)
    return st, box, n + MESH_SETTLE


def _to_cpu(x):
    return type(x)(*[None if v is None else v.cpu() for v in x])


def _clone_tree(x):
    return type(x)(*[None if v is None else v.clone() for v in x])


def _mesh_parity(torch, dev) -> dict:
    """(a) and (d): elect on the card, then MESH_PARITY_STEPS
    self-driving serve steps with an open mask on the card (launches
    counted, K1 and K2 tapped) and from the same state on the CPU;
    every state, box and output leaf equal after every step; the taps
    against the plain arms."""
    from dragonboat_tpu_torch import kernels
    from dragonboat_tpu_torch.core import kernel as K
    from dragonboat_tpu_torch.core import router
    from dragonboat_tpu_torch.parallel import ici

    t0 = time.perf_counter()
    kp, cl, st, box, cut = _mesh_cluster(torch, dev)
    st, box, elect_steps = _mesh_elect(torch, kp, cl, st, box, cut)
    torch.cuda.synchronize()
    elect_s = time.perf_counter() - t0
    st_c, box_c = _to_cpu(st), _to_cpu(box)
    kp_c, cl_c, _, _, _ = _mesh_cluster(torch, torch.device("cpu"))
    cut_c = cut.cpu()
    card = []
    k1, untap1 = _tap(K, "commit_quorum", LOOP_TAP_EVERY)
    k2, untap2 = _tap(router, "gather_lanes_multi", 2)
    counts: dict = {}
    uncount = _count_calls(ici, "_exchange", counts)
    torch.cuda.synchronize()
    kernels.reset_launches()
    try:
        for _ in range(MESH_PARITY_STEPS):
            st, box, out = ici.ici_serve_step(
                cl, st, box, ici.self_driving_input(kp, st), cut)
            card.append(_leaves("", (st, box, out)))
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    finally:
        untap1()
        untap2()
        uncount()
    for i, ref in enumerate(card):
        st_c, box_c, out_c = ici.ici_serve_step(
            cl_c, st_c, box_c, ici.self_driving_input(kp_c, st_c), cut_c)
        bad = _leaf_diff(torch, ref, _leaves("", (st_c, box_c, out_c)))
        check(not bad, f"mesh: card != CPU at serve step {i}: {bad[:6]}")
    per_step = _k1_calls_per_step(kp)
    steps = MESH_PARITY_STEPS
    check(counts["_exchange"] == steps, f"mesh: {counts['_exchange']} exchanges")
    check(launches["quorum_match"] == per_step * steps,
          f"mesh: {launches['quorum_match']} K1 launches in {steps} serve "
          f"steps, not {per_step} a step")
    check(launches["gather_lanes"] == K2_PER_ROUTE * steps,
          f"mesh: {launches['gather_lanes']} K2 launches in {steps} serve steps")
    check(launches["kv_apply"] == 0, "mesh: kv_apply launched off its path")
    held = {**_tapped(torch, k1["inputs"], "k1_held", "commit_quorum"),
            **_tapped(torch, k2["inputs"], "k2_held", "gather_lanes_multi")}
    for k in ("k1_held", "k2_held"):
        check(held[f"{k}_mismatches"] == 0,
              f"mesh: {k[:2].upper()} differs from its plain arm on the serve steps")
    committed = int(st.committed.max())
    check(committed > 0, "mesh parity run committed nothing")
    return {"groups": MESH_GROUPS, "replicas": REPLICAS, "rows": cl.total_rows,
            "elect_steps": elect_steps, "elect_s": elect_s,
            "serve_steps": steps, "card_vs_cpu": "equal",
            "k1_per_step": per_step,
            "launches": json.dumps(launches, separators=(",", ":")),
            **held, "seconds": time.perf_counter() - t0,
            "_state": (kp, cl, st, box, cut)}


def _mesh_ab(torch, kp, cl, st0, box0, cut) -> dict:
    """(b) bench.py's run_mesh_pipeline_ab on the port: the depth-0
    protocol (stage from the current state, blocking fetch, non-donating
    entry) against the depth-1 protocol (stage from one-step-stale host
    copies, pull the next copies right before dispatch, donating entry),
    MESH_AB_STEPS micro-steps a window, windows interleaved, median of 3
    per arm after one warm window each."""
    from dragonboat_tpu_torch.core import params as KP
    from dragonboat_tpu_torch.core.kstate import StepInput
    from dragonboat_tpu_torch.parallel import ici

    B, dev = kp.proposal_cap, cl.device
    lead_rows = st0.role == KP.LEADER

    def host_input(role_h, proc_h):
        G = role_h.shape[0]
        z = lambda: np.zeros((G,), np.int32)  # noqa: E731
        lead = role_h == KP.LEADER
        inp = StepInput(
            prop_valid=np.broadcast_to(lead[:, None], (G, B)).copy(),
            prop_cc=np.zeros((G, B), bool), ri_valid=np.zeros((G,), bool),
            ri_low=z(), ri_high=z(), transfer_to=z(),
            tick=np.ones((G,), bool), quiesced=np.zeros((G,), bool),
            applied=proc_h)
        return cl.shard(inp)

    def committed(st):
        return int(torch.where(lead_rows, st.committed.to(torch.int64), 0).sum())

    arms = {a: {"state": _clone_tree(st0), "box": _clone_tree(box0)}
            for a in ("serial", "pipelined")}

    def window(arm):
        a = arms[arm]
        c0 = committed(a["state"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if arm == "serial":
            for _ in range(MESH_AB_STEPS):
                inp = host_input(a["state"].role.cpu().numpy(),
                                 a["state"].processed.cpu().numpy())
                a["state"], a["box"], _ = ici.serve_step(
                    kp, cl, a["state"], a["box"], inp, cut)
        else:
            role_h = a["state"].role.cpu().numpy()
            proc_h = a["state"].processed.cpu().numpy()
            for _ in range(MESH_AB_STEPS):
                inp = host_input(role_h, proc_h)
                role_h = a["state"].role.cpu().numpy()
                proc_h = a["state"].processed.cpu().numpy()
                a["state"], a["box"], _ = ici.serve_step_donated(
                    kp, cl, a["state"], a["box"], inp, cut)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        w = committed(a["state"]) - c0
        return {"wall_s": dt, "micro_step_ms": dt / MESH_AB_STEPS * 1e3,
                "writes": w, "writes_per_s": w / dt}

    for arm in arms:
        window(arm)
    wins = {"serial": [], "pipelined": []}
    for _ in range(3):
        for arm in ("serial", "pipelined"):
            wins[arm].append(window(arm))
    med = {arm: sorted(ws, key=lambda r: r["micro_step_ms"])[1]
           for arm, ws in wins.items()}
    for arm in arms:
        check(med[arm]["writes"] > 0, f"mesh A/B: the {arm} arm committed nothing")
    return {"micro_steps_per_window": MESH_AB_STEPS,
            "micro_steps_of_bench": f"{MESH_AB_STEPS}/120",
            "serial_micro_step_ms": med["serial"]["micro_step_ms"],
            "serial_writes_per_s": med["serial"]["writes_per_s"],
            "pipelined_micro_step_ms": med["pipelined"]["micro_step_ms"],
            "pipelined_writes_per_s": med["pipelined"]["writes_per_s"],
            "windows": json.dumps({a: [round(w["micro_step_ms"], 3) for w in ws]
                                   for a, ws in wins.items()})}


def _mesh_link_cut(hosts) -> dict:
    """Cut one link of shard 1 with set_link_hub_served: both directions
    turn hub, a write still commits and reaches the cut follower; after
    healing both turn resident again and another write commits."""
    from dragonboat_tpu_torch import fabric
    from dragonboat_tpu_torch.request import RequestDroppedError, RequestTimeoutError

    def write(cmd, deadline=60.0):
        end = time.perf_counter() + deadline
        while True:
            lid = _nh_leaders(hosts, 1).get(1)
            try:
                if lid:
                    nh = hosts[lid]
                    return nh.sync_propose(nh.get_noop_session(1), cmd, timeout_s=10)
            except (RequestDroppedError, RequestTimeoutError):
                pass
            check(time.perf_counter() < end, f"mesh cut: {cmd!r} never committed")
            time.sleep(0.1)

    def classes(a, b):
        lc = fabric.METER.snapshot()["link_classes"]
        return lc.get(f"{a}->{b}"), lc.get(f"{b}->{a}")

    t0 = time.perf_counter()
    lid = _nh_leaders(hosts, 1)[1]
    frid = next(r for r in hosts if r != lid)
    eng = hosts[lid].mesh_engine
    lnode = eng.by_shard[(1, lid)]
    book = eng._link_class_book(lnode)
    la, fa = book[lid], book[frid]
    eng.set_link_hub_served(lnode, frid, True)
    cut_classes = classes(la, fa)
    check(cut_classes == ("hub", "hub"), f"mesh cut: link classes {cut_classes}")
    write(b"cut=1")
    end = time.perf_counter() + 60
    while hosts[frid].stale_read(1, "cut") != "1":
        check(time.perf_counter() < end, "mesh cut: the cut follower never applied")
        time.sleep(0.05)
    eng.set_link_hub_served(lnode, frid, False)
    healed = classes(la, fa)
    check(healed == ("resident", "resident"), f"mesh heal: link classes {healed}")
    write(b"heal=1")
    return {"cut_link": f"{la}<->{fa}", "cut_classes": "hub,hub",
            "healed_classes": "resident,resident",
            "cut_seconds": time.perf_counter() - t0}


def _mesh_cell(torch, dev, tag, mesh_devices=None) -> dict:
    """(c) The NodeHost mesh cell: three hosts share MeshSpec(g_size=1,
    replicas=3, n_local=MESH_GROUPS), mesh_resident shards, the
    reference's default ExpertConfig, the positions on ``mesh_devices``
    (the engine's default grid unless given); elect, NH_WRITES writes per
    shard, every write acknowledged, the last one read back from every
    replica; the census and the link classes; launches counted over the
    cell (a serve step steps and routes once per position: once on one
    device) and K1/K2 tapped; then the link cut."""
    from dragonboat_tpu_torch import fabric, kernels
    from dragonboat_tpu_torch.core import invariants as inv
    from dragonboat_tpu_torch.core import kernel as K
    from dragonboat_tpu_torch.core import router
    from dragonboat_tpu_torch.parallel import ici

    t0 = time.perf_counter()
    # the fabric meter is process-wide: phase 7's hub commits must not
    # count in this cell's hop census
    fabric.METER.reset()
    torch.cuda.synchronize()
    kernels.reset_launches()
    step_tap, untap_step = _tap(K, "commit_quorum", K1_TAP_EVERY)
    probe_tap, untap_probe = _tap(inv, "quorum_match", 1)
    route_tap, untap_route = _tap(router, "gather_lanes_multi", 7)
    counts: dict = {}
    uncount = [_count_calls(ici, attr, counts) for attr in ("step", "route")]

    def restore():
        untap_step()
        untap_probe()
        untap_route()
        for u in uncount:
            u()

    try:
        hosts = _nh_hosts(tag, MESH_GROUPS, dev, mesh=True,
                          mesh_devices=mesh_devices)
        admit_s = time.perf_counter() - t0
        try:
            try:
                st = _nh_serve(hosts, MESH_GROUPS)
                # between two engine steps: a serve step counts its
                # positions' steps, then their routes
                with hosts[1].mesh_engine.mu:
                    torch.cuda.synchronize()
                    launches = dict(kernels.launches)
                    calls = (step_tap["calls"], probe_tap["calls"],
                             route_tap["calls"], counts["step"],
                             counts["route"])
            finally:
                restore()
            eng = hosts[1].mesh_engine
            positions = eng.cluster.positions
            grid = eng.cluster.devices
            check(all(nh.mesh_engine is eng for nh in hosts.values()),
                  "mesh cell: the hosts do not share one engine")
            check(all(nh.kernel_engine is None for nh in hosts.values()),
                  "mesh cell: a kernel engine was built")
            fab = hosts[1].info()["fabric"]
            hops = fab["census"]["p50_commit_host_hops"]
            lc = fab["link_classes"]
            k1_per_step = _k1_calls_per_step(eng.kp)
            inv_seen = eng.last_invariants
            cut = _mesh_link_cut(hosts)
        finally:
            c0 = time.perf_counter()
            _nh_close(hosts)
            close_s = time.perf_counter() - c0
    finally:
        restore()
    check(st["acked"] == MESH_GROUPS * NH_WRITES, "mesh cell: not every write acknowledged")
    check(hops == 0.0, f"mesh cell: p50 commit host hops {hops}")
    check(len(lc) == 6 and set(lc.values()) == {fabric.LINK_CLASS_RESIDENT},
          f"mesh cell: link classes {lc}")
    check(inv_seen is not None and inv_seen["violations_seen"] == 0,
          f"mesh cell: invariant probe {inv_seen}")
    step_calls, probe_calls, route_calls, steps, routes = calls
    # one device: one step and one route a serve step; split: one each
    # per position
    per = positions if grid is not None else 1
    exchanges = routes // per
    check(routes > 0 and route_calls == routes and steps == routes
          and routes == exchanges * per,
          f"mesh cell: {route_calls} K2 calls, {routes} routes, {steps} "
          f"steps on {per} position(s) a serve step")
    check(step_calls == k1_per_step * steps,
          f"mesh cell: {step_calls} K1 step launches in {steps} steps, "
          f"not {k1_per_step} a step")
    check(probe_calls > 0, "mesh cell: the invariant probe never launched K1")
    check(launches["quorum_match"] == step_calls + probe_calls,
          "mesh cell: K1's launches are not the step's and the probe's")
    check(launches["gather_lanes"] == K2_PER_ROUTE * routes,
          f"mesh cell: {launches['gather_lanes']} K2 launches in {routes} routes")
    check(launches["kv_apply"] == 0, "mesh cell: kv_apply launched off its path")
    held = {**_tapped(torch, step_tap["inputs"], "k1_tapped", "commit_quorum"),
            **_tapped(torch, probe_tap["inputs"], "k1_probe_tapped"),
            **_tapped(torch, route_tap["inputs"], "k2_tapped", "gather_lanes_multi")}
    for key in ("k1_tapped", "k1_probe_tapped", "k2_tapped"):
        check(held[f"{key}_mismatches"] == 0, f"mesh cell: {key} differs from its plain arm")
    return {"shards": MESH_GROUPS, "replicas": 3, "hosts": 3, "admit_s": admit_s,
            **st, "p50_commit_host_hops": hops, "link_classes": len(lc),
            "layout": _layout(grid), "serve_steps": exchanges,
            "k1_per_serve_step": k1_per_step * per,
            "k2_per_serve_step": K2_PER_ROUTE * per,
            "k1_step_launches": step_calls, "k1_probe_launches": probe_calls,
            "launches": json.dumps(launches, separators=(",", ":")),
            **held, **cut, "close_s": close_s, "seconds": time.perf_counter() - t0,
            "_taps": (step_tap["inputs"], route_tap["inputs"]),
            "_launches": launches}


def _mesh_depth1(dev, tag) -> dict:
    """The mesh cell at kernel_pipeline_depth 1 with MESH_DEPTH1_SHARDS
    shards: every write acknowledged and read back, overlapped steps > 0,
    no invariant violation."""
    t0 = time.perf_counter()
    hosts = _nh_hosts(tag, MESH_DEPTH1_SHARDS, dev, depth=1, mesh=True)
    try:
        st = _nh_serve(hosts, MESH_DEPTH1_SHARDS)
        eng = hosts[1].mesh_engine
        overlapped = eng.events.metrics.snapshot().get(
            "engine.pipeline.overlapped", 0)
        inv = eng.last_invariants
    finally:
        _nh_close(hosts)
    check(st["acked"] == MESH_DEPTH1_SHARDS * NH_WRITES,
          "mesh depth 1: not every write acknowledged")
    check(eng.pipeline_depth == 1 and overlapped > 0, "mesh depth 1: no step overlapped")
    check(inv is not None and inv["violations_seen"] == 0,
          f"mesh depth 1: invariant probe {inv}")
    return {"shards": MESH_DEPTH1_SHARDS, **st, "overlapped": overlapped,
            "violations_seen": inv["violations_seen"],
            "seconds": time.perf_counter() - t0}


def _mesh_eager(dev, tag) -> dict:
    """The mesh NodeHost cell's serve (elect, NH_WRITES writes a shard,
    read back) with the engine's eager bodies (``graphs.eager()``): engine
    step p50/p90 and the step phases' host ms."""
    from dragonboat_tpu_torch import graphs

    t0 = time.perf_counter()
    spans: dict = {}
    unspan = _time_spans(spans)
    try:
        with graphs.eager():
            hosts = _nh_hosts(tag, MESH_GROUPS, dev, mesh=True)
            try:
                st = _nh_serve(hosts, MESH_GROUPS)
            finally:
                _nh_close(hosts)
    finally:
        unspan()
    check(st["acked"] == MESH_GROUPS * NH_WRITES,
          "mesh eager cell: not every write acknowledged")
    return {"shards": MESH_GROUPS, "steps": "eager", **st, **_span_stats(spans),
            "seconds": time.perf_counter() - t0}


def _k1_row(torch, k1_inputs, launches, path: str) -> dict:
    """The kernels line's K1 row for a path: commit_quorum on the inputs
    the path gave it (the last tap), timed against its plain arm, with
    the path's launches."""
    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    match, kind = k1_inputs[-1]
    G, P = match.shape
    got, ref = fk.commit_quorum(match, kind), fk.commit_quorum_plain(match, kind)
    b_ms, b_by = bound(_commit_bytes(G, P), _commit_ops(G, P))
    return {"name": "commit_quorum", "kernel": "quorum_match", "route": "cuda",
            "source": "dragonboat_tpu_torch/csrc/quorum_match.cu",
            "replaces": "dragonboat_tpu/parallel/fabric_pallas.py:177",
            "path": path, "shape": f"match [{G}, {P}] i32, kind [{G}, {P}] i32",
            "launches": launches["quorum_match"],
            "max_abs_err": max_abs_err(torch, got, ref),
            "bound_ms": b_ms, "bound_by": b_by,
            **_times(torch, lambda: fk.commit_quorum(match, kind),
                     lambda: fk.commit_quorum_plain(match, kind), None)}


def _mesh_rows(torch, k1_inputs, k2_inputs, launches,
               path: str = "mesh") -> list[dict]:
    """The kernels line's rows for a path (the mesh cell's by default):
    K1's commit_quorum and K2's gather_lanes_multi on the inputs the path
    gave them (the last tap of each), timed against their plain arms,
    with the path's launches."""
    from dragonboat_tpu_torch.parallel import fabric_kernels as fk

    k1 = _k1_row(torch, k1_inputs, launches, path)
    fields, lanes = k2_inputs[-1]
    got = _flat(fk.gather_lanes_multi(fields, lanes))
    ref = _flat(fk.gather_lanes_multi_plain(fields, lanes))
    nbytes = _k2_bytes(fields, lanes, got)
    N, Rt, Rs = lanes[0].shape
    b_ms, b_by = bound(nbytes, N * Rt * Rs * len(lanes) * (2 + 2 * len(fields)))
    k2 = {"name": "gather_lanes_multi", "kernel": "gather_lanes", "route": "cuda",
          "source": "dragonboat_tpu_torch/csrc/gather_lanes.cu",
          "replaces": "dragonboat_tpu/parallel/fabric_pallas.py:101",
          "path": path,
          "shape": f"{len(fields)} fields [{fields[0].shape[0]}, {fields[0].shape[1]}], "
                   f"{len(lanes)} lanes [{N}, {Rt}, {Rs}] i32",
          "launches": launches["gather_lanes"],
          "max_abs_err": max(max_abs_err(torch, a, b) for a, b in zip(got, ref)),
          "bound_ms": b_ms, "bound_by": b_by,
          **_times(torch, lambda: fk.gather_lanes_multi(fields, lanes),
                   lambda: fk.gather_lanes_multi_plain(fields, lanes), None)}
    for r in (k1, k2):
        check(r["max_abs_err"] == 0, f"{path}: {r['name']} differs from its plain arm")
    return [k1, k2]


def phase_mesh(torch, dev, smi: str) -> list[dict]:
    """Phase 8: the mesh serving path at the reference bench's mesh shape,
    1024 groups x 3 replicas on a (g=1, r=3) mesh, every position on the
    card.  Returns the kernels line's mesh rows."""
    t0 = time.perf_counter()
    par = _mesh_parity(torch, dev)
    kp, cl, st, box, cut = par.pop("_state")
    say("mesh_parity", **par, card=json.dumps(smi))
    ab = _mesh_ab(torch, kp, cl, st, box, cut)
    say("mesh_ab", groups=MESH_GROUPS, replicas=REPLICAS, mesh="(g=1, r=3)",
        **ab, card=json.dumps(smi))
    del st, box
    cell = _mesh_cell(torch, dev, f"msh{time.monotonic_ns()}")
    taps, launches = cell.pop("_taps"), cell.pop("_launches")
    say("mesh_nodehost", **cell, card=json.dumps(smi))
    ea = _mesh_eager(dev, f"msh{time.monotonic_ns()}e")
    say("mesh_eager", **ea, graphed_step_ms_p50=cell["step_ms_p50"],
        graphed_step_ms_p90=cell["step_ms_p90"], card=json.dumps(smi))
    d1 = _mesh_depth1(dev, f"msh{time.monotonic_ns()}d1")
    say("mesh_depth1", **d1)
    say("mesh_nodehost_parity", mesh="(g=1, r=3), one group",
        **_nh_parity(torch, dev, f"msh{time.monotonic_ns()}", mesh=True))
    rows = _mesh_rows(torch, *taps, launches)
    for r in rows:
        say("mesh_kernel", **{k: v for k, v in r.items() if k != "timing"},
            timing=json.dumps(r["timing"]))
    say("mesh_total", seconds=time.perf_counter() - t0)
    return rows


# ---------------------------------------------------------------------------
# phase 12: the split mesh (each position's rows its own tensors)
# ---------------------------------------------------------------------------


def _layout(grid) -> str:
    """A mesh's placement as printed: one device, or its grid."""
    if grid is None:
        return "one device"
    names = [str(d) for d in grid]
    if len(set(names)) == 1:
        return f"split, {len(names)} positions on {names[0]}"
    return "split, " + ",".join(names)


def _split_grids(torch, dev, positions: int) -> list:
    """The grids phase 12 runs a geometry on: every position on the one
    card, then one card a position where the process sees enough."""
    grids = [(dev,) * positions]
    if torch.cuda.device_count() >= positions:
        grids.append(tuple(torch.device("cuda", i) for i in range(positions)))
    return grids


def _split_masks(torch, cl, dev):
    """The open cut mask and one with the link between replica 1 and
    replica R of the last group cut at both ends."""
    R, n = cl.replicas, cl.n_local
    open_ = torch.zeros((cl.total_rows, cl.kp.num_peers), dtype=torch.bool,
                        device=dev)
    link = open_.clone()
    ig, g = divmod(cl.num_groups - 1, n)
    link[(ig * R) * n + g, R - 1] = True
    link[(ig * R + R - 1) * n + g, 0] = True
    return open_, link


def _split_parity(torch, dev, g_size: int, replicas: int, grid) -> dict:
    """One geometry at MESH_GROUPS groups: elect on the one-device mesh,
    then MESH_PARITY_STEPS self-driving serve steps (the last
    SPLIT_CUT_STEPS with one link cut at both ends) on three arms in
    lockstep: one device (graphed), split on ``grid`` (graphed) and, at
    SPLIT_EAGER_GEOMETRY for the last SPLIT_EAGER_STEPS from the graphed
    arm's state, split eager (``graphs.eager()``).  Every state, box and
    output leaf equal after every step, the placement check after every
    split step, the graphed split arm's K1 and K2 launches counted
    exactly (a position's step and route each), K1 and K2 tapped against
    their plain arms; then micro-step ms of both layouts (``serve_step``,
    its graphs captured again by one step each), SPLIT_AB_STEPS a
    window, windows interleaved, median of 3; the seconds of the
    election, the lockstep and the windows."""
    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch import graphs, kernels
    from dragonboat_tpu_torch.analysis import partition
    from dragonboat_tpu_torch.core import kernel as K
    from dragonboat_tpu_torch.core import router
    from dragonboat_tpu_torch.parallel import ici

    t0 = time.perf_counter()
    P = g_size * replicas
    kp = bl.bench_params(replicas, dev)
    cl, st, box = ici.make_ici_cluster(kp, g_size, replicas, MESH_GROUPS,
                                       device=dev)
    scl, _, _ = ici.make_ici_cluster(kp, g_size, replicas, MESH_GROUPS,
                                     devices=grid)
    open_, link = _split_masks(torch, cl, dev)
    s_open, s_link = scl.shard(open_), scl.shard(link)
    st, box, elect_steps = _mesh_elect(torch, kp, cl, st, box, open_)
    elect_s = time.perf_counter() - t0
    eager_steps = (SPLIT_EAGER_STEPS
                   if (g_size, replicas) == SPLIT_EAGER_GEOMETRY else 0)
    arms = {"graphed": (scl.shard(st), scl.shard(box))}
    k1, untap1 = _tap(K, "commit_quorum", LOOP_TAP_EVERY)
    k2, untap2 = _tap(router, "gather_lanes_multi", 7)
    counts: dict = {}
    uncount = [_count_calls(ici, attr, counts) for attr in ("step", "route")]
    launches: dict = {}
    calls = {"step": 0, "route": 0}

    def split_step(arm, cut):
        s, b = arms[arm]
        s, b, o = ici.ici_serve_step(scl, s, b, ici.self_driving_input(kp, s),
                                     cut)
        arms[arm] = (s, b)
        check(partition.placement_check(
            scl, ShardState=s, Inbox=b, StepOutput=o) == [],
            f"mesh split {g_size}x{replicas}: a piece off its position")
        return _leaves("", (scl.gather(s), scl.gather(b), scl.gather(o)))

    try:
        for i in range(MESH_PARITY_STEPS):
            cut, s_cut = ((open_, s_open)
                          if i < MESH_PARITY_STEPS - SPLIT_CUT_STEPS
                          else (link, s_link))
            st, box, out = ici.ici_serve_step(
                cl, st, box, ici.self_driving_input(kp, st), cut)
            want = _leaves("", (st, box, out))
            l0, c0 = dict(kernels.launches), dict(counts)
            got = split_step("graphed", s_cut)
            for k, v in kernels.launches.items():
                launches[k] = launches.get(k, 0) + v - l0.get(k, 0)
            for k in calls:
                calls[k] += counts[k] - c0[k]
            bad = _leaf_diff(torch, want, got)
            check(not bad, f"mesh split {g_size}x{replicas}: split != one "
                  f"device at serve step {i}: {bad[:6]}")
            if i < MESH_PARITY_STEPS - eager_steps:
                # non-donating: the graphed arm's results are fresh
                arms["eager"] = arms["graphed"]
                continue
            with graphs.eager():
                eager = split_step("eager", s_cut)
            bad = _leaf_diff(torch, got, eager)
            check(not bad, f"mesh split {g_size}x{replicas}: eager != graphed "
                  f"at serve step {i}: {bad[:6]}")
    finally:
        untap1()
        untap2()
        for u in uncount:
            u()
    steps = MESH_PARITY_STEPS
    per_step = _k1_calls_per_step(kp)
    check(calls["step"] == P * steps and calls["route"] == P * steps,
          f"mesh split {g_size}x{replicas}: {calls} in {steps} serve steps "
          f"of {P} positions")
    check(launches.get("quorum_match", 0) == per_step * P * steps,
          f"mesh split {g_size}x{replicas}: {launches.get('quorum_match')} K1 "
          f"launches in {steps} serve steps, not {per_step} x {P} a step")
    check(launches.get("gather_lanes", 0) == K2_PER_ROUTE * P * steps,
          f"mesh split {g_size}x{replicas}: {launches.get('gather_lanes')} K2 "
          f"launches in {steps} serve steps, not {P} a step")
    check(launches.get("kv_apply", 0) == 0,
          f"mesh split {g_size}x{replicas}: kv_apply launched off its path")
    held = {**_tapped(torch, k1["inputs"], "k1_held", "commit_quorum"),
            **_tapped(torch, k2["inputs"], "k2_held", "gather_lanes_multi")}
    for k in ("k1_held", "k2_held"):
        check(held[f"{k}_mismatches"] == 0, f"mesh split {g_size}x{replicas}: "
              f"{k[:2].upper()} differs from its plain arm")
    check(int(st.committed.max()) > 0, f"mesh split {g_size}x{replicas}: "
          "nothing committed")
    lockstep_s = time.perf_counter() - t0 - elect_s

    # micro-step ms, one device against split, through the serving entry
    # the lockstep ran (the taps' removal dropped its graphs: one step
    # of each layout captures them again before the windows)
    timed = {"one_device": (cl, st, box, link), "split": (scl, *arms["graphed"],
                                                        s_link)}

    def window(layout, steps=SPLIT_AB_STEPS):
        c, s, b, cut = timed[layout]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            s, b, _ = ici.serve_step(
                kp, c, s, b, ici.self_driving_input(kp, s), cut)
        torch.cuda.synchronize()
        timed[layout] = (c, s, b, cut)
        return (time.perf_counter() - t) / steps * 1e3

    t1 = time.perf_counter()
    for layout in timed:
        window(layout, 1)
    wins = {"one_device": [], "split": []}
    for _ in range(3):
        for layout in wins:
            wins[layout].append(window(layout))
    ms = {k: statistics.median(v) for k, v in wins.items()}
    windows_s = time.perf_counter() - t1
    graphs.clear()
    return {"geometry": f"(g={g_size}, r={replicas})", "groups": MESH_GROUPS,
            "positions": P, "rows": cl.total_rows,
            "layout": _layout(scl.devices),
            "elect_steps": elect_steps, "serve_steps": steps,
            "link_cut_steps": SPLIT_CUT_STEPS,
            "split_vs_one_device": "equal",
            "eager_vs_graphed": "equal" if eager_steps else "not run",
            "eager_steps": eager_steps,
            "placement_checks": steps + eager_steps,
            "k1_per_serve_step": per_step * P,
            "k2_per_serve_step": K2_PER_ROUTE * P,
            "launches": json.dumps(launches, separators=(",", ":")), **held,
            "one_device_micro_step_ms": ms["one_device"],
            "split_micro_step_ms": ms["split"],
            "split_over_one_device": ms["split"] / ms["one_device"],
            "micro_steps_per_window": SPLIT_AB_STEPS,
            "windows": json.dumps({k: [round(x, 3) for x in v]
                                   for k, v in wins.items()}),
            "elect_s": elect_s, "lockstep_s": lockstep_s,
            "windows_s": windows_s, "seconds": time.perf_counter() - t0}


def phase_mesh_split(torch, dev, smi: str, guard: bool = True) -> list[dict]:
    """Phase 12: the split mesh, forced onto the one card (and on one
    card a position where the process sees enough): with ``guard`` the
    transfer and placement legs first (the default run leaves them to
    phase 10's ``[lint]``, which runs the same legs), the serve step at
    SPLIT_GEOMETRIES against the one-device mesh, then phase 8's NodeHost
    mesh cell on the split layout.  Returns the kernels line's mesh_split
    rows."""
    from dragonboat_tpu_torch.analysis import __main__ as lint
    from dragonboat_tpu_torch.analysis import partition, transfer

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    say("mesh_split_devices", device_count=cards,
        separate_cards=json.dumps([f"(g={g}, r={r})" for g, r in
                                   SPLIT_GEOMETRIES if cards >= g * r]))
    if guard:
        # the transfer leg's four geometries under the CUDA sync guard
        # (its split mesh on two cards where the process sees two: the
        # peer copies must not sync), and the placement check (PS002) on
        # each grid
        found = transfer.live_transfer_check(lint.ROOT, use_cache=False,
                                             device=dev)
        found += partition.dynamic_check(dev)
        if cards >= 2:
            found += partition.dynamic_check(
                dev, devices=[torch.device("cuda", i) for i in range(2)])
        say("mesh_split_guard", findings=len(found),
            split_leg="two cards" if cards >= 2 else "one card",
            seconds=time.perf_counter() - t0)
        check(not found, f"mesh split: {[f.format() for f in found][:4]}")
    for g, r in SPLIT_GEOMETRIES:
        for grid in _split_grids(torch, dev, g * r):
            say("mesh_split", **_split_parity(torch, dev, g, r, grid),
                card=json.dumps(smi))
        if cards < g * r:
            say("mesh_split_cards", geometry=f"(g={g}, r={r})", run="no",
                reason=f"the process sees {cards} card(s), the mesh has "
                       f"{g * r} positions")
    rows = None
    for grid in _split_grids(torch, dev, 3):
        cell = _mesh_cell(torch, dev, f"mss{time.monotonic_ns()}",
                          mesh_devices=list(grid))
        taps, launches = cell.pop("_taps"), cell.pop("_launches")
        say("mesh_split_nodehost", **cell, card=json.dumps(smi))
        if rows is None:
            rows = _mesh_rows(torch, *taps, launches, path="mesh_split")
    if cards < 3:
        say("mesh_split_cards", geometry="NodeHost (g=1, r=3)", run="no",
            reason=f"the process sees {cards} card(s), the mesh has 3 "
                   "positions")
    for r in rows:
        say("mesh_split_kernel", **{k: v for k, v in r.items() if k != "timing"},
            timing=json.dumps(r["timing"]))
    say("mesh_split_total", seconds=time.perf_counter() - t0)
    return rows


# ---------------------------------------------------------------------------
# phase 9: the verification harnesses (model checker, chaos runner, probe)
# ---------------------------------------------------------------------------


def _counted(torch, fn, total: dict):
    """``fn()`` with every launch counted over it alone, added to
    ``total``."""
    from dragonboat_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    for k, v in kernels.launches.items():
        total[k] = total.get(k, 0) + v
    return out


def _verify_model_check(torch, dev) -> tuple[dict, list]:
    """The fast scope on the card and on the CPU in this process: zero
    violations, the same explored set; K1 launched exactly step calls x
    the per-step count and equal to its plain arm on tapped inputs; the
    double_vote mutation caught on the card.  Returns the line and the
    K1 taps."""
    from dragonboat_tpu_torch import model_check as mc
    from dragonboat_tpu_torch.core import kernel as K

    launches: dict = {}
    tap, untap = _tap(K, "commit_quorum", MC_TAP_EVERY)
    try:
        t0 = time.perf_counter()
        card = mc.ModelChecker(scope="fast", device=dev)
        res = _counted(torch, card.run, launches)
        card_s = time.perf_counter() - t0
    finally:
        untap()
    per_step = _k1_calls_per_step(card.kp)
    t1 = time.perf_counter()
    cpu = mc.ModelChecker(scope="fast", device="cpu")
    ref = cpu.run()
    cpu_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    mut = mc.run_scope("fast", mutation="double_vote", device=dev)
    mut_s = time.perf_counter() - t2
    held = _tapped(torch, tap["inputs"], "k1_held", "commit_quorum")
    out = {"scope": "fast", "states": res["states_explored"],
           "transitions": res["transitions"], "step_calls": res["step_calls"],
           "violations": len(res["violations"]),
           "scope_complete": res["scope_complete"],
           "seen_digest": card.seen_digest(), "cpu_seen_digest": cpu.seen_digest(),
           "card_s": card_s, "cpu_s": cpu_s,
           "k1_launches": launches["quorum_match"], "k1_per_step": per_step,
           "k1_calls": tap["calls"], **held,
           "double_vote_violations": len(mut["violations"]),
           "double_vote_properties": json.dumps(sorted(
               {v["property"] for v in mut["violations"]})),
           "double_vote_s": mut_s}
    check(res["violations"] == [] and res["scope_complete"],
          f"model check: violations on the card {res['violations'][:3]}")
    check((res["states_explored"], res["transitions"], card.seen_digest())
          == (ref["states_explored"], ref["transitions"], cpu.seen_digest()),
          "model check: the card's explored set differs from the CPU's")
    check(launches["quorum_match"] == res["step_calls"] * per_step
          == tap["calls"],
          f"model check: {launches['quorum_match']} K1 launches, "
          f"{tap['calls']} calls, in {res['step_calls']} steps of {per_step}")
    check(held["k1_held_mismatches"] == 0,
          "model check: K1 differs from its plain arm")
    check(any(v["property"] == "invariant:vote_once_per_term"
              for v in mut["violations"]),
          "model check: double_vote escaped the fast scope on the card")
    return out, tap["inputs"]


def _verify_schedule(torch, dev, seed: int, **kw) -> tuple[dict, dict]:
    """One run_schedule on the card with K1 and K2 tapped and every
    launch counted over the run alone."""
    from dragonboat_tpu_torch.chaos import FaultPlan, run_schedule
    from dragonboat_tpu_torch.core import kernel as K
    from dragonboat_tpu_torch.core import router

    launches: dict = {}
    k1, untap1 = _tap(K, "commit_quorum", K1_TAP_EVERY)
    k2, untap2 = _tap(router, "gather_lanes_multi", 7)
    try:
        t0 = time.perf_counter()
        r = _counted(torch, lambda: run_schedule(seed, device=dev, **kw), launches)
        secs = time.perf_counter() - t0
    finally:
        untap1()
        untap2()
    mesh = kw.get("mesh_resident", False)
    path = ("mesh" if mesh else
            f"device_resident depth {kw.get('pipeline_depth', 0)}")
    out = {"seed": seed, "path": path, "time_scale": kw.get("time_scale", 1.0),
           "writes_per_plan_step": kw.get("proposals_per_step", 4),
           "ok": r.report.ok, "failures": json.dumps(r.report.failures),
           "acked": r.acked_count, "seconds": secs,
           "plan_equal": r.plan_json == FaultPlan.generate(
               seed, n_replicas=3, steps=6).to_json(),
           "k1_launches": launches["quorum_match"],
           "k2_launches": launches["gather_lanes"],
           "violations_seen": r.report.invariant_probe.get("violations_seen")}
    out.update(_tapped(torch, k1["inputs"], "k1_held", "commit_quorum"))
    if mesh:
        out.update(_tapped(torch, k2["inputs"], "k2_held", "gather_lanes_multi"))
    say("verify_chaos", **out)
    check(r.report.ok, f"chaos seed {seed} ({path}): {r.report.failures}")
    check(r.acked_count > 0, f"chaos seed {seed} ({path}): nothing acknowledged")
    check(out["plan_equal"], f"chaos seed {seed}: plan differs from FaultPlan.generate")
    check(launches["quorum_match"] > 0, f"chaos seed {seed} ({path}): K1 never launched")
    check(out["k1_held_mismatches"] == 0, f"chaos seed {seed}: K1 differs from its plain arm")
    if mesh:
        check(launches["gather_lanes"] > 0, f"chaos seed {seed} (mesh): K2 never launched")
        check(out["k2_held_mismatches"] == 0, f"chaos seed {seed}: K2 differs from its plain arm")
    return launches, {"k1": k1["inputs"], "k2": k2["inputs"]}


def _verify_chaos(torch, dev, full: bool) -> tuple[dict, dict]:
    """[verify_chaos]: with ``full`` the fast seeds on device-resident
    shards at depth 0 and seed 1 at depth 1; always seed 7 mesh-resident
    and the detector differential; with ``full`` run_hotspot(11).
    Returns the summed launches and the last taps of K1 (an engine's) and
    K2 (the mesh route's)."""
    from dragonboat_tpu_torch.chaos import run_detector_differential, run_hotspot

    total: dict = {}
    taps = {}
    runs = [(7, dict(mesh_resident=True, time_scale=CHAOS_TIME_SCALE))]
    if full:
        runs = ([(seed, dict(device_resident=True, time_scale=CHAOS_TIME_SCALE))
                 for seed in VERIFY_SEEDS]
                + [(1, dict(device_resident=True, pipeline_depth=1,
                            time_scale=CHAOS_TIME_SCALE))] + runs)
    for seed, kw in runs:
        launches, t = _verify_schedule(torch, dev, seed, **kw)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        taps["k1"] = t["k1"]
        if kw.get("mesh_resident"):
            taps["k2"] = t["k2"]
    t0 = time.perf_counter()
    d = _counted(torch, lambda: run_detector_differential(
        1, device=dev, time_scale=CHAOS_TIME_SCALE), total)
    say("verify_detector", seed=1, fault=d.fault, anomaly_class=d.anomaly_class,
        raised=d.raised, cleared=d.cleared,
        differential_checks=d.differential_checks,
        failures=json.dumps(d.failures), seconds=time.perf_counter() - t0)
    check(d.ok and d.raised and d.cleared and d.differential_checks >= 2,
          f"detector differential: {d.failures}")
    if full:
        t0 = time.perf_counter()
        h = _counted(torch, lambda: run_hotspot(
            11, device=dev, time_scale=CHAOS_TIME_SCALE), total)
        say("verify_hotspot", seed=11, time_scale=CHAOS_TIME_SCALE, ok=h.ok,
            hot_shard=h.hot_shard, initial_leader=h.initial_leader,
            final_leader=h.final_leader, transfers=len(h.transfers),
            acked=h.acked_count, failures=json.dumps(h.report.failures),
            seconds=time.perf_counter() - t0)
        check(h.ok, f"hotspot: {h.report.failures}")
    return total, taps


def _verify_probe(torch, dev) -> dict:
    """[verify_probe]: a live device-resident cluster serving the model
    checker's commit_without_quorum kernel trips leader_commit_quorum:
    violations_seen, the flight recorder's edge, /healthz 503."""
    from dragonboat_tpu_torch import flight
    from dragonboat_tpu_torch.chaos import runner
    from dragonboat_tpu_torch.engine import kernel_engine as ke
    from dragonboat_tpu_torch.model_check import load_kernel_module
    from dragonboat_tpu_torch.server.metrics_http import MetricsServer

    t0 = time.perf_counter()
    mut = load_kernel_module("commit_without_quorum")
    saved = ke.kernel_step, ke.kernel_step_donated
    cluster = runner._Cluster(
        seed=PROBE_SEED, n=3, device_resident=True, device=dev,
        time_scale=CHAOS_TIME_SCALE,
        expert_overrides=dict(kernel_capacity=8, kernel_apply_batch=16,
                              kernel_compaction_overhead=16,
                              fleet_stats_every=1))
    # the engine binds these module globals at construction time
    ke.kernel_step, ke.kernel_step_donated = mut.step, mut.step_donated
    try:
        cluster.start()
        ke.kernel_step, ke.kernel_step_donated = saved
        seq0 = flight.RECORDER.next_seq
        deadline = time.perf_counter() + 120.0
        i, seen = 0, {}
        while time.perf_counter() < deadline:
            cluster.propose(f"m{i}=x".encode(), timeout=4.0)
            i += 1
            seen = {rid: cluster.hosts[rid]._invariants_snapshot()
                    for rid in cluster.live_rids()}
            if any(v["violations_seen"] for v in seen.values()):
                break
        rid, snap = max(seen.items(), key=lambda kv: kv[1]["violations_seen"])
        nh = cluster.hosts[rid]

        def ewmas():
            return [int(cluster.hosts[r].events.metrics.snapshot().get(
                "engine.kernel_step.ewma_us", 0)) for r in cluster.live_rids()]

        # the engine step's latency EWMA on each host, at the load of
        # one write at a time (CHAOS_TIME_SCALE's reason), then after
        # PROBE_IDLE_S of idle ticking, when the first steps' captures
        # have decayed out of it
        ewma = ewmas()
        idle0 = [len(cluster.hosts[r].kernel_engine._step_timer.samples)
                 for r in cluster.live_rids()]
        time.sleep(PROBE_IDLE_S)
        idle_ewma = ewmas()
        idle_steps = [len(cluster.hosts[r].kernel_engine._step_timer.samples) - n
                      for r, n in zip(cluster.live_rids(), idle0)]
        idle_ms = [x / 1e3 for r in cluster.live_rids()
                   for x in list(cluster.hosts[r].kernel_engine._step_timer.samples)[-10:]]
        edges = [r for r in flight.RECORDER.tail(512)
                 if r.get("kind") == flight.INVARIANT_VIOLATION and r["seq"] >= seq0]
        server = MetricsServer([nh.events.metrics.registry],
                               invariants_source=nh._invariants_snapshot)
        try:
            status, body, _ = server.healthz()
        finally:
            server.close()
    finally:
        ke.kernel_step, ke.kernel_step_donated = saved
        cluster.close()
    tripped = sorted({n for r in edges for n in r.get("invariants", [])})
    out = {"mutation": "commit_without_quorum", "proposals": i,
           "violations_seen": snap["violations_seen"],
           "flight_edges": len(edges), "tripped": json.dumps(tripped),
           "healthz": status, "step_ewma_us": json.dumps(ewma),
           "idle_s": PROBE_IDLE_S, "idle_steps": json.dumps(idle_steps),
           "idle_step_ewma_us": json.dumps(idle_ewma),
           "idle_step_ms_p50": float(np.percentile(idle_ms, 50)),
           "ref_idle_step_us": REF_IDLE_STEP_US,
           "seconds": time.perf_counter() - t0}
    check(snap["violations_seen"] > 0, f"probe: no violation seen {snap}")
    check(min(idle_ewma) > REF_IDLE_STEP_US,
          f"probe: the idle engine step's EWMA {idle_ewma} us is down to the "
          f"reference's idle {REF_IDLE_STEP_US} us: run the chaos runner "
          "at time_scale 1.0 and remove the knob (ROADMAP item 17)")
    check(edges, "probe: no invariant_violation flight record")
    check("leader_commit_quorum" in tripped,
          f"probe: leader_commit_quorum not tripped ({tripped})")
    check(status == 503 and json.loads(body)["invariants"]["violations_seen"] > 0,
          f"probe: /healthz {status}")
    return out


def _wide_leaders(cluster, shards: int) -> dict:
    """shard -> the leader every live, unpartitioned host agrees on."""
    hosts = [cluster.hosts[r] for r in cluster.live_rids()
             if not cluster.hosts[r]._partitioned]
    out = {}
    for sid in range(1, shards + 1):
        ids = {nh.get_leader_id(sid) for nh in hosts}
        if len(ids) == 1:
            lid, ok = ids.pop()
            if ok and lid in cluster.hosts and cluster.live(lid):
                out[sid] = lid
    return out


def _wide_elect(cluster, shards: int, deadline_s: float) -> float:
    t0 = time.perf_counter()
    while len(_wide_leaders(cluster, shards)) < shards:
        check(time.perf_counter() - t0 < deadline_s,
              f"wide: {len(_wide_leaders(cluster, shards))} of {shards} "
              "shards elected")
        time.sleep(0.5)
    return time.perf_counter() - t0


def _wide_writes(cluster, shards: int, tag: str, deadline_s: float) -> dict:
    """WIDE_WRITES asynchronous writes per shard on its leader's host,
    retried on a drop or timeout as a client does; shard -> acked cmds."""
    from dragonboat_tpu_torch.request import RequestResultCode

    leaders = _wide_leaders(cluster, shards)

    def send(sid, w):
        nh = cluster.hosts[leaders.get(sid) or cluster.live_rids()[0]]
        cmd = f"{tag}{sid}x{w}=v".encode()
        try:
            return cmd, nh.propose(nh.get_noop_session(sid), cmd, timeout_s=60)
        except Exception:
            return cmd, None

    t0 = time.perf_counter()
    acked: dict = {sid: [] for sid in range(1, shards + 1)}
    pending = {(sid, w): send(sid, w) for sid in range(1, shards + 1)
               for w in range(WIDE_WRITES)}
    while pending:
        check(time.perf_counter() - t0 < deadline_s,
              f"wide: {len(pending)} writes never acknowledged")
        again = {}
        for key, (cmd, rs) in pending.items():
            if rs is not None and rs.wait(60).code == RequestResultCode.COMPLETED:
                acked[key[0]].append(cmd)
                continue
            time.sleep(0.01)
            leaders.update(_wide_leaders(cluster, shards))
            again[key] = send(*key)
        pending = again
    return acked


def _verify_wide(torch, dev, shards: int) -> dict:
    """[verify_wide]: seed 7's fault plan (partition, kill, delay) on
    ``shards`` device-resident shards x 3 (kernel_capacity = shards), with
    WIDE_WRITES writes on every shard before the first fault and after
    the heal; every acknowledged write in the journal of all three
    replicas, the journals equal, on every shard."""
    from dragonboat_tpu_torch.chaos import FaultPlan, runner

    plan = FaultPlan.generate(WIDE_SEED, n_replicas=3, steps=6)
    t0 = time.perf_counter()
    cluster = runner._Cluster(
        seed=WIDE_SEED, n=3, device_resident=True, device=dev,
        time_scale=CHAOS_TIME_SCALE, shards=tuple(range(1, shards + 1)),
        expert_overrides=dict(kernel_capacity=shards))
    try:
        cluster.start()
        admit_s = time.perf_counter() - t0
        elect_s = _wide_elect(cluster, shards, 300.0)
        before = _wide_writes(cluster, shards, "b", 300.0)
        t1 = time.perf_counter()
        events = []
        for step in range(plan.steps + 1):
            for ev in plan.events_at(step):
                events.append(f"{ev.kind}@{ev.target}")
                cluster.execute(ev)
            time.sleep(WIDE_STEP_S)
        fault_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        reelect_s = _wide_elect(cluster, shards, 300.0)
        after = _wide_writes(cluster, shards, "a", 300.0)
        converged, missing = False, shards
        while not converged:
            check(time.perf_counter() - t2 < 300.0,
                  f"wide: {missing} shards not converged")
            missing = 0
            for sid in range(1, shards + 1):
                js = cluster.journals(shard=sid)
                vals = list(js.values())
                have = set(vals[0]) if vals else set()
                if (len(js) != 3 or any(v != vals[0] for v in vals[1:])
                        or not all(c in have for c in before[sid] + after[sid])):
                    missing += 1
            converged = missing == 0
            if not converged:
                time.sleep(0.5)
        converge_s = time.perf_counter() - t2
        probe = cluster.invariant_counters()
    finally:
        cluster.close()
    out = {"seed": WIDE_SEED, "shards": shards, "replicas": 3,
           "events": json.dumps(events),
           "acked_before": sum(map(len, before.values())),
           "acked_after": sum(map(len, after.values())),
           "admit_s": admit_s, "elect_s": elect_s, "fault_window_s": fault_s,
           "reelect_s": reelect_s, "converge_s": converge_s,
           "violations_seen": probe["violations_seen"],
           "seconds": time.perf_counter() - t0}
    check(out["acked_before"] == out["acked_after"] == shards * WIDE_WRITES,
          "wide: not every write acknowledged")
    check(probe["violations_seen"] == 0, f"wide: invariant probe {probe}")
    return out


def phase_verify(torch, dev, smi: str, full: bool) -> list[dict]:
    """Phase 9: the model checker, the chaos runner and the invariant
    probe on the card.  The default run, after phases 1-8, runs the
    model checker, the mesh schedule, the detector differential and the
    probe; ``full`` (``--verify``) also every fast seed at depth 0, the
    depth-1 schedule, the hotspot and the wide schedule.  Returns the
    kernels line's verify rows."""
    t0 = time.perf_counter()
    mc, mc_taps = _verify_model_check(torch, dev)
    say("verify_model_check", **mc, card=json.dumps(smi))
    launches, taps = _verify_chaos(torch, dev, full)
    launches["quorum_match"] += mc["k1_launches"]
    say("verify_probe", **_counted(torch, lambda: _verify_probe(torch, dev),
                                   launches), card=json.dumps(smi))
    shards = 0
    if full:
        shards = WIDE_SHARDS
        while True:
            w = _counted(torch, lambda: _verify_wide(torch, dev, shards), launches)
            say("verify_wide", **w, card=json.dumps(smi))
            if w["seconds"] <= WIDE_LIMIT_S or shards <= 64:
                break
            shards //= 2
    rows = _mesh_rows(torch, taps["k1"], taps["k2"], launches, path="verify")
    for r in rows:
        say("verify_kernel", **{k: v for k, v in r.items() if k != "timing"},
            timing=json.dumps(r["timing"]))
    say("verify_total", seconds=time.perf_counter() - t0, wide_shards=shards)
    return rows


# ---------------------------------------------------------------------------
# phase 10: gossip addressing over the TCP transport, and the lint driver
# ---------------------------------------------------------------------------


def _free_ports(n: int, kind) -> list[int]:
    """n distinct free loopback ports (held until all are chosen)."""
    import socket

    socks = [socket.socket(socket.AF_INET, kind) for _ in range(n)]
    for so in socks:
        so.bind(("127.0.0.1", 0))
    ports = [so.getsockname()[1] for so in socks]
    for so in socks:
        so.close()
    return ports


def _gt_hosts(shards: int, dev) -> dict:
    """Three NodeHosts over ``TCPTransportFactory()`` (native wire) on
    loopback ports, addressed by NodeHostID through gossip (each host's
    gossip bound and advertised on a loopback port and seeded with the
    others'), the reference's default ExpertConfig, rtt 10 ms;
    ``shards`` device-resident shards x 3 replicas whose members are
    NodeHostIDs."""
    import socket

    from dragonboat_tpu_torch.config import (
        Config,
        ExpertConfig,
        GossipConfig,
        NodeHostConfig,
    )
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.transport.tcp import TCPTransportFactory

    gossip = [f"127.0.0.1:{p}" for p in _free_ports(3, socket.SOCK_DGRAM)]
    raft = [f"127.0.0.1:{p}" for p in _free_ports(3, socket.SOCK_STREAM)]
    hosts = {}
    try:
        for r in (1, 2, 3):
            hosts[r] = NodeHost(NodeHostConfig(
                raft_address=raft[r - 1], rtt_millisecond=10,
                transport_factory=TCPTransportFactory(),
                address_by_node_host_id=True,
                gossip=GossipConfig(bind_address=gossip[r - 1],
                                    advertise_address=gossip[r - 1],
                                    seed=[a for a in gossip
                                          if a != gossip[r - 1]]),
                expert=ExpertConfig()), device=dev)
        members = {r: nh.id for r, nh in hosts.items()}
        for sid in range(1, shards + 1):
            for r, nh in hosts.items():
                nh.start_replica(members, False, _kv_sm, Config(
                    shard_id=sid, replica_id=r, election_rtt=10,
                    heartbeat_rtt=1, device_resident=True))
    except BaseException:
        _nh_close(hosts)
        raise
    return hosts


def _gt_registries(hosts, deadline_s: float = 60.0) -> float:
    """Seconds until every host's registry is the gossip one and resolves
    every replica's NodeHostID to that host's raft address."""
    t0 = time.perf_counter()
    while True:
        regs = [nh.get_node_host_registry() for nh in hosts.values()]
        check(all(ok for _, ok in regs), "get_node_host_registry() not ok")
        bad = []
        for reg, _ in regs:
            for rid, other in hosts.items():
                try:
                    addr = reg.resolve(1, rid)[0]
                except KeyError:
                    addr = None
                if addr != other.config.raft_address:
                    bad.append((rid, addr))
        if not bad:
            return time.perf_counter() - t0
        check(time.perf_counter() - t0 < deadline_s,
              f"gossip view never converged: {bad[:4]}")
        time.sleep(0.1)


def _gossip_tcp(torch, dev, shards: int) -> dict:
    """[gossip_tcp]: the cell, its K1 launches (the step's, exactly
    _k1_calls_per_step a step, and the probe's) and taps, and the
    history of its writes and leader reads, checked linearizable."""
    from dragonboat_tpu_torch import history, kernels
    from dragonboat_tpu_torch.core import invariants as inv
    from dragonboat_tpu_torch.core import kernel as K
    from dragonboat_tpu_torch.engine import kernel_engine

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    step_tap, untap_step = _tap(K, "commit_quorum", K1_TAP_EVERY)
    probe_tap, untap_probe = _tap(inv, "quorum_match", 1)
    engine_steps: dict = {}
    uncount = [_count_calls(kernel_engine, attr, engine_steps)
               for attr in ("kernel_step", "kernel_step_donated")]
    spans: dict = {}
    unspan = _time_spans(spans)

    def restore():
        untap_step()
        untap_probe()
        for u in uncount:
            u()
        unspan()

    hist = history.HistoryRecorder()
    try:
        hosts = _gt_hosts(shards, dev)
        admit_s = time.perf_counter() - t0
        try:
            try:
                converge_s = _gt_registries(hosts)
                st = _nh_serve(hosts, shards, history=hist)
                torch.cuda.synchronize()
                launches = dict(kernels.launches)
                calls = (step_tap["calls"], probe_tap["calls"],
                         sum(engine_steps.values()))
                span_stats = _span_stats(spans)
            finally:
                restore()
            known = [nh.get_node_host_registry()[0].num_of_shards()
                     for nh in hosts.values()]
            k1_per_step = _k1_calls_per_step(hosts[1].kernel_engine.kp)
            resident = all(nh.nodes[1].peer is None for nh in hosts.values())
        finally:
            c0 = time.perf_counter()
            _nh_close(hosts)
            close_s = time.perf_counter() - c0
    finally:
        restore()
    t1 = time.perf_counter()
    linearizable = history.check_linearizable_kv(hist.ops)
    out = {"shards": shards, "replicas": 3, "hosts": 3,
           "transport": "TCPTransportFactory() native wire, loopback",
           "addressing": "NodeHostID via gossip", "admit_s": admit_s,
           "gossip_converge_s": converge_s,
           "gossip_known_shards": json.dumps(known), **st, **span_stats,
           "history_ops": len(hist.ops),
           "history_check_s": time.perf_counter() - t1,
           "linearizable": linearizable,
           "k1_launches": launches["quorum_match"],
           "k1_step_calls": calls[0], "k1_probe_calls": calls[1],
           "engine_steps": calls[2], "k1_per_engine_step": k1_per_step,
           "k1_per_engine_step_measured": calls[0] / max(1, calls[2]),
           **_tapped(torch, step_tap["inputs"], "k1_tapped", "commit_quorum"),
           **_tapped(torch, probe_tap["inputs"], "k1_probe_tapped"),
           "close_s": close_s, "seconds": time.perf_counter() - t0}
    check(resident, "gossip_tcp: a shard is not device-resident")
    check(out["acked"] == shards * NH_WRITES,
          "gossip_tcp: not every write acknowledged")
    check(linearizable, "gossip_tcp: the client history is not linearizable")
    check(calls[0] > 0 and calls[0] == k1_per_step * calls[2],
          f"gossip_tcp: {calls[0]} K1 launches by the engines' {calls[2]} "
          f"steps, not {k1_per_step} a step")
    check(calls[0] + calls[1] == launches["quorum_match"],
          "gossip_tcp: K1's launches are not the step's and the probe's calls")
    for key in ("k1_tapped_mismatches", "k1_probe_tapped_mismatches"):
        check(out[key] == 0, f"gossip_tcp: K1 disagrees with its plain arm ({key})")
    out["_taps"] = step_tap["inputs"]
    out["_launches"] = launches
    return out


def _lint(torch, dev) -> dict:
    """[lint]: the lint driver's passes with their dynamic legs on the
    card, no cached verdicts: RS005 (the model checker's fast scope, K1
    on the card), the transfer dynamic leg under the CUDA sync guard,
    KC007 on card tensors; findings and wall seconds of each pass."""
    import os

    from dragonboat_tpu_torch.analysis import __main__ as lint
    from dragonboat_tpu_torch.analysis import common

    launches: dict = {}
    t0 = time.perf_counter()
    res = _counted(torch, lambda: lint.run_passes(
        dynamic=True, device=dev, use_cache=False), launches)
    waivers = common.load_waivers(os.path.join(lint.ROOT, lint.WAIVERS_FILE))
    out, bad = {}, []
    for name, (found, secs) in res.items():
        unwaived, _ = common.apply_waivers(found, waivers)
        key = name.replace("-", "_")
        out[f"{key}_findings"] = len(unwaived)
        out[f"{key}_s"] = secs
        bad += [f.format() for f in unwaived]
    bad += [f.format() for f in lint.stale_waiver_findings(waivers, lint.ROOT)]
    out.update(k1_launches=launches.get("quorum_match", 0),
               k2_launches=launches.get("gather_lanes", 0),
               seconds=time.perf_counter() - t0)
    check(not bad, f"lint: {len(bad)} finding(s) on the card: {bad[:4]}")
    check(out["k1_launches"] > 0, "lint: the dynamic legs launched no K1")
    # the guard's controls: a device->host read raises under it, and
    # passes inside a sanctioned crossing
    from dragonboat_tpu_torch.capacity import METER

    x = torch.ones(4, device=dev)
    with METER.guard():
        try:
            x.sum().item()
            trips = False
        except RuntimeError:
            trips = True
        with METER.sanctioned("control"):
            lifted = x.sum().item() == 4.0
    METER.reset()
    out.update(guard_trips_undeclared=trips, guard_lifts_sanctioned=lifted)
    check(trips, "lint: an undeclared sync did not raise under the guard")
    check(lifted, "lint: a sanctioned crossing did not lift the guard")
    return out


def phase_gossip_tcp(torch, dev, smi: str,
                     shards: int = GT_SHARDS) -> list[dict]:
    """Phase 10: the NodeHost cell addressed by NodeHostID over the TCP
    transport, then the lint driver's dynamic legs on the card.  Returns
    the kernels line's gossip_tcp row."""
    t0 = time.perf_counter()
    cell = _gossip_tcp(torch, dev, shards)
    taps, launches = cell.pop("_taps"), cell.pop("_launches")
    say("gossip_tcp", **cell, phase7_shards=NH_SHARDS, card=json.dumps(smi))
    say("lint", **_lint(torch, dev), card=json.dumps(smi))
    row = _k1_row(torch, taps, launches, "gossip_tcp")
    say("gossip_tcp_kernel", **{k: v for k, v in row.items() if k != "timing"},
        timing=json.dumps(row["timing"]))
    say("gossip_tcp_total", seconds=time.perf_counter() - t0)
    return [row]


# ---------------------------------------------------------------------------
# phase 11: the 100k-group capacity rungs (dragonboat_tpu_torch.scale_100k)
# ---------------------------------------------------------------------------


def _scale_eager_vs_graphed(torch, kp, state, box) -> dict:
    """From phase A's final state, one graphed step (a fresh capture of the
    untapped body) against one eager step (``graphs.eager()``), every
    state and inbox leaf.  The graphed result is copied out and its graph
    dropped before the eager step runs, so the card holds one arm's
    temporaries at a time; an eager step that still does not fit is
    reported, with the bytes it asked for, and not compared."""
    from dragonboat_tpu_torch import bench_loop as bl
    from dragonboat_tpu_torch import graphs

    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    graphed = graphs.fresh(bl._run(kp, REPLICAS, True, True, state, box))
    torch.cuda.synchronize()
    out = {"graphed_step_s": time.perf_counter() - t,
           "graphed_peak_bytes": torch.cuda.max_memory_allocated()}
    graphs.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        with graphs.eager():
            eager = bl._run(kp, REPLICAS, True, True, state, box)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        out.update(eager="did not fit", eager_error=str(e).splitlines()[0],
                   eager_peak_bytes=torch.cuda.max_memory_allocated())
        del graphed
        torch.cuda.empty_cache()
        return out
    out.update(eager_step_s=time.perf_counter() - t,
               eager_peak_bytes=torch.cuda.max_memory_allocated(),
               leaf_mismatches=json.dumps(_same(torch, eager, graphed)),
               leaves=len(graphs.leaves_of(graphed)))
    del eager, graphed
    torch.cuda.empty_cache()
    return out


def _scale_a(torch, dev, groups: int) -> dict:
    """Phase A at ``groups`` x 3 on the card: the rung's line, K1 and K2
    counted per step and tapped, the capture's seconds and the peak
    device bytes through the capture and through the replays, then one
    eager step against one graphed step from the rung's final state."""
    from dragonboat_tpu_torch import graphs, kernels, scale_100k

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    taps, calls, untap = _loop_taps()
    kernels.reset_launches()
    try:
        line, extra = scale_100k.phase_a(groups, steps=SCALE_A_STEPS, device=dev)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        counted = dict(calls)
    finally:
        untap()
    kp = extra["kp"]
    captures = extra["capture_s"]
    per_step = _check_path_launches("scale_a", launches, counted, kp)
    steps = counted["step"]
    held = _loop_held(torch, "scale_a", taps)
    cmp = _scale_eager_vs_graphed(torch, kp, extra["state"], extra["box"])
    del extra["state"], extra["box"]
    graphs.clear()
    torch.cuda.empty_cache()
    out = {**line, "capture_s": sum(captures), "captures_timed": len(captures),
           "first_call_s": extra["first_call_s"],
           "capture_peak_bytes": extra["capture_peak_bytes"],
           "replay_peak_bytes": extra["replay_peak_bytes"],
           "step_ms_unrounded": extra["step_s"] * 1e3,
           "steps_driven": steps, "k1_per_step": launches["quorum_match"] / steps,
           "k2_per_step": launches["gather_lanes"] / steps,
           "k1_expected_per_step": per_step,
           "launches": json.dumps(launches, separators=(",", ":")),
           **held, **cmp, "seconds": time.perf_counter() - t0,
           "_taps": taps, "_launches": launches}
    check(line["predicted_bytes"] == line["measured_bytes"],
          f"scale_a: predicted {line['predicted_bytes']} != measured "
          f"{line['measured_bytes']} bytes")
    check(line["dispatch_compiles"] == 1 and line["dispatch_retraces"] == 0
          and len(captures) == 1,
          f"scale_a: {line['dispatch_compiles']} captures, "
          f"{line['dispatch_retraces']} retraces, {len(captures)} timed")
    check(steps == 2 * SCALE_A_STEPS, f"scale_a: {steps} steps counted")
    check(per_step == 16, f"scale_a: {per_step} K1 launches a step, not 16")
    R = REPLICAS
    check(held["k1_held_shapes"] == json.dumps([[groups * R, R]]),
          f"scale_a: K1 tapped at {held['k1_held_shapes']}")
    check(json.loads(held["k2_held_shapes"])[0] == [groups * R, 10],
          f"scale_a: K2 tapped at {held['k2_held_shapes']}")
    lanes = {tuple(t.shape) for _f, ls in taps[1]["inputs"] for t in ls}
    check(lanes == {(groups, R, R)}, f"scale_a: K2 lanes tapped at {lanes}")
    check(cmp.get("eager") == "did not fit" or cmp["leaf_mismatches"] == "[]",
          f"scale_a: graphed != eager at leaves {cmp.get('leaf_mismatches')}")
    return out


def _scale_b(torch, dev, groups: int) -> dict:
    """Phase B at ``groups`` device-resident shards on one NodeHost: the
    rung's line, the engine step over the pump, the host ms of the step's
    phases, K1 counted per engine step (and by the invariant probe) and
    tapped, no K2 (no router behind the engine)."""
    from dragonboat_tpu_torch import kernels, scale_100k
    from dragonboat_tpu_torch.core import invariants as inv
    from dragonboat_tpu_torch.core import kernel as K
    from dragonboat_tpu_torch.engine import kernel_engine

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_tap, untap_step = _tap(K, "commit_quorum", K1_TAP_EVERY)
    probe_tap, untap_probe = _tap(inv, "quorum_match", 1)
    engine_steps: dict = {}
    uncount = [_count_calls(kernel_engine, attr, engine_steps)
               for attr in ("kernel_step", "kernel_step_donated")]
    spans: dict = {}
    unspan = _time_spans(spans)
    try:
        line, extra = scale_100k.phase_b(groups, device=dev)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
    finally:
        untap_step()
        untap_probe()
        for u in uncount:
            u()
        unspan()
    steps = sum(engine_steps.values())
    per_step = _k1_calls_per_step(extra["kp"])
    pump_ms = [s * 1e3 for s in extra["pump_step_s"]]
    out = {**line, **_span_stats(spans),
           "pump_step_ms_p50": float(np.percentile(pump_ms, 50)),
           "pump_step_ms_max": max(pump_ms),
           "pump_step_ms": json.dumps([round(x, 1) for x in pump_ms]),
           "idle_step_ms": json.dumps([round(x * 1e3, 2) for x in extra["idle_step_s"]]),
           "engine_steps": steps, "k1_launches": launches["quorum_match"],
           "k1_step_calls": step_tap["calls"], "k1_probe_calls": probe_tap["calls"],
           "k1_per_engine_step": per_step,
           "k2_launches": launches["gather_lanes"],
           "launches": json.dumps(launches, separators=(",", ":")),
           **_tapped(torch, step_tap["inputs"], "k1_tapped", "commit_quorum"),
           "max_memory_allocated": peak, "seconds": time.perf_counter() - t0,
           "_taps": step_tap["inputs"], "_launches": launches}
    torch.cuda.empty_cache()
    check(line["predicted_bytes"] == line["measured_bytes"],
          f"scale_b: predicted {line['predicted_bytes']} != measured "
          f"{line['measured_bytes']} bytes")
    check(line["dispatch_compiles"] == 1 and line["dispatch_retraces"] == 0,
          f"scale_b: {line['dispatch_compiles']} captures, "
          f"{line['dispatch_retraces']} retraces")
    check(line["leaders"] == line["shards"] == groups,
          f"scale_b: {line['leaders']} leaders of {line['shards']} shards")
    check(line["proposals_queued"] == min(groups, SCALE_WAVE),
          f"scale_b: {line['proposals_queued']} proposals queued")
    check(line["committed_total"] == 2 * line["shards"] + line["proposals_queued"],
          f"scale_b: committed_total {line['committed_total']}")
    check(out["k1_step_calls"] + out["k1_probe_calls"] == out["k1_launches"],
          "scale_b: K1's launches are not the step's and the probe's calls")
    check(out["k1_step_calls"] == per_step * steps,
          f"scale_b: {out['k1_step_calls']} K1 launches in {steps} engine steps, "
          f"not {per_step} a step")
    check(out["k1_tapped_mismatches"] == 0, "scale_b: K1 differs from its plain arm")
    check(out["k2_launches"] == 0, "scale_b: K2 launched with no router")
    return out


def phase_scale(torch, dev, smi: str, groups: int = SCALE_GROUPS) -> list[dict]:
    """Phase 11: ``scripts/scale_100k.py``'s two rungs on the port at
    ``groups`` (SCALE_GROUPS unless given; never cut): phase A at groups x
    3, phase B at groups device-resident shards on one NodeHost.  Returns
    the kernels line's scale rows."""
    t0 = time.perf_counter()
    a = _scale_a(torch, dev, groups)
    taps, launches = a.pop("_taps"), a.pop("_launches")
    say("scale_a", **a, card=json.dumps(smi))
    rows = _mesh_rows(torch, taps[0]["inputs"], taps[1]["inputs"], launches, "scale")
    del taps
    b = _scale_b(torch, dev, groups)
    b_taps, b_launches = b.pop("_taps"), b.pop("_launches")
    say("scale_b", **b, card=json.dumps(smi))
    row = _k1_row(torch, b_taps, b_launches, "scale_b")
    check(row["max_abs_err"] == 0, "scale_b: commit_quorum differs from its plain arm")
    rows.append(row)
    for r in rows:
        say("scale_kernel", **{k: v for k, v in r.items() if k != "timing"},
            timing=json.dumps(r["timing"]))
    say("scale_total", seconds=time.perf_counter() - t0)
    return rows


# ---------------------------------------------------------------------------
# phase 13: membership and log-lifecycle operations (witnesses, snapshots
# and compaction, leader transfer, restart from disk, witness escalation
# off the mesh), and the user examples
# ---------------------------------------------------------------------------


class _OpsMeter:
    """K1 tapped where the step (``commit_quorum``) and the invariant
    probe (``quorum_match``) call it, on the mesh K2 where the route calls
    it (``gather_lanes_multi``), and the engine steps counted (the
    KernelEngine's two step entries, the mesh's steps and routes), over
    one cell; with ``cuda_only`` only the calls on card tensors (a cell
    that drives the CPU beside the card)."""

    def __init__(self, torch, mesh: bool = False, cuda_only: bool = False):
        from dragonboat_tpu_torch import kernels
        from dragonboat_tpu_torch.core import invariants as inv
        from dragonboat_tpu_torch.core import kernel as K
        from dragonboat_tpu_torch.core import router
        from dragonboat_tpu_torch.engine import kernel_engine
        from dragonboat_tpu_torch.parallel import ici

        self.torch, self.mesh = torch, mesh
        torch.cuda.synchronize()
        kernels.reset_launches()
        self.counts: dict = {}
        self.step_tap, u1 = _tap(K, "commit_quorum", K1_TAP_EVERY, cuda_only)
        self.probe_tap, u2 = _tap(inv, "quorum_match", 1, cuda_only)
        self._undo = [u1, u2]
        if mesh:
            self.route_tap, u3 = _tap(router, "gather_lanes_multi", 7, cuda_only)
            self._undo.append(u3)
            mod, attrs = ici, ("step", "route")
        else:
            mod, attrs = kernel_engine, ("kernel_step", "kernel_step_donated")
        self._undo += [_count_calls(mod, a, self.counts, cuda_only=cuda_only)
                       for a in attrs]
        self.launches = None

    def stop(self) -> None:
        """Read the launches and take the taps out (once)."""
        from dragonboat_tpu_torch import kernels

        if self.launches is None:
            self.torch.cuda.synchronize()
            self.launches = dict(kernels.launches)
            self.calls = (self.step_tap["calls"], self.probe_tap["calls"],
                          dict(self.counts))
        while self._undo:
            self._undo.pop()()

    def checked(self, name: str, kp) -> dict:
        """K1 exactly a CPU step's count per engine step (plus the
        probe's), K2 once per route on the mesh and never elsewhere, no
        K3; K1 (and K2) bitwise equal to their plain arms on the tapped
        inputs."""
        torch = self.torch
        launches = self.launches
        step_calls, probe_calls, counts = self.calls
        per_step = _k1_calls_per_step(kp)
        if self.mesh:
            steps, routes = counts["step"], counts["route"]
            check(routes > 0 and routes == steps,
                  f"{name}: {steps} mesh steps, {routes} routes")
            check(self.route_tap["calls"] == routes
                  and launches["gather_lanes"] == K2_PER_ROUTE * routes,
                  f"{name}: {launches['gather_lanes']} K2 launches in {routes} routes")
        else:
            steps = counts["kernel_step"] + counts["kernel_step_donated"]
            check(launches["gather_lanes"] == 0,
                  f"{name}: K2 launched behind the KernelEngine")
        check(steps > 0 and step_calls == per_step * steps,
              f"{name}: {step_calls} K1 launches by {steps} engine steps, "
              f"not {per_step} a step")
        check(launches["quorum_match"] == step_calls + probe_calls,
              f"{name}: K1's launches are not the step's and the probe's calls")
        check(launches["kv_apply"] == 0, f"{name}: kv_apply launched off its path")
        out = {"engine_steps": steps, "k1_per_engine_step": per_step,
               "k1_launches": launches["quorum_match"],
               "k1_probe_launches": probe_calls,
               "k2_launches": launches["gather_lanes"],
               **_tapped(torch, self.step_tap["inputs"], "k1_tapped", "commit_quorum")}
        if probe_calls:
            out.update(_tapped(torch, self.probe_tap["inputs"], "k1_probe_tapped"))
        if self.mesh:
            out.update(_tapped(torch, self.route_tap["inputs"], "k2_tapped",
                               "gather_lanes_multi"))
        for key in ("k1_tapped", "k1_probe_tapped", "k2_tapped"):
            check(out.get(f"{key}_mismatches", 0) == 0,
                  f"{name}: {key} differs from its plain arm")
        return out


def _step_pctiles(engines) -> dict:
    """Engine step ms p50/p90 over the engines' step timers."""
    steps = [x / 1e3 for eng in engines for x in eng._step_timer.samples]
    check(len(steps) > 0, "no engine step was timed")
    return {"step_ms_p50": float(np.percentile(steps, 50)),
            "step_ms_p90": float(np.percentile(steps, 90)),
            "step_samples": len(steps)}


def _ops_reductions_equal(a, b, where) -> None:
    """Two engines' reduction snapshots equal (card and CPU)."""
    _snapshots_equal(_reduction_snapshots(a), _reduction_snapshots(b), where)


def _ops_parity(torch, dev, mesh: bool) -> dict:
    """[ops_parity] / [ops_parity_mesh]: the lockstep drive of
    ``dragonboat_tpu_torch.lockstep`` (the operations of the CPU tests'
    cases (a) and (c)), the port on the CPU against the port on the card:
    every engine state leaf, reduction snapshot, replica and witness log
    equal after every round; the card's K1 (and K2) launches per engine
    step counted and tapped."""
    import tempfile

    from dragonboat_tpu_torch import convert, lockstep
    from dragonboat_tpu_torch import request as req
    from dragonboat_tpu_torch.config import (
        Config,
        EngineConfig,
        ExpertConfig,
        MeshSpec,
        NodeHostConfig,
    )
    from dragonboat_tpu_torch.nodehost import NodeHost

    def side(device):
        return lockstep.Side(
            NodeHost, NodeHostConfig, ExpertConfig, EngineConfig, Config,
            MeshSpec, _kv_sm, {"device": device},
            lambda eng, tree: convert.to_numpy(eng._dispatch.join(tree)), req)

    t0 = time.perf_counter()
    name = "ops_parity_mesh" if mesh else "ops_parity"
    meter = _OpsMeter(torch, mesh=mesh, cuda_only=True)
    with tempfile.TemporaryDirectory(prefix="ops") as root:
        ls = lockstep.Lockstep({"c": side("cpu"), "g": side(dev)}, root,
                               f"ops{int(mesh)}x{time.monotonic_ns()}",
                               _ops_reductions_equal, mesh=mesh)
        try:
            try:
                steps = iter(lockstep.script(OPS_SEEDS[mesh], 100_000))
                seen = (lockstep.mesh_ops if mesh else lockstep.kernel_ops)(ls, steps)
            except AssertionError as e:
                raise SmokeFailure(f"{name}: card != CPU: {e}") from e
            finally:
                meter.stop()
        finally:
            ls.close_all()
    return {"case": "(c) mesh (g=2, r=4)" if mesh else "(a) KernelEngine, depth 0",
            "card_vs_cpu": "equal every round", **seen,
            **meter.checked(name, ls.engines["g"][0].kp),
            **_step_pctiles([e for e in ls.engines["g"] if e._step_timer.samples]),
            "seconds": time.perf_counter() - t0}


def _ops_hosts(tag, dev, rids=(1, 2), depth=0, dirs=None, mesh=None,
               snapshot_entries=0, compaction_overhead=5):
    """NodeHosts ``rids`` of one shard (auto_run) with the reference
    engine tests' geometry: device-resident, or mesh-resident on
    ``mesh`` (a MeshSpec's keywords), ``dirs`` their node_host_dirs."""
    from dragonboat_tpu_torch import lockstep
    from dragonboat_tpu_torch.config import (
        Config,
        ExpertConfig,
        MeshSpec,
        NodeHostConfig,
    )
    from dragonboat_tpu_torch.nodehost import NodeHost

    addrs = {r: f"{tag}-{r}" for r in rids}
    hosts = {}
    for r in rids:
        ex = dict(lockstep.GEOMETRY, kernel_pipeline_depth=depth)
        if mesh is not None:
            ex.pop("kernel_capacity")
            ex["mesh"] = MeshSpec(name=tag, **mesh)
        hosts[r] = NodeHost(NodeHostConfig(
            raft_address=addrs[r], rtt_millisecond=5,
            node_host_dir=(dirs or {}).get(r, ""),
            expert=ExpertConfig(**ex)), device=dev)
        hosts[r].start_replica(addrs, False, _kv_sm, Config(
            shard_id=1, replica_id=r, election_rtt=10, heartbeat_rtt=2,
            snapshot_entries=snapshot_entries,
            compaction_overhead=compaction_overhead,
            device_resident=mesh is None, mesh_resident=mesh is not None))
    return hosts


def _ops_witness_host(addr, dev, compaction_overhead=5):
    """A host-resident witness (replica ``lockstep.WITNESS``) that joins
    shard 1."""
    from dragonboat_tpu_torch import lockstep
    from dragonboat_tpu_torch.config import Config, NodeHostConfig
    from dragonboat_tpu_torch.nodehost import NodeHost

    nh = NodeHost(NodeHostConfig(raft_address=addr, rtt_millisecond=5),
                  device=dev)
    nh.start_replica({}, True, _kv_sm, Config(
        shard_id=1, replica_id=lockstep.WITNESS, election_rtt=10, heartbeat_rtt=2,
        is_witness=True, compaction_overhead=compaction_overhead))
    return nh


def _ops_until(cond, what: str, deadline_s: float = 30.0) -> float:
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < deadline_s, what)
        time.sleep(0.02)
    return time.perf_counter() - t0


def _ops_witness(torch, dev) -> dict:
    """[ops_witness]: 2 device-resident voters and a host witness
    (auto_run): 10 writes, the witness's log METADATA only; a voter
    closed, 5 writes committed through the witness's acks, the shard
    still on its engine; then a fresh pair whose leader lane's ring
    compacts before the witness joins, which catches up through the
    stripped file-less snapshot (its snapshot record a witness one), the
    leader never evicted."""
    from dragonboat_tpu_torch import lockstep

    t0 = time.perf_counter()
    tag = f"opw{time.monotonic_ns()}"
    meter = _OpsMeter(torch)
    engines, out = [], {}
    hosts = _ops_hosts(tag, dev)
    try:
        try:
            lockstep.majority_leader(hosts)
            out["elect_s"] = time.perf_counter() - t0
            hosts[lockstep.WITNESS] = _ops_witness_host(f"{tag}-w", dev)
            lockstep.add_witness_sync(hosts, f"{tag}-w")
            w0 = time.perf_counter()
            lid = lockstep.writes(hosts, [f"k{i}=v{i}"
                                          for i in range(OPS_WITNESS_WRITES)])
            out["metadata_entries"] = lockstep.metadata_only(
                hosts[lockstep.WITNESS], OPS_WITNESS_WRITES)
            check(1 in hosts[lid].kernel_engine.by_shard, "witness cell: shard evicted")
            down = next(r for r in (1, 2) if r != lid)
            engines.append(hosts[down].kernel_engine)
            hosts.pop(down).close()
            lid = lockstep.writes(hosts, [f"solo{i}=v{i}"
                                          for i in range(OPS_SOLO_WRITES)])
            out["write_s"] = time.perf_counter() - w0
            check(hosts[lid].stale_read(1, f"solo{OPS_SOLO_WRITES - 1}")
                  == f"v{OPS_SOLO_WRITES - 1}",
                  "witness cell: the writes with a voter down did not apply")
            check(1 in hosts[lid].kernel_engine.by_shard,
                  "witness cell: the leader's shard left its engine")
            out["voter_down"] = down
            out["writes"] = OPS_WITNESS_WRITES + OPS_SOLO_WRITES
        finally:
            engines += [nh.kernel_engine for nh in hosts.values() if nh.kernel_engine]
            _nh_close(hosts)
        # the witness added after the leader lane's ring compacted
        s0 = time.perf_counter()
        tag = f"ops{time.monotonic_ns()}"
        hosts = _ops_hosts(tag, dev, snapshot_entries=8, compaction_overhead=2)
        try:
            lid = lockstep.writes(hosts, [f"p{i}=v{i}"
                                          for i in range(OPS_STRIP_WRITES)])
            eng = hosts[lid].kernel_engine
            lane = eng.by_shard[1].lane

            def compacted():
                return int(eng.state.snap_index[lane]) > 0
            if not compacted():
                for i in range(20):
                    lockstep.writes(hosts, [f"more{i}=x"])
                    if compacted():
                        break
            check(compacted(), "witness cell: the leader lane's ring never compacted")
            hosts[lockstep.WITNESS] = _ops_witness_host(f"{tag}-w", dev, 2)
            lid = lockstep.add_witness_sync(hosts, f"{tag}-w")
            wnode = hosts[lockstep.WITNESS].nodes[1]
            target = hosts[lid].nodes[1].sm.get_last_applied()

            def caught_up():
                lockstep.writes(hosts, ["tick=t"])
                return wnode.sm.get_last_applied() >= target
            _ops_until(caught_up, "the witness never caught up past compaction")
            wss = hosts[lockstep.WITNESS].logdb.get_snapshot(1, lockstep.WITNESS)
            check(wss is not None and wss.witness,
                  "witness cell: catch-up took no witness snapshot")
            check(1 in hosts[lid].kernel_engine.by_shard,
                  "witness cell: the leader was evicted serving a witness snapshot")
            check(wnode.sm.sm.kv == {}, "a payload reached the witness's SM")
            out.update(strip_ring_snap_index=int(eng.state.snap_index[lane]),
                       strip_witness_snapshot_index=wss.index,
                       strip_seconds=time.perf_counter() - s0)
        finally:
            engines += [nh.kernel_engine for nh in hosts.values() if nh.kernel_engine]
            _nh_close(hosts)
    finally:
        meter.stop()
    kp = engines[0].kp
    return {**out, **meter.checked("ops_witness", kp), **_step_pctiles(engines),
            "seconds": time.perf_counter() - t0, "_meter": meter}


def _ops_depth1(torch, dev) -> dict:
    """[ops_depth1]: three device-resident voters at pipeline depth 1 on
    tan directories, snapshot_entries 12: OPS_D1_WRITES writes, the log
    compacted, the last read back through the leader; every host closed
    and reopened on its directory, every write read back on every
    replica; the pending step context drained at idle; then the partition
    monkey, its history linearizable."""
    import tempfile

    from dragonboat_tpu_torch import lockstep

    t0 = time.perf_counter()
    meter = _OpsMeter(torch)
    engines, out = [], {}
    want = {f"s{i}": f"v{i}" for i in range(OPS_D1_WRITES)}
    try:
        with tempfile.TemporaryDirectory(prefix="opsd1") as root:
            dirs = {r: f"{root}/nh{r}" for r in (1, 2, 3)}
            tag = f"opd{time.monotonic_ns()}"
            hosts = _ops_hosts(tag, dev, (1, 2, 3), depth=1, dirs=dirs,
                               snapshot_entries=12)
            try:
                lockstep.majority_leader(hosts)
                out["elect_s"] = time.perf_counter() - t0
                w0 = time.perf_counter()
                lid = lockstep.writes(hosts, [f"{k}={v}" for k, v in want.items()])
                out["write_s"] = time.perf_counter() - w0
                node = hosts[lid].nodes[1]
                _ops_until(lambda: node.compacted_to > 0, "depth 1: no compaction")
                out["compacted_to"] = node.compacted_to
                last = f"s{OPS_D1_WRITES - 1}"
                check(hosts[lid].sync_read(1, last, timeout_s=10) == want[last],
                      "depth 1: the last write did not read back")
                out["overlapped"] = sum(nh.events.metrics.snapshot().get(
                    "engine.pipeline.overlapped", 0) for nh in hosts.values())
                check(out["overlapped"] > 0, "depth 1: no step overlapped")
            finally:
                engines += [nh.kernel_engine for nh in hosts.values()]
                _nh_close(hosts)
            r0 = time.perf_counter()
            hosts = _ops_hosts(tag, dev, (1, 2, 3), depth=1, dirs=dirs,
                               snapshot_entries=12)
            try:
                lockstep.majority_leader(hosts)
                out["restart_elect_s"] = time.perf_counter() - r0
                _ops_until(lambda: all(nh.stale_read(1, k) == v
                                       for nh in hosts.values()
                                       for k, v in want.items()),
                           "depth 1: a write was not read back after restart")
                out["read_back_replicas"] = len(hosts)
                out["restart_s"] = time.perf_counter() - r0
                # each engine seen with no step in flight: with a tick
                # round every rtt, the three are seldom idle at one instant
                idle = set()

                def drained():
                    idle.update(r for r, nh in hosts.items()
                                if nh.kernel_engine._pending_ctx is None)
                    return len(idle) == len(hosts)
                _ops_until(drained, "depth 1: a pending step context never drained")
                out.update(lockstep.monkey(hosts, OPS_MONKEY_S, OPS_MONKEY_OPS,
                                           op_timeout_s=1.0))
            finally:
                engines += [nh.kernel_engine for nh in hosts.values()]
                _nh_close(hosts)
    finally:
        meter.stop()
    return {"writes": OPS_D1_WRITES, **out,
            **meter.checked("ops_depth1", engines[0].kp), **_step_pctiles(engines),
            "seconds": time.perf_counter() - t0, "_meter": meter}


def _ops_mesh(torch, dev) -> dict:
    """[ops_mesh]: three mesh-resident voters on tan directories sharing
    a (g=2, r=4) MeshSpec (witness id 4 inside mesh addressing) on the
    one-device mesh layout: writes, every host restarted from its
    directory and every write read back; a witness added, the group
    escalated off the mesh to the host engines, writes through them; a
    snapshot on every voter, then a restart that mesh admission refuses
    from the durable membership, writes again."""
    import tempfile

    from dragonboat_tpu_torch import lockstep

    t0 = time.perf_counter()
    meter = _OpsMeter(torch, mesh=True)
    out, engines, kp = {}, [], None
    want = {f"m{i}": f"v{i}" for i in range(6)}
    try:
        with tempfile.TemporaryDirectory(prefix="opsm") as root:
            dirs = {r: f"{root}/nh{r}" for r in (1, 2, 3)}
            tag = f"opm{time.monotonic_ns()}"
            def reopen():
                return _ops_hosts(tag, dev, (1, 2, 3), dirs=dirs,
                                  mesh=lockstep.MESH)

            def off_mesh(hs):
                eng = hs[1].mesh_engine
                return all(eng is None or (1, r) not in eng.by_shard
                           for r in (1, 2, 3))

            hosts = reopen()
            try:
                check(all(nh.nodes[1].peer is None for nh in hosts.values()),
                      "mesh ops: a replica is not mesh-resident")
                eng = hosts[1].mesh_engine
                kp = eng.kp
                out["layout"] = _layout(eng.cluster.devices)
                lockstep.majority_leader(hosts)
                out["elect_s"] = time.perf_counter() - t0
                lockstep.writes(hosts, [f"{k}={v}" for k, v in want.items()])
            finally:
                engines.append(hosts[1].mesh_engine)
                _nh_close(hosts)
            r0 = time.perf_counter()
            hosts = reopen()
            try:
                check(all((1, r) in hosts[1].mesh_engine.by_shard for r in (1, 2, 3)),
                      "mesh ops: the rows were not re-injected on restart")
                lockstep.majority_leader(hosts)
                _ops_until(lambda: all(nh.stale_read(1, k) == v
                                       for nh in hosts.values()
                                       for k, v in want.items()),
                           "mesh ops: a write was not read back after restart")
                out["restart_s"] = time.perf_counter() - r0
                w0 = time.perf_counter()
                hosts[lockstep.WITNESS] = _ops_witness_host(f"{tag}-w", dev)
                lockstep.add_witness_sync(hosts, f"{tag}-w")
                out["escalate_s"] = _ops_until(lambda: off_mesh(hosts),
                                               "mesh ops: the witness group stayed on the mesh")
                check(all(hosts[r].nodes[1].peer is not None for r in (1, 2, 3)),
                      "mesh ops: the escalated group is not host-resident")
                lockstep.writes(hosts, ["post=wit"])
                out["witness_s"] = time.perf_counter() - w0
                for r in (1, 2, 3):
                    hosts[r].sync_request_snapshot(1, timeout_s=10)
            finally:
                engines.append(hosts[1].mesh_engine)
                _nh_close(hosts)
            a0 = time.perf_counter()
            hosts = reopen()
            try:
                check(off_mesh(hosts)
                      and all(hosts[r].nodes[1].peer is not None for r in (1, 2, 3)),
                      "mesh ops: admission took the witness group onto the mesh")
                lid = lockstep.writes(hosts, ["again=ok"])
                check(hosts[lid].stale_read(1, "post") == "wit",
                      "mesh ops: the write through the host engines was lost")
                out["admission_s"] = time.perf_counter() - a0
            finally:
                _nh_close(hosts)
    finally:
        meter.stop()
    engines = [e for e in engines if e is not None and e._step_timer.samples]
    return {"mesh": "(g=2, r=4)", "writes": len(want) + 2, **out,
            **meter.checked("ops_mesh", kp), **_step_pctiles(engines),
            "seconds": time.perf_counter() - t0, "_meter": meter}


def _ops_examples() -> dict:
    """[ops_examples]: the three user examples as subprocesses on the
    card, ``multigroup_device`` at its default 32 shards."""
    import os
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    out = {}

    def run(name, *args, cwd):
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", f"dragonboat_tpu_torch.examples.{name}", *args],
            capture_output=True, text=True, env=env, cwd=cwd, timeout=300)
        check(r.returncode == 0,
              f"example {name} exited {r.returncode}: {r.stderr[-1500:]}")
        out[f"{name}_s"] = out.get(f"{name}_s", 0.0) + time.perf_counter() - t
        return r.stdout

    with tempfile.TemporaryDirectory(prefix="opsx") as tmp:
        got = run("helloworld", cwd=tmp)
        check("dublin (linearizable read via follower host): rain" in got,
              f"helloworld printed {got!r}")
        got = run("ondisk", f"{tmp}/data", cwd=tmp)
        check("wrote boot" in got, f"ondisk printed {got!r}")
        got = run("ondisk", f"{tmp}/data", cwd=tmp)
        check("recovered from disk: boot =" in got, f"ondisk (again) printed {got!r}")
        got = run("multigroup_device", cwd=tmp)
        n = OPS_EXAMPLE_SHARDS
        check(f"{n}/{n} shards elected" in got and f"wrote to {n}/{n} shards" in got,
              f"multigroup_device printed {got!r}")
    out["multigroup_shards"] = OPS_EXAMPLE_SHARDS
    return out


def phase_ops(torch, dev, smi: str) -> list[dict]:
    """Phase 13: the membership and log-lifecycle operations on
    device- and mesh-resident shards, and the user examples.  Returns the
    kernels line's rows (K1 on the KernelEngine cells' inputs, K1 and K2
    on the mesh cell's)."""
    try:
        return _phase_ops(torch, dev, smi)
    except AssertionError as e:   # lockstep's checks
        raise SmokeFailure(f"ops: {e}") from e


def _phase_ops(torch, dev, smi: str) -> list[dict]:
    t0 = time.perf_counter()
    for mesh in (False, True):
        st = _ops_parity(torch, dev, mesh)
        say("ops_parity_mesh" if mesh else "ops_parity", **st, card=json.dumps(smi))
    wit = _ops_witness(torch, dev)
    wit_meter = wit.pop("_meter")
    say("ops_witness", **wit, card=json.dumps(smi))
    d1 = _ops_depth1(torch, dev)
    d1_meter = d1.pop("_meter")
    say("ops_depth1", **d1, card=json.dumps(smi))
    ms = _ops_mesh(torch, dev)
    ms_meter = ms.pop("_meter")
    say("ops_mesh", **ms, card=json.dumps(smi))
    say("ops_examples", **_ops_examples(), card=json.dumps(smi))
    # the kernels line's rows: K1 on the witness cell's step inputs with
    # the KernelEngine cells' launches, K1 and K2 on the mesh cell's
    launches = {k: wit_meter.launches[k] + d1_meter.launches[k]
                for k in wit_meter.launches}
    rows = [_k1_row(torch, wit_meter.step_tap["inputs"], launches, "ops"),
            *_mesh_rows(torch, ms_meter.step_tap["inputs"],
                        ms_meter.route_tap["inputs"], ms_meter.launches,
                        "ops_mesh")]
    for r in rows:
        say("ops_kernel", **{k: v for k, v in r.items() if k != "timing"},
            timing=json.dumps(r["timing"]))
    say("ops_total", seconds=time.perf_counter() - t0)
    return rows


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


def compare_turns(torch, dev, rounds: int) -> int:
    """``python3 chip_smoke.py --compare-turns [ROUNDS]``: the NodeHost
    cell graphed with the engines' shared step lock
    (``KernelEngine._step_mu``) and with a null lock in its place, in
    turn, ROUNDS times each (1 unless given), one line per run with every
    check of the cell.  Not part of the default run."""
    tag = f"cmt{time.monotonic_ns()}"
    for i, on in enumerate((True, False) * rounds):
        st = _nh_cell(torch, dev, f"{tag}-{i}", turns=on)
        st.pop("extra")
        say("nodehost_turns", run=i, **st)
        check(st["acked"] == NH_SHARDS * NH_WRITES, "not every write acknowledged")
        check(st["k1_step_calls"] == st["k1_per_engine_step"] * st["engine_steps"],
              "K1 launches are not 21 an engine step")
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
    if sys.argv[1:2] == ["--compare-turns"]:
        return compare_turns(torch, dev, int((sys.argv[2:] or ["1"])[0]))
    if sys.argv[1:2] == ["--mesh"]:
        phase_mesh(torch, dev, device["nvidia_smi"])
        phase_mesh_split(torch, dev, device["nvidia_smi"])
        return 0
    if sys.argv[1:2] == ["--verify"]:
        phase_verify(torch, dev, device["nvidia_smi"], full=True)
        return 0
    if sys.argv[1:2] == ["--gossip"]:
        phase_gossip_tcp(torch, dev, device["nvidia_smi"],
                         int((sys.argv[2:] or [GT_SHARDS])[0]))
        return 0
    if sys.argv[1:2] == ["--scale"]:
        phase_scale(torch, dev, device["nvidia_smi"],
                    int((sys.argv[2:] or [SCALE_GROUPS])[0]))
        return 0
    if sys.argv[1:2] == ["--ops"]:
        phase_ops(torch, dev, device["nvidia_smi"])
        return 0
    rows = phase_kernels(torch, dev)
    phase_parity(torch, dev)
    launches = phase_slice(torch, dev)
    phase_loops(torch, dev)
    phase_nodehost(torch, dev, device["nvidia_smi"])
    mesh_rows = phase_mesh(torch, dev, device["nvidia_smi"])
    verify_rows = phase_verify(torch, dev, device["nvidia_smi"], full=False)
    gossip_rows = phase_gossip_tcp(torch, dev, device["nvidia_smi"])
    scale_rows = phase_scale(torch, dev, device["nvidia_smi"])
    split_rows = phase_mesh_split(torch, dev, device["nvidia_smi"],
                                  guard=False)
    ops_rows = phase_ops(torch, dev, device["nvidia_smi"])
    say("total", seconds=time.perf_counter() - t0)
    # one row per kernel: the numbers of the entry the main path launches
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": r["kernel"], "entry": r["name"], "path": "slice",
         "launches": launches[r["kernel"]], **{k: r[k] for k in keys}}
        for r in rows if r["name"] in MAIN_PATH_ENTRIES] + [
        {"name": r["kernel"], "entry": r["name"], "path": r["path"],
         "launches": r["launches"], **{k: r[k] for k in keys}}
        for r in mesh_rows + verify_rows + gossip_rows + scale_rows
        + split_rows + ops_rows]}))
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
