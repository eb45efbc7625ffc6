"""Self-driving device loop: the replicated-KV data path end to end.

Port of the reference's ``bench_loop.py``: ``run_steps`` and its pipelined
form, the device-SM loops (``run_steps_sm`` and the served 9:1 mix
``run_steps_mixed_sm``), the ReadIndex mix (``run_steps_mixed``), the
commit-latency loops (``run_steps_lat``), the election storm
(``run_steps_storm``) and the membership wave's ``cc_step``.
``full_step`` is one cluster step (raft step + device routing) plus the
feedback a host engine would give: proposals on leaders, the applied
cursor trailing the processed cursor, and the logical clock.
``full_step_sm`` adds the device state machine: the apply window the step
releases is applied to a ``DeviceKV`` on every replica through K3.

The reference jits each loop whole (a ``fori_loop`` under ``jax.jit``).
Here each loop replays one compiled step body (``dragonboat_tpu_torch
.graphs``) ``iters`` times: on the card the body is captured once per
geometry as a CUDA graph, on the CPU it runs eagerly.  The bodies donate
their carries, so a loop passes the graph's own buffers back and pays no
copy; a loop returns its results copied out of the graph (``graphs
.fresh``), so they outlive the next call as the reference's do.  The
pipelined loops, whose bodies fuse two steps for XLA, are the serial
loops at twice the count.  The carries stay tensors on the state's device
(0-d int32 for the counters, 0-d int64 for the clock ``now`` and the
storm's draw counter, advanced inside the graph), so no value that
changes from step to step is baked into a graph, and nothing in the loops
reads the device from the host except ``elect_all``'s convergence check.

The storm's message drops cannot be the reference's threefry bits.  The
port draws its own from ``storm_keep``, a counter-based hash of (seed,
micro-step, row, slot) that gives the same bits on the CPU and the card;
a caller (a differential test) may pass its own keep masks instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dragonboat_tpu_torch import graphs
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.core.kernel import step
from dragonboat_tpu_torch.core.kstate import (
    Inbox,
    ShardState,
    StepInput,
    empty_inbox,
    init_state,
)
from dragonboat_tpu_torch.core.router import route
from dragonboat_tpu_torch.devices import resolve_device
from dragonboat_tpu_torch.rsm.device_kv import DeviceKV
from dragonboat_tpu_torch.rsm.device_kv_kernels import apply_window

I32 = torch.int32
I64 = torch.int64


def _clock(now0: int, state: ShardState) -> torch.Tensor:
    """The loop clock as a 0-d int64 tensor on the state's device."""
    return torch.full((), int(now0), dtype=I64, device=state.term.device)


def bench_params(replicas: int = 3, device=None) -> KP.KernelParams:
    """The reference bench geometry.  ``device`` (default: the CUDA card)
    picks the ring-read lowering as the reference picks it from JAX's
    backend: one-hot selects off the CPU, gathers on the CPU."""
    return KP.KernelParams(
        onehot_reads=resolve_device(device).type != "cpu",
        num_peers=replicas,
        log_cap=128,
        inbox_cap=5 * (replicas - 1),
        msg_entries=32,
        proposal_cap=32,
        readindex_cap=4,
        apply_batch=64,
        compaction_overhead=16,
    )


def sm_params(replicas: int = 3, device=None) -> KP.KernelParams:
    """bench_params with the inline-payload lanes on (the lv ring and
    ent_val routing the device-SM data path rides)."""
    return dataclasses.replace(bench_params(replicas, device),
                               inline_payloads=True)


def make_cluster(kp: KP.KernelParams, num_groups: int, replicas: int = 3,
                 election: int = 10, device=None) -> ShardState:
    """``num_groups`` groups x ``replicas`` rows, replica ids 1..R."""
    G = num_groups * replicas
    rids = np.tile(np.arange(1, replicas + 1, dtype=np.int32), num_groups)
    pids = np.arange(1, replicas + 1, dtype=np.int32)
    return init_state(kp, G, rids, pids, election_timeout=election,
                      device=resolve_device(device))


def _self_input(kp: KP.KernelParams, state: ShardState, tick: bool,
                propose: bool, write_width: int | None, do_reads: bool,
                now) -> StepInput:
    """The self-driving feedback input: propose on leaders (first
    ``write_width`` lanes, or all), optionally one batched ReadIndex per
    leader, instant-apply cursor, logical clock tick.  ``now`` (the
    ReadIndex ctx) is a Python int or a 0-d tensor."""
    G, B = state.term.shape[0], kp.proposal_cap
    dev = state.term.device
    is_leader = state.role == KP.LEADER
    lanes = torch.arange(B, dtype=I32, device=dev)
    pv = is_leader[:, None].expand(G, B) & bool(propose)
    if write_width is not None and write_width < B:
        pv = pv & (lanes < write_width)[None, :]
    # inline payloads: lane j proposes value last + 1 + j, the entry's
    # own index, so any replica can verify lv[slot(i)] == i
    pval = state.last[:, None] + 1 + lanes[None, :]
    ri = is_leader & bool(do_reads) & bool(propose)
    if isinstance(now, torch.Tensor):
        ctx = torch.zeros((G,), dtype=I32, device=dev) + (now & 0x7FFFFFFF).to(I32)
    else:
        ctx = torch.full((G,), int(now) & 0x7FFFFFFF, dtype=I32, device=dev)
    return StepInput(
        prop_valid=pv.contiguous(),
        prop_cc=torch.zeros((G, B), dtype=torch.bool, device=dev),
        ri_valid=ri,
        ri_low=ctx,
        ri_high=ctx,
        transfer_to=torch.zeros((G,), dtype=I32, device=dev),
        tick=torch.full((G,), bool(tick), dtype=torch.bool, device=dev),
        quiesced=torch.zeros((G,), dtype=torch.bool, device=dev),
        applied=state.processed,  # instant-apply feedback
        prop_val=pval,
    )


def full_step(kp: KP.KernelParams, replicas: int, state: ShardState,
              box: Inbox, tick: bool, propose: bool):
    """One self-driving step; returns (state, next_box, out)."""
    inp = _self_input(kp, state, tick, propose, None, False, 0)
    state, out = step(kp, state, box, inp)
    return state, route(kp, replicas, out), out


def _run_body(kp: KP.KernelParams, replicas: int, tick: bool, propose: bool,
              state: ShardState, box: Inbox):
    state, box, _ = full_step(kp, replicas, state, box, tick, propose)
    return state, box


_run = graphs.compiled(_run_body, static_argnums=(0, 1, 2, 3),
                       donate_argnums=(4, 5))


def run_steps(kp: KP.KernelParams, replicas: int, iters: int,
              tick: bool, propose: bool, state: ShardState, box: Inbox):
    """``iters`` self-driving steps; returns (state, box)."""
    for _ in range(iters):
        state, box = _run(kp, replicas, bool(tick), bool(propose), state, box)
    return graphs.fresh((state, box))


def _cc_step(kp: KP.KernelParams, replicas: int, state: ShardState,
             box: Inbox):
    """One step of the membership-change wave: every leader proposes a
    config-change entry in lane 0 beside its write batch (the kernel
    keeps one CC in flight per group; the caller plays the engine and
    clears ``pending_cc`` once the CC applied).  Returns (state,
    next_box, accepted_cc [G] bool, cc_index [G] i32)."""
    inp = _self_input(kp, state, True, True, None, False, 0)
    prop_cc = inp.prop_cc.clone()
    prop_cc[:, 0] = True
    state, out = step(kp, state, box, inp._replace(prop_cc=prop_cc))
    return (state, route(kp, replicas, out),
            out.prop_accepted[:, 0], out.prop_index[:, 0])


#: the membership wave's step (the reference's jitted ``cc_step``)
cc_step = graphs.compiled(_cc_step, static_argnums=(0, 1))


# ---------------------------------------------------------------------------
# pipelined (double-pumped) loops: two micro-steps per iteration, the clock
# and the storm's draw advancing per micro-step.  The reference fuses the
# pair into one fori_loop body for XLA; run eagerly that is the serial loop
# at 2n, so these are calls to it.
# ---------------------------------------------------------------------------


def run_steps_pipelined(kp: KP.KernelParams, replicas: int, iters: int,
                        tick: bool, propose: bool, state: ShardState,
                        box: Inbox):
    """``iters`` pipeline steps of two micro-steps each:
    ``run_steps(kp, replicas, 2 * iters, ...)``."""
    return run_steps(kp, replicas, 2 * iters, tick, propose, state, box)


def run_steps_mixed(kp: KP.KernelParams, replicas: int, iters: int,
                    write_width: int, now0: int, state: ShardState, box: Inbox,
                    reads):
    """The read/write mix without latency capture: writes narrowed to
    ``write_width`` lanes, one batched ReadIndex ctx per leader per step
    with ctx ``now0 + i``; ``reads`` (0-d int32) counts completed ctxs.
    Returns (state, box, reads)."""
    now = _clock(now0, state)
    for _ in range(iters):
        state, box, reads, now = _mixed(kp, replicas, write_width, state,
                                        box, reads, now)
    return graphs.fresh((state, box, reads))


def _mixed_body(kp: KP.KernelParams, replicas: int, write_width: int,
                state: ShardState, box: Inbox, reads, now):
    inp = _self_input(kp, state, True, True, write_width, True, now)
    state, out = step(kp, state, box, inp)
    box = route(kp, replicas, out)
    return state, box, reads + out.rtr_valid.sum(dtype=I32), now + 1


_mixed = graphs.compiled(_mixed_body, static_argnums=(0, 1, 2),
                         donate_argnums=(3, 4, 5, 6))


def run_steps_mixed_pipelined(kp: KP.KernelParams, replicas: int, iters: int,
                              write_width: int, now0: int, state: ShardState,
                              box: Inbox, reads):
    """Pipelined 9:1 mix: the ctx clock advances per micro-step
    (now0 + 2i, now0 + 2i + 1), i.e. ``run_steps_mixed(2 * iters)``."""
    return run_steps_mixed(kp, replicas, 2 * iters, write_width, now0,
                           state, box, reads)


def make_device_sm(num_groups: int, replicas: int = 3,
                   table_cap: int = 1024, device=None):
    """(DeviceKV, kv_state) sized for the bench cluster.  Direct-mapped:
    the apply writes key = index mod table_cap, so every slot is that
    key's private home and no write can be rejected."""
    kv = DeviceKV(table_cap=table_cap, hash_keys=False)
    return kv, kv.init_state(num_groups * replicas, resolve_device(device))


def _apply_released(kp: KP.KernelParams, kv: DeviceKV, kv_state: dict,
                    state: ShardState, out):
    """The apply window the step released, read from the post-step lv ring
    (valid on leaders and followers), through K3 on every replica: entry
    i writes key ``i mod key space`` = its payload.  Returns (kv_state,
    n_rejected), ``n_rejected`` a 0-d int32 tensor left on the device."""
    CAP, AB = kp.log_cap, kp.apply_batch
    lanes = torch.arange(AB, dtype=I32, device=state.term.device)
    idx = out.apply_first[:, None] + lanes[None, :]
    valid = idx <= out.apply_last[:, None]                   # [G, AB]
    vals = torch.gather(state.lv, 1, (idx & (CAP - 1)).long())
    key_space = kv.table_cap // 2 if kv.hash_keys else kv.table_cap
    cmds = torch.stack([idx & (key_space - 1), vals], dim=-1)  # [G, AB, 2]
    kv_state, (_results, ok) = apply_window(kv, kv_state, cmds, valid)
    # a rejected committed write is surfaced, not swallowed
    return kv_state, (~ok & valid).sum(dtype=I32)


def _full_step_sm(kp: KP.KernelParams, replicas: int, kv: DeviceKV,
                  state: ShardState, box: Inbox, kv_state: dict,
                  tick: bool, propose: bool):
    if not kp.inline_payloads:
        raise ValueError("device-SM path needs sm_params()")
    state, box2, out = full_step(kp, replicas, state, box, tick, propose)
    kv_state, n_rejected = _apply_released(kp, kv, kv_state, state, out)
    return state, box2, kv_state, n_rejected, out


#: ``full_step`` plus the device state machine (``_apply_released``), a
#: compiled entry that donates state, box and ``kv_state``: on the card
#: the graph updates them in place in its static buffers (K3 writes the
#: table in place), and every result stays valid until the next call.
#: Returns (state, box, kv_state, n_rejected, out).
full_step_sm = graphs.compiled(_full_step_sm, static_argnums=(0, 1, 2, 6, 7),
                               donate_argnums=(3, 4, 5))


def _sm_body(kp: KP.KernelParams, replicas: int, kv: DeviceKV, tick: bool,
             propose: bool, state: ShardState, box: Inbox, kv_state: dict,
             rej):
    state, box, kv_state, r, _ = _full_step_sm(
        kp, replicas, kv, state, box, kv_state, tick, propose)
    return state, box, kv_state, rej + r


_sm = graphs.compiled(_sm_body, static_argnums=(0, 1, 2, 3, 4),
                      donate_argnums=(5, 6, 7, 8))


def run_steps_sm(kp: KP.KernelParams, replicas: int, kv: DeviceKV,
                 iters: int, tick: bool, propose: bool, state: ShardState,
                 box: Inbox, kv_state: dict):
    """``iters`` device-SM steps; returns (state, box, kv_state, rejects)
    with ``rejects`` a 0-d int32 tensor on the device.  The caller's
    ``kv_state`` is left as it was; the returned one is new."""
    rej = torch.zeros((), dtype=I32, device=state.term.device)
    for _ in range(iters):
        state, box, kv_state, rej = _sm(kp, replicas, kv, bool(tick),
                                        bool(propose), state, box, kv_state,
                                        rej)
    return graphs.fresh((state, box, kv_state, rej))


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2**32 to int32, two's complement: what
    an int32 sum that wraps gives, whatever the order of its terms."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(I32)


def run_steps_mixed_sm(kp: KP.KernelParams, replicas: int, kv: DeviceKV,
                       iters: int, write_width: int, now0: int,
                       state: ShardState, box: Inbox, kv_state: dict, reads,
                       acc, rejects):
    """The 9:1 mix with reads served: the device-SM write path
    (``_apply_released``) plus one batched
    ReadIndex ctx per leader per step, and for every ctx that is servable
    (confirmed and applied past: ``rix <= processed`` after the step) a
    window of ``9 * write_width`` keys below the ctx index read from the
    device table by a slot scan.  Direct-mapped slots test their own
    position, hashed slots their stored key.  ``reads`` counts served
    ctxs, ``acc`` folds the read values (an int32 sum that wraps),
    ``rejects`` the refused committed writes; all three are 0-d int32 and
    accumulate across calls.  The caller's ``kv_state`` is left as it
    was.  Returns (state, box, kv_state, reads, acc, rejects)."""
    if not kp.inline_payloads:
        raise ValueError("device-SM path needs sm_params()")
    now = _clock(now0, state)
    for _ in range(iters):
        state, box, kv_state, reads, acc, rejects, now = _mixed_sm(
            kp, replicas, kv, write_width, state, box, kv_state, reads, acc,
            rejects, now)
    return graphs.fresh((state, box, kv_state, reads, acc, rejects))


def _mixed_sm_body(kp: KP.KernelParams, replicas: int, kv: DeviceKV,
                   write_width: int, state: ShardState, box: Inbox,
                   kv_state: dict, reads, acc, rejects, now):
    T = kv.table_cap
    KS = T // 2 if kv.hash_keys else T      # key space (as _apply_released)
    RB = 9 * write_width
    slots = torch.arange(T, dtype=I32, device=state.term.device)
    inp = _self_input(kp, state, True, True, write_width, True, now)
    state, out = step(kp, state, box, inp)
    box = route(kp, replicas, out)
    kv_state, rej = _apply_released(kp, kv, kv_state, state, out)
    rejects = rejects + rej
    # read side: the newest confirmed ctx per lane, served only once
    # the state machine has applied past its index (never stale)
    rix = torch.where(out.rtr_valid, out.rtr_index, 0).amax(dim=1)
    served = out.rtr_valid.any(dim=1) & (rix <= state.processed)
    if kv.hash_keys:
        # stored key (keys - 1; 0 = empty) against the served window,
        # modulo the key space
        keys = kv_state["keys"]
        d = (rix[:, None] - 1 - (keys - 1)) & (KS - 1)
        hit = (d < RB) & (keys > 0) & served[:, None]
    else:
        d = (rix[:, None] - 1 - slots[None, :]) & (T - 1)
        hit = (d < RB) & served[:, None]
    got = torch.where(hit, kv_state["vals"], 0).sum(dtype=torch.int64)
    acc = wrap_i32(acc.to(torch.int64) + got)
    reads = reads + served.sum(dtype=I32)
    return state, box, kv_state, reads, acc, rejects, now + 1


_mixed_sm = graphs.compiled(_mixed_sm_body, static_argnums=(0, 1, 2, 3),
                            donate_argnums=(4, 5, 6, 7, 8, 9, 10))


# ---------------------------------------------------------------------------
# commit latency: a stamp ring records the step each accepted proposal
# entered the log; releases on leader rows are bucketed by steps waited
# ---------------------------------------------------------------------------

LAT_BUCKETS = 64  # steps-to-release, 1-step buckets, last bucket saturates


def lat_init(kp: KP.KernelParams, G: int, device=None):
    """(stamp ring [G, log_cap], histogram [LAT_BUCKETS], completed-ctx
    counter), int32 on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return (torch.zeros((G, kp.log_cap), dtype=I32, device=dev),
            torch.zeros((LAT_BUCKETS,), dtype=I32, device=dev),
            torch.zeros((), dtype=I32, device=dev))


def _stamp_accepts(kp: KP.KernelParams, stamp, out, now):
    """Stamp ``now`` (a Python int or a 0-d tensor) into the ring slot of
    every accepted proposal.  The
    reference's [G, B, CAP] one-hot becomes a scatter-add of the accept
    flags; lanes that share a slot all write the same ``now``."""
    idx = (out.prop_index & (kp.log_cap - 1)).long()
    hits = torch.zeros_like(stamp).scatter_add_(
        1, idx, out.prop_accepted.to(I32))
    if isinstance(now, torch.Tensor):
        # a tensor fill value would be read on the host: select instead
        return torch.where(hits > 0, now.to(I32), stamp)
    return stamp.masked_fill(hits > 0, now)


def _bucket_releases(kp: KP.KernelParams, stamp, hist, out, now,
                     is_leader):
    """Add ``now - stamp`` (clipped to the last bucket) of every entry
    released on a leader row this step to the histogram; only leader rows
    carry stamps.  The reference's one-hot sum is a scatter-add of the
    valid flags into the buckets: same int32 counts."""
    CAP, AB = kp.log_cap, kp.apply_batch
    lanes = torch.arange(AB, dtype=I32, device=stamp.device)
    idx = out.apply_first[:, None] + lanes[None, :]
    valid = (idx <= out.apply_last[:, None]) & is_leader[:, None]
    st = torch.gather(stamp, 1, (idx & (CAP - 1)).long())
    if isinstance(now, torch.Tensor):
        now = now.to(I32)
    lat = (now - st).clamp(0, LAT_BUCKETS - 1)
    return hist.scatter_add(0, lat.reshape(-1).long(),
                            valid.reshape(-1).to(I32))


def full_step_lat(kp: KP.KernelParams, replicas: int, write_width: int,
                  do_reads: bool, state: ShardState, box: Inbox, tick: bool,
                  propose: bool, now, stamp, hist, reads):
    """``full_step`` plus latency stamping and, with ``do_reads``, one
    batched ReadIndex per leader, at clock ``now`` (a Python int or a 0-d
    tensor); returns (state, box, stamp, hist, reads)."""
    is_leader = state.role == KP.LEADER
    inp = _self_input(kp, state, tick, propose, write_width, do_reads, now)
    state, out = step(kp, state, box, inp)
    nxt = route(kp, replicas, out)
    stamp = _stamp_accepts(kp, stamp, out, now)
    hist = _bucket_releases(kp, stamp, hist, out, now, is_leader)
    reads = reads + out.rtr_valid.sum(dtype=I32)
    return state, nxt, stamp, hist, reads


def _lat_body(kp: KP.KernelParams, replicas: int, write_width: int,
              do_reads: bool, tick: bool, propose: bool, advance: int,
              state, box, stamp, hist, reads, now):
    state, box, stamp, hist, reads = full_step_lat(
        kp, replicas, write_width, do_reads, state, box, tick, propose, now,
        stamp, hist, reads)
    return state, box, stamp, hist, reads, now + advance


_lat = graphs.compiled(_lat_body, static_argnums=(0, 1, 2, 3, 4, 5, 6),
                       donate_argnums=(7, 8, 9, 10, 11, 12))


def run_steps_lat(kp: KP.KernelParams, replicas: int, iters: int,
                  write_width: int, do_reads: bool, tick: bool, propose: bool,
                  now0: int, state, box, stamp, hist, reads):
    """``iters`` instrumented steps at clock ``now0 + i``; returns
    (state, box, stamp, hist, reads)."""
    now = _clock(now0, state)
    flags = (write_width, bool(do_reads), bool(tick), bool(propose))
    for _ in range(iters):
        state, box, stamp, hist, reads, now = _lat(
            kp, replicas, *flags, 1, state, box, stamp, hist, reads, now)
    return graphs.fresh((state, box, stamp, hist, reads))


def run_steps_lat_pipelined(kp: KP.KernelParams, replicas: int, iters: int,
                            write_width: int, do_reads: bool, tick: bool,
                            propose: bool, now0: int, state, box, stamp, hist,
                            reads):
    """Instrumented pipelined loop: both micro-steps of pipeline step i
    stamp and bucket at ``now0 + i``, so the histogram counts pipeline
    steps.  Not equal to ``run_steps_lat`` by construction (the stamps
    differ); the uninstrumented pipelined loops are the bitwise ones."""
    now = _clock(now0, state)
    flags = (write_width, bool(do_reads), bool(tick), bool(propose))
    for _ in range(iters):
        for advance in (0, 1):
            state, box, stamp, hist, reads, now = _lat(
                kp, replicas, *flags, advance, state, box, stamp, hist,
                reads, now)
    return graphs.fresh((state, box, stamp, hist, reads))


# ---------------------------------------------------------------------------
# election storm: random message drops (pre-vote keeps terms bounded),
# then recovery to one leader per group on a clean network
# ---------------------------------------------------------------------------


def storm_keep(seed: int, micro_step: int, drop_p: float, like: torch.Tensor):
    """The port's drop draw: a keep mask shaped and placed like ``like``
    (the inbox's ``[G, K]`` mtype), True where the message survives.  Each
    slot's 32 bits are splitmix32 of (row * K + slot) xor a key mixed from
    (seed, micro_step), so the mask depends on nothing else and is the
    same on the CPU and the card; a slot drops when its bits fall below
    ``drop_p * 2**32``."""
    def scalar(v):
        return torch.full((), int(v), dtype=I64, device=like.device)

    return _storm_keep_t(scalar(KP.splitmix32(seed & KP.U32_MASK)),
                         scalar(micro_step), drop_p, like)


def _storm_keep_t(key0: torch.Tensor, micro: torch.Tensor, drop_p: float,
                  like: torch.Tensor):
    """``storm_keep`` with splitmix32(seed) and the micro-step given as 0-d
    int64 tensors (a graph's inputs)."""
    key = KP.splitmix32_t(key0 ^ (micro & KP.U32_MASK))
    flat = torch.arange(like.numel(), dtype=I64, device=like.device)
    bits = KP.splitmix32_t(flat.reshape(like.shape) ^ key)
    return bits >= min(round(float(drop_p) * 2**32), 2**32)


def _drop_box(box: Inbox, keep: torch.Tensor) -> Inbox:
    """Zero every routed message where ``keep [G, K]`` is False (a dropped
    slot is all-zero, the kernel's empty-slot contract)."""
    def z(x):
        if x is None:
            return None
        k = keep if x.dim() == keep.dim() else keep[..., None]
        return x.masked_fill(~k, 0)

    return type(box)(*[z(f) for f in box])


def _storm_body(kp: KP.KernelParams, replicas: int, drop_p: float,
                state: ShardState, box: Inbox, key0, micro):
    state, box, _ = full_step(kp, replicas, state, box, True, False)
    box = _drop_box(box, _storm_keep_t(key0, micro, drop_p, box.mtype))
    return state, box, key0, micro + 1


_storm = graphs.compiled(_storm_body, static_argnums=(0, 1, 2),
                         donate_argnums=(3, 4, 5, 6))


def _storm_masked_body(kp: KP.KernelParams, replicas: int,
                       state: ShardState, box: Inbox, keep):
    state, box, _ = full_step(kp, replicas, state, box, True, False)
    return state, _drop_box(box, keep)


_storm_masked = graphs.compiled(_storm_masked_body, static_argnums=(0, 1),
                                donate_argnums=(2, 3))


def run_steps_storm(kp: KP.KernelParams, replicas: int, iters: int,
                    drop_p: float, seed: int, state: ShardState, box: Inbox,
                    *, keep_masks=None):
    """``iters`` ticking steps, no proposals, the routed inbox of step i
    thinned by ``storm_keep(seed, i, drop_p)``, or by ``keep_masks[i]``
    (``[G, K]`` bool each) when the caller gives them.  Returns (state,
    box)."""
    if keep_masks is None:
        key0 = _clock(KP.splitmix32(seed & KP.U32_MASK), state)
        micro = _clock(0, state)
        for _ in range(iters):
            state, box, key0, micro = _storm(kp, replicas, float(drop_p),
                                             state, box, key0, micro)
    else:
        for i in range(iters):
            state, box = _storm_masked(kp, replicas, state, box,
                                       keep_masks[i])
    return graphs.fresh((state, box))


def run_steps_storm_pipelined(kp: KP.KernelParams, replicas: int, iters: int,
                              drop_p: float, seed: int, state: ShardState,
                              box: Inbox, *, keep_masks=None):
    """Pipelined storm: the draw advances per micro-step (2i, 2i + 1;
    ``keep_masks`` holds ``2 * iters`` masks), i.e.
    ``run_steps_storm(2 * iters)``."""
    return run_steps_storm(kp, replicas, 2 * iters, drop_p, seed, state, box,
                           keep_masks=keep_masks)


def elect_all(kp: KP.KernelParams, replicas: int, state: ShardState,
              max_rounds: int = 40):
    """Tick (no proposals) until every group has a leader, then settle."""
    box = empty_inbox(kp, state.term.shape[0], state.term.device)
    for _ in range(max_rounds):
        state, box = run_steps(kp, replicas, 10, True, False, state, box)
        role = state.role.reshape(-1, replicas)
        if bool((role == KP.LEADER).any(dim=1).all()):
            # settle in-flight traffic
            return run_steps(kp, replicas, 6, False, False, state, box)
    raise RuntimeError("election did not converge")
