"""Self-driving device loop: the replicated-KV data path end to end.

Port of the reference's ``bench_loop.py`` (the ``run_steps`` and device-SM
loops).  ``full_step`` is one cluster step (raft step + device routing)
plus the feedback a host engine would give: proposals on leaders, the
applied cursor trailing the processed cursor, and the logical clock.
``full_step_sm`` adds the device state machine: the apply window the step
releases is applied to a ``DeviceKV`` on every replica through K3.

PyTorch runs eagerly, so the reference's ``fori_loop``s are Python loops
here; nothing in them reads the device from the host except
``elect_all``'s convergence check.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
                now: int) -> StepInput:
    """The self-driving feedback input: propose on leaders (first
    ``write_width`` lanes, or all), optionally one batched ReadIndex per
    leader, instant-apply cursor, logical clock tick."""
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


def run_steps(kp: KP.KernelParams, replicas: int, iters: int,
              tick: bool, propose: bool, state: ShardState, box: Inbox):
    """``iters`` self-driving steps; returns (state, box)."""
    for _ in range(iters):
        state, box, _ = full_step(kp, replicas, state, box, tick, propose)
    return state, box


def make_device_sm(num_groups: int, replicas: int = 3,
                   table_cap: int = 1024, device=None):
    """(DeviceKV, kv_state) sized for the bench cluster.  Direct-mapped:
    the apply writes key = index mod table_cap, so every slot is that
    key's private home and no write can be rejected."""
    kv = DeviceKV(table_cap=table_cap, hash_keys=False)
    return kv, kv.init_state(num_groups * replicas, resolve_device(device))


def full_step_sm(kp: KP.KernelParams, replicas: int, kv: DeviceKV,
                 state: ShardState, box: Inbox, kv_state: dict,
                 tick: bool, propose: bool):
    """``full_step`` plus the device state machine: the apply window the
    step releases, read from the replicated lv ring (valid on leaders and
    followers), goes through K3 on every replica.  On the card ``kv_state``
    is updated in place.  Returns (state, box, kv_state, n_rejected, out),
    ``n_rejected`` a 0-d int32 tensor left on the device."""
    if not kp.inline_payloads:
        raise ValueError("device-SM path needs sm_params()")
    CAP, AB = kp.log_cap, kp.apply_batch
    state, box2, out = full_step(kp, replicas, state, box, tick, propose)
    lanes = torch.arange(AB, dtype=I32, device=state.term.device)
    idx = out.apply_first[:, None] + lanes[None, :]
    valid = idx <= out.apply_last[:, None]                   # [G, AB]
    vals = torch.gather(state.lv, 1, (idx & (CAP - 1)).long())
    key_space = kv.table_cap // 2 if kv.hash_keys else kv.table_cap
    cmds = torch.stack([idx & (key_space - 1), vals], dim=-1)  # [G, AB, 2]
    kv_state, (_results, ok) = apply_window(kv, kv_state, cmds, valid)
    # a rejected committed write is surfaced, not swallowed
    n_rejected = (~ok & valid).sum(dtype=I32)
    return state, box2, kv_state, n_rejected, out


def run_steps_sm(kp: KP.KernelParams, replicas: int, kv: DeviceKV,
                 iters: int, tick: bool, propose: bool, state: ShardState,
                 box: Inbox, kv_state: dict):
    """``iters`` device-SM steps; returns (state, box, kv_state, rejects)
    with ``rejects`` a 0-d int32 tensor on the device."""
    rej = torch.zeros((), dtype=I32, device=state.term.device)
    for _ in range(iters):
        state, box, kv_state, r, _ = full_step_sm(
            kp, replicas, kv, state, box, kv_state, tick, propose)
        rej = rej + r
    return state, box, kv_state, rej


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
