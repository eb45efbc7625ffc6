"""Structure-of-arrays state for the batched Raft step, as torch tensors.

The port's copy of the reference's ``core/kstate.py`` layout: ``ShardState``,
``Inbox``, ``StepInput`` and ``StepOutput`` hold the same fields in the same
order with the same dtypes (int32 and bool only), each with a leading
``[G]`` shard axis.  ``CONTRACTS`` is the reference's field contract
literal (grammar documented there: ``"[<axes>] <dtype> [tags]"``); the
tests hold it equal to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dragonboat_tpu_torch.core import params as P
from dragonboat_tpu_torch.devices import resolve_device

CONTRACTS = {
    "ShardState": {
        # identity / config
        "replica_id": "[G] i32 part=G",
        "seed": "[G] i32 part=G",
        "e_timeout": "[G] i32 part=G",
        "h_timeout": "[G] i32 part=G",
        "check_quorum": "[G] bool part=G",
        "pre_vote": "[G] bool part=G",
        # core protocol state
        "role": "[G] i32 domain=FOLLOWER..WITNESS part=G",
        "term": "[G] i32 part=G",
        "vote": "[G] i32 part=G",
        "leader": "[G] i32 part=G",
        "applied": "[G] i32 part=G",
        "e_tick": "[G] i32 part=G",
        "h_tick": "[G] i32 part=G",
        "rand_timeout": "[G] i32 part=G",
        "rand_counter": "[G] i32 part=G",
        "pending_cc": "[G] bool part=G",
        "ltt": "[G] i32 part=G",
        "is_ltt": "[G] bool part=G",
        # peer books
        "pid": "[G, P] i32 part=G",
        "kind": "[G, P] i32 domain=K_ABSENT..K_WITNESS part=G",
        "match": "[G, P] i32 part=G",
        "next": "[G, P] i32 part=G",
        "pstate": "[G, P] i32 domain=R_RETRY..R_SNAPSHOT part=G",
        "active": "[G, P] bool part=G",
        "psnap": "[G, P] i32 part=G",
        "vresp": "[G, P] bool part=G",
        "vgrant": "[G, P] bool part=G",
        # log ring + cursors
        "lt": "[G, CAP] i32 ring part=G",
        "lcc": "[G, CAP] bool ring part=G",
        "snap_index": "[G] i32 part=G",
        "snap_term": "[G] i32 part=G",
        "last": "[G] i32 part=G",
        "committed": "[G] i32 part=G",
        "processed": "[G] i32 part=G",
        "stable": "[G] i32 part=G",
        # ReadIndex circular book
        "ri_low": "[G, RI] i32 ring part=G",
        "ri_high": "[G, RI] i32 ring part=G",
        "ri_index": "[G, RI] i32 ring part=G",
        "ri_acks": "[G, RI, P] bool ring part=G",
        "ri_head": "[G] i32 part=G",
        "ri_count": "[G] i32 part=G",
        "needs_host": "[G] bool part=G",
        # device quiesce (the kernel-masked form of quiesce.py)
        "quiesce_on": "[G] bool part=G",
        "idle_tick": "[G] i32 part=G",
        "quiesced": "[G] bool part=G",
        "quiesce_epoch": "[G] i32 part=G",
        "lv": "[G, CAP] i32 ring optional part=G",
    },
    "Inbox": {
        "mtype": "[G, K] i32 part=G",
        "from_": "[G, K] i32 part=G",
        "term": "[G, K] i32 part=G",
        "log_term": "[G, K] i32 part=G",
        "log_index": "[G, K] i32 part=G",
        "commit": "[G, K] i32 part=G",
        "reject": "[G, K] bool part=G",
        "hint": "[G, K] i32 part=G",
        "hint_high": "[G, K] i32 part=G",
        "n_ent": "[G, K] i32 part=G",
        "ent_term": "[G, K, E] i32 part=G",
        "ent_cc": "[G, K, E] bool part=G",
        "ent_val": "[G, K, E] i32 optional part=G",
    },
    "StepInput": {
        "prop_valid": "[G, B] bool part=G",
        "prop_cc": "[G, B] bool part=G",
        "ri_valid": "[G] bool part=G",
        "ri_low": "[G] i32 part=G",
        "ri_high": "[G] i32 part=G",
        "transfer_to": "[G] i32 part=G",
        "tick": "[G] bool part=G",
        "quiesced": "[G] bool part=G",
        "applied": "[G] i32 part=G",
        "prop_val": "[G, B] i32 optional part=G",
    },
    "StepOutput": {
        "r_type": "[G, K] i32 part=G",
        "r_to": "[G, K] i32 part=G",
        "r_term": "[G, K] i32 part=G",
        "r_log_index": "[G, K] i32 part=G",
        "r_reject": "[G, K] bool part=G",
        "r_hint": "[G, K] i32 part=G",
        "r_hint_high": "[G, K] i32 part=G",
        "s_rep": "[G, P] bool part=G",
        "s_prev_index": "[G, P] i32 part=G",
        "s_prev_term": "[G, P] i32 part=G",
        "s_commit": "[G, P] i32 part=G",
        "s_n_ent": "[G, P] i32 part=G",
        "s_ent_term": "[G, P, E] i32 part=G",
        "s_ent_cc": "[G, P, E] bool part=G",
        "s_ent_val": "[G, P, E] i32 optional part=G",
        "s_vote": "[G, P] i32 part=G",
        "s_vote_term": "[G, P] i32 part=G",
        "s_vote_lindex": "[G, P] i32 part=G",
        "s_vote_lterm": "[G, P] i32 part=G",
        "s_vote_hint": "[G, P] i32 part=G",
        "s_hb": "[G, P] bool part=G",
        "s_hb_commit": "[G, P] i32 part=G",
        "s_hb_low": "[G, P] i32 part=G",
        "s_hb_high": "[G, P] i32 part=G",
        "s_timeout_now": "[G, P] bool part=G",
        "s_need_snapshot": "[G, P] bool part=G",
        "s_wit_snap": "[G, P] bool part=G",
        "save_first": "[G] i32 part=G",
        "save_last": "[G] i32 part=G",
        "apply_first": "[G] i32 part=G",
        "apply_last": "[G] i32 part=G",
        "term": "[G] i32 part=G",
        "vote": "[G] i32 part=G",
        "commit": "[G] i32 part=G",
        "rtr_valid": "[G, RI] bool part=G",
        "rtr_index": "[G, RI] i32 part=G",
        "rtr_low": "[G, RI] i32 part=G",
        "rtr_high": "[G, RI] i32 part=G",
        "ri_dropped": "[G] bool part=G",
        "prop_accepted": "[G, B] bool part=G",
        "prop_index": "[G, B] i32 part=G",
        "prop_term": "[G, B] i32 part=G",
        "leader": "[G] i32 part=G",
        "leader_term": "[G] i32 part=G",
        "needs_host": "[G] bool part=G",
    },
}


class ShardState(NamedTuple):
    """Per-shard raft state; every field has a leading [G] axis."""

    # identity / config
    replica_id: torch.Tensor     # [G] i32 — local replica id within the shard
    seed: torch.Tensor           # [G] i32 — PRNG stream id
    e_timeout: torch.Tensor      # [G] i32 — election timeout in ticks
    h_timeout: torch.Tensor      # [G] i32 — heartbeat timeout in ticks
    check_quorum: torch.Tensor   # [G] bool
    pre_vote: torch.Tensor       # [G] bool

    # core protocol state
    role: torch.Tensor           # [G] i32 ∈ {FOLLOWER..WITNESS}
    term: torch.Tensor           # [G] i32
    vote: torch.Tensor           # [G] i32 (replica id, 0 = none)
    leader: torch.Tensor         # [G] i32 (0 = NoLeader)
    applied: torch.Tensor        # [G] i32 — RSM-confirmed applied index
    e_tick: torch.Tensor         # [G] i32
    h_tick: torch.Tensor         # [G] i32
    rand_timeout: torch.Tensor   # [G] i32
    rand_counter: torch.Tensor   # [G] i32 — bumps on each timeout reset
    pending_cc: torch.Tensor     # [G] bool
    ltt: torch.Tensor            # [G] i32 — leader-transfer target (0 none)
    is_ltt: torch.Tensor         # [G] bool — local node is transfer target

    # peer books [G, P]
    pid: torch.Tensor            # peer replica ids (0 = empty slot)
    kind: torch.Tensor           # K_ABSENT/K_VOTER/K_NON_VOTING/K_WITNESS
    match: torch.Tensor          # i32
    next: torch.Tensor           # i32
    pstate: torch.Tensor         # R_RETRY/R_WAIT/R_REPLICATE/R_SNAPSHOT
    active: torch.Tensor         # bool — recent contact (checkQuorum)
    psnap: torch.Tensor          # i32 — pending install-snapshot index
    vresp: torch.Tensor          # bool — vote response received this election
    vgrant: torch.Tensor         # bool — vote granted

    # log [G, CAP] ring + cursors
    lt: torch.Tensor             # [G, CAP] i32 — term of entry i at slot i & (CAP-1)
    lcc: torch.Tensor            # [G, CAP] bool — entry is a config change
    snap_index: torch.Tensor     # [G] i32 — last snapshot index (ring floor)
    snap_term: torch.Tensor      # [G] i32
    last: torch.Tensor           # [G] i32
    committed: torch.Tensor      # [G] i32
    processed: torch.Tensor      # [G] i32 — released to the apply pipeline
    stable: torch.Tensor         # [G] i32 — handed to the fsync pipeline

    # ReadIndex circular book [G, RI] (+ acks [G, RI, P])
    ri_low: torch.Tensor
    ri_high: torch.Tensor
    ri_index: torch.Tensor
    ri_acks: torch.Tensor        # [G, RI, P] bool
    ri_head: torch.Tensor        # [G] i32
    ri_count: torch.Tensor       # [G] i32

    # host-escalation flag: the shard touched a path the kernel does not
    # model (a peer needs an InstallSnapshot stream)
    needs_host: torch.Tensor     # [G] bool

    # device quiesce
    quiesce_on: torch.Tensor     # [G] bool — per-lane enable
    idle_tick: torch.Tensor      # [G] i32 — ticks since last activity
    quiesced: torch.Tensor       # [G] bool — device-resident quiesced mask
    quiesce_epoch: torch.Tensor  # [G] i32 — wakes so far (monotone)

    # inline payload ring [G, CAP] i32; None unless kp.inline_payloads
    lv: torch.Tensor | None = None


def init_state(
    kp: P.KernelParams,
    num_shards: int,
    replica_id,
    peer_ids,
    peer_kinds=None,
    election_timeout: int = 10,
    heartbeat_timeout: int = 1,
    check_quorum: bool = False,
    pre_vote: bool = False,
    seeds=None,
    quiesce: bool = False,
    device=None,
) -> ShardState:
    """Build a fresh [G] state on ``device`` (the CUDA card by default).

    ``replica_id``: scalar or [G] — the local replica id per shard.
    ``peer_ids``: [P] or [G, P] replica ids (0 marks an empty slot).
    ``peer_kinds``: same shape, defaults to K_VOTER for non-empty slots.
    The seed mix and the first timeout draw are the reference's numpy code.
    """
    dev = resolve_device(device)
    G, Pn, CAP, RI = num_shards, kp.num_peers, kp.log_cap, kp.readindex_cap
    z = lambda *s: np.zeros((G, *s), np.int32)  # noqa: E731
    zb = lambda *s: np.zeros((G, *s), bool)  # noqa: E731

    rid = np.broadcast_to(np.asarray(replica_id, np.int32), (G,)).copy()
    pids = np.asarray(peer_ids, np.int32)
    if pids.ndim == 1:
        pids = np.broadcast_to(pids, (G, Pn)).copy()
    if peer_kinds is None:
        kinds = np.where(pids != 0, P.K_VOTER, P.K_ABSENT).astype(np.int32)
    else:
        kinds = np.asarray(peer_kinds, np.int32)
        if kinds.ndim == 1:
            kinds = np.broadcast_to(kinds, (G, Pn)).copy()
    if seeds is None:
        seeds = (
            np.arange(1, G + 1, dtype=np.int64) * 2654435761 % (1 << 31)
            + rid.astype(np.int64) * 40503
        ) % (1 << 31)
        seeds = seeds.astype(np.int32)
    seeds = np.asarray(seeds, np.int32)
    et = np.full((G,), election_timeout, np.int32)
    rand0 = np.asarray(
        [P.randomized_timeout(int(seeds[g]), 0, int(et[g])) for g in range(G)],
        np.int32,
    )

    is_nv = np.zeros((G,), bool)
    is_wt = np.zeros((G,), bool)
    for g in range(G):
        slot = np.nonzero(pids[g] == rid[g])[0]
        if slot.size:
            is_nv[g] = kinds[g, slot[0]] == P.K_NON_VOTING
            is_wt[g] = kinds[g, slot[0]] == P.K_WITNESS
    role = np.where(is_wt, P.WITNESS, np.where(is_nv, P.NON_VOTING, P.FOLLOWER))

    fields = dict(
        replica_id=rid,
        seed=seeds,
        e_timeout=et,
        h_timeout=np.full((G,), heartbeat_timeout, np.int32),
        check_quorum=np.full((G,), check_quorum, bool),
        pre_vote=np.full((G,), pre_vote, bool),
        role=role.astype(np.int32),
        term=z(), vote=z(), leader=z(), applied=z(), e_tick=z(), h_tick=z(),
        rand_timeout=rand0,
        rand_counter=z(),
        pending_cc=zb(),
        ltt=z(),
        is_ltt=zb(),
        pid=pids, kind=kinds,
        match=z(Pn), next=z(Pn) + 1, pstate=z(Pn), active=zb(Pn),
        psnap=z(Pn), vresp=zb(Pn), vgrant=zb(Pn),
        lt=z(CAP), lcc=zb(CAP),
        snap_index=z(), snap_term=z(), last=z(), committed=z(),
        processed=z(), stable=z(),
        ri_low=z(RI), ri_high=z(RI), ri_index=z(RI), ri_acks=zb(RI, Pn),
        ri_head=z(), ri_count=z(),
        needs_host=zb(),
        quiesce_on=np.full((G,), quiesce, bool),
        idle_tick=z(), quiesced=zb(), quiesce_epoch=z(),
        lv=z(CAP) if kp.inline_payloads else None,
    )
    return ShardState(**{
        k: None if v is None else torch.as_tensor(v).to(dev)
        for k, v in fields.items()})


class Inbox(NamedTuple):
    """Fixed-width inbound message block, [G, K] lanes (+ [G, K, E] entries)."""

    mtype: torch.Tensor      # i32 (empty slot when from_ == 0)
    from_: torch.Tensor      # i32 replica id (0 = empty slot)
    term: torch.Tensor
    log_term: torch.Tensor
    log_index: torch.Tensor
    commit: torch.Tensor
    reject: torch.Tensor     # bool
    hint: torch.Tensor
    hint_high: torch.Tensor
    n_ent: torch.Tensor      # i32 — entries carried (replicate)
    ent_term: torch.Tensor   # [G, K, E] i32
    ent_cc: torch.Tensor     # [G, K, E] bool
    # inline payload lanes; None when payloads stay host-side
    ent_val: torch.Tensor | None = None


def empty_inbox(kp: P.KernelParams, num_shards: int, device=None) -> Inbox:
    dev = resolve_device(device)
    G, K, E = num_shards, kp.inbox_cap, kp.msg_entries
    z = lambda *s: torch.zeros((G, *s), dtype=torch.int32, device=dev)  # noqa: E731
    zb = lambda *s: torch.zeros((G, *s), dtype=torch.bool, device=dev)  # noqa: E731
    return Inbox(
        mtype=z(K), from_=z(K), term=z(K), log_term=z(K), log_index=z(K),
        commit=z(K), reject=zb(K), hint=z(K), hint_high=z(K),
        n_ent=z(K), ent_term=z(K, E), ent_cc=zb(K, E),
        ent_val=z(K, E) if kp.inline_payloads else None,
    )


class StepInput(NamedTuple):
    """Everything a shard consumes in one step besides its inbox."""

    prop_valid: torch.Tensor     # [G, B] bool
    prop_cc: torch.Tensor        # [G, B] bool
    ri_valid: torch.Tensor       # [G] bool
    ri_low: torch.Tensor         # [G] i32
    ri_high: torch.Tensor        # [G] i32
    transfer_to: torch.Tensor    # [G] i32 (0 = none)
    tick: torch.Tensor           # [G] bool — advance the logical clock
    quiesced: torch.Tensor       # [G] bool — tick in quiesced mode
    applied: torch.Tensor        # [G] i32 — host-confirmed applied cursor
    # inline proposal payloads (device-SM path); None = host-side payloads
    prop_val: torch.Tensor | None = None


def empty_input(kp: P.KernelParams, num_shards: int, device=None) -> StepInput:
    dev = resolve_device(device)
    G, B = num_shards, kp.proposal_cap
    z = lambda *s: torch.zeros((G, *s), dtype=torch.int32, device=dev)  # noqa: E731
    zb = lambda *s: torch.zeros((G, *s), dtype=torch.bool, device=dev)  # noqa: E731
    return StepInput(
        prop_valid=zb(B), prop_cc=zb(B),
        ri_valid=zb(), ri_low=z(), ri_high=z(),
        transfer_to=z(), tick=zb(), quiesced=zb(), applied=z(),
    )


class StepOutput(NamedTuple):
    """Per-shard, per-step results as fixed lanes."""

    # responses to inbox slots [G, K]
    r_type: torch.Tensor     # i32 (0 = none; NoOP uses its real enum value)
    r_to: torch.Tensor
    r_term: torch.Tensor
    r_log_index: torch.Tensor
    r_reject: torch.Tensor   # bool
    r_hint: torch.Tensor
    r_hint_high: torch.Tensor

    # replicate/vote lanes per peer [G, P]
    s_rep: torch.Tensor      # bool — send a Replicate to this peer
    s_prev_index: torch.Tensor
    s_prev_term: torch.Tensor
    s_commit: torch.Tensor
    s_n_ent: torch.Tensor
    s_ent_term: torch.Tensor  # [G, P, E]
    s_ent_cc: torch.Tensor    # [G, P, E] bool
    s_ent_val: torch.Tensor | None  # [G, P, E] i32; None unless inline
    s_vote: torch.Tensor      # i32: 0 none, 1 RequestVote, 2 RequestPreVote
    s_vote_term: torch.Tensor
    s_vote_lindex: torch.Tensor
    s_vote_lterm: torch.Tensor
    s_vote_hint: torch.Tensor
    s_hb: torch.Tensor        # bool — heartbeat to this peer
    s_hb_commit: torch.Tensor
    s_hb_low: torch.Tensor
    s_hb_high: torch.Tensor
    s_timeout_now: torch.Tensor   # bool
    s_need_snapshot: torch.Tensor  # bool — host must stream a snapshot
    s_wit_snap: torch.Tensor      # bool — witness peer behind compaction

    # persistence + apply pipeline [G]
    save_first: torch.Tensor
    save_last: torch.Tensor
    apply_first: torch.Tensor
    apply_last: torch.Tensor
    term: torch.Tensor
    vote: torch.Tensor
    commit: torch.Tensor

    # ReadIndex results [G, RI]
    rtr_valid: torch.Tensor
    rtr_index: torch.Tensor
    rtr_low: torch.Tensor
    rtr_high: torch.Tensor
    ri_dropped: torch.Tensor  # [G] bool

    # proposal fates [G, B]
    prop_accepted: torch.Tensor  # bool
    prop_index: torch.Tensor
    prop_term: torch.Tensor

    # events [G]
    leader: torch.Tensor
    leader_term: torch.Tensor
    needs_host: torch.Tensor
