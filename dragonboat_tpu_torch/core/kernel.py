"""The batched Raft step kernel, in PyTorch with the [G] axis written out.

One call advances every shard one step: drain the inbox lanes, serve the
batched ReadIndex request, append proposals, apply the transfer request,
tick the logical clock, then materialize one coalesced send phase.  This
is the port of the reference's ``core/kernel.py``.  There the body is
per-shard code under ``jax.vmap``; here every per-shard scalar is a ``[G]``
tensor, every ``[P]``/``[RI]``/``[CAP]`` lane a ``[G, ...]`` tensor, and
the per-family ``lax.scan`` over inbox slots a Python loop over the static
slot lists.  Every branch runs for every shard as masked updates, exactly
as in the reference, so the port stays bitwise equal to it
(``tests/test_torch_step.py``).

Broadcasting: ``sel`` and ``mrep`` align operands on the LEADING (shard)
axis — a ``[G]`` mask or value spreads over a field's trailing axes, which
is what the reference's per-shard scalars did under vmap.  Everywhere else
mixed-rank operands are aligned by hand with ``[:, None]``.

Integer hazards handled here: ``argmax`` on bool masks goes through int32
(ties go to the first index in both libraries), ``sum``/``cumsum`` take
``dtype=int32``, and the uint32 timeout mixer runs on int64 masked to 32
bits (``params.splitmix32_t``).

The commit rule's order statistic goes through K1
(``parallel/fabric_kernels.quorum_match``), which launches the CUDA kernel
on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.core import params as P
from dragonboat_tpu_torch.core.kstate import (
    Inbox,
    ShardState,
    StepInput,
    StepOutput,
)
from dragonboat_tpu_torch.parallel.fabric_kernels import quorum_match

I32 = torch.int32
INT_MAX = 2**31 - 1
MT = pb.MessageType

# Contracts for the kernel-local structs, PER SHARD as in the reference
# (the port adds the leading [G] axis to every field).
CONTRACTS = {
    "Effects": {
        "need_rep": "[P] bool part=G",
        "need_hb": "[] bool part=G",
        "hb_low": "[] i32 part=G",
        "hb_high": "[] i32 part=G",
        "send_vote": "[] i32 part=G",
        "vote_hint": "[] i32 part=G",
        "send_tn": "[P] bool part=G",
        "rtr_valid": "[RI] bool part=G",
        "rtr_index": "[RI] i32 part=G",
        "rtr_low": "[RI] i32 part=G",
        "rtr_high": "[RI] i32 part=G",
        "rtr_n": "[] i32 part=G",
        "save_from": "[] i32 part=G",
        "ri_dropped": "[] bool part=G",
    },
    "_Pre": {
        "act": "[] bool part=G",
        "is_leader": "[] bool part=G",
        "is_candidate": "[] bool part=G",
        "is_follower_like": "[] bool part=G",
        "sender_known": "[] bool part=G",
        "sender_slot": "[] i32 part=G",
        "noop_reply": "[] bool part=G",
    },
    "_Resp": {
        "r_type": "[] i32 part=G",
        "r_to": "[] i32 part=G",
        "r_term": "[] i32 part=G",
        "r_log_index": "[] i32 part=G",
        "r_reject": "[] bool part=G",
        "r_hint": "[] i32 part=G",
        "r_hint_high": "[] i32 part=G",
    },
}


def _lift(x, ndim: int):
    """Left-align a [G, ...] tensor against an ``ndim``-axis operand."""
    if isinstance(x, torch.Tensor) and x.dim() < ndim:
        return x.reshape(x.shape + (1,) * (ndim - x.dim()))
    return x


def sel(c, a, b):
    """``where(c, a, b)`` with shard-axis (leading) alignment; Python
    scalars take the dtype of the tensor operand (int32 when both are)."""
    n = max(t.dim() for t in (c, a, b) if isinstance(t, torch.Tensor))
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        dt = torch.bool if isinstance(a, bool) and isinstance(b, bool) else I32
        a = torch.full(c.shape, a, dtype=dt, device=c.device)
    return torch.where(_lift(c, n), _lift(a, n), _lift(b, n))


def mrep(s: ShardState, mask, **kw) -> ShardState:
    """Masked replace: set fields where the [G] mask holds."""
    return s._replace(**{k: sel(mask, v, getattr(s, k)) for k, v in kw.items()})


def _tree_sel(mask, a: NamedTuple, b: NamedTuple):
    """Field-wise ``sel(mask, a, b)``; fields that are the same tensor in
    both (untouched by the branch) are kept as they are."""
    return type(b)(*[
        y if (x is y or y is None) else sel(mask, x, y)
        for x, y in zip(a, b)])


def _argmax(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """First True index along ``dim`` (0 when none), as int32."""
    return torch.argmax(mask.to(I32), dim=dim).to(I32)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


class Effects(NamedTuple):
    """Step-local accumulator consumed by the send phase."""

    need_rep: torch.Tensor       # [G, P] bool
    need_hb: torch.Tensor        # [G] bool
    hb_low: torch.Tensor
    hb_high: torch.Tensor
    send_vote: torch.Tensor      # 0 none / 1 RequestVote / 2 RequestPreVote
    vote_hint: torch.Tensor
    send_tn: torch.Tensor        # [G, P] bool — TimeoutNow
    rtr_valid: torch.Tensor      # [G, RI]
    rtr_index: torch.Tensor
    rtr_low: torch.Tensor
    rtr_high: torch.Tensor
    rtr_n: torch.Tensor
    save_from: torch.Tensor      # min appended/truncated index this step
    ri_dropped: torch.Tensor


def _empty_effects(kp: P.KernelParams, G: int, dev) -> Effects:
    Pn, RI = kp.num_peers, kp.readindex_cap
    z = lambda *s: torch.zeros((G, *s), dtype=I32, device=dev)  # noqa: E731
    zb = lambda *s: torch.zeros((G, *s), dtype=torch.bool, device=dev)  # noqa: E731
    return Effects(
        need_rep=zb(Pn), need_hb=zb(), hb_low=z(), hb_high=z(),
        send_vote=z(), vote_hint=z(), send_tn=zb(Pn),
        rtr_valid=zb(RI), rtr_index=z(RI), rtr_low=z(RI), rtr_high=z(RI),
        rtr_n=z(), save_from=torch.full((G,), INT_MAX, dtype=I32, device=dev),
        ri_dropped=zb(),
    )


# ---------------------------------------------------------------------------
# one-hot / gather reads and writes of one dynamic slot per shard
# ---------------------------------------------------------------------------


def _set1(arr, idx, val, mask):
    """arr[g, idx[g]] = val[g] where mask[g], as a one-hot select
    (arr [G, N], idx/mask [G], val scalar or [G])."""
    oh = (_arange(arr.shape[1], arr)[None, :] == idx[:, None]) & mask[:, None]
    return sel(oh, val, arr)


def _clear_row(arr, idx, mask):
    """arr[g, idx[g], :] = False where mask[g] (arr [G, N, P] bool)."""
    oh = (_arange(arr.shape[1], arr)[None, :] == idx[:, None]) & mask[:, None]
    return arr & ~oh[:, :, None]


def onehot_select(oh, arr, axis: int):
    """Reduce ``arr`` along ``axis`` through the one-hot mask ``oh``
    (broadcastable to arr).  Exact when at most one slot is hot."""
    if arr.dtype == torch.bool:
        return (oh & arr).any(dim=axis)
    return torch.where(oh, arr, 0).sum(dim=axis, dtype=arr.dtype)


def _get1(kp: P.KernelParams, arr, idx):
    """arr[g, idx[g, ...]] for arr [G, N] and any [G, ...] index in [0, N).

    Both lowerings of the reference: a gather, or with ``kp.onehot_reads``
    a one-hot compare+select+sum.  Every caller passes an in-range index,
    so the two are bitwise identical."""
    G, N = arr.shape
    if not kp.onehot_reads:
        got = torch.gather(arr, 1, idx.reshape(G, -1).long())
        return got.reshape(idx.shape)
    oh = idx.unsqueeze(-1) == _arange(N, arr)
    return onehot_select(oh, arr.reshape((G,) + (1,) * (idx.dim() - 1) + (N,)), -1)


def _get_row(kp: P.KernelParams, arr, idx):
    """arr[g, idx[g], :] for arr [G, N, P] and idx [G]."""
    G, N, Pn = arr.shape
    if not kp.onehot_reads:
        ix = idx.long().reshape(G, 1, 1).expand(G, 1, Pn)
        return torch.gather(arr, 1, ix)[:, 0]
    oh = _arange(N, arr)[None, :] == idx[:, None]
    return onehot_select(oh[:, :, None], arr, 1)


# ---------------------------------------------------------------------------
# log-ring helpers
# ---------------------------------------------------------------------------


def _slot(kp: P.KernelParams, idx):
    return idx & (kp.log_cap - 1)


def log_term_at(kp: P.KernelParams, s: ShardState, idx):
    """(term, compacted, unavailable) for index idx ([G] or [G, ...])."""
    n = idx.dim()
    snap_i, snap_t = _lift(s.snap_index, n), _lift(s.snap_term, n)
    last = _lift(s.last, n)
    in_ring = (idx > snap_i) & (idx <= last)
    t = sel(idx == 0, 0,
            sel(idx == snap_i, snap_t,
                sel(in_ring, _get1(kp, s.lt, _slot(kp, idx)), 0)))
    return t, idx < snap_i, idx > last


def match_term(kp, s, idx, term):
    t, comp, unav = log_term_at(kp, s, idx)
    return (~comp) & (~unav) & (t == term)


def up_to_date(kp, s, idx, term):
    lt_last, _, _ = log_term_at(kp, s, s.last)
    return (term > lt_last) | ((term == lt_last) & (idx >= s.last))


def _cc_count_in(kp: P.KernelParams, s: ShardState, lo, hi):
    """Config-change entries with index in (lo, hi]."""
    j = _arange(kp.log_cap, s.lt)[None, :]
    last = s.last[:, None]
    idx = last - ((last - j) & (kp.log_cap - 1))
    live = (idx > lo[:, None]) & (idx <= hi[:, None]) & (idx > s.snap_index[:, None])
    return (live & s.lcc).sum(dim=1, dtype=I32)


# ---------------------------------------------------------------------------
# peer-book helpers
# ---------------------------------------------------------------------------


def _self_slot_mask(s: ShardState):
    return (s.pid == s.replica_id[:, None]) & (s.kind != P.K_ABSENT)


def _voting_mask(s: ShardState):
    return (s.kind == P.K_VOTER) | (s.kind == P.K_WITNESS)


def _num_voting(s: ShardState):
    return _voting_mask(s).sum(dim=1, dtype=I32)


def _quorum(s: ShardState):
    return _num_voting(s) // 2 + 1


def _is_single_node(s: ShardState):
    return _quorum(s) == 1


def _self_removed(s: ShardState):
    return ~_self_slot_mask(s).any(dim=1)


def _sorted_match_quorum_index(kp: P.KernelParams, s: ShardState):
    """The q-th largest match among voting members (K1)."""
    return quorum_match(s.match, _voting_mask(s), _quorum(s))


def _try_commit(kp, s: ShardState) -> ShardState:
    q = _sorted_match_quorum_index(kp, s)
    t, comp, _ = log_term_at(kp, s, q)
    t = sel(comp, 0, t)
    ok = (q > s.committed) & (t == s.term) & (s.role == P.LEADER)
    return mrep(s, ok, committed=q)


# ---------------------------------------------------------------------------
# state transitions
# ---------------------------------------------------------------------------


def _next_rand_timeout(s: ShardState):
    """uint32 ``splitmix32(seed ^ (counter * 0x632BE5AB)) % e_timeout``,
    computed on int64 masked to 32 bits."""
    counter = s.rand_counter + 1
    mixed = P.splitmix32_t(P.u32(s.seed) ^ P.mul32(P.u32(counter), 0x632BE5AB))
    r = (mixed % P.u32(s.e_timeout)).to(I32)
    return counter, s.e_timeout + r


def _reset(s: ShardState, mask, term, reset_timeout) -> ShardState:
    """Shared reset on every role transition."""
    if not isinstance(reset_timeout, torch.Tensor):
        reset_timeout = torch.full_like(mask, bool(reset_timeout))
    term_changed = s.term != term
    counter, rand_t = _next_rand_timeout(s)
    self_mask = _self_slot_mask(s)
    return mrep(
        s, mask,
        term=term,
        vote=sel(term_changed, 0, s.vote),
        e_tick=sel(reset_timeout, 0, s.e_tick),
        rand_counter=sel(reset_timeout, counter, s.rand_counter),
        rand_timeout=sel(reset_timeout, rand_t, s.rand_timeout),
        h_tick=0,
        pending_cc=False,
        ltt=0,
        vresp=False,
        vgrant=False,
        match=sel(self_mask, s.last, 0),
        next=(s.last + 1)[:, None].expand_as(s.next),
        pstate=0,
        active=False,
        psnap=0,
        ri_head=0,
        ri_count=0,
        ri_acks=False,
    )


def _become_follower(s, mask, term, leader, reset_timeout=True):
    # witnesses/non-votings keep their role on term bumps
    new_role = sel(s.role == P.NON_VOTING, P.NON_VOTING,
                   sel(s.role == P.WITNESS, P.WITNESS, P.FOLLOWER))
    if not isinstance(reset_timeout, torch.Tensor):
        reset_timeout = torch.full_like(mask, bool(reset_timeout))
    s = _reset(s, mask, sel(mask, term, s.term), reset_timeout & mask)
    return mrep(s, mask, role=new_role, leader=leader)


def _append_one(kp, s: ShardState, mask, term, is_cc) -> ShardState:
    idx = s.last + 1
    slot = _slot(kp, idx)
    s = s._replace(lt=_set1(s.lt, slot, term, mask),
                   lcc=_set1(s.lcc, slot, is_cc, mask))
    if kp.inline_payloads:
        s = s._replace(lv=_set1(s.lv, slot, 0, mask))
    return mrep(s, mask, last=idx)


def _become_leader(kp, s: ShardState, mask, eff: Effects):
    """Candidate to leader: reset, restore the pending-CC flag, append a
    noop, broadcast."""
    s2 = _reset(s, mask, s.term, True)
    s2 = mrep(s2, mask, role=P.LEADER, leader=s.replica_id)
    cc_pending = _cc_count_in(kp, s2, s2.committed, s2.last) > 0
    s2 = mrep(s2, mask, pending_cc=cc_pending)
    s2 = _append_one(kp, s2, mask, s2.term, False)
    self_mask = _self_slot_mask(s2) & mask[:, None]
    s2 = s2._replace(
        match=sel(self_mask, s2.last, s2.match),
        next=sel(self_mask, s2.last + 1, s2.next),
    )
    s2 = _try_commit(kp, s2)
    eff = eff._replace(
        need_rep=sel(mask, True, eff.need_rep),
        save_from=sel(mask, torch.minimum(eff.save_from, s2.last), eff.save_from),
    )
    return s2, eff


def _campaign(kp, s: ShardState, eff: Effects, mask, allow_prevote=True):
    """Election entry: pre-vote campaign unless transferring; single-node
    fast path to leader."""
    # refuse to campaign only while a config change sits committed but
    # unapplied
    gate = (s.committed > s.applied) & (
        _cc_count_in(kp, s, s.applied, s.committed) > 0)
    mask = mask & ~gate & ~_self_removed(s)
    use_prevote = s.pre_vote & ~s.is_ltt
    if not allow_prevote:
        use_prevote = torch.zeros_like(use_prevote)
    single = _is_single_node(s)

    # pre-vote branch: no term bump
    pv = mask & use_prevote
    s = _reset(s, pv, s.term, True)
    s = mrep(s, pv, role=P.PRE_VOTE_CANDIDATE, leader=0)
    self_mask = _self_slot_mask(s) & pv[:, None]
    s = s._replace(vresp=s.vresp | self_mask, vgrant=s.vgrant | self_mask)
    eff = eff._replace(send_vote=sel(pv & ~single, 2, eff.send_vote))

    # real campaign branch
    rc = mask & (~use_prevote | single)
    hint = sel(s.is_ltt, s.replica_id, 0)
    s = _reset(s, rc, s.term + 1, True)
    s = mrep(s, rc, role=P.CANDIDATE, leader=0, vote=s.replica_id,
             is_ltt=False)
    self_mask = _self_slot_mask(s) & rc[:, None]
    s = s._replace(vresp=s.vresp | self_mask, vgrant=s.vgrant | self_mask)
    eff = eff._replace(
        send_vote=sel(rc & ~single, 1, eff.send_vote),
        vote_hint=sel(rc & ~single, hint, eff.vote_hint),
    )
    return _become_leader(kp, s, rc & single, eff)


# ---------------------------------------------------------------------------
# readindex book
# ---------------------------------------------------------------------------


def _ri_push(kp, s: ShardState, mask, low, high, index):
    RI = kp.readindex_cap
    full = s.ri_count >= RI
    pos = (s.ri_head + s.ri_count) & (RI - 1)
    do = mask & ~full
    s = s._replace(
        ri_low=_set1(s.ri_low, pos, low, do),
        ri_high=_set1(s.ri_high, pos, high, do),
        ri_index=_set1(s.ri_index, pos, index, do),
        ri_acks=_clear_row(s.ri_acks, pos, do),
    )
    s = mrep(s, do, ri_count=s.ri_count + 1)
    # a full book drops the request (the host retries)
    return s, mask & full


def _ri_confirm(kp, s: ShardState, eff: Effects, mask, low, high, sender_slot):
    """Ack ctx from sender; pop every ctx at or before it once a quorum
    has acked."""
    RI = kp.readindex_cap
    ar = _arange(RI, s.ri_low)
    # queue position of each physical slot (0..count-1)
    qpos = (ar[None, :] - s.ri_head[:, None]) & (RI - 1)
    live = qpos < s.ri_count[:, None]
    hit = live & (s.ri_low == low[:, None]) & (s.ri_high == high[:, None])
    hit_any = mask & hit.any(dim=1)
    hit_slot = _argmax(hit)
    Pn = s.ri_acks.shape[2]
    oh2 = ((ar[None, :] == hit_slot[:, None])[:, :, None]
           & (_arange(Pn, s.ri_low)[None, :] == sender_slot[:, None])[:, None, :]
           & hit_any[:, None, None])
    s = s._replace(ri_acks=s.ri_acks | oh2)
    n_acks = _get_row(kp, s.ri_acks, hit_slot).sum(dim=1, dtype=I32)
    quorum_ok = hit_any & (n_acks + 1 >= _quorum(s))
    pop_n = sel(quorum_ok, _get1(kp, qpos, hit_slot) + 1, 0)
    # pop: each popped ctx goes to rtr lane base + qpos
    popping = live & (qpos < pop_n[:, None])
    base = eff.rtr_n
    out_pos = base[:, None] + qpos
    rv, ri_, rl, rh = (list(t.unbind(1)) for t in (
        eff.rtr_valid, eff.rtr_index, eff.rtr_low, eff.rtr_high))
    for j in range(RI):
        src = popping & (out_pos == j)
        any_src = src.any(dim=1)
        k = _argmax(src)
        rv[j] = rv[j] | any_src
        ri_[j] = sel(any_src, _get1(kp, s.ri_index, k), ri_[j])
        rl[j] = sel(any_src, _get1(kp, s.ri_low, k), rl[j])
        rh[j] = sel(any_src, _get1(kp, s.ri_high, k), rh[j])
    eff = eff._replace(
        rtr_valid=torch.stack(rv, 1), rtr_index=torch.stack(ri_, 1),
        rtr_low=torch.stack(rl, 1), rtr_high=torch.stack(rh, 1),
        rtr_n=base + pop_n,
    )
    s = mrep(s, pop_n > 0,
             ri_head=(s.ri_head + pop_n) & (RI - 1),
             ri_count=s.ri_count - pop_n)
    return s, eff


# ---------------------------------------------------------------------------
# the per-message processor (loop body over the K inbox slots)
# ---------------------------------------------------------------------------


class _Pre(NamedTuple):
    """Shared term/role preamble results for one inbound message."""

    act: torch.Tensor
    is_leader: torch.Tensor
    is_candidate: torch.Tensor
    is_follower_like: torch.Tensor
    sender_known: torch.Tensor
    sender_slot: torch.Tensor
    noop_reply: torch.Tensor


class _Resp(NamedTuple):
    r_type: torch.Tensor
    r_to: torch.Tensor
    r_term: torch.Tensor
    r_log_index: torch.Tensor
    r_reject: torch.Tensor
    r_hint: torch.Tensor
    r_hint_high: torch.Tensor


def _preamble(kp: P.KernelParams, s: ShardState, m: Inbox):
    """Term preamble and role folding shared by every handler family."""
    valid = m.from_ != 0
    mtype = m.mtype

    slot_hit = (s.pid == m.from_[:, None]) & (s.kind != P.K_ABSENT)
    sender_known = slot_hit.any(dim=1)
    sender_slot = _argmax(slot_hit)

    is_rv_msg = (mtype == MT.REQUEST_VOTE) | (mtype == MT.REQUEST_PREVOTE)
    is_leader_msg = (
        (mtype == MT.REPLICATE)
        | (mtype == MT.HEARTBEAT)
        | (mtype == MT.TIMEOUT_NOW)
        | (mtype == MT.READ_INDEX_RESP)
    )

    drop_rv = (
        valid & is_rv_msg & s.check_quorum & (m.term > s.term)
        & (m.hint != m.from_)
        & (s.leader != 0) & (s.e_tick < s.e_timeout)
    )
    higher = valid & (m.term > s.term) & ~drop_rv
    prevote_expected = (mtype == MT.REQUEST_PREVOTE) | (
        (mtype == MT.REQUEST_PREVOTE_RESP) & ~m.reject
    )
    bump = higher & ~prevote_expected
    new_leader = sel(is_leader_msg, m.from_, 0)
    keep_tick = mtype == MT.REQUEST_VOTE
    s = _become_follower(s, bump, m.term, new_leader, reset_timeout=~keep_tick)

    lower = valid & (m.term < s.term) & (m.term != 0)
    # free-stuck-candidate NoOP
    noop_reply = lower & (
        (mtype == MT.REQUEST_PREVOTE)
        | (is_leader_msg & (s.check_quorum | s.pre_vote))
    )
    ignore = drop_rv | lower

    act = valid & ~ignore
    is_candidate = (s.role == P.CANDIDATE) | (s.role == P.PRE_VOTE_CANDIDATE)
    is_follower_like = (
        (s.role == P.FOLLOWER) | (s.role == P.NON_VOTING) | (s.role == P.WITNESS)
    )

    # candidate + same-term leader message -> become follower
    cand_fold = act & is_candidate & (
        (mtype == MT.REPLICATE) | (mtype == MT.HEARTBEAT)
    )
    s = _become_follower(s, cand_fold, s.term, m.from_)
    is_follower_like = is_follower_like | cand_fold

    pre = _Pre(
        act=act,
        is_leader=s.role == P.LEADER,
        is_candidate=is_candidate,
        is_follower_like=is_follower_like,
        sender_known=sender_known,
        sender_slot=sender_slot,
        noop_reply=noop_reply,
    )
    return s, pre


def _empty_resp(s: ShardState, m: Inbox, pre: _Pre) -> _Resp:
    z = torch.zeros_like(s.term)
    return _Resp(
        r_type=sel(pre.noop_reply, int(MT.NOOP), 0),
        r_to=m.from_,
        r_term=s.term,
        r_log_index=z,
        r_reject=torch.zeros_like(pre.act),
        r_hint=z,
        r_hint_high=z,
    )


def _h_replicate(kp, s: ShardState, eff: Effects, m: Inbox, pre: _Pre, r: _Resp):
    """Follower-side Replicate."""
    E = kp.msg_entries
    h_rep = pre.act & pre.is_follower_like & (m.mtype == MT.REPLICATE)
    s = mrep(s, h_rep, leader=m.from_, e_tick=0)
    below_commit = m.log_index < s.committed
    prev_ok = match_term(kp, s, m.log_index, m.log_term)
    # ring-capacity guard: reject rather than run the append past the ring
    over_cap = (m.log_index + m.n_ent - s.snap_index) > kp.log_cap
    accept = h_rep & ~below_commit & prev_ok & ~over_cap
    s = mrep(s, h_rep & over_cap, needs_host=True)
    # conflict scan over the E entry lanes
    lane = _arange(E, s.lt)[None, :]
    ent_idx = m.log_index[:, None] + 1 + lane
    ent_live = lane < m.n_ent[:, None]
    ent_match = match_term(kp, s, ent_idx, m.ent_term)
    conflict_lane = ent_live & ~ent_match
    any_conflict = conflict_lane.any(dim=1)
    first_conflict = _argmax(conflict_lane)
    # append entries from the first conflicting lane on
    do_append = accept & any_conflict
    append_from_lane = first_conflict
    write_lane = ent_live & (lane >= append_from_lane[:, None])
    wmask = do_append[:, None] & write_lane
    cap = kp.log_cap
    # each ring slot gathers its (consecutive mod cap) message lane
    rel = (_arange(cap, s.lt)[None, :]
           - _slot(kp, m.log_index + 1)[:, None]) & (cap - 1)
    lane_of_slot = torch.clamp(rel, max=E - 1)
    slot_written = (rel < E) & _get1(kp, wmask, lane_of_slot)
    s = s._replace(
        lt=torch.where(slot_written, _get1(kp, m.ent_term, lane_of_slot), s.lt),
        lcc=torch.where(slot_written, _get1(kp, m.ent_cc, lane_of_slot), s.lcc),
    )
    if kp.inline_payloads:
        # a payload-carrying kernel must be fed payload lanes: zeros
        # would silently corrupt follower state machines after a failover
        if m.ent_val is None:
            raise ValueError("inline_payloads kernel requires Inbox.ent_val lanes")
        s = s._replace(
            lv=torch.where(slot_written, _get1(kp, m.ent_val, lane_of_slot), s.lv))
    new_last_if_append = m.log_index + m.n_ent
    s = mrep(s, do_append, last=new_last_if_append,
             stable=torch.minimum(s.stable, m.log_index + append_from_lane))
    eff = eff._replace(save_from=sel(
        do_append,
        torch.minimum(eff.save_from, m.log_index + append_from_lane + 1),
        eff.save_from))
    last_idx_msg = m.log_index + m.n_ent
    commit_to = torch.minimum(torch.minimum(last_idx_msg, m.commit), s.last)
    s = mrep(s, accept, committed=torch.maximum(s.committed, commit_to))
    stale = h_rep & below_commit
    r = r._replace(
        r_type=sel(stale, int(MT.REPLICATE_RESP), r.r_type),
        r_log_index=sel(stale, s.committed, r.r_log_index),
    )
    r = r._replace(
        r_type=sel(accept, int(MT.REPLICATE_RESP), r.r_type),
        r_log_index=sel(accept, last_idx_msg, r.r_log_index),
    )
    rejected = h_rep & ~below_commit & (~prev_ok | over_cap)
    r = r._replace(
        r_type=sel(rejected, int(MT.REPLICATE_RESP), r.r_type),
        r_reject=r.r_reject | rejected,
        r_log_index=sel(rejected, m.log_index, r.r_log_index),
        r_hint=sel(rejected, s.last, r.r_hint),
    )
    return s, eff, r


def _h_heartbeat(kp, s: ShardState, eff: Effects, m: Inbox, pre: _Pre, r: _Resp):
    """Follower-side Heartbeat."""
    h_hb = pre.act & pre.is_follower_like & (m.mtype == MT.HEARTBEAT)
    s = mrep(s, h_hb, leader=m.from_, e_tick=0,
             committed=torch.maximum(s.committed, torch.minimum(m.commit, s.last)))
    r = r._replace(
        r_type=sel(h_hb, int(MT.HEARTBEAT_RESP), r.r_type),
        r_hint=sel(h_hb, m.hint, r.r_hint),
        r_hint_high=sel(h_hb, m.hint_high, r.r_hint_high),
    )
    return s, eff, r


def _h_votereq(kp, s: ShardState, eff: Effects, m: Inbox, pre: _Pre, r: _Resp):
    """RequestVote / RequestPreVote / TimeoutNow."""
    act = pre.act
    # RequestVote
    h_rv = act & (m.mtype == MT.REQUEST_VOTE)
    can_grant = (s.vote == 0) | (s.vote == m.from_)
    utd = up_to_date(kp, s, m.log_index, m.log_term)
    grant = h_rv & can_grant & utd
    s = mrep(s, grant, vote=m.from_, e_tick=0)
    r = r._replace(
        r_type=sel(h_rv, int(MT.REQUEST_VOTE_RESP), r.r_type),
        r_reject=r.r_reject | (h_rv & ~grant),
    )
    # RequestPreVote
    h_pv = act & (m.mtype == MT.REQUEST_PREVOTE)
    pv_grant = h_pv & (m.term > s.term) & utd
    r = r._replace(
        r_type=sel(h_pv, int(MT.REQUEST_PREVOTE_RESP), r.r_type),
        r_term=sel(pv_grant, m.term, r.r_term),
        r_reject=r.r_reject | (h_pv & ~pv_grant),
    )
    # TimeoutNow (follower)
    h_tn = act & (s.role == P.FOLLOWER) & (m.mtype == MT.TIMEOUT_NOW)
    s = mrep(s, h_tn, is_ltt=True)
    s, eff = _campaign(kp, s, eff, h_tn)
    s = mrep(s, h_tn, is_ltt=False)
    return s, eff, r


def _h_resp(kp, s: ShardState, eff: Effects, m: Inbox, pre: _Pre, r: _Resp):
    """Response-side handlers: vote tallies, replication flow control,
    heartbeat acks, unreachable, snapshot status."""
    act = pre.act
    is_leader = pre.is_leader
    sender_known, sender_slot = pre.sender_known, pre.sender_slot

    # RequestVoteResp (candidate)
    h_vr = act & (s.role == P.CANDIDATE) & (m.mtype == MT.REQUEST_VOTE_RESP)
    h_vr = h_vr & sender_known & (_get1(kp, s.kind, sender_slot) != P.K_NON_VOTING)
    not_seen = ~_get1(kp, s.vresp, sender_slot)
    s = s._replace(
        vresp=_set1(s.vresp, sender_slot, True, h_vr),
        vgrant=_set1(s.vgrant, sender_slot, ~m.reject, h_vr & not_seen),
    )
    votes_for = s.vgrant.sum(dim=1, dtype=I32)
    votes_against = (s.vresp & ~s.vgrant).sum(dim=1, dtype=I32)
    q = _quorum(s)
    s, eff = _become_leader(kp, s, h_vr & (votes_for == q), eff)
    s = _become_follower(s, h_vr & (votes_against == q), s.term, 0)

    # RequestPreVoteResp
    h_pvr = act & (s.role == P.PRE_VOTE_CANDIDATE) & (
        m.mtype == MT.REQUEST_PREVOTE_RESP)
    h_pvr = h_pvr & sender_known & (_get1(kp, s.kind, sender_slot) != P.K_NON_VOTING)
    not_seen = ~_get1(kp, s.vresp, sender_slot)
    s = s._replace(
        vresp=_set1(s.vresp, sender_slot, True, h_pvr),
        vgrant=_set1(s.vgrant, sender_slot, ~m.reject, h_pvr & not_seen),
    )
    votes_for = s.vgrant.sum(dim=1, dtype=I32)
    votes_against = (s.vresp & ~s.vgrant).sum(dim=1, dtype=I32)
    s, eff = _campaign(kp, s, eff, h_pvr & (votes_for == q),
                       allow_prevote=False)
    s = _become_follower(s, h_pvr & (votes_against == q), s.term, 0)

    # ReplicateResp (leader)
    h_rr = act & is_leader & (m.mtype == MT.REPLICATE_RESP) & sender_known
    s = s._replace(active=_set1(s.active, sender_slot, True, h_rr))
    old_match = _get1(kp, s.match, sender_slot)
    old_next = _get1(kp, s.next, sender_slot)
    old_pstate = _get1(kp, s.pstate, sender_slot)
    paused = (old_pstate == P.R_WAIT) | (old_pstate == P.R_SNAPSHOT)
    # non-reject: tryUpdate
    ok_resp = h_rr & ~m.reject
    updated = ok_resp & (old_match < m.log_index)
    s = s._replace(
        next=_set1(s.next, sender_slot,
                   torch.maximum(old_next, m.log_index + 1), ok_resp),
        match=_set1(s.match, sender_slot, m.log_index, updated),
    )
    # wait -> retry -> replicate; snapshot -> retry once caught up
    ps = _get1(kp, s.pstate, sender_slot)
    ps = sel(updated & (ps == P.R_WAIT), P.R_RETRY, ps)
    ps = sel(updated & (ps == P.R_RETRY), P.R_REPLICATE, ps)
    snap_caught = _get1(kp, s.match, sender_slot) >= _get1(kp, s.psnap, sender_slot)
    ps = sel(updated & (ps == P.R_SNAPSHOT) & snap_caught, P.R_RETRY, ps)
    s = s._replace(
        pstate=_set1(s.pstate, sender_slot, ps, h_rr),
        psnap=_set1(s.psnap, sender_slot, 0,
                    updated & (old_pstate == P.R_SNAPSHOT) & snap_caught),
    )
    committed_before = s.committed
    s = _tree_sel(updated, _try_commit(kp, s), s)
    commit_advanced = s.committed > committed_before
    # broadcast on commit advance; else resend to the (formerly paused) peer
    eff = eff._replace(need_rep=sel(
        updated & commit_advanced, True,
        _set1(eff.need_rep, sender_slot, True,
              updated & ~commit_advanced & paused)))
    # leadership transfer: target caught up -> TimeoutNow
    tn = updated & (s.ltt == m.from_) & (_get1(kp, s.match, sender_slot) == s.last)
    eff = eff._replace(send_tn=_set1(eff.send_tn, sender_slot, True, tn))
    # reject: decreaseTo + resend
    rej = h_rr & m.reject
    in_replicate = old_pstate == P.R_REPLICATE
    dec_ok_rep = rej & in_replicate & (m.log_index > old_match)
    dec_ok_probe = rej & ~in_replicate & (old_next - 1 == m.log_index)
    new_next = sel(
        in_replicate, old_match + 1,
        torch.clamp(torch.minimum(m.log_index, m.hint + 1), min=1),
    )
    dec = dec_ok_rep | dec_ok_probe
    cur_ps = _get1(kp, s.pstate, sender_slot)
    dec_ps = sel(dec_ok_rep, P.R_RETRY,
                 sel(dec_ok_probe & (cur_ps == P.R_WAIT), P.R_RETRY, cur_ps))
    s = s._replace(
        next=_set1(s.next, sender_slot, new_next, dec),
        pstate=_set1(s.pstate, sender_slot, dec_ps, h_rr),
    )
    eff = eff._replace(need_rep=_set1(eff.need_rep, sender_slot, True, dec))

    # HeartbeatResp (leader)
    h_hr = act & is_leader & (m.mtype == MT.HEARTBEAT_RESP) & sender_known
    s = s._replace(
        active=_set1(s.active, sender_slot, True, h_hr),
        pstate=_set1(s.pstate, sender_slot, P.R_RETRY,
                     h_hr & (_get1(kp, s.pstate, sender_slot) == P.R_WAIT)),
    )
    lagging = _get1(kp, s.match, sender_slot) < s.last
    eff = eff._replace(need_rep=_set1(eff.need_rep, sender_slot, True,
                                      h_hr & lagging))
    conf = h_hr & (m.hint != 0)
    s_c, eff_c = _ri_confirm(kp, s, eff, conf, m.hint, m.hint_high, sender_slot)
    s = _tree_sel(conf, s_c, s)
    eff = _tree_sel(conf, eff_c, eff)

    # Unreachable (leader)
    h_un = act & is_leader & (m.mtype == MT.UNREACHABLE) & sender_known
    s = s._replace(pstate=_set1(
        s.pstate, sender_slot, P.R_RETRY,
        h_un & (_get1(kp, s.pstate, sender_slot) == P.R_REPLICATE)))

    # SnapshotStatus (leader, immediate variant)
    h_ss = act & is_leader & (m.mtype == MT.SNAPSHOT_STATUS) & sender_known
    in_snap = _get1(kp, s.pstate, sender_slot) == P.R_SNAPSHOT
    # becomeWait: next = max(match+1, psnap+1) on success; clear psnap on reject
    cur_match = _get1(kp, s.match, sender_slot)
    nn = sel(m.reject, cur_match + 1,
             torch.maximum(cur_match + 1, _get1(kp, s.psnap, sender_slot) + 1))
    s = s._replace(
        next=_set1(s.next, sender_slot, nn, h_ss & in_snap),
        psnap=_set1(s.psnap, sender_slot, 0, h_ss & in_snap),
        pstate=_set1(s.pstate, sender_slot, P.R_WAIT, h_ss & in_snap),
    )
    return s, eff, r


_FAMILY_HANDLERS = {
    "rep": (_h_replicate,),
    "hb": (_h_heartbeat,),
    "vote": (_h_votereq,),
    "resp": (_h_resp,),
    "any": (_h_replicate, _h_heartbeat, _h_votereq, _h_resp),
}


def _process_family(kp: P.KernelParams, family: str, s: ShardState,
                    eff: Effects, m: Inbox):
    """One inbound message slot against every shard, with only
    ``family``'s handlers (their masks are mutually exclusive per type)."""
    s, pre = _preamble(kp, s, m)
    r = _empty_resp(s, m, pre)
    for h in _FAMILY_HANDLERS[family]:
        s, eff, r = h(kp, s, eff, m, pre, r)
    return s, eff, r


# ---------------------------------------------------------------------------
# full step
# ---------------------------------------------------------------------------


def step(kp: P.KernelParams, s: ShardState, box: Inbox,
         inp: StepInput) -> tuple[ShardState, StepOutput]:
    """Advance every shard row one step; returns (state, output)."""
    E, K, RI, Pn = kp.msg_entries, kp.inbox_cap, kp.readindex_cap, kp.num_peers
    G, dev = s.term.shape[0], s.term.device
    eff = _empty_effects(kp, G, dev)
    save_base = s.stable  # entries above this are unsaved at step start

    # 0. host-confirmed applied cursor
    s = s._replace(applied=torch.maximum(s.applied, inp.applied))

    # 0b. device quiesce wake: any non-heartbeat inbound message or client
    # activity wakes the lane and bumps the wake epoch
    hb_like = (box.mtype == MT.HEARTBEAT) | (box.mtype == MT.HEARTBEAT_RESP)
    activity = (
        ((box.from_ != 0) & ~hb_like).any(dim=1)
        | inp.prop_valid.any(dim=1) | inp.ri_valid | (inp.transfer_to != 0)
    )
    wake = s.quiesced & activity
    s = mrep(s, wake, quiesced=False, idle_tick=0, e_tick=0,
             quiesce_epoch=s.quiesce_epoch + 1)

    # 1. inbox processing, slots grouped by their static family; the
    # responses stack in the same (family, slot) order as the reference
    fams = P.slot_families(K)
    r_parts = []
    for fam in ("resp", "rep", "hb", "vote", "any"):
        for k in (k for k, f in enumerate(fams) if f == fam):
            m = Inbox(*[None if f is None else f[:, k] for f in box])
            s, eff, r = _process_family(kp, fam, s, eff, m)
            r_parts.append(r)
    r_stack = tuple(torch.stack([r[i] for r in r_parts], dim=1)
                    for i in range(len(_Resp._fields)))

    # 2. batched ReadIndex request (the host routes it to the leader)
    is_leader = s.role == P.LEADER
    ri_req = inp.ri_valid & is_leader
    lt_committed, comp_c, _ = log_term_at(kp, s, s.committed)
    has_cur_term_commit = (sel(comp_c, 0, lt_committed) == s.term) & (s.term > 0)
    single = _is_single_node(s)
    # single-node fast path: ready immediately
    fast = ri_req & single
    lane = torch.clamp(eff.rtr_n, max=RI - 1)
    eff = eff._replace(
        rtr_valid=_set1(eff.rtr_valid, lane, True, fast),
        rtr_index=_set1(eff.rtr_index, lane, s.committed, fast),
        rtr_low=_set1(eff.rtr_low, lane, inp.ri_low, fast),
        rtr_high=_set1(eff.rtr_high, lane, inp.ri_high, fast),
        rtr_n=eff.rtr_n + fast.to(I32),
    )
    quorum_path = ri_req & ~single & has_cur_term_commit
    s, dropped_full = _ri_push(kp, s, quorum_path, inp.ri_low, inp.ri_high,
                               s.committed)
    eff = eff._replace(
        need_hb=eff.need_hb | (quorum_path & ~dropped_full),
        hb_low=sel(quorum_path, inp.ri_low, eff.hb_low),
        hb_high=sel(quorum_path, inp.ri_high, eff.hb_high),
        ri_dropped=eff.ri_dropped
        | (inp.ri_valid & (~is_leader | (ri_req & ~single & ~has_cur_term_commit)))
        | dropped_full,
    )

    # 3. proposals (leader only, not while transferring), as the
    # reference's closed-form batch append: the ring-room guard caps the
    # accept rank, and only the first config change lands while none is
    # pending
    can_prop = is_leader & (s.ltt == 0)
    prop_vals = (inp.prop_val if inp.prop_val is not None
                 else torch.zeros(inp.prop_cc.shape, dtype=I32, device=dev))
    v0 = inp.prop_valid & can_prop[:, None]                   # [G, B]
    cc_cand = v0 & inp.prop_cc & ~s.pending_cc[:, None]
    cc_first = cc_cand & (torch.cumsum(cc_cand, dim=1, dtype=I32) == 1)
    do1 = v0 & (~inp.prop_cc | cc_first)
    m_max = kp.log_cap - (s.last - s.snap_index)              # ring room left
    do = do1 & (torch.cumsum(do1, dim=1, dtype=I32) <= m_max[:, None])
    rank = torch.cumsum(do, dim=1, dtype=I32)                 # 1-based
    n_total = rank[:, -1]
    appended_any = n_total > 0
    prop_accepted = do
    prop_index = sel(do, s.last[:, None] + rank, 0)
    prop_term = sel(do, s.term, 0)
    # compress accepted slots by rank: offset j holds the rank-(j+1) accept
    B = do.shape[1]
    ar_b = _arange(B, rank)
    rank_onehot = ((rank[:, None, :] == (ar_b + 1)[None, :, None])
                   & do[:, None, :])                          # [G, off, slot]
    cc_by_off = (rank_onehot & cc_first[:, None, :]).any(dim=2)
    val_by_off = torch.where(rank_onehot, prop_vals[:, None, :], 0).sum(
        dim=2, dtype=I32)
    # one pass over the ring: position p hosts unwrapped index base + off
    base = s.last + 1
    off = (_arange(kp.log_cap, rank)[None, :] - _slot(kp, base)[:, None]) & (
        kp.log_cap - 1)
    in_win = off < n_total[:, None]
    off_c = torch.clamp(off, max=B - 1)
    s = s._replace(
        lt=torch.where(in_win, s.term[:, None], s.lt),
        lcc=torch.where(in_win, _get1(kp, cc_by_off, off_c), s.lcc),
        last=s.last + n_total,
        pending_cc=s.pending_cc | (do & cc_first).any(dim=1),
    )
    if kp.inline_payloads:
        s = s._replace(lv=torch.where(in_win, _get1(kp, val_by_off, off_c), s.lv))
    eff = eff._replace(save_from=sel(
        appended_any, torch.minimum(eff.save_from, base), eff.save_from))
    self_mask = _self_slot_mask(s) & appended_any[:, None]
    s = s._replace(
        match=sel(self_mask, s.last, s.match),
        next=sel(self_mask, s.last + 1, s.next),
    )
    s = _tree_sel(appended_any & single, _try_commit(kp, s), s)
    eff = eff._replace(need_rep=sel(appended_any, True, eff.need_rep))

    # 4. leadership transfer request
    tr = inp.transfer_to
    tr_req = (tr != 0) & is_leader & (s.ltt == 0) & (tr != s.replica_id)
    tr_hit = (s.pid == tr[:, None]) & (s.kind == P.K_VOTER)
    tr_known = tr_hit.any(dim=1)
    tr_slot = _argmax(tr_hit)
    do_tr = tr_req & tr_known
    s = mrep(s, do_tr, ltt=tr, e_tick=0)
    fast_tn = do_tr & (_get1(kp, s.match, tr_slot) == s.last)
    eff = eff._replace(send_tn=_set1(eff.send_tn, tr_slot, True, fast_tn))

    # 5. tick
    is_leader = s.role == P.LEADER
    # quiesced: the host-driven input flag or the device-resident mask
    q_any = inp.quiesced | s.quiesced
    live_tick = inp.tick & ~q_any
    s = mrep(s, inp.tick & q_any, e_tick=s.e_tick + 1)
    # non-leader tick
    nl = live_tick & ~is_leader
    s = mrep(s, nl, e_tick=s.e_tick + 1)
    can_campaign = (
        (s.role == P.FOLLOWER) | (s.role == P.CANDIDATE)
        | (s.role == P.PRE_VOTE_CANDIDATE)
    )
    elect = nl & can_campaign & (s.e_tick >= s.rand_timeout)
    s = mrep(s, elect, e_tick=0)
    s, eff = _campaign(kp, s, eff, elect)
    # leader tick
    lt_ = live_tick & is_leader
    s = mrep(s, lt_, e_tick=s.e_tick + 1)
    cq_time = lt_ & (s.e_tick >= s.e_timeout)
    abort_tr = cq_time & (s.ltt != 0)
    s = mrep(s, cq_time, e_tick=0)
    # checkQuorum: count active voters (self counts), reset
    do_cq = cq_time & s.check_quorum
    active_v = (_voting_mask(s) & (s.active | _self_slot_mask(s))).sum(
        dim=1, dtype=I32)
    lost = do_cq & (active_v < _quorum(s))
    s = s._replace(active=s.active & ~do_cq[:, None])
    s = _become_follower(s, lost, s.term, 0)
    s = mrep(s, abort_tr & ~lost, ltt=0)
    is_leader = s.role == P.LEADER
    lt_ = lt_ & is_leader
    s = mrep(s, lt_, h_tick=s.h_tick + 1)
    hb_time = lt_ & (s.h_tick >= s.h_timeout)
    s = mrep(s, hb_time, h_tick=0)
    # heartbeat broadcast carries the newest pending ReadIndex ctx
    newest = (s.ri_head + s.ri_count - 1) & (RI - 1)
    has_pending = s.ri_count > 0
    eff = eff._replace(
        need_hb=eff.need_hb | hb_time,
        hb_low=sel(hb_time, sel(has_pending, _get1(kp, s.ri_low, newest), 0),
                   eff.hb_low),
        hb_high=sel(hb_time, sel(has_pending, _get1(kp, s.ri_high, newest), 0),
                    eff.hb_high),
    )

    # 5b. device quiesce idle clock + entry (evaluated after this step's
    # tick work, so the crossing step still ran live)
    s = mrep(s, inp.tick & ~activity & ~s.quiesced, idle_tick=s.idle_tick + 1)
    s = mrep(s, activity, idle_tick=0)
    enter_q = (s.quiesce_on & ~s.quiesced & inp.tick
               & (s.idle_tick >= s.e_timeout * 10))
    s = mrep(s, enter_q, quiesced=True, e_tick=0, h_tick=0)

    # 6. send phase
    is_leader = s.role == P.LEADER
    not_self = ~_self_slot_mask(s)
    present = s.kind != P.K_ABSENT

    # replicate lanes
    want_rep = eff.need_rep & is_leader[:, None] & present & not_self
    paused_p = (s.pstate == P.R_WAIT) | (s.pstate == P.R_SNAPSHOT)
    can_send = want_rep & ~paused_p
    prev = s.next - 1
    prev_term, prev_comp, _ = log_term_at(kp, s, prev)
    needs_snap = can_send & prev_comp  # log compacted under the peer
    # witness peers take a file-less stripped snapshot: no escalation
    wit_snap = needs_snap & (s.kind == P.K_WITNESS)
    send_rep = can_send & ~prev_comp
    n_avail = torch.clamp(s.last[:, None] - prev, 0, E)
    lane = _arange(E, prev)[None, None, :]
    ent_idx = s.next[:, :, None] + lane                       # [G, P, E]
    ent_live = lane < n_avail[:, :, None]
    eslot = _slot(kp, ent_idx)
    ent_term = torch.where(ent_live, _get1(kp, s.lt, eslot), 0)
    ent_cc = ent_live & _get1(kp, s.lcc, eslot)
    ent_val = (torch.where(ent_live, _get1(kp, s.lv, eslot), 0)
               if kp.inline_payloads else None)
    # optimistic pipelined advance
    adv = send_rep & (s.pstate == P.R_REPLICATE) & (n_avail > 0)
    s = s._replace(
        next=torch.where(adv, s.next + n_avail, s.next),
        pstate=sel(send_rep & (s.pstate == P.R_RETRY), P.R_WAIT,
                   sel(needs_snap, P.R_SNAPSHOT, s.pstate)),
        psnap=sel(needs_snap, s.snap_index, s.psnap),
    )
    s = mrep(s, (needs_snap & ~wit_snap).any(dim=1), needs_host=True)

    # heartbeat lanes
    has_ctx = (eff.hb_low != 0) | (eff.hb_high != 0)
    hb_target = present & not_self & (
        _voting_mask(s) | (~has_ctx[:, None] & (s.kind == P.K_NON_VOTING)))
    send_hb = (eff.need_hb & is_leader)[:, None] & hb_target
    hb_commit = torch.minimum(s.match, s.committed[:, None])

    # vote-request lanes, masked by the end-of-step role: only a live
    # candidate may broadcast at its current term
    role_ok = sel(eff.send_vote == 2, s.role == P.PRE_VOTE_CANDIDATE,
                  s.role == P.CANDIDATE)
    vr = ((eff.send_vote > 0) & role_ok)[:, None] & _voting_mask(s) & not_self
    vote_term = sel(eff.send_vote == 2, s.term + 1, s.term)
    last_t, _, _ = log_term_at(kp, s, s.last)

    # persistence: entries (save_first..save_last]
    save_first = sel(eff.save_from == INT_MAX, save_base + 1,
                     torch.minimum(eff.save_from, save_base + 1))
    save_last = s.last
    s = s._replace(stable=torch.clamp(save_last, min=0))

    # apply release
    apply_first = s.processed + 1
    apply_last = torch.minimum(s.committed, s.processed + kp.apply_batch)
    s = s._replace(processed=torch.maximum(s.processed, apply_last))

    # device-side log compaction: raise the snapshot floor over entries
    # applied everywhere we care about, keeping compaction_overhead
    # entries for laggards; a leader also keeps what a present peer needs
    peer_floor = torch.where(
        (s.kind != P.K_ABSENT) & ~_self_slot_mask(s), s.match, INT_MAX,
    ).min(dim=1).values
    floor = torch.minimum(s.applied, s.committed)
    floor = sel(is_leader, torch.minimum(floor, peer_floor), floor)
    new_snap = torch.maximum(s.snap_index, floor - kp.compaction_overhead)
    new_snap_term, nsc, nsu = log_term_at(kp, s, new_snap)
    can_compact = (new_snap > s.snap_index) & ~nsc & ~nsu
    s = mrep(s, can_compact, snap_index=new_snap, snap_term=new_snap_term)

    def per_peer(x):  # [G] -> [G, P]
        return x[:, None].expand(G, Pn).contiguous()

    out = StepOutput(
        r_type=r_stack[0], r_to=r_stack[1], r_term=r_stack[2],
        r_log_index=r_stack[3], r_reject=r_stack[4], r_hint=r_stack[5],
        r_hint_high=r_stack[6],
        s_rep=send_rep, s_prev_index=prev,
        s_prev_term=sel(prev_comp, 0, prev_term),
        s_commit=per_peer(s.committed),
        s_n_ent=sel(send_rep, n_avail, 0),
        s_ent_term=ent_term, s_ent_cc=ent_cc, s_ent_val=ent_val,
        s_vote=sel(vr, eff.send_vote, 0),
        s_vote_term=per_peer(vote_term),
        s_vote_lindex=per_peer(s.last),
        s_vote_lterm=per_peer(last_t),
        s_vote_hint=per_peer(eff.vote_hint),
        s_hb=send_hb, s_hb_commit=hb_commit,
        s_hb_low=per_peer(eff.hb_low),
        s_hb_high=per_peer(eff.hb_high),
        s_timeout_now=eff.send_tn & is_leader[:, None],
        s_need_snapshot=needs_snap & ~wit_snap,
        s_wit_snap=wit_snap,
        save_first=save_first, save_last=save_last,
        apply_first=apply_first, apply_last=apply_last,
        term=s.term, vote=s.vote, commit=s.committed,
        rtr_valid=eff.rtr_valid, rtr_index=eff.rtr_index,
        rtr_low=eff.rtr_low, rtr_high=eff.rtr_high,
        ri_dropped=eff.ri_dropped,
        prop_accepted=prop_accepted, prop_index=prop_index, prop_term=prop_term,
        leader=s.leader, leader_term=s.term,
        needs_host=s.needs_host,
    )
    return s, out


# The reference's donating entry point.  torch has no buffer donation, so
# this is ``step`` itself; callers keep the reference's no-touch contract
# (the reference's kstate.DONATION): after a call, read only the RETURNED
# state and output, never the state/inbox/input arguments, so a later
# in-place implementation cannot change what they observe.
step_donated = step


# Message-class order of the [G, C] activity-flag matrix produced by
# ``output_row_flags``.
FLAG_CLASSES = ("resp", "rep", "hb", "vote", "timeout_now",
                "need_snapshot", "wit_snap", "rtr")


def output_row_flags(outs: StepOutput) -> torch.Tensor:
    """[G, C] bool: per-row any() over each message class of a StepOutput,
    columns in ``FLAG_CLASSES`` order."""
    cols = (
        (outs.r_type != 0).any(dim=1),
        outs.s_rep.any(dim=1),
        outs.s_hb.any(dim=1),
        (outs.s_vote != 0).any(dim=1),
        outs.s_timeout_now.any(dim=1),
        outs.s_need_snapshot.any(dim=1),
        outs.s_wit_snap.any(dim=1),
        outs.rtr_valid.any(dim=1),
    )
    return torch.stack(cols, dim=1)
