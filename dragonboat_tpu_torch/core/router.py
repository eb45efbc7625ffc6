"""Device-side message router for co-located replica groups.

Port of the reference's ``core/router.py``.  When every replica of a group
lives in the same kernel state, message exchange is a pure tensor shuffle:
the out-lanes of step t become the in-lanes of step t+1 with no host
involvement.  Rows are grouped ``[N, R]`` (groups x replicas).

Inbox slot layout per target, per peer q of the R-1 remote peers:
  [q*5 + 0]  first response lane addressed to me
  [q*5 + 1]  second response lane addressed to me
  [q*5 + 2]  replicate
  [q*5 + 3]  heartbeat
  [q*5 + 4]  vote request / TimeoutNow (mutually exclusive senders)
Requires ``inbox_cap >= 5 * (R - 1)``.

The response-lane pick goes through K2
(``parallel/fabric_kernels.gather_lanes``), which launches the CUDA kernel
on the card.  The per-source ``take`` keeps both of the reference's
lowerings (gather, or one-hot with ``kp.onehot_reads``).
"""

from __future__ import annotations

import torch

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.core.kernel import onehot_select, step
from dragonboat_tpu_torch.core.kstate import Inbox, ShardState, StepInput, StepOutput
from dragonboat_tpu_torch.parallel.fabric_kernels import gather_lanes

MT = pb.MessageType
I32 = torch.int32

#: slots per remote peer in the fixed inbox layout (module docstring)
SLOTS_PER_PEER = 5
#: class offsets within one peer's slot block
SLOT_RESP0, SLOT_RESP1, SLOT_REP, SLOT_HB, SLOT_VOTE = range(SLOTS_PER_PEER)

#: route()-producible message types -> slot offset within the peer block;
#: everything else rides the two response lanes
SLOT_OFFSETS_OF_TYPE = {
    int(MT.REPLICATE): (SLOT_REP,),
    int(MT.HEARTBEAT): (SLOT_HB,),
    int(MT.REQUEST_VOTE): (SLOT_VOTE,),
    int(MT.REQUEST_PREVOTE): (SLOT_VOTE,),
    int(MT.TIMEOUT_NOW): (SLOT_VOTE,),
}
_RESP_OFFSETS = (SLOT_RESP0, SLOT_RESP1)

_RESP_FIELDS = ("r_type", "r_term", "r_log_index", "r_reject", "r_hint",
                "r_hint_high")


def peer_ordinal(target_rid: int, source_rid: int, replicas: int) -> int:
    """Remote-peer ordinal ``q`` of ``source_rid`` as seen by
    ``target_rid``: the inverse of route()'s source enumeration
    ``s = (t + 1 + q) % R`` (both rids 1-based, q in 0..R-2)."""
    return (source_rid - target_rid - 1) % replicas


def slot_candidates(target_rid: int, source_rid: int, replicas: int,
                    mtype: int) -> tuple[int, ...]:
    """Inbox slot indexes (in preference order) where route() would place
    a ``mtype`` message from ``source_rid`` addressed to ``target_rid``."""
    base = peer_ordinal(target_rid, source_rid, replicas) * SLOTS_PER_PEER
    offs = SLOT_OFFSETS_OF_TYPE.get(int(mtype), _RESP_OFFSETS)
    return tuple(base + o for o in offs)


def route(kp: KP.KernelParams, replicas: int, out: StepOutput) -> Inbox:
    """Turn one step's StepOutput into the next step's Inbox, on the
    device.  All tensors have leading [G] = [N*R], rows grouped by group.
    The output tensors are fresh; ``out`` is never written."""
    R = replicas
    K, E = kp.inbox_cap, kp.msg_entries
    if K < SLOTS_PER_PEER * (R - 1):
        raise ValueError("inbox_cap too small for the fixed slot layout")
    G = out.term.shape[0]
    N = G // R
    dev = out.term.device

    def grp(x):  # [G, ...] -> [N, R, ...]
        return x.reshape((N, R) + tuple(x.shape[1:]))

    term = grp(out.term)
    r_type = grp(out.r_type)          # [N, R, K]
    r_to = grp(out.r_to)

    # to_me[n, t, s, k]: source s's resp lane k addresses replica t+1
    rid_t = torch.arange(1, R + 1, dtype=I32, device=dev)
    to_me = (r_to[:, None, :, :] == rid_t[None, :, None, None]) & (
        r_type[:, None, :, :] != 0)                          # [N, Rt, Rs, K]
    # first and second matching lane indexes per (t, s); K = no lane
    lane_iota = torch.arange(K, dtype=I32, device=dev)
    first = torch.where(to_me, lane_iota, K).min(dim=-1).values
    second = torch.where(to_me & (lane_iota != first[..., None]),
                         lane_iota, K).min(dim=-1).values     # [N, Rt, Rs]

    def pick(src_field, lane):
        """src_field [N, Rs, K], lane [N, Rt, Rs] -> [N, Rt, Rs]: K2 over
        vals [(n, s), K] and idx [(n, s), t]; a lane of K reads 0."""
        vals = src_field.reshape(N * R, K).to(I32).contiguous()
        idx = lane.transpose(1, 2).reshape(N * R, R).contiguous()
        got = gather_lanes(vals, idx).reshape(N, R, R).transpose(1, 2)
        return got.to(src_field.dtype)

    picked = [{f: pick(grp(getattr(out, f)), lane) for f in _RESP_FIELDS}
              for lane in (first, second)]
    resp_valid = (first < K, second < K)

    # per-peer lanes: source s's peer slot t is the lane to target rid t+1
    def peer_lane(field):  # [G, P(, E)] -> [N, Rt, Rs(, E)]
        return grp(field)[:, :, :R].transpose(1, 2)

    rep_valid = peer_lane(out.s_rep)
    rep_prev_i = peer_lane(out.s_prev_index)
    rep_prev_t = peer_lane(out.s_prev_term)
    rep_commit = peer_lane(out.s_commit)
    rep_n = peer_lane(out.s_n_ent)
    rep_ent_t = peer_lane(out.s_ent_term)                    # [N, Rt, Rs, E]
    rep_ent_cc = peer_lane(out.s_ent_cc)
    inline = out.s_ent_val is not None
    rep_ent_v = peer_lane(out.s_ent_val) if inline else None
    hb_valid = peer_lane(out.s_hb)
    hb_commit = peer_lane(out.s_hb_commit)
    hb_low = peer_lane(out.s_hb_low)
    hb_high = peer_lane(out.s_hb_high)
    vt_kind = peer_lane(out.s_vote)                          # 0/1/2
    vt_term = peer_lane(out.s_vote_term)
    vt_li = peer_lane(out.s_vote_lindex)
    vt_lt = peer_lane(out.s_vote_lterm)
    vt_hint = peer_lane(out.s_vote_hint)
    tn_valid = peer_lane(out.s_timeout_now)

    src_term = term[:, None, :].expand(N, R, R)              # [N, Rt, Rs]
    src_rid = torch.arange(1, R + 1, dtype=I32, device=dev)[None, None, :].expand(
        N, R, R)

    # the [N, Rt, K] inbox, freshly allocated: slot writes go in place
    def z(*s, dtype=I32):
        return torch.zeros((N, R, K) + s, dtype=dtype, device=dev)

    fields = {
        "mtype": z(), "from_": z(), "term": z(), "log_term": z(),
        "log_index": z(), "commit": z(), "reject": z(dtype=torch.bool),
        "hint": z(), "hint_high": z(), "n_ent": z(),
        "ent_term": z(E), "ent_cc": z(E, dtype=torch.bool),
    }
    if inline:
        fields["ent_val"] = z(E)

    def put(name, k_slot, v):
        fields[name][:, :, k_slot] = v

    t_iota = torch.arange(R, dtype=I32, device=dev)
    for q in range(R - 1):
        # the remote source of target t: s = (t + 1 + q) % R
        s_of_t = (t_iota + 1 + q) % R                         # [R]
        oh_src = s_of_t[:, None] == torch.arange(R, dtype=I32, device=dev)

        def take(x3):  # [N, Rt, Rs] -> [N, Rt], source s_of_t[t]
            if not kp.onehot_reads:
                idx = s_of_t[None, :, None].expand(N, R, 1).long()
                return torch.gather(x3, 2, idx)[:, :, 0]
            return onehot_select(oh_src[None], x3, 2)

        def take4(x4):  # [N, Rt, Rs, E] -> [N, Rt, E]
            if not kp.onehot_reads:
                idx = s_of_t[None, :, None, None].expand(
                    N, R, 1, x4.shape[-1]).long()
                return torch.gather(x4, 2, idx)[:, :, 0]
            return onehot_select(oh_src[None, :, :, None], x4, 2)

        base = q * SLOTS_PER_PEER
        # responses
        for lane_no in (0, 1):
            v = take(resp_valid[lane_no])
            pk = picked[lane_no]
            k_slot = base + lane_no
            put("mtype", k_slot, torch.where(v, take(pk["r_type"]), 0))
            put("from_", k_slot, torch.where(v, take(src_rid), 0))
            put("term", k_slot, torch.where(v, take(pk["r_term"]), 0))
            put("log_index", k_slot, torch.where(v, take(pk["r_log_index"]), 0))
            put("reject", k_slot, v & take(pk["r_reject"]))
            put("hint", k_slot, torch.where(v, take(pk["r_hint"]), 0))
            put("hint_high", k_slot, torch.where(v, take(pk["r_hint_high"]), 0))
        # replicate
        v = take(rep_valid)
        k_slot = base + SLOT_REP
        put("mtype", k_slot, torch.where(v, int(MT.REPLICATE), 0).to(I32))
        put("from_", k_slot, torch.where(v, take(src_rid), 0))
        put("term", k_slot, torch.where(v, take(src_term), 0))
        put("log_term", k_slot, torch.where(v, take(rep_prev_t), 0))
        put("log_index", k_slot, torch.where(v, take(rep_prev_i), 0))
        put("commit", k_slot, torch.where(v, take(rep_commit), 0))
        put("n_ent", k_slot, torch.where(v, take(rep_n), 0))
        put("ent_term", k_slot, torch.where(v[..., None], take4(rep_ent_t), 0))
        put("ent_cc", k_slot, v[..., None] & take4(rep_ent_cc))
        if inline:
            put("ent_val", k_slot, torch.where(v[..., None], take4(rep_ent_v), 0))
        # heartbeat
        v = take(hb_valid)
        k_slot = base + SLOT_HB
        put("mtype", k_slot, torch.where(v, int(MT.HEARTBEAT), 0).to(I32))
        put("from_", k_slot, torch.where(v, take(src_rid), 0))
        put("term", k_slot, torch.where(v, take(src_term), 0))
        put("commit", k_slot, torch.where(v, take(hb_commit), 0))
        put("hint", k_slot, torch.where(v, take(hb_low), 0))
        put("hint_high", k_slot, torch.where(v, take(hb_high), 0))
        # vote request or TimeoutNow
        vk = take(vt_kind)
        tn = take(tn_valid)
        k_slot = base + SLOT_VOTE
        mt = torch.where(
            tn, int(MT.TIMEOUT_NOW),
            torch.where(vk == 1, int(MT.REQUEST_VOTE),
                        torch.where(vk == 2, int(MT.REQUEST_PREVOTE), 0))).to(I32)
        v = mt != 0
        put("mtype", k_slot, mt)
        put("from_", k_slot, torch.where(v, take(src_rid), 0))
        put("term", k_slot, torch.where(
            tn, take(src_term), torch.where(v, take(vt_term), 0)))
        voting = vk > 0
        put("log_index", k_slot, torch.where(voting, take(vt_li), 0))
        put("log_term", k_slot, torch.where(voting, take(vt_lt), 0))
        put("hint", k_slot, torch.where(voting, take(vt_hint), 0))

    return Inbox(**{k: v.reshape((G,) + tuple(v.shape[2:]))
                    for k, v in fields.items()})


def cluster_step(kp: KP.KernelParams, replicas: int, state: ShardState,
                 inbox: Inbox, inp: StepInput):
    """One step for co-located groups: kernel step + device routing.
    Returns (state, next_inbox, out)."""
    state, out = step(kp, state, inbox, inp)
    return state, route(kp, replicas, out), out
