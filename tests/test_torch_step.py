"""The port's batched Raft step and device router against the JAX reference.

Inputs are made from numpy seeds and fed to both packages
(``convert`` carries them across); every state, output and next-inbox leaf
must be bitwise equal.  The geometry is the router's (``inbox_cap`` 12: ten
typed slots plus two 'any' slots, so every handler family runs).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dragonboat_tpu.core import kernel as ref_kernel
from dragonboat_tpu.core import kstate as ref_ks
from dragonboat_tpu.core import params as ref_P
from dragonboat_tpu.core.router import cluster_step as ref_cluster_step
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch.core import kernel as tk
from dragonboat_tpu_torch.core import kstate as ks
from dragonboat_tpu_torch.core import params as P
from dragonboat_tpu_torch.core.router import cluster_step
from dragonboat_tpu_torch.raftpb import MessageType as MT

GEOMETRY = dict(num_peers=3, log_cap=256, inbox_cap=12, msg_entries=4,
                proposal_cap=4, readindex_cap=4)
GROUPS, R = 4, 3
G = GROUPS * R
MTYPES = np.asarray([int(m) for m in MT], np.int32)


def _kps(onehot: bool):
    return (ref_P.KernelParams(**GEOMETRY, onehot_reads=onehot),
            P.KernelParams(**GEOMETRY, onehot_reads=onehot))


def _ref_np(x):
    return {k: None if v is None else np.asarray(v) for k, v in zip(x._fields, x)}


def _to_ref(cls, fields):
    return cls(**{k: None if v is None else jnp.asarray(v) for k, v in fields.items()})


def _fresh(kp_ref, kp, **opts):
    rids = np.tile(np.arange(1, R + 1, dtype=np.int32), GROUPS)
    pids = np.arange(1, R + 1, dtype=np.int32)
    ref = ref_ks.init_state(kp_ref, G, rids, pids, **opts)
    got = ks.init_state(kp, G, rids, pids, device="cpu", **opts)
    assert convert.diff_leaves(_ref_np(ref), convert.to_numpy(got)) == []
    return got


def _both_steps(kp_ref, kp, state, box, inp):
    """One cluster step (step + route) through both packages from the same
    numpy inputs; asserts equality and returns the port's results."""
    s_np, b_np, i_np = (convert.to_numpy(x) for x in (state, box, inp))
    rs, rb, ro = ref_cluster_step(kp_ref, R, _to_ref(ref_ks.ShardState, s_np),
                                  _to_ref(ref_ks.Inbox, b_np),
                                  _to_ref(ref_ks.StepInput, i_np))
    ts, tb, to = cluster_step(kp, R, state, box, inp)
    for what, ref, got in (("state", rs, ts), ("out", ro, to), ("inbox", rb, tb)):
        bad = convert.diff_leaves(_ref_np(ref), convert.to_numpy(got))
        assert bad == [], f"{what} leaves differ: {bad}"
    return ts, tb, to, ro


def _input(kp, state, rng, tick=True, p_prop=0.5, p_read=0.2, p_transfer=0.05):
    """A StepInput drawn with numpy from the current state."""
    role = convert.to_numpy(state)["role"]
    B = kp.proposal_cap
    leader = role == P.LEADER
    fields = dict(
        prop_valid=leader[:, None] & (rng.random((G, B)) < p_prop),
        prop_cc=rng.random((G, B)) < 0.05,
        ri_valid=leader & (rng.random(G) < p_read),
        ri_low=rng.integers(0, 4, G).astype(np.int32),
        ri_high=rng.integers(0, 4, G).astype(np.int32),
        transfer_to=np.where(rng.random(G) < p_transfer,
                             rng.integers(1, R + 1, G), 0).astype(np.int32),
        tick=np.full(G, tick) if isinstance(tick, bool) else tick,
        quiesced=np.zeros(G, bool),
        applied=convert.to_numpy(state)["processed"],
        prop_val=None,
    )
    return convert.from_numpy(ks.StepInput, fields, "cpu")


def _drop(box, keep):
    """Zero every lane of the dropped [G, K] slots (the kernel's contract
    for an empty slot)."""
    out = {}
    for k, v in convert.to_numpy(box).items():
        if v is not None:
            m = keep if v.ndim == 2 else keep[..., None]
            v = np.where(m, v, np.zeros_like(v))
        out[k] = v
    return convert.from_numpy(ks.Inbox, out, "cpu")


def _random_state_and_box(kp, state, rng):
    """Perturb a reached state's flow-control, ReadIndex and quiesce fields
    and fill every inbox slot with a random message of any kernel type."""
    s = convert.to_numpy(state)
    RI, K, E = kp.readindex_cap, kp.inbox_cap, kp.msg_entries
    s["pstate"] = rng.integers(0, 4, (G, R)).astype(np.int32)
    s["psnap"] = rng.integers(0, 3, (G, R)).astype(np.int32)
    s["active"] = rng.random((G, R)) < 0.5
    s["ri_head"] = rng.integers(0, RI, G).astype(np.int32)
    s["ri_count"] = rng.integers(0, RI + 1, G).astype(np.int32)
    s["ri_low"] = rng.integers(0, 4, (G, RI)).astype(np.int32)
    s["ri_high"] = rng.integers(0, 4, (G, RI)).astype(np.int32)
    s["ri_acks"] = rng.random((G, RI, R)) < 0.3
    s["ltt"] = np.where(rng.random(G) < 0.2, rng.integers(1, R + 1, G), 0).astype(np.int32)
    s["quiesce_on"] = rng.random(G) < 0.3
    s["quiesced"] = s["quiesce_on"] & (rng.random(G) < 0.5)
    s["pending_cc"] = rng.random(G) < 0.2
    term, last = s["term"][:, None], s["last"][:, None]
    box = dict(
        mtype=rng.choice(MTYPES, (G, K)).astype(np.int32),
        from_=rng.integers(0, R + 1, (G, K)).astype(np.int32),
        term=np.maximum(term + rng.integers(-1, 2, (G, K)), 0).astype(np.int32),
        log_term=rng.integers(0, 3, (G, K)).astype(np.int32) + np.maximum(term - 2, 0),
        log_index=rng.integers(0, 3, (G, K)).astype(np.int32) + np.maximum(last - 1, 0),
        commit=rng.integers(0, 3, (G, K)).astype(np.int32) + np.maximum(last - 1, 0),
        reject=rng.random((G, K)) < 0.3,
        hint=rng.integers(0, 4, (G, K)).astype(np.int32),
        hint_high=rng.integers(0, 4, (G, K)).astype(np.int32),
        n_ent=rng.integers(0, E + 1, (G, K)).astype(np.int32),
        ent_term=(rng.integers(0, 2, (G, K, E)) + term[..., None]).astype(np.int32),
        ent_cc=rng.random((G, K, E)) < 0.05,
        ent_val=None,
    )
    for k in ("log_term", "log_index", "commit"):
        box[k] = box[k].astype(np.int32)
    return (convert.from_numpy(ks.ShardState, s, "cpu"),
            convert.from_numpy(ks.Inbox, box, "cpu"))


@pytest.mark.parametrize("onehot,seed,cq_pv", [
    (False, 3, False), (False, 4, True), (True, 3, False), (True, 4, True)])
def test_random_step_and_route_equal_reference(onehot, seed, cq_pv):
    """Random (state, inbox, input) triples through one step + route of
    both packages, under both read lowerings."""
    rng = np.random.default_rng(seed)
    kp_ref, kp = _kps(onehot)
    state = _fresh(kp_ref, kp, check_quorum=cq_pv, pre_vote=cq_pv)
    box = ks.empty_inbox(kp, G, "cpu")
    # reach a live cluster on the port alone, then perturb it
    for _ in range(16):
        state, box, _ = cluster_step(kp, R, state, box, _input(kp, state, rng))
    for _ in range(3):
        state, box = _random_state_and_box(kp, state, rng)
        inp = _input(kp, state, rng, tick=rng.random(G) < 0.7, p_prop=0.6,
                     p_read=0.5, p_transfer=0.3)
        inp = inp._replace(quiesced=convert.tensor_from_numpy(rng.random(G) < 0.1, "cpu"))
        state, box, out, ref_out = _both_steps(kp_ref, kp, state, box, inp)
        assert np.array_equal(np.asarray(ref_kernel.output_row_flags(ref_out)),
                              tk.output_row_flags(out).numpy())
    # the donating entry compiles the same step body, donating state,
    # inbox and input as the reference's (donate_argnums=(1, 2, 3))
    assert tk.step_donated.fn is tk.step.fn
    assert tk.step_donated.donate_argnums == (1, 2, 3)


@pytest.mark.parametrize("seed,cq_pv", [(1, False), (2, True)])
def test_sixty_steps_with_drops_equal_reference(seed, cq_pv):
    """60 steps from a fresh cluster with numpy-drawn inbox drops applied
    identically to both sides: elections, rejects and retries occur, and
    every state, output and next-inbox leaf is equal at every step."""
    rng = np.random.default_rng(seed)
    kp_ref, kp = _kps(False)
    state = _fresh(kp_ref, kp, check_quorum=cq_pv, pre_vote=cq_pv)
    box = ks.empty_inbox(kp, G, "cpu")
    rejects = leaders_seen = 0
    for _ in range(60):
        state, box, out, _ = _both_steps(kp_ref, kp, state, box,
                                         _input(kp, state, rng))
        box = _drop(box, rng.random((G, kp.inbox_cap)) >= 0.25)
        rejects += int(out.r_reject.sum())
        leaders_seen = max(leaders_seen, int((out.leader != 0).sum()))
    st = convert.to_numpy(state)
    assert rejects > 0 and leaders_seen > 0
    assert st["committed"].max() > 1 and st["term"].max() >= 1
