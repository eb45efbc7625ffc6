"""The batched entries of K1 and K2 against the JAX reference, on the CPU.

``fabric_kernels.commit_quorum(match, kind)`` derives the voting mask and
the quorum from the peer kinds in the same launch as the order statistic;
``fabric_kernels.gather_lanes_multi(fields, lanes)`` does the route's six
response fields by both lanes in one launch.  The kernels cannot run
here, so their plain arms are held bit for bit against the reference's
XLA arms (``quorum_match_xla``, ``gather_lanes_xla``) and its Pallas
kernels in interpret mode, in the shapes and layouts the step and the
router give them; then the port's ``_sorted_match_quorum_index`` and
``route`` against the reference's own on a state from a short elected run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonboat_tpu import bench_loop as ref_bl
from dragonboat_tpu.core import kernel as ref_kernel
from dragonboat_tpu.core import kstate as ref_ks
from dragonboat_tpu.core import params as ref_P
from dragonboat_tpu.core import router as ref_router
from dragonboat_tpu.parallel.fabric_pallas import (
    gather_lanes_pallas,
    gather_lanes_xla,
    quorum_match_pallas,
    quorum_match_xla,
)
from dragonboat_tpu_torch import bench_loop as bl
from dragonboat_tpu_torch import convert, kernels
from dragonboat_tpu_torch.core import kernel as tk
from dragonboat_tpu_torch.core import router
from dragonboat_tpu_torch.parallel import fabric_kernels as fk

R = 3
K = 5 * (R - 1)            # the route's inbox_cap at three replicas
INT_MAX = np.iinfo(np.int32).max
# the route's response fields: five int32, r_reject bool
FIELD_DTYPES = (np.int32,) * 3 + (np.bool_,) + (np.int32,) * 2


def _route_inputs(rng, N):
    """Six [G, K] fields and the two [N, Rt, Rs] lanes, a third of the
    lanes the no-lane sentinel K."""
    G = N * R
    fields = [rng.random((G, K)) < 0.5 if dt is np.bool_
              else rng.integers(-(1 << 20), 1 << 20, (G, K)).astype(np.int32)
              for dt in FIELD_DTYPES]
    lanes = [np.where(rng.random((N, R, R)) < 1 / 3, K,
                      rng.integers(0, K, (N, R, R))).astype(np.int32)
             for _ in range(2)]
    return fields, lanes


@pytest.mark.parametrize("N", [1, 4, 64])
def test_gather_lanes_multi_plain_equals_reference(N):
    rng = np.random.default_rng(100 + N)
    fields, lanes = _route_inputs(rng, N)
    kernels.reset_launches()
    got = fk.gather_lanes_multi([torch.as_tensor(f) for f in fields],
                                [torch.as_tensor(lane) for lane in lanes])
    assert kernels.launches["gather_lanes"] == 0, "the CPU takes the plain arm"
    assert len(got) == 2 and all(len(per) == len(fields) for per in got)
    sentinels = 0
    for lane, per_lane in zip(lanes, got):
        # the reference's K2 inputs: vals [(n, s), K], idx [(n, s), t]
        idx = lane.transpose(0, 2, 1).reshape(N * R, R)
        inside = idx < K
        sentinels += int((~inside).sum())
        for f, out in zip(fields, per_lane):
            vals = jnp.asarray(f.astype(np.int32))
            ref_p = np.asarray(gather_lanes_pallas(vals, jnp.asarray(idx), interpret=True))
            # gather_lanes_xla takes in-range indexes only: the sentinel is
            # clamped and masked, as the reference router's gather branch does
            ref_x = np.where(inside, np.asarray(gather_lanes_xla(
                vals, jnp.asarray(np.minimum(idx, K - 1)))), 0)
            o = out.numpy()
            assert o.dtype == f.dtype and o.shape == (N, R, R)
            flat = o.astype(np.int32).transpose(0, 2, 1).reshape(N * R, R)
            assert np.array_equal(flat, ref_p) and np.array_equal(flat, ref_x)
    assert sentinels > 0


def _kinds(rng, G, P):
    """Kinds drawn from all four values; every fourth row has no voter."""
    kind = rng.integers(ref_P.K_ABSENT, ref_P.K_WITNESS + 1, (G, P)).astype(np.int32)
    none = np.arange(G) % 4 == 0
    kind[none] = np.where(kind[none] % 2 == 0, ref_P.K_ABSENT, ref_P.K_NON_VOTING)
    return kind


def _ref_voting_quorum(kind):
    """dragonboat_tpu/core/kernel.py's _voting_mask and _quorum, per row."""
    k = jnp.asarray(kind)
    voting = (k == ref_P.K_VOTER) | (k == ref_P.K_WITNESS)
    nv = jnp.sum(voting.astype(jnp.int32), axis=1)
    return voting, nv // 2 + 1


@pytest.mark.parametrize("P", [3, 5, 8])
def test_commit_quorum_plain_equals_reference(P):
    rng = np.random.default_rng(200 + P)
    G = 96
    kind = _kinds(rng, G, P)
    # ties: half the rows draw from four values
    match = np.where((np.arange(G) % 2 == 1)[:, None], rng.integers(0, 4, (G, P)),
                     rng.integers(0, 1 << 20, (G, P))).astype(np.int32)
    voting, quorum = _ref_voting_quorum(kind)
    ref = np.asarray(quorum_match_xla(jnp.asarray(match), voting, quorum))
    ref_p = np.asarray(quorum_match_pallas(jnp.asarray(match), voting, quorum,
                                           interpret=True))
    kernels.reset_launches()
    got = fk.commit_quorum(torch.as_tensor(match), torch.as_tensor(kind)).numpy()
    assert kernels.launches["quorum_match"] == 0, "the CPU takes the plain arm"
    assert got.dtype == np.int32
    assert np.array_equal(got, ref) and np.array_equal(got, ref_p)
    nv = np.asarray(voting).sum(axis=1)
    assert (got[nv == 0] == INT_MAX).all() and (nv == 0).any() and (nv > 0).any()


def _elected_run():
    """Both packages' kernel params (the gather lowering, where the
    reference's pick clamps the no-lane sentinel) and a port state after
    elect_all and three self-driving steps with proposals, 4 groups x 3."""
    kp_ref = dataclasses.replace(ref_bl.bench_params(R), onehot_reads=False)
    kp = dataclasses.replace(bl.bench_params(R, device="cpu"), onehot_reads=False)
    st, box = bl.elect_all(kp, R, bl.make_cluster(kp, 4, R, device="cpu"))
    st, box = bl.run_steps(kp, R, 3, True, True, st, box)
    return kp_ref, kp, st, box


def _ref(cls, fields):
    return cls(**{k: None if v is None else jnp.asarray(v) for k, v in fields.items()})


def test_step_quorum_and_route_equal_reference():
    kp_ref, kp, st, box = _elected_run()
    # the commit rule's order statistic on the elected state, and on the
    # same state with kinds drawn from all four values (rows with 0 voters)
    rng = np.random.default_rng(7)
    mixed = st._replace(kind=torch.as_tensor(_kinds(rng, *st.kind.shape)),
                        match=torch.as_tensor(rng.integers(0, 4, st.match.shape)
                                              .astype(np.int32)))
    ref_q = jax.vmap(lambda s: ref_kernel._sorted_match_quorum_index(kp_ref, s))
    for s in (st, mixed):
        got = tk._sorted_match_quorum_index(kp, s).numpy()
        ref = np.asarray(ref_q(_ref(ref_ks.ShardState, convert.to_numpy(s))))
        assert got.dtype == ref.dtype == np.int32
        assert np.array_equal(got, ref)
    assert (np.asarray(tk._sorted_match_quorum_index(kp, st)) > 0).any()

    # one more step with proposals; both routers on its StepOutput
    inp = bl._self_input(kp, st, True, True, None, False, 0)
    _st, out = tk.step(kp, st, box, inp)
    got = router.route(kp, R, out)
    ref = ref_router.route(kp_ref, R, _ref(ref_ks.StepOutput, convert.to_numpy(out)))
    bad = convert.diff_leaves({k: None if v is None else np.asarray(v)
                               for k, v in zip(ref._fields, ref)},
                              convert.to_numpy(got))
    assert bad == []
    assert int((got.mtype != 0).sum()) > 0 and bool(out.r_type.ne(0).any())
