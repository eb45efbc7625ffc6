"""The port's mesh serving path (``parallel/ici.py``) against the JAX
package's, on the CPU.

The reference runs its mesh on the virtual 8-device CPU mesh of
``tests/conftest.py``; the port places every mesh position on ``"cpu"``.
Both start from the same block-major state and take the same inputs; after
every step every leaf of state, carried inbox and output must be equal,
dtypes included (tolerance 0, ``convert.diff_leaves``: all state is int32
or bool).  Cases:

- ``serve_step`` against ``jit_serve_step`` at the geometries of
  ``tests/test_mesh_differential.py`` over 30 serving steps (that file
  runs 40), the cut mask open for 16 steps (elections, commits), then one
  row fully cut for 7, then one link cut at both ends for 7;
- ``ici_cluster_step`` and ``ici_run_steps`` against the reference's own;
- the port's mesh state against the port's router state after the row
  permutation (``core/router.cluster_step`` on group-major rows);
- the third arm of ``tests/test_engine_differential.py`` on the port
  alone: the resident exchange (open mask) against hub delivery (every
  link cut, the out-lanes routed host-side and staged back) under the
  reference's randomized schedule generator at seed 7, at depths 0 and 1,
  for ``HUB_STEPS`` micro-steps (the reference runs 300).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dragonboat_tpu.core import params as ref_P
from dragonboat_tpu.parallel import ici as ref_ici
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch.core.router import cluster_step, route
from dragonboat_tpu_torch.parallel import ici

from test_engine_differential import _audit_slots, _random_input

torch.set_num_threads(1)

#: micro-steps of each depth of the resident-vs-hub arm
HUB_STEPS = 40
SERVE_STEPS, OPEN_STEPS, ROW_CUT_STEPS = 30, 16, 7


def _kps(replicas: int):
    """The reference tests' geometry, as the reference's and the port's
    KernelParams."""
    ref = ref_P.KernelParams(
        num_peers=replicas, log_cap=64, inbox_cap=5 * max(1, replicas - 1),
        msg_entries=4, proposal_cap=4, readindex_cap=4, apply_batch=16,
        compaction_overhead=16)
    return ref, convert.kernel_params_from(dataclasses.asdict(ref))


def _ref_cluster(kp, g_size, replicas, n_local):
    devs = jax.devices()
    assert len(devs) >= g_size * replicas, "conftest forces 8 CPU devices"
    mesh = Mesh(np.array(devs[:g_size * replicas]).reshape(g_size, replicas),
                ("g", "r"))
    return ref_ici.make_ici_cluster(kp, mesh, num_groups=g_size * n_local)


def _perm(g_size, replicas, n_local):
    """perm[router_row] = mesh_row for the same (group, replica)."""
    perm = np.empty(g_size * n_local * replicas, np.int64)
    for g in range(g_size * n_local):
        ig, n = divmod(g, n_local)
        for ir in range(replicas):
            perm[g * replicas + ir] = (ig * replicas + ir) * n_local + n
    return perm


def _np(tree):
    """A reference (JAX) struct as a dict of numpy arrays."""
    return {f: None if v is None else np.array(v)
            for f, v in zip(tree._fields, tree)}


def _port(cls, d):
    return convert.from_numpy(cls, d, device="cpu")


def _permute(d, perm):
    return {k: None if v is None else v[perm] for k, v in d.items()}


def _equal(tag, ref, got):
    bad = convert.diff_leaves(ref, got)
    assert not bad, (tag, bad)


def _cut_schedule(g_size, replicas, n_local):
    """Step -> the [rows, P] cut mask: open, then one row fully cut, then
    one link (replica 1 <-> replica R of the last group) cut at both
    ends."""
    total = g_size * replicas * n_local
    perm = _perm(g_size, replicas, n_local)
    open_ = np.zeros((total, replicas), bool)
    row = open_.copy()
    row[perm[0 * replicas + 1], :] = True
    link = open_.copy()
    last = g_size * n_local - 1
    a, b = perm[last * replicas], perm[last * replicas + replicas - 1]
    link[a, replicas - 1] = True
    link[b, 0] = True

    def at(step):
        if step < OPEN_STEPS:
            return open_
        return row if step < OPEN_STEPS + ROW_CUT_STEPS else link
    return at


@pytest.mark.parametrize("g_size,replicas,n_local",
                         [(2, 3, 4), (2, 4, 2), (1, 5, 3)])
def test_serve_step_matches_reference(g_size, replicas, n_local):
    ref_kp, kp = _kps(replicas)
    rcl, rst, rbox = _ref_cluster(ref_kp, g_size, replicas, n_local)
    cl, st, box = ici.make_ici_cluster(kp, g_size, replicas,
                                       g_size * n_local, device="cpu")
    _equal("init state", _np(rst), convert.to_numpy(st))
    _equal("init box", _np(rbox), convert.to_numpy(box))
    cut_at = _cut_schedule(g_size, replicas, n_local)
    committed = 0
    for i in range(SERVE_STEPS):
        cut = cut_at(i)
        rinp = ref_ici.self_driving_input(ref_kp, rst, tick=True, propose=True)
        inp = ici.self_driving_input(kp, st, tick=True, propose=True)
        _equal(("input", i), _np(rinp), convert.to_numpy(inp))
        rst, rbox, rout = ref_ici.ici_serve_step(
            rcl, rst, rbox, rcl.shard(rinp), rcl.shard(cut))
        st, box, out = ici.ici_serve_step(cl, st, box, inp, cl.shard(cut))
        _equal(("state", i), _np(rst), convert.to_numpy(st))
        _equal(("box", i), _np(rbox), convert.to_numpy(box))
        _equal(("out", i), _np(rout), convert.to_numpy(out))
        if i == OPEN_STEPS - 1:
            committed = int(st.committed.max())
    assert committed > 0, "nothing committed before the cuts"
    # the cut row's peers went on without it
    assert int(st.committed.max()) > committed


def test_cluster_step_and_run_steps_match_reference():
    g_size, replicas, n_local = 2, 3, 4
    ref_kp, kp = _kps(replicas)
    rcl, rst, rbox = _ref_cluster(ref_kp, g_size, replicas, n_local)
    cl, st, box = ici.make_ici_cluster(kp, g_size, replicas,
                                       g_size * n_local, device="cpu")
    for i in range(8):
        rinp = ref_ici.self_driving_input(ref_kp, rst, tick=True, propose=True)
        rst, rbox, rout = ref_ici.ici_cluster_step(rcl, rst, rbox,
                                                   rcl.shard(rinp))
        st, box, out = ici.ici_cluster_step(
            cl, st, box, ici.self_driving_input(kp, st))
        _equal(("state", i), _np(rst), convert.to_numpy(st))
        _equal(("box", i), _np(rbox), convert.to_numpy(box))
        _equal(("out", i), _np(rout), convert.to_numpy(out))
    rst, rbox = ref_ici.ici_run_steps(ref_kp, rcl, 6, True, rst, rbox)
    st, box = ici.ici_run_steps(kp, cl, 6, True, st, box)
    _equal("run_steps state", _np(rst), convert.to_numpy(st))
    _equal("run_steps box", _np(rbox), convert.to_numpy(box))
    assert int(st.committed.max()) > 0


def test_mesh_equals_router_after_row_permutation():
    """The port's serve step with an open mask is the port's router path
    on the same (group, replica) rows, state and carried inbox."""
    g_size, replicas, n_local = 2, 3, 4
    _, kp = _kps(replicas)
    cl, st, box = ici.make_ici_cluster(kp, g_size, replicas,
                                       g_size * n_local, device="cpu")
    perm = _perm(g_size, replicas, n_local)
    st_r = _port("ShardState", _permute(convert.to_numpy(st), perm))
    box_r = _port("Inbox", _permute(convert.to_numpy(box), perm))
    cut = torch.zeros((cl.total_rows, replicas), dtype=torch.bool)
    for i in range(20):
        st, box, _ = ici.ici_serve_step(cl, st, box,
                                        ici.self_driving_input(kp, st), cut)
        st_r, box_r, _ = cluster_step(kp, replicas, st_r, box_r,
                                      ici.self_driving_input(kp, st_r))
        _equal(("state", i), convert.to_numpy(st_r),
               _permute(convert.to_numpy(st), perm))
        _equal(("box", i), convert.to_numpy(box_r),
               _permute(convert.to_numpy(box), perm))
    assert int(st_r.committed.max()) > 0


@pytest.mark.parametrize("depth", [0, 1])
def test_resident_exchange_equals_hub_delivery(depth):
    """Arm A serves with every link open (messages ride the exchange);
    arm B with every link cut (the step exchanges nothing, the host
    routes the out-lanes through the router's slot layout and stages them
    as the next inbox).  Same randomized schedule (the reference's
    generator, seed 7); the two states and boxes stay equal at every
    micro-step, and every hub-staged slot is one the slot-exact builder
    would pick.  Depth 1 goes through the donating entry and reads each
    step back before the next dispatch, as the pipelined engine does."""
    g_size, replicas, n_local = 1, 2, 4
    _, kp = _kps(replicas)
    cl, st_a, box_a = ici.make_ici_cluster(kp, g_size, replicas,
                                           g_size * n_local, device="cpu")
    perm = _perm(g_size, replicas, n_local)
    iperm = np.argsort(perm)
    total = cl.total_rows
    cut_open = torch.zeros((total, replicas), dtype=torch.bool)
    cut_all = torch.ones((total, replicas), dtype=torch.bool)
    st_b = _port("ShardState", convert.to_numpy(st_a))
    box_b = _port("Inbox", convert.to_numpy(box_a))
    serve = ici.serve_step if depth == 0 else ici.serve_step_donated
    rng = np.random.default_rng(7)
    committed = 0
    for i in range(HUB_STEPS):
        sa, sb = convert.to_numpy(st_a), convert.to_numpy(st_b)
        _equal(("arm state", depth, i), sa, sb)
        committed = int(sa["committed"].max())
        draws = rng.bit_generator.state  # the same draws for both arms
        inp_a = _random_input(kp, rng, _Np(sa), iperm)
        rng.bit_generator.state = draws
        inp_b = _random_input(kp, rng, _Np(sb), iperm)
        st_a, box_a, _ = serve(kp, cl, st_a, box_a, _port("StepInput", _np(inp_a)),
                              cut_open)
        st_b, box_ret, out_b = serve(kp, cl, st_b, box_b,
                                     _port("StepInput", _np(inp_b)), cut_all)
        assert not bool(box_ret.mtype.any()), "all-cut serve leaked traffic"
        out_rt = _port("StepOutput", _permute(convert.to_numpy(out_b), perm))
        hub = convert.to_numpy(route(kp, replicas, out_rt))
        _equal(("arm box", depth, i), _permute(convert.to_numpy(box_a), perm),
               hub)
        _audit_slots(_Np(hub), replicas)
        box_b = _port("Inbox", _permute(hub, iperm))
    assert committed > 0, "the resident-vs-hub arm never committed"


class _Np:
    """Attribute view of a numpy leaf dict (the reference helpers read
    ``state.term``, ``box.mtype`` and so on)."""

    def __init__(self, d):
        self.__dict__.update(d)
