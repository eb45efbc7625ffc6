"""The port's compiled entries (``dragonboat_tpu_torch.graphs``) on the CPU.

On the card a compiled entry captures a CUDA graph per geometry and
replays it; here the tests select the CPU stand-in replayer
(``graphs.stand_in()``), which keeps a graph's static buffers, copies the
inputs in, re-runs the body and copies the results into the same output
tensors.  That exercises the copy-in, the donation, the lifetime of
non-donated results, the double-buffered staging of a depth-1 engine and
the cache key.  Every compiled entry through the stand-in is held bitwise
equal to the eager port, and ``cluster_step_donated`` to the JAX
package's.  G = 8 groups x 3 and a few steps keep the file cheap.
"""

import itertools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonboat_tpu import bench_loop as ref_bl
from dragonboat_tpu.core import kstate as ref_ks
from dragonboat_tpu.core import router as ref_router
from dragonboat_tpu_torch import bench_loop as bl
from dragonboat_tpu_torch import capacity, convert, graphs, kernels, telemetry
from dragonboat_tpu_torch import request as req
from dragonboat_tpu_torch.core import kernel as K
from dragonboat_tpu_torch.core import router
from dragonboat_tpu_torch.core.kstate import empty_inbox
from dragonboat_tpu_torch.parallel import ici

N, R = 8, 3
G = N * R
STEPS = 4


def _equal(a, b) -> bool:
    la, lb = graphs.leaves_of(a), graphs.leaves_of(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _np(x):
    return {k: None if v is None else np.array(v) for k, v in zip(x._fields, x)}


@pytest.fixture(scope="module")
def elected():
    """An elected G-row device-SM cluster (sm_params: inline payloads)."""
    kp = bl.sm_params(R, device="cpu")
    st, box = bl.elect_all(kp, R, bl.make_cluster(kp, N, R, device="cpu"))
    return kp, st, box


@pytest.fixture(autouse=True)
def _fresh_graphs():
    graphs.clear()
    yield
    graphs.clear()


ENTRIES = {
    "step": lambda: K.step,
    "cluster_step": lambda: router.cluster_step,
    "cluster_step_donated": lambda: router.cluster_step_donated,
    "full_step_sm": lambda: bl.full_step_sm,
    "serve_step": lambda: ici.serve_step,
    "serve_step_donated": lambda: ici.serve_step_donated,
}


def _drive(entry: str, kp, st, box):
    """STEPS calls of one compiled entry, passing its results back as a
    loop does; returns every call's results, copied out."""
    fn = ENTRIES[entry]()
    kv, kvs = bl.make_device_sm(N, R, 128, device="cpu")
    cl, _, _ = ici.make_ici_cluster(kp, 1, R, N, device="cpu")
    cut = torch.zeros((G, kp.num_peers), dtype=torch.bool)
    cut[5, 1] = cut[7, 0] = True
    seen = []
    for _ in range(STEPS):
        inp = bl._self_input(kp, st, True, True, None, False, 0)
        if entry == "step":
            st, out = fn(kp, st, box, inp)
            box = router.route(kp, R, out)
            res = (st, out)
        elif entry == "full_step_sm":
            res = fn(kp, R, kv, st, box, kvs, True, True)
            st, box, kvs = res[:3]
        elif entry.startswith("cluster"):
            res = fn(kp, R, st, box, inp)
            st, box = res[:2]
        else:  # the mesh serving entries, one group per g block row set
            res = fn(kp, cl, st, box, inp, cut)
            st, box = res[:2]
        seen.append(graphs.fresh(res))
    return seen


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_compiled_entry_equals_eager_under_the_stand_in(elected, entry):
    kp, st, box = elected
    eager = _drive(entry, kp, st, box)
    with graphs.stand_in():
        replayed = _drive(entry, kp, st, box)
    assert all(_equal(a, b) for a, b in zip(eager, replayed))
    # one geometry, one capture
    assert ENTRIES[entry]()._cache_size() == 1


def test_cluster_step_donated_equals_the_reference():
    """The stand-in's donating cluster step, looped with proposals, against
    the JAX package's cluster_step_donated (one compile), leaf for leaf."""
    kp, kp_ref = bl.bench_params(R, device="cpu"), ref_bl.bench_params(R)
    st_ref = jax.tree.map(jnp.copy, ref_bl.make_cluster(kp_ref, N, R))
    box_ref = jax.tree.map(jnp.copy, ref_ks.empty_inbox(kp_ref, G))
    st = convert.from_numpy("ShardState", _np(st_ref), "cpu")
    box = empty_inbox(kp, G, "cpu")
    with graphs.stand_in():
        for i in range(14):
            propose = i >= 10
            inp = bl._self_input(kp, st, True, propose, None, False, 0)
            inp_ref = ref_bl._self_input(kp_ref, st_ref, True, propose, None,
                                         False, 0)
            # applied is the state's processed cursor and ri_low ri_high's
            # buffer: donate copies
            inp_ref = jax.tree.map(jnp.copy, inp_ref)
            st, box, out = router.cluster_step_donated(kp, R, st, box, inp)
            st_ref, box_ref, out_ref = ref_router.cluster_step_donated(
                kp_ref, R, st_ref, box_ref, inp_ref)
            for ref, got in ((st_ref, st), (box_ref, box), (out_ref, out)):
                bad = convert.diff_leaves(_np(ref), convert.to_numpy(got))
                assert not bad, (i, bad)
    assert int(st.committed.max()) > 0
    assert router.cluster_step_donated._cache_size() == 1


def test_non_donated_result_survives_the_next_call(elected):
    kp, st, box = elected
    with graphs.stand_in():
        inp = bl._self_input(kp, st, True, True, None, False, 0)
        first = K.step(kp, st, box, inp)
        kept = graphs.fresh(first)
        second = K.step(kp, first[0], router.route(kp, R, first[1]),
                        bl._self_input(kp, first[0], True, True, None, False, 0))
    assert not _equal(first[0], second[0])
    assert _equal(first, kept)


def test_donated_result_is_the_graphs_own_buffer(elected):
    """A loop passing the donated state back pays no copy: the result is
    the graph's static input, and the caller's tensors are untouched."""
    kp, st, box = elected
    before = graphs.fresh((st, box))
    with graphs.stand_in():
        inp = bl._self_input(kp, st, True, True, None, False, 0)
        s1, b1, _ = router.cluster_step_donated(kp, R, st, box, inp)
        inp = bl._self_input(kp, s1, True, True, None, False, 0)
        s2, b2, _ = router.cluster_step_donated(kp, R, s1, b1, inp)
        static = router.cluster_step_donated.last_static(2)
    assert all(a is b for a, b in zip(graphs.leaves_of(s2), graphs.leaves_of(static)))
    assert _equal((st, box), before)


@pytest.mark.parametrize("loop", ["latency", "storm"])
def test_varying_scalars_are_graph_inputs(elected, loop):
    """The clock ``now`` and the storm's micro-step change from call to
    call: a second call at another clock gives that clock's result, not
    the captured one's, and a Python number in a non-static position
    raises."""
    kp, st, box = elected

    def run(start):
        if loop == "latency":
            return bl.run_steps_lat(kp, R, 2, 4, True, True, True, start, st, box,
                                    *bl.lat_init(kp, G, device="cpu"))
        return bl.run_steps_storm(kp, R, 3, 0.4, start, st, box)

    eager = [run(s) for s in (5, 40)]
    with graphs.stand_in():
        replayed = [run(s) for s in (5, 40)]
    assert not _equal(eager[0], eager[1])
    assert all(_equal(a, b) for a, b in zip(eager, replayed))
    graph = bl._lat if loop == "latency" else bl._storm
    assert graph._cache_size() == 1
    with graphs.stand_in(), pytest.raises(TypeError, match="0-d"):
        bl._mixed(kp, R, 4, st, box, torch.zeros((), dtype=torch.int32), 7)


def test_one_capture_per_geometry_and_the_tracker_counts_it(elected):
    kp, st, box = elected
    tracker = capacity.CompileTracker(registry=telemetry.Registry())
    entry = tracker.wrap("step", K.step.fork())
    with graphs.stand_in():
        for _ in range(3):
            st2, _ = entry(kp, st, box, bl._self_input(kp, st, True, False, None,
                                                       False, 0))
        small = bl.make_cluster(kp, 2, R, device="cpu")
        entry(kp, small, empty_inbox(kp, 2 * R, "cpu"),
              bl._self_input(kp, small, True, False, None, False, 0))
    stats = entry.stats()
    assert (stats["calls"], stats["compiles"]) == (4, 2)
    with graphs.stand_in(), kernels.plain_arms():
        # the plain arms are another graph (the card's kernels are baked in)
        entry(kp, st, box, bl._self_input(kp, st, True, False, None, False, 0))
    assert entry.stats()["compiles"] == 3


def test_launches_and_tallies_count_per_replay():
    """A counted stub: its launch and tally are recorded at capture and
    added at every replay; the warm-up counts nothing."""
    bumps = []

    def body(x):
        kernels.check_launch(0, "quorum_match")
        graphs.tally(lambda: bumps.append(1))
        return x + 1

    fn = graphs.compiled(body)
    x = torch.zeros(3, dtype=torch.int32)
    kernels.reset_launches()
    try:
        with graphs.stand_in():
            for _ in range(3):
                x = fn(x)
        assert kernels.launches["quorum_match"] == 3 and len(bumps) == 3
        assert torch.equal(x, torch.full((3,), 3, dtype=torch.int32))
        fn(x)  # eager on the CPU: counted at once
        assert kernels.launches["quorum_match"] == 4 and len(bumps) == 4
    finally:
        kernels.reset_launches()


def _engine_run(depth: int, rounds: int = 6):
    """A manual-drive script on three port NodeHosts (one shard, the
    engine tests' geometry): per round maybe a write on the leader or a
    ReadIndex, ticks, one run_once per host; returns every round's engine
    states and replica contents."""
    from test_torch_nodehost import close_all, engine_expert, make_cluster

    req.PendingProposal._seq = itertools.count(1)
    req.PendingReadIndex._ctx = itertools.count(1)
    hosts = make_cluster(f"tg{depth}{graphs._state['stand_in']}", auto_run=False,
                         expert=engine_expert(kernel_pipeline_depth=depth,
                                              fleet_stats_every=3))
    rng = np.random.default_rng(7)
    trace = []
    try:
        for _ in range(rounds):
            kind, val = int(rng.integers(0, 3)), int(rng.integers(0, 100))
            ids = {nh.get_leader_id(1) for nh in hosts.values()}
            lead = ids.pop()[0] if len(ids) == 1 else 0
            if kind == 1 and lead in hosts:
                nh = hosts[lead]
                nh.propose(nh.get_noop_session(1), f"k{val % 5}={val}".encode(),
                           timeout_s=2)
            elif kind == 2:
                hosts[1 + val % 3].read_index(1, timeout_s=2)
            for nh in hosts.values():
                for _ in range(2 + depth):
                    nh.tick_all()
            for nh in hosts.values():
                nh.run_once()
            # copies: a donated step updates the engine's state in place
            trace.append([({k: None if v is None else v.copy() for k, v in
                            convert.to_numpy(nh.kernel_engine.state).items()},
                           nh.nodes[1].sm.get_last_applied())
                          for nh in hosts.values()])
    finally:
        close_all(hosts)
    return trace


@pytest.mark.parametrize("depth", [0, 1])
def test_kernel_engine_through_the_stand_in_equals_eager(depth):
    eager = _engine_run(depth)
    with graphs.stand_in():
        replayed = _engine_run(depth)
    for i, (a, b) in enumerate(zip(eager, replayed)):
        for (sa, ap_a), (sb, ap_b) in zip(a, b):
            assert not convert.diff_leaves(sa, sb), i
            assert ap_a == ap_b, i
    assert max(ap for _s, ap in eager[-1]) > 0


def test_a_graph_released_during_a_capture_is_destroyed_at_its_end():
    """Destroying a CUDA graph on the capturing thread invalidates the
    capture (the collector may free a closed engine's graphs there): a
    graph whose last reference goes while a capture is open is kept until
    the capture ends."""

    class Held:  # stands for the torch.cuda.CUDAGraph
        pass

    g = graphs._Graph()
    g.cuda_graph = Held()
    alive = weakref.ref(g.cuda_graph)
    with graphs._capturing():
        del g
        assert alive() is not None
    assert alive() is None and not graphs._doomed
    g = graphs._Graph()
    g.cuda_graph = Held()
    alive = weakref.ref(g.cuda_graph)
    del g
    assert alive() is None
