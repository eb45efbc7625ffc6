"""The port's split mesh on the CPU: the port's form of
``tests/test_multichip.py``.

A split cluster (``ici.make_ici_cluster(..., devices=[...])``) holds each
mesh position's rows as tensors of its own, here with every position's
device forced to ``"cpu"``.  Its steps must be bitwise equal (every leaf,
dtypes included, tolerance 0: ``convert.diff_leaves``) to the port's
one-device mesh after every step, and through it, at ``(g, r) = (2, 4)``,
to the reference's ``shard_map`` mesh on the 8 virtual CPU devices of
``tests/conftest.py``.  Cases:

- ``ici_cluster_step`` at (2, 4), (4, 2) and (1, 3), then the reference's
  liveness checks on the split state: one leader per group, commits
  across positions, committed spread within ``2 * msg_entries``;
- ``serve_step_donated`` through the CPU graph stand-in (each position's
  graphs, the exchange's copies into the route's static inputs) with the
  cut mask open, one row cut, then one link cut at both ends, and after
  every step the placement check (``analysis/partition.py``): each
  position's leaves on its device with ``n_local`` rows;
- ``ici_run_steps``; the row writes and reads the engine goes through;
  the device grid's default and validation;
- three NodeHosts on a split (1, 3) mesh: elect, write, read back from
  every replica, one link cut to the hub and healed.

The long runs start from a state the one-device port elected, so that
elections are not paid ``g * r`` times (an eager CPU step costs about the
same on 2 rows as on 16).
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dragonboat_tpu.core import kstate as ref_kstate
from dragonboat_tpu.parallel import ici as ref_ici
from dragonboat_tpu_torch import convert, fabric, graphs
from dragonboat_tpu_torch.analysis import partition
from dragonboat_tpu_torch.config import (
    Config,
    EngineConfig,
    ExpertConfig,
    MeshSpec,
    NodeHostConfig,
)
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.engine.mesh_engine import (
    attach_mesh_engine,
    detach_mesh_engine,
)
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.parallel import ici

from test_torch_nodehost import RTT_MS, KVStateMachine

torch.set_num_threads(1)

#: steps compared after the one-device port's election
STEPS = 2
#: the one-device port's election run (timeout 3: every group elects)
ELECTION, ELECT_STEPS = 3, 12


def _params(r):
    """``tests/test_multichip.py``'s geometry."""
    return KP.KernelParams(
        num_peers=r, log_cap=256, inbox_cap=5 * (r - 1), msg_entries=8,
        proposal_cap=4, readindex_cap=4, apply_batch=32,
        compaction_overhead=32)


@functools.lru_cache(maxsize=None)
def _elected(g_size, replicas):
    """The one-device port's state and box after its election run, with
    proposals on (host copies, so each test starts from its own)."""
    kp = _params(replicas)
    cl, st, box = ici.make_ici_cluster(kp, g_size, replicas, g_size * 2,
                                       election=ELECTION, device="cpu")
    st, box = ici.ici_run_steps(kp, cl, ELECT_STEPS, True, st, box)
    assert _one_leader_per_group(cl, convert.to_numpy(st)["role"])
    return convert.to_numpy(st), convert.to_numpy(box)


def _start(g_size, replicas):
    """(one-device cluster, split cluster, state, box) from the elected
    state; the split one's state and box are its per-position pieces."""
    kp = _params(replicas)
    st_np, box_np = _elected(g_size, replicas)
    cl, _, _ = ici.make_ici_cluster(kp, g_size, replicas, g_size * 2,
                                    device="cpu")
    scl, _, _ = ici.make_ici_cluster(kp, g_size, replicas, g_size * 2,
                                     devices=["cpu"] * (g_size * replicas))
    st = convert.from_numpy("ShardState", st_np, device="cpu")
    box = convert.from_numpy("Inbox", box_np, device="cpu")
    return cl, scl, st, box


def _by_group(cl, a):
    """[G] block-major -> [num_groups, R] (one row per group)."""
    return np.transpose(np.asarray(a).reshape(
        cl.g_size, cl.replicas, cl.n_local), (0, 2, 1)).reshape(
            -1, cl.replicas)


def _one_leader_per_group(cl, role):
    return ((_by_group(cl, role) == KP.LEADER).sum(axis=1) == 1).all()


def _equal(tag, want, got):
    bad = convert.diff_leaves(want, got)
    assert not bad, (tag, bad)


def _joined(scl, tree):
    return convert.to_numpy(scl.gather(tree))


def _ref_np(tree):
    return {f: None if v is None else np.asarray(v)
            for f, v in zip(tree._fields, tree)}


def _ref_tree(cls, d):
    return cls(*[None if d[f] is None else jnp.asarray(d[f])
                 for f in cls._fields])


@pytest.mark.parametrize("g_size,replicas", [(2, 4), (4, 2), (1, 3)])
def test_cluster_step_split_equals_one_device(g_size, replicas):
    """Split = one-device after every step (and = the reference's
    ``shard_map`` mesh at (2, 4)); then the reference's liveness checks
    on the split state."""
    kp = _params(replicas)
    cl, scl, st, box = _start(g_size, replicas)
    sst, sbox = scl.shard(st), scl.shard(box)
    ref = None
    if (g_size, replicas) == (2, 4):
        devs = jax.devices()
        assert len(devs) >= 8, "conftest forces 8 CPU devices"
        mesh = Mesh(np.array(devs[:8]).reshape(2, 4), ("g", "r"))
        # the geometry alone: the state comes from the port's election
        rcl = ref_ici.IciCluster(kp=_ref_params(replicas), mesh=mesh,
                                 replicas=replicas, n_local=2, num_groups=4)
        ref = (rcl, rcl.shard(_ref_tree(ref_kstate.ShardState,
                                         convert.to_numpy(st))),
               rcl.shard(_ref_tree(ref_kstate.Inbox, convert.to_numpy(box))))
    c0 = _by_group(cl, convert.to_numpy(st)["committed"]).max(axis=1)
    for i in range(STEPS):
        st, box, out = ici.ici_cluster_step(
            cl, st, box, ici.self_driving_input(kp, st))
        sst, sbox, sout = ici.ici_cluster_step(
            scl, sst, sbox, ici.self_driving_input(kp, sst))
        want = {"state": convert.to_numpy(st), "box": convert.to_numpy(box),
                "out": convert.to_numpy(out)}
        for tag, tree in (("state", sst), ("box", sbox), ("out", sout)):
            assert isinstance(tree, graphs.Split) and \
                len(tree) == g_size * replicas
            _equal((tag, i), want[tag], _joined(scl, tree))
        if ref is not None:
            rcl, rst, rbox = ref
            rinp = rcl.shard(ref_ici.self_driving_input(rcl.kp, rst))
            rst, rbox, rout = ref_ici.ici_cluster_step(rcl, rst, rbox, rinp)
            ref = (rcl, rst, rbox)
            for tag, tree in (("state", rst), ("box", rbox), ("out", rout)):
                _equal(("reference", tag, i), _ref_np(tree), want[tag])
    # liveness on the split state (tests/test_multichip.py)
    joined = _joined(scl, sst)
    assert _one_leader_per_group(cl, joined["role"])
    commits = _by_group(cl, joined["committed"])
    assert (commits.max(axis=1) > c0).all(), "no commit across positions"
    spread = commits.max(axis=1) - commits.min(axis=1)
    assert (spread <= kp.msg_entries * 2).all()


def _ref_params(r):
    from dragonboat_tpu.core import params as ref_P

    return ref_P.KernelParams(
        num_peers=r, log_cap=256, inbox_cap=5 * (r - 1), msg_entries=8,
        proposal_cap=4, readindex_cap=4, apply_batch=32,
        compaction_overhead=32)


def test_serve_step_split_cuts_and_placement():
    """The donating serve step on the split layout, replayed through the
    CPU graph stand-in, against the one-device serve step with the cut
    mask open, one row cut, then one link cut at both ends; the
    placement check holds after every step."""
    g_size, replicas = 1, 3
    kp = _params(replicas)
    cl, scl, st, box = _start(g_size, replicas)
    sst, sbox = scl.shard(st), scl.shard(box)
    total = cl.total_rows
    open_ = np.zeros((total, replicas), bool)
    row = open_.copy()
    row[1, :] = True                  # replica 1 of group 1: every link
    link = open_.copy()               # group 0: replica 1 <-> replica 3
    link[0, 2] = True
    link[2 * cl.n_local, 0] = True
    schedule = [open_] * 2 + [row] * 2 + [link] * 2
    committed = []
    with graphs.stand_in():
        for i, cut in enumerate(schedule):
            st, box, out = ici.serve_step(
                kp, cl, st, box, ici.self_driving_input(kp, st),
                torch.from_numpy(cut))
            sst, sbox, sout = ici.serve_step_donated(
                kp, scl, sst, sbox, ici.self_driving_input(kp, sst),
                scl.shard(cut))
            _equal(("state", i), convert.to_numpy(st), _joined(scl, sst))
            _equal(("box", i), convert.to_numpy(box), _joined(scl, sbox))
            _equal(("out", i), convert.to_numpy(out), _joined(scl, sout))
            assert partition.placement_check(
                scl, ShardState=sst, Inbox=sbox, StepOutput=sout) == []
            committed.append(int(st.committed.max()))
    assert committed[-1] > committed[0]
    # graphs per position: a step and a route for each, both cached
    made = ici.serve_step_donated.positions()
    assert sum(k[1] == scl for k in made) == 2 * scl.positions


def test_placement_check_fires_on_a_misplaced_piece():
    """The placement check is not vacuous: a leaf on another device, a
    piece with the wrong rows and a tree left whole are each found."""
    kp = _params(3)
    scl, sst, sbox = ici.make_ici_cluster(kp, 1, 3, 2, devices=["cpu"] * 3)
    assert partition.placement_check(scl, ShardState=sst, Inbox=sbox) == []
    moved = list(sst)
    moved[1] = moved[1]._replace(term=moved[1].term.to("meta"))
    cut = list(sbox)
    cut[2] = cut[2]._replace(mtype=cut[2].mtype[:1])
    found = partition.placement_check(
        scl, ShardState=graphs.Split(moved), Inbox=graphs.Split(cut),
        StepOutput=scl.gather(sst))
    assert sorted(f.rule for f in found) == ["PS002"] * 3
    msgs = " ".join(f.message for f in found)
    assert "ShardState.term of position (0, 1) is on meta" in msgs
    assert "Inbox.mtype of position (0, 2) has shape (1, 10)" in msgs
    assert "StepOutput is not split" in msgs


def test_run_steps_split_equals_one_device():
    """The self-driving loop, split (through the CPU graph stand-in) and
    on one device."""
    g_size, replicas = 4, 2
    kp = _params(replicas)
    cl, scl, st, box = _start(g_size, replicas)
    sst, sbox = scl.shard(st), scl.shard(box)
    st, box = ici.ici_run_steps(kp, cl, STEPS, True, st, box)
    with graphs.stand_in():
        sst, sbox = ici.ici_run_steps(kp, scl, STEPS, True, sst, sbox)
    _equal("state", convert.to_numpy(st), _joined(scl, sst))
    _equal("box", convert.to_numpy(box), _joined(scl, sbox))


def test_rows_written_and_read_per_position():
    """The engine's row writes and reads on split pieces equal the same
    writes and reads on the whole state."""
    kp = _params(3)
    cl, whole, _ = ici.make_ici_cluster(kp, 2, 3, 4, device="cpu")
    scl, split, _ = ici.make_ici_cluster(kp, 2, 3, 4, devices=["cpu"] * 6)
    rows = np.array([11, 0, 5, 6], np.int64)
    pid = np.arange(rows.size * 3, dtype=np.int32).reshape(-1, 3)
    upd = {"term": np.array([7, 8, 9, 10], np.int32), "pid": pid,
           "kind": np.array([[1, 2, 1]], np.int32), "role": KP.LEADER,
           "next": (pid[:, :1] + 1)}
    whole = ici.write_rows(whole, rows, upd)
    split = ici.write_rows(split, rows, upd)
    whole = ici.write_rows(whole, 3, {"vote": 2, "lt": np.ones((1, 256),
                                                               np.int32)})
    split = ici.write_rows(split, 3, {"vote": 2, "lt": np.ones((1, 256),
                                                               np.int32)})
    _equal("write_rows", convert.to_numpy(whole), _joined(scl, split))
    for x, y in ((whole.term, split.term), (whole.pid, split.pid)):
        assert np.array_equal(ici.take_rows(x, rows), ici.take_rows(y, rows))
        assert np.array_equal(ici.to_host(x), ici.to_host(y))
    assert ici.take_rows(split.term, rows).tolist() == [7, 8, 9, 10]


def test_device_grid_default_and_validation():
    """No grid on the CPU by default (the one-device layout); a named
    grid is taken as given and must have one device per position; hosts
    sharing a mesh must ask for the same placement."""
    cpu = torch.device("cpu")
    assert ici.mesh_grid(3, cpu) is None
    assert ici.mesh_grid(3, cpu, ["cpu"] * 3) == (cpu,) * 3
    with pytest.raises(ValueError, match="needs 3 devices"):
        ici.mesh_grid(3, cpu, ["cpu"] * 2)
    spec = MeshSpec(name=f"tmcG{time.monotonic_ns()}", g_size=1, replicas=3,
                    n_local=1)
    kp = _params(3)
    eng = attach_mesh_engine(kp, spec, device="cpu", devices=["cpu"] * 3)
    try:
        assert eng.cluster.devices == (cpu,) * 3
        assert isinstance(eng.state, graphs.Split) and len(eng.state) == 3
        with pytest.raises(RuntimeError, match="device mismatch"):
            attach_mesh_engine(kp, spec, device="cpu")
    finally:
        detach_mesh_engine(eng)


def test_nodehost_split_mesh_write_read_and_link_cut():
    """Three NodeHosts on a split (1, 3) mesh, driven by hand: the group
    elects, every write is applied on every replica, one link cut to the
    hub still carries writes, and healing makes it resident again."""
    fabric.METER.reset()
    prefix = f"tmcN{time.monotonic_ns()}"
    spec = MeshSpec(name=prefix, g_size=1, replicas=3, n_local=1)
    addrs = {r: f"{prefix}-{r}" for r in (1, 2, 3)}
    hosts = {}
    try:
        for r in (1, 2, 3):
            nh = NodeHost(NodeHostConfig(
                raft_address=addrs[r], rtt_millisecond=RTT_MS,
                expert=ExpertConfig(
                    mesh=spec, engine=EngineConfig(exec_shards=1,
                                                   apply_shards=1),
                    kernel_log_cap=256, kernel_apply_batch=16,
                    kernel_compaction_overhead=16)),
                auto_run=False, device="cpu", mesh_devices=["cpu"] * 3)
            nh.start_replica(addrs, False, KVStateMachine, Config(
                shard_id=1, replica_id=r, election_rtt=10, heartbeat_rtt=2,
                compaction_overhead=5, mesh_resident=True))
            hosts[r] = nh
        eng = hosts[1].mesh_engine
        assert all(nh.mesh_engine is eng for nh in hosts.values())
        assert eng.cluster.devices is not None

        def round_():
            for nh in hosts.values():
                nh.tick_all()
                nh.tick_all()
            hosts[1].run_once()

        def leader():
            ids = {nh.get_leader_id(1) for nh in hosts.values()}
            lid, ok = ids.pop() if len(ids) == 1 else (0, False)
            return lid if ok else 0

        for _ in range(30):
            if leader():
                break
            round_()
        lid = leader()
        assert lid, "no leader on the split mesh"

        def write(key, value):
            nh = hosts[lid]
            nh.propose(nh.get_noop_session(1), f"{key}={value}".encode(),
                       timeout_s=60)
            for _ in range(20):
                round_()
                if all(nh.nodes[1].sm.sm.kv.get(key) == value
                       for nh in hosts.values()):
                    return
            raise AssertionError(f"{key} not applied on every replica")

        write("a", "1")
        frid = next(r for r in (1, 2, 3) if r != lid)
        lnode, fnode = eng.by_shard[(1, lid)], eng.by_shard[(1, frid)]
        eng.set_link_hub_served(lnode, frid, True)
        assert eng.link_hub_served(lnode, frid)
        assert eng.link_hub_served(fnode, lid)
        write("b", "2")
        eng.set_link_hub_served(lnode, frid, False)
        assert not eng._dispatch.cut.any()
        write("c", "3")
        classes = fabric.METER.snapshot()["link_classes"]
        assert classes and set(classes.values()) == {
            fabric.LINK_CLASS_RESIDENT}
        assert isinstance(eng.state, graphs.Split)
        assert partition.placement_check(
            eng.cluster, ShardState=eng.state,
            Inbox=eng._dispatch.box) == []
        assert eng.last_invariants["violations_seen"] == 0
    finally:
        for nh in hosts.values():
            nh.close()
