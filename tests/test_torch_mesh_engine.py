"""The port's MeshEngine behind NodeHost, on the CPU.

Differential: three reference NodeHosts and three port NodeHosts, each
trio sharing one ``MeshSpec(g_size=2, replicas=3, n_local=4)`` with
``Config(mesh_resident=True)``, ``auto_run=False``, driven by the seeded
script of ``tests/test_torch_engine.py`` (ticks, proposals on the leader's
host, ReadIndex reads on any host) for ``ROUNDS`` rounds.  After every
round the shared mesh engines' ``ShardState`` and carried inbox must be
equal leaf for leaf, dtypes included (tolerance 0, ``convert.diff_leaves``), and so must every
replica's applied index and KV contents and the engines' reduction
snapshots.  The reference's mesh lives on 6 of the 8 virtual CPU devices
of ``tests/conftest.py``, the port's on ``"cpu"``.

End to end (``auto_run=True``), port forms of ``tests/test_mesh_engine.py``:
a partitioned leader deposed, eviction of the whole group to the host
engines, then on one cluster shared by the last three tests: propose and
read, a proposal through a follower host (forwarded in-engine to the
leader's row), and one link cut falling back to the hub and healing.  The
shared cluster comes last: an idle mesh engine on the CPU still steps on
every tick round, and its threads would slow the other clusters.
"""

import time

import numpy as np
import pytest
import torch

from dragonboat_tpu.config import Config as RefConfig
from dragonboat_tpu.config import EngineConfig as RefEngineConfig
from dragonboat_tpu.config import ExpertConfig as RefExpertConfig
from dragonboat_tpu.config import MeshSpec as RefMeshSpec
from dragonboat_tpu.config import NodeHostConfig as RefNodeHostConfig
from dragonboat_tpu.nodehost import NodeHost as RefNodeHost
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch import fabric
from dragonboat_tpu_torch.config import (
    Config,
    EngineConfig,
    ExpertConfig,
    MeshSpec,
    NodeHostConfig,
)
from dragonboat_tpu_torch.engine.mesh_engine import MeshEngine
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.request import RequestDroppedError, RequestTimeoutError

from test_nodehost import KVStateMachine as RefKV
from test_nodehost import wait_leader
from test_torch_engine import (  # noqa: F401  (fresh_counters: a fixture)
    _kv,
    _leader,
    _reductions_equal,
    _round,
    _script,
    fresh_counters,
)
from test_torch_nodehost import RTT_MS, KVStateMachine

torch.set_num_threads(1)

GEOMETRY = dict(kernel_log_cap=256, kernel_apply_batch=16,
                kernel_compaction_overhead=16)
SPEC = dict(g_size=2, replicas=3, n_local=4)
REPLICAS = (1, 2, 3)
ROUNDS = 16


def _hosts(side, prefix, auto_run=False):
    if side == "ref":
        NH, NHC, EX, EC, CF, SM, MS, kw = (
            RefNodeHost, RefNodeHostConfig, RefExpertConfig, RefEngineConfig,
            RefConfig, RefKV, RefMeshSpec, {})
        rtt = 5
    else:
        NH, NHC, EX, EC, CF, SM, MS, kw = (
            NodeHost, NodeHostConfig, ExpertConfig, EngineConfig, Config,
            KVStateMachine, MeshSpec, {"device": "cpu"})
        rtt = RTT_MS
    spec = MS(name=prefix, **SPEC)
    addrs = {r: f"{prefix}-{r}" for r in REPLICAS}
    hosts = {}
    for r in REPLICAS:
        nh = NH(NHC(raft_address=addrs[r], rtt_millisecond=rtt,
                    expert=EX(mesh=spec,
                              engine=EC(exec_shards=1, apply_shards=1),
                              **GEOMETRY)),
                auto_run=auto_run, **kw)
        nh.start_replica(addrs, False, SM, CF(
            shard_id=1, replica_id=r, election_rtt=10, heartbeat_rtt=2,
            compaction_overhead=5, mesh_resident=True))
        hosts[r] = nh
    return hosts


def _close(hosts):
    for nh in hosts.values():
        nh.close()


def _ref_leaves(tree):
    return {f: None if v is None else np.asarray(v)
            for f, v in zip(tree._fields, tree)}


@pytest.mark.parametrize("seed", [3, 11])
def test_mesh_nodehost_differential_bitwise(seed, fresh_counters):
    tag = f"tme{seed}x{time.monotonic_ns()}"
    ref = _hosts("ref", f"r{tag}")
    port = _hosts("port", f"p{tag}")
    try:
        eng, ref_eng = port[1].mesh_engine, ref[1].mesh_engine
        assert isinstance(eng, MeshEngine) and eng.device.type == "cpu"
        assert all(port[r].mesh_engine is eng for r in REPLICAS)
        assert all(port[r].nodes[1].peer is None for r in REPLICAS)
        lead_seen = False
        for i, action in enumerate(_script(seed, ROUNDS)):
            lead = _leader(ref)
            assert _leader(port) == lead, (i, lead, _leader(port))
            lead_seen |= bool(lead)
            _round(ref, action, lead)
            _round(port, action, lead)
            bad = convert.diff_leaves(_ref_leaves(ref_eng.state),
                                      convert.to_numpy(eng.state))
            assert not bad, (seed, i, "state", bad)
            bad = convert.diff_leaves(_ref_leaves(ref_eng._dispatch.box),
                                      convert.to_numpy(eng._dispatch.box))
            assert not bad, (seed, i, "box", bad)
            for r in REPLICAS:
                assert _kv(port[r]) == _kv(ref[r]), (seed, i, r)
            _reductions_equal(ref_eng, eng, (seed, i))
        assert lead_seen
        assert any(_kv(nh)[1] for nh in port.values()), "no write applied"
        assert eng.last_invariants["violations_seen"] == 0
        assert eng._inv_seq >= 2
    finally:
        _close(ref)
        _close(port)


def _propose(nh, cmd, deadline_s=30):
    end = time.time() + deadline_s
    while True:
        try:
            return nh.sync_propose(nh.get_noop_session(1), cmd, timeout_s=5)
        except (RequestDroppedError, RequestTimeoutError):
            if time.time() > end:
                raise
            time.sleep(0.1)


def _converged(hosts, key, value, timeout=30):
    end = time.time() + timeout
    while time.time() < end:
        if all(h.stale_read(1, key) == value for h in hosts.values()):
            return True
        time.sleep(0.05)
    return False


def test_mesh_partitioned_leader_deposed():
    """A partitioned leader host's rows are cut on the device: the other
    two re-elect and commit; after healing the old leader converges."""
    hosts = _hosts("port", f"tmeP{time.monotonic_ns()}", auto_run=True)
    try:
        lid = wait_leader(hosts, timeout=60)
        _propose(hosts[lid], b"pre=cut")
        hosts[lid].partition_node()
        others = {r: h for r, h in hosts.items() if r != lid}
        new_lid, end = None, time.time() + 60
        while time.time() < end:
            try:
                new_lid = wait_leader(others, timeout=10)
                if new_lid != lid:
                    break
            except AssertionError:
                pass
        assert new_lid is not None and new_lid != lid
        _propose(others[new_lid], b"during=cut")
        hosts[lid].restore_partitioned_node()
        assert _converged({lid: hosts[lid]}, "during", "cut")
    finally:
        _close(hosts)


def test_mesh_eviction_to_host_engines():
    """Whole-group escalation: after eviction every member runs as a
    host-resident Node on its own NodeHost and the group keeps serving
    over the chan transport."""
    hosts = _hosts("port", f"tmeE{time.monotonic_ns()}", auto_run=True)
    try:
        nh = hosts[wait_leader(hosts, timeout=60)]
        _propose(nh, b"pre=evict")
        assert _converged(hosts, "pre", "evict")
        eng = nh.mesh_engine
        with eng.mu:
            eng._evict(eng.by_shard[(1, nh.nodes[1].replica_id)],
                       reason="test")
        assert all((1, r) not in eng.by_shard for r in REPLICAS)
        assert all(h.nodes[1].peer is not None for h in hosts.values())
        ok, end = False, time.time() + 60
        while time.time() < end and not ok:
            try:
                nh2 = hosts[wait_leader(hosts, timeout=10)]
                nh2.sync_propose(nh2.get_noop_session(1), b"post=evict",
                                 timeout_s=3)
                ok = nh2.sync_read(1, "post", timeout_s=3) == "evict"
            except Exception:
                time.sleep(0.2)
        assert ok
    finally:
        _close(hosts)


@pytest.fixture(scope="module")
def cluster():
    # the fabric meter is process-wide: start its hop census and link
    # classes afresh, so hub commits of earlier clusters in this process
    # do not count against this one's
    fabric.METER.reset()
    hosts = _hosts("port", f"tmeA{time.monotonic_ns()}", auto_run=True)
    yield hosts
    _close(hosts)


def test_mesh_propose_and_read(cluster):
    hosts = cluster
    eng = hosts[1].mesh_engine
    assert all(hosts[r].mesh_engine is eng for r in REPLICAS)
    # replicas sit in distinct rows: one per mesh position along 'r'
    assert len({eng.by_shard[(1, r)].lane for r in REPLICAS}) == 3
    nh = hosts[wait_leader(hosts, timeout=60)]
    for i in range(6):
        _propose(nh, f"k{i}={i}".encode())
    assert nh.sync_read(1, "k5", timeout_s=10) == "5"
    assert _converged(hosts, "k5", "5")
    info = nh.info()["fabric"]
    assert info["census"]["p50_commit_host_hops"] == 0.0
    assert info["link_classes"] and set(info["link_classes"].values()) == {
        fabric.LINK_CLASS_RESIDENT}


def test_mesh_propose_via_follower_host(cluster):
    """A follower host's proposal is forwarded in-engine to the leader's
    row."""
    hosts = cluster
    lid = wait_leader(hosts, timeout=60)
    fnh = hosts[next(r for r in REPLICAS if r != lid)]
    assert _propose(fnh, b"fwd=yes").value >= 1
    assert hosts[lid].sync_read(1, "fwd", timeout_s=10) == "yes"


def test_mesh_single_link_cut_falls_back_to_hub(cluster):
    """One cut link leaves the mesh at both ends and rides the host hub:
    the cut follower still converges; healing makes it resident again."""
    hosts = cluster
    lid = wait_leader(hosts, timeout=60)
    nh = hosts[lid]
    eng = nh.mesh_engine
    frid = next(r for r in REPLICAS if r != lid)
    lnode, fnode = eng.by_shard[(1, lid)], eng.by_shard[(1, frid)]
    eng.set_link_hub_served(lnode, frid, True)
    try:
        assert eng._dispatch.cut[lnode.lane, frid - 1]
        assert eng._dispatch.cut[fnode.lane, lid - 1]
        assert not eng._dispatch.cut[lnode.lane].all()
        assert eng.link_hub_served(lnode, frid)
        assert eng.link_hub_served(fnode, lid)
        book = eng._link_class_book(lnode)
        la, fa = book[lid], book[frid]
        classes = fabric.METER.snapshot()["link_classes"]
        assert classes[f"{la}->{fa}"] == classes[f"{fa}->{la}"] == "hub"
        _propose(nh, b"during=cut")
        assert _converged({frid: hosts[frid]}, "during", "cut"), (
            "the cut link did not fall back to the hub")
    finally:
        eng.set_link_hub_served(lnode, frid, False)
    assert not eng._dispatch.cut[lnode.lane].any()
    assert not eng._dispatch.cut[fnode.lane].any()
    classes = fabric.METER.snapshot()["link_classes"]
    assert classes[f"{la}->{fa}"] == classes[f"{fa}->{la}"] == "resident"
    _propose(hosts[wait_leader(hosts, timeout=60)], b"post=heal")
    assert _converged(hosts, "post", "heal")


def test_mesh_engine_concurrent_admission():
    """The replicas of many shards admitted into one MeshEngine, each from
    its own thread (more threads than cores, a short switch interval),
    some removed and re-admitted, over several fresh engines: every
    registered replica sits in its own row of its shard's lane, every
    lane is held by one shard, and every queued injection names a
    registered replica."""
    import sys
    import threading
    from types import SimpleNamespace

    from dragonboat_tpu_torch.core import params as KP
    from dragonboat_tpu_torch.engine.kernel_engine import _LaneInit

    kp = KP.KernelParams(num_peers=3, log_cap=64, inbox_cap=10,
                         msg_entries=4, proposal_cap=4, readindex_cap=4,
                         apply_batch=16, compaction_overhead=16)
    book = SimpleNamespace(addresses={r: f"c{r}" for r in REPLICAS},
                           non_votings={}, witnesses={})
    peers = [(r, KP.K_VOTER) for r in REPLICAS]

    def node(sid, rid):
        return SimpleNamespace(
            shard_id=sid, replica_id=rid, lane=-1, engine=None, mirror=None,
            sm=SimpleNamespace(get_membership=lambda: book))

    def admit(eng, sid, rid):
        # each replica from its own thread, as three NodeHosts admit them
        n = node(sid, rid)
        eng.add_shard(n, _LaneInit(0, 0, 0, 0, 0, 0, [], peers))
        if rid == 2:
            eng.remove_replica(n)
            eng.add_shard(node(sid, rid),
                          _LaneInit(0, 0, 0, 0, 0, 0, [], peers))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for rnd in range(5):
            spec = MeshSpec(name=f"tmeC{rnd}x{time.monotonic_ns()}",
                            g_size=2, replicas=3, n_local=64)
            eng = MeshEngine(kp, spec, device="cpu")
            shards = spec.g_size * spec.n_local
            threads = [threading.Thread(target=admit, args=(eng, sid, rid))
                       for sid in range(1, shards + 1) for rid in REPLICAS]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert len(eng.by_shard) == 3 * shards and not eng._free_lanes
            assert sorted(eng._lane_of.values()) == list(range(shards))
            for (sid, rid), n in eng.by_shard.items():
                assert n.lane == eng._row(eng._lane_of[sid], rid)
                assert eng.nodes[n.lane] is n
                assert n.mirror is eng._mirrors[sid]
            assert {g: v[0] for g, v in eng._pending_inject.items()} \
                == eng.nodes
    finally:
        sys.setswitchinterval(interval)
