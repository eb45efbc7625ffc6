"""The port's KernelEngine against the reference's, behind NodeHost.

Differential: three reference NodeHosts and three port NodeHosts (CPU),
``auto_run=False``, driven by one seeded script of ``tick_all()`` and
``run_once()`` rounds with proposals and ReadIndex reads.  After every
round each host's engine ``ShardState`` must equal its counterpart leaf
for leaf, dtypes included (tolerance 0, ``convert.diff_leaves``), and so
must every replica's applied index and KV contents.  The geometry is the
reference engine tests' (``kernel_log_cap=256``, ``kernel_capacity=8``,
``kernel_apply_batch=16``, ``kernel_compaction_overhead=16``) with the
three decimated device reductions on at the reference's defaults (every 10
steps, top 8, the invariant probe): after every round the engines' last
fleet, health, invariant and capacity snapshots and both digests must be
equal too.  The capacity snapshots' compile counters are left out: the
reference counts jit compiles, and the port's eager entries compile
nothing (their call counts are compared).  At pipeline depth 1 the same
script runs reference against port, the reductions reading the state of
the step still in flight.

Depth 1 against depth 0: the port at ``kernel_pipeline_depth=1`` and at
depth 0, driven until every write of the same script is acknowledged,
must hold the same SM contents and applied indexes once idle, and the
depth-1 engine must have overlapped steps.

Each round ticks twice (three times at depth 1): a lane whose step has no
work of its own (no message, tick or request) is dropped from staging with
its applied cursor, so a caller that ticks once per ``run_once`` never
hands the device the applied index of the bootstrap entries and no lane
ever campaigns; at depth 1 the retire that re-dirties a lane runs a step
later.  That is the reference engine's behavior (ROADMAP.md Queue 3),
kept by the port.
"""

import dataclasses
import itertools
import time

import numpy as np
import pytest
import torch

from dragonboat_tpu import request as ref_request
from dragonboat_tpu.config import Config as RefConfig
from dragonboat_tpu.config import EngineConfig as RefEngineConfig
from dragonboat_tpu.config import ExpertConfig as RefExpertConfig
from dragonboat_tpu.config import NodeHostConfig as RefNodeHostConfig
from dragonboat_tpu.core.params import KernelParams as RefKernelParams
from dragonboat_tpu.nodehost import NodeHost as RefNodeHost
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch import request as port_request
from dragonboat_tpu_torch.config import Config, EngineConfig, ExpertConfig, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost

from test_nodehost import KVStateMachine as RefKV
from test_torch_nodehost import KVStateMachine

torch.set_num_threads(1)

GEOMETRY = dict(kernel_log_cap=256, kernel_capacity=8, kernel_apply_batch=16,
                kernel_compaction_overhead=16)
#: the compile telemetry of a capacity entry: the reference's jit entries
#: compile, the port's eager entries never do
COMPILE_COUNTERS = ("compiles", "retraces", "compile_us_total",
                    "last_compile_us")
REPLICAS = (1, 2, 3)


def _hosts(side, prefix, depth=0):
    if side == "ref":
        NH, NHC, EX, EC, CF, SM, kw = (RefNodeHost, RefNodeHostConfig,
                                       RefExpertConfig, RefEngineConfig,
                                       RefConfig, RefKV, {})
    else:
        NH, NHC, EX, EC, CF, SM, kw = (NodeHost, NodeHostConfig, ExpertConfig,
                                       EngineConfig, Config, KVStateMachine,
                                       {"device": "cpu"})
    addrs = {r: f"{prefix}-{r}" for r in REPLICAS}
    hosts = {}
    for r in REPLICAS:
        nh = NH(NHC(raft_address=addrs[r], rtt_millisecond=5,
                    expert=EX(kernel_pipeline_depth=depth,
                              engine=EC(exec_shards=1, apply_shards=1),
                              **GEOMETRY)),
                auto_run=False, **kw)
        nh.start_replica(addrs, False, SM, CF(
            shard_id=1, replica_id=r, election_rtt=10, heartbeat_rtt=2,
            compaction_overhead=5, device_resident=True))
        hosts[r] = nh
    return hosts


@pytest.fixture
def fresh_counters(monkeypatch):
    """Both packages' process-wide request counters restarted at 1, so
    the ReadIndex ctx each side stages (it lands in the device state)
    is the same number."""
    for mod in (ref_request, port_request):
        monkeypatch.setattr(mod.PendingProposal, "_seq", itertools.count(1))
        monkeypatch.setattr(mod.PendingReadIndex, "_ctx", itertools.count(1))


def _script(seed, rounds):
    """Per round: 0 = ticks only, 1 = a proposal on the leader's host,
    2 = a ReadIndex read on a random host; plus the value and host."""
    rng = np.random.default_rng(seed)
    return [(int(rng.choice(3, p=[0.4, 0.4, 0.2])), int(rng.integers(0, 100)),
             int(rng.choice(REPLICAS))) for _ in range(rounds)]


def _round(hosts, action, lead_hint, ticks=2):
    kind, val, rid = action
    if kind == 1 and lead_hint:
        nh = hosts[lead_hint]
        nh.propose(nh.get_noop_session(1), f"k{val % 7}={val}".encode(),
                   timeout_s=2)
    elif kind == 2:
        hosts[rid].read_index(1, timeout_s=2)
    for nh in hosts.values():
        for _ in range(ticks):
            nh.tick_all()
    for nh in hosts.values():
        nh.run_once()


def _leader(hosts):
    ids = {nh.get_leader_id(1) for nh in hosts.values()}
    if len(ids) == 1:
        lid, ok = ids.pop()
        return lid if ok else 0
    return 0


def _ref_state(nh):
    s = nh.kernel_engine.state
    return {f: None if v is None else np.asarray(v)
            for f, v in zip(s._fields, s)}


def _kv(nh):
    n = nh.nodes[1]
    return n.sm.get_last_applied(), dict(n.sm.sm.kv)


def _digest(d):
    return None if d is None else {f: np.asarray(v) if not isinstance(
        v, torch.Tensor) else v.numpy() for f, v in zip(d._fields, d)}


def _capacity(cap):
    """A capacity snapshot without the compile counters."""
    if cap is None:
        return None
    return dict(cap, entries={
        name: {k: v for k, v in e.items() if k not in COMPILE_COUNTERS}
        for name, e in cap["entries"].items()})


def _reductions_equal(ref_eng, eng, where):
    for name in ("last_fleet", "last_health", "last_invariants",
                 "_health_seq", "_inv_seq", "_capacity_seq"):
        assert getattr(eng, name) == getattr(ref_eng, name), (where, name)
    assert _capacity(eng.last_capacity) == _capacity(ref_eng.last_capacity), \
        where
    for name in ("_health_digest", "_inv_digest"):
        a, b = _digest(getattr(ref_eng, name)), _digest(getattr(eng, name))
        assert (a is None) == (b is None), (where, name)
        if a is not None:
            assert not convert.diff_leaves(a, b), (where, name)


def _differential(seed, depth):
    """The seeded script on reference and port hosts; every leaf equal
    after every round.  Returns the reduction ticks host 1 took."""
    tag = f"ted{seed}d{depth}x{time.monotonic_ns()}"
    ref = _hosts("ref", f"r{tag}", depth=depth)
    port = _hosts("port", f"p{tag}", depth=depth)
    ticks = 2 + depth
    try:
        assert all(nh.kernel_engine.device.type == "cpu"
                   for nh in port.values())
        lead_seen = False
        for i, action in enumerate(_script(seed, 24)):
            lead = _leader(ref)
            assert _leader(port) == lead, (i, lead, _leader(port))
            lead_seen |= bool(lead)
            _round(ref, action, lead, ticks=ticks)
            _round(port, action, lead, ticks=ticks)
            for r in REPLICAS:
                got = convert.to_numpy(port[r].kernel_engine.state)
                bad = convert.diff_leaves(_ref_state(ref[r]), got)
                assert not bad, (seed, i, r, bad)
                assert _kv(port[r]) == _kv(ref[r]), (seed, i, r)
                _reductions_equal(ref[r].kernel_engine,
                                  port[r].kernel_engine, (seed, i, r))
        assert lead_seen
        assert any(_kv(nh)[1] for nh in port.values()), "no write applied"
        eng = port[1].kernel_engine
        assert eng.last_invariants["violations_seen"] == 0
        return eng._inv_seq
    finally:
        for nh in (*ref.values(), *port.values()):
            nh.close()


@pytest.mark.parametrize("seed", [3, 11])
def test_engine_differential_bitwise(seed, fresh_counters):
    assert _differential(seed, 0) >= 2


@pytest.mark.parametrize("seed", [3, 11])
def test_engine_differential_bitwise_depth1(seed, fresh_counters):
    """Depth 1, reference against port: the decimated reductions read the
    state of the step still in flight on both sides."""
    assert _differential(seed, 1) >= 2


def _drive_writes(hosts, values, budget=200):
    """Write ``w<i>=<value>`` for every value, all in flight at once on
    the current leader, re-proposing any that is dropped, until every
    write is acknowledged."""
    pending = {i: None for i in range(len(values))}
    rounds = 0
    while pending:
        rounds += 1
        assert rounds < budget, ("writes not acknowledged", sorted(pending))
        lead = _leader(hosts)
        for i, rs in pending.items():
            if rs is None and lead:
                nh = hosts[lead]
                pending[i] = nh.propose(nh.get_noop_session(1),
                                        f"w{i}={values[i]}".encode(),
                                        timeout_s=2)
        _round(hosts, (0, 0, 1), 0, ticks=3)
        for i, rs in list(pending.items()):
            if rs is not None and rs._event.is_set():
                if rs.result.completed():
                    del pending[i]
                else:
                    pending[i] = None
    for _ in range(4):   # settle: every replica applies the last write
        _round(hosts, (0, 0, 1), 0, ticks=3)


def test_depth1_matches_depth0_once_idle():
    values = [int(v) for v in np.random.default_rng(5).integers(0, 50, 6)]
    tag = f"tdp{time.monotonic_ns()}"
    d0, d1 = _hosts("port", f"a{tag}"), _hosts("port", f"b{tag}", depth=1)
    try:
        _drive_writes(d0, values)
        _drive_writes(d1, values)
        for r in REPLICAS:
            a, b = _kv(d0[r]), _kv(d1[r])
            assert b[1] == a[1] == {f"w{i}": str(v)
                                    for i, v in enumerate(values)}
            assert b[0] == a[0], r
        assert all(nh.kernel_engine.pipeline_depth == 1 for nh in d1.values())
        assert sum(nh.events.metrics.snapshot().get(
            "engine.pipeline.overlapped", 0) for nh in d1.values()) > 0
    finally:
        for nh in (*d0.values(), *d1.values()):
            nh.close()


def test_host_side_parts_agree_with_the_reference(tmp_path):
    """The hand-ported host modules hold the reference's data: the
    reductions' dict forms and invariant names, the dispatch contract
    literals, and the capacity model, which also equals the bytes the
    port's engine state measures."""
    from dragonboat_tpu import capacity as ref_capacity
    from dragonboat_tpu.core import fleet as ref_fleet
    from dragonboat_tpu.core import health as ref_health
    from dragonboat_tpu.core import invariants as ref_invariants
    from dragonboat_tpu.engine import dispatch as ref_dispatch
    from dragonboat_tpu_torch import capacity, tracing
    from dragonboat_tpu_torch.core import fleet, health, invariants
    from dragonboat_tpu_torch.engine import dispatch

    for port_mod, ref_mod in ((fleet, ref_fleet), (health, ref_health),
                              (invariants, ref_invariants),
                              (capacity, ref_capacity)):
        assert port_mod.empty_dict() == ref_mod.empty_dict(), port_mod
    assert invariants.INVARIANT_NAMES == ref_invariants.INVARIANT_NAMES
    assert health.DEFAULT_THRESHOLDS == tuple(ref_health.DEFAULT_THRESHOLDS)
    for name in ("STEP_LOOP_METHODS", "DISPATCH_SEAMS", "ENGINE_FEATURE_KNOBS",
                 "ENGINE_FEATURE_CALLS", "SYNC_POINTS", "TRANSFER_LEDGER"):
        assert getattr(dispatch, name) == getattr(ref_dispatch, name), name

    nh = NodeHost(NodeHostConfig(raft_address=f"tcap{time.monotonic_ns()}",
                                 expert=ExpertConfig(**GEOMETRY)),
                  auto_run=False, device="cpu")
    try:
        kp = nh._kernel_params()
        eng = nh._ensure_kernel_engine()
        per = capacity.model_bytes_per_group(kp, ("ShardState",))
        ref_kp = RefKernelParams(**dataclasses.asdict(kp))
        assert per == ref_capacity.model_bytes_per_group(ref_kp, ("ShardState",))
        assert capacity.measure_tree_bytes(eng.state) == \
            per["ShardState"] * eng.capacity
    finally:
        nh.close()

    tracing.start_trace(str(tmp_path))
    with tracing.annotate("probe"):
        torch.zeros(4).sum()
    assert tracing.stop_trace() == str(tmp_path)
    assert (tmp_path / "trace.json").exists()
