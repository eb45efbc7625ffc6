"""The port's NodeHost end to end on the CPU: device-resident shards on the
port's KernelEngine behind the client API.

The cases mirror ``tests/test_kernel_engine.py`` and
``tests/test_pipeline_engine.py`` on the reference: propose and read, a
read from a follower host (ReadIndex forwarded to the leader's row),
snapshot and compaction, leader transfer, eviction to the host engine with
a pipelined step in flight, restart from a durable (sharded tan) directory,
and two config changes in a row.  Every host runs with the three decimated
device reductions off, which the port's engine requires, on
``device="cpu"`` (the plain arms of the step's kernels).
"""

import struct
import time

import pytest
import torch

from dragonboat_tpu_torch.config import (
    Config,
    EngineConfig,
    ExpertConfig,
    NodeHostConfig,
)
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.request import RequestDroppedError, RequestTimeoutError
from dragonboat_tpu_torch.statemachine import IStateMachine, Result

# several engine threads per test: keep each on one intra-op thread
torch.set_num_threads(1)

#: the three device reductions the port does not have yet, turned off
REDUCTIONS_OFF = dict(fleet_stats_every=0, health_top_k=0,
                      invariant_probe=False)

#: tick interval of the three-host clusters.  Device rows tick once per
#: engine step, host-resident nodes (a shard after eviction) on the wall
#: clock: with the reference tests' 5 ms and CPU steps of tens of ms, a
#: host follower times out long before its device leader's next
#: heartbeat.  50 ms ticks keep the two clocks within reach; heartbeats
#: every tick and client calls that retry on the current leader absorb
#: the leadership changes that slow steps on a loaded CPU still cause.
RTT_MS = 50


class KVStateMachine(IStateMachine):
    """cmd = "key=value"; lookup = key; snapshot = whole dict (the
    reference test's KV machine, on the port's interface)."""

    def __init__(self, shard_id, replica_id):
        self.kv = {}

    def update(self, entry):
        k, v = entry.cmd.decode().split("=", 1)
        self.kv[k] = v
        return Result(value=len(self.kv))

    def lookup(self, query):
        return self.kv.get(query)

    def save_snapshot(self, w, files, done):
        data = "\n".join(f"{k}={v}" for k, v in sorted(self.kv.items()))
        w.write(struct.pack("<I", len(data)))
        w.write(data.encode())

    def recover_from_snapshot(self, r, files, done):
        (n,) = struct.unpack("<I", r.read(4))
        data = r.read(n).decode()
        self.kv = dict(line.split("=", 1) for line in data.split("\n") if line)


def engine_expert(**kw):
    """The reference engine tests' geometry, reductions off, one step
    worker (every shard here is device-resident and stepped by the engine
    on worker 0; the idle-worker test below runs the reference's
    EngineConfig)."""
    for k, v in dict(kernel_log_cap=256, kernel_capacity=8,
                     kernel_apply_batch=16, kernel_compaction_overhead=16,
                     engine=EngineConfig(exec_shards=1, apply_shards=1),
                     **REDUCTIONS_OFF).items():
        kw.setdefault(k, v)
    return ExpertConfig(**kw)


def make_cluster(prefix, n=3, snapshot_entries=0, expert=None,
                 auto_run=True, shard_id=1):
    addrs = {i: f"{prefix}-{i}" for i in range(1, n + 1)}
    hosts = {}
    for rid, addr in addrs.items():
        nh = NodeHost(NodeHostConfig(
            raft_address=addr, rtt_millisecond=RTT_MS,
            expert=expert or engine_expert()),
            auto_run=auto_run, device="cpu")
        nh.start_replica(addrs, False, KVStateMachine, Config(
            shard_id=shard_id, replica_id=rid, election_rtt=10,
            heartbeat_rtt=1, snapshot_entries=snapshot_entries,
            compaction_overhead=5, device_resident=True))
        hosts[rid] = nh
    return hosts


def close_all(hosts):
    for nh in hosts.values():
        nh.close()


def wait_leader(hosts, shard_id=1, timeout=30.0):
    """A leader a majority of hosts agree on."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        votes = {}
        for nh in hosts.values():
            lid, ok = nh.get_leader_id(shard_id)
            if ok:
                votes[lid] = votes.get(lid, 0) + 1
        for lid, n in votes.items():
            if n > len(hosts) // 2 and lid in hosts:
                return lid
        time.sleep(0.02)
    raise AssertionError("no leader elected")


def on_leader(hosts, fn, deadline_s=60):
    """``fn(leader_host)``, retried on the current leader after a drop,
    a timeout or a missing leader, as a client does: a device-resident
    shard takes proposals only on its leader's host, and leadership can
    move while the engines step slowly on a loaded CPU."""
    end = time.time() + deadline_s
    while True:
        try:
            return fn(hosts[wait_leader(hosts, timeout=10)])
        except (AssertionError, RequestDroppedError, RequestTimeoutError):
            if time.time() > end:
                raise
            time.sleep(0.05)


def propose_retry(hosts, cmd, timeout_s=2):
    """sync_propose on the current leader, retried like a client."""
    return on_leader(hosts, lambda nh: nh.sync_propose(
        nh.get_noop_session(1), cmd, timeout_s=timeout_s))


def wait_until(pred, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


@pytest.fixture
def cluster():
    hosts = make_cluster(f"tnh{time.monotonic_ns()}")
    yield hosts
    close_all(hosts)


def test_propose_and_read_on_the_port_engine(cluster):
    nh = cluster[wait_leader(cluster)]
    assert nh.kernel_engine is not None and nh.nodes[1].peer is None
    assert nh.kernel_engine.device.type == "cpu"
    for i in range(6):
        propose_retry(cluster, f"k{i}={i}".encode())
    assert on_leader(cluster, lambda h: h.sync_read(1, "k5", timeout_s=2)) == "5"
    assert wait_until(lambda: all(h.stale_read(1, "k5") == "5"
                                  for h in cluster.values()))
    st = nh.kernel_engine.state
    assert st.term.dtype == torch.int32 and st.quiesced.dtype == torch.bool


def test_read_from_follower_host(cluster):
    propose_retry(cluster, b"fw=ok")
    val = None
    deadline = time.time() + 30
    while time.time() < deadline and val != "ok":
        follower = next(r for r in cluster if r != wait_leader(cluster))
        try:
            val = cluster[follower].sync_read(1, "fw", timeout_s=3)
        except (RequestDroppedError, RequestTimeoutError):
            time.sleep(0.05)
    assert val == "ok"


def test_snapshot_and_compaction():
    hosts = make_cluster(f"tsn{time.monotonic_ns()}", snapshot_entries=4)
    try:
        for i in range(8):
            propose_retry(hosts, f"s{i}=v{i}".encode())
        # every replica snapshots itself after snapshot_entries applies
        assert wait_until(lambda: all(h.nodes[1].compacted_to > 0
                                      for h in hosts.values()))
        assert on_leader(hosts, lambda h: h.sync_read(
            1, "s7", timeout_s=2)) == "v7"
        assert on_leader(hosts, lambda h: h.sync_request_snapshot(
            1, timeout_s=2)) > 0
    finally:
        close_all(hosts)


def test_leader_transfer(cluster):
    lead = wait_leader(cluster)
    target = next(r for r in cluster if r != lead)
    r = None
    for _ in range(5):
        lead_now = wait_leader(cluster)
        rs = cluster[lead_now].nodes[1].request_leader_transfer(target, 2000)
        cluster[lead_now]._work.set()
        r = rs.wait(15.0)
        if r.code.name == "COMPLETED" or lead_now == target:
            break
    assert r is not None
    assert wait_until(lambda: wait_leader(cluster) == target, timeout=30)


def test_eviction_with_step_in_flight():
    """Depth 1: evicting a row while its step is in flight must not
    resurrect the removed node, and the shard keeps serving host-side."""
    hosts = make_cluster(f"tev{time.monotonic_ns()}",
                         expert=engine_expert(kernel_pipeline_depth=1))
    try:
        propose_retry(hosts, b"pre=evict")
        nh = hosts[wait_leader(hosts)]
        eng = nh.kernel_engine
        assert eng.pipeline_depth == 1
        knode = eng.by_shard[1]
        with eng.mu:
            eng._evict(knode, reason="test")
        node = nh.nodes[1]
        assert node is not knode and node.peer is not None
        assert nh.stale_read(1, "pre") == "evict"
        # the shard keeps serving (possibly after a re-election)
        propose_retry(hosts, b"post=evict")
        assert on_leader(hosts, lambda h: h.sync_read(
            1, "post", timeout_s=3)) == "evict"
        assert nh.events.metrics.snapshot()["engine.pipeline.overlapped"] > 0
    finally:
        close_all(hosts)


def test_restart_from_disk(tmp_path):
    """A durable host (sharded tan LogDB): close, reopen, the row is
    re-injected from the persisted state with the data intact."""
    addrs = {1: f"trs{time.monotonic_ns()}-1"}

    def mk():
        nh = NodeHost(NodeHostConfig(
            # a lone replica elects only once its bootstrap entries reach
            # the device as applied, which needs a tick round pending at
            # the step that restages it (ROADMAP.md Queue 3): ticks
            # shorter than a step keep one pending
            raft_address=addrs[1], rtt_millisecond=5,
            node_host_dir=str(tmp_path),
            expert=engine_expert(kernel_capacity=4)), device="cpu")
        nh.start_replica(addrs, False, KVStateMachine, Config(
            shard_id=1, replica_id=1, election_rtt=10, heartbeat_rtt=1,
            device_resident=True))
        assert wait_until(lambda: nh.get_leader_id(1)[1])
        return nh

    nh = mk()
    assert nh.logdb.name().startswith("sharded-tan")
    for i in range(8):
        propose_retry({1: nh}, f"d{i}=v{i}".encode())
    nh.close()

    nh = mk()
    try:
        assert wait_until(lambda: nh.stale_read(1, "d7") == "v7")
        for i in range(8):
            assert nh.stale_read(1, f"d{i}") == f"v{i}", i
        propose_retry({1: nh}, b"dz=zz")
        assert nh.sync_read(1, "dz", timeout_s=10) == "zz"
    finally:
        nh.close()


def test_sequential_config_changes(cluster):
    """A row accepts a second config change after the first applies (the
    engine clears the row's pending_cc on apply)."""
    def add(h, rid):
        # a retried change may have landed before its answer was lost
        if rid not in h.sync_get_shard_membership(1, timeout_s=2).non_votings:
            h.sync_request_add_nonvoting(1, rid, f"tcc-nv-{rid}", 0,
                                         timeout_s=2)

    for rid in (8, 9):
        on_leader(cluster, lambda h, rid=rid: add(h, rid))
    m = on_leader(cluster, lambda h: h.sync_get_shard_membership(
        1, timeout_s=2))
    assert 8 in m.non_votings and 9 in m.non_votings
    assert all(1 in h.kernel_engine.by_shard for h in cluster.values())


def _thread_cpu_ticks(thread) -> int:
    with open(f"/proc/self/task/{thread.native_id}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[11]) + int(fields[12])


def test_idle_step_workers_sleep_under_the_default_engine_config():
    """Under the reference's EngineConfig (several step workers), a worker
    whose shards are all device-resident waits without polling, and a
    host-resident shard hashed onto it wakes it."""
    hosts = make_cluster(f"idle{time.monotonic_ns()}",
                         expert=engine_expert(engine=EngineConfig()))
    try:
        propose_retry(hosts, b"d=1")
        nh = hosts[1]
        workers = nh._num_workers
        assert nh._refresh_host_workers() == {0}
        idle = nh._workers[1:]
        before = [_thread_cpu_ticks(t) for t in idle]
        time.sleep(0.5)
        assert [_thread_cpu_ticks(t) for t in idle] == before
        sid = 2 + (workers > 2)
        addrs = {r: h.config.raft_address for r, h in hosts.items()}
        for rid, h in hosts.items():
            h.start_replica(addrs, False, KVStateMachine, Config(
                shard_id=sid, replica_id=rid, election_rtt=10,
                heartbeat_rtt=1))
        assert nh.nodes[sid].peer is not None
        assert wait_until(lambda: nh._host_workers == {0, sid % workers},
                          timeout=5)
    finally:
        close_all(hosts)
