"""The port's NodeHost addressed by NodeHostID through gossip, on the CPU.

The reference's ``tests/test_gossip.py`` cases that run a NodeHost
(``test_cluster_over_nhid_addressing``,
``test_shard_view_gossips_to_non_hosting_host``), with device-resident
shards on the port's KernelEngine, over the chan transport and over the
TCP transport (the shape of ``tests/test_tcp_transport.py``'s
``test_tcp_cluster_propose_and_read``).  The gossip, history and TCP
modules are verbatim copies of the reference's (``_hostcopy.MODULES``):
the reference's own tests hold their units, these hold the port's NodeHost
on top of them.  The refusal without a gossip config is
``tests/test_torch_rules.py::test_gossip_addressing_is_refused``.
"""

import socket
import time

import pytest

from dragonboat_tpu_torch.config import Config, GossipConfig, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.transport.tcp import TCPTransportFactory

from test_torch_nodehost import (
    RTT_MS,
    KVStateMachine,
    close_all,
    engine_expert,
    on_leader,
    propose_retry,
    wait_leader,
    wait_until,
)


def free_ports(n, kind=socket.SOCK_DGRAM):
    """n distinct free loopback ports (held until all are chosen)."""
    socks = [socket.socket(socket.AF_INET, kind) for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def gossip_hosts(prefix, n, transport="chan"):
    """n port NodeHosts with address_by_node_host_id, seeded with host 1's
    gossip port; over TCP each raft address is a loopback port."""
    gports = free_ports(n)
    seed = [f"127.0.0.1:{gports[0]}"]
    rports = free_ports(n, socket.SOCK_STREAM) if transport == "tcp" else ()
    hosts = {}
    try:
        for i in range(1, n + 1):
            kw = {}
            if transport == "tcp":
                kw["transport_factory"] = TCPTransportFactory()
                addr = f"127.0.0.1:{rports[i - 1]}"
            else:
                addr = f"{prefix}-{i}"
            hosts[i] = NodeHost(NodeHostConfig(
                raft_address=addr, rtt_millisecond=RTT_MS,
                address_by_node_host_id=True,
                gossip=GossipConfig(bind_address=f"127.0.0.1:{gports[i - 1]}",
                                    seed=list(seed)),
                expert=engine_expert(), **kw), device="cpu")
    except BaseException:
        close_all(hosts)
        raise
    return hosts


def start(hosts, members):
    for rid in members:
        hosts[rid].start_replica(members, False, KVStateMachine, Config(
            shard_id=1, replica_id=rid, election_rtt=10, heartbeat_rtt=1,
            device_resident=True))


@pytest.mark.parametrize("transport", ["chan", "tcp"])
def test_cluster_over_nhid_addressing(transport):
    """Initial members are NodeHostIDs; gossip resolves them to raft
    addresses; the device-resident shard elects, acknowledges a write and
    serves it from the leader and from every replica."""
    hosts = gossip_hosts(f"tg{time.monotonic_ns()}", 3, transport)
    try:
        members = {i: hosts[i].id for i in hosts}   # rid -> NodeHostID
        start(hosts, members)
        lead = wait_leader(hosts, timeout=60)
        assert hosts[lead].nodes[1].peer is None
        assert all(h.kernel_engine.device.type == "cpu"
                   for h in hosts.values())
        for nh in hosts.values():
            reg, ok = nh.get_node_host_registry()
            assert ok
            for rid, h in hosts.items():
                assert reg.resolve(1, rid)[0] == h.config.raft_address
        propose_retry(hosts, b"dyn=addr")
        assert on_leader(hosts, lambda h: h.sync_read(
            1, "dyn", timeout_s=2)) == "addr"
        assert wait_until(lambda: all(h.stale_read(1, "dyn") == "addr"
                                      for h in hosts.values()))
    finally:
        close_all(hosts)


def test_shard_view_gossips_to_non_hosting_host():
    """A host that never hosts shard 1 learns its membership and its
    device-resident leader through the gossip shard view."""
    hosts = gossip_hosts(f"tsv{time.monotonic_ns()}", 3)
    try:
        members = {1: hosts[1].id, 2: hosts[2].id}
        start(hosts, members)
        lead = wait_leader({1: hosts[1], 2: hosts[2]}, timeout=60)
        reg, ok = hosts[3].get_node_host_registry()
        assert ok
        view = None
        deadline = time.time() + 20
        while time.time() < deadline:
            view = reg.get_shard_info(1)
            if view is not None and view.leader_id == lead \
                    and len(view.replicas) == 2:
                break
            time.sleep(0.05)
        assert view is not None, "host 3 never learned shard 1"
        assert view.leader_id == lead and view.term > 0
        assert set(view.replicas) == {1, 2}
        assert view.replicas[1] == hosts[1].id
        assert reg.num_of_shards() >= 1
    finally:
        close_all(hosts)
