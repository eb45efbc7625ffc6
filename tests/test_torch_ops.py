"""Membership and log-lifecycle operations on the port's device- and
mesh-resident shards, held against the reference.

Differential (``auto_run=False``): three reference and three port
NodeHosts on the CPU driven in lockstep by ``dragonboat_tpu_torch.lockstep``
(the seeded script of ``tests/test_torch_engine.py``: ticks, proposals on
the leader's host, ReadIndex reads on any host) with the operations a
Raft library's users depend on put in at fixed points, each on both
sides in the same round: a witness added with ``request_add_witness``
and started on a host of its own (host-resident, ``is_witness=True``)
after the leader lane's device ring compacted, so it catches up through
the stripped file-less witness snapshot (``s_wit_snap`` set on the leader
row, counted where the engines build their messages); one voter closed,
so commits need the witness's acks; ``request_leader_transfer``;
``request_snapshot`` beside the automatic snapshots of a small
``snapshot_entries``; every open host closed and reopened on its
``node_host_dir`` (sharded tan), its rows re-injected from disk.  The
geometry is the reference engine tests' with the three decimated
reductions on.  After every round: every device engine's state leaf for
leaf, dtypes included (tolerance 0), its reduction snapshots, every
replica's applied index and KV contents, and the witness's durable log
(each entry's index, term, type and payload length: METADATA without a
payload but for config changes) must be equal between the sides.

Cases: the KernelEngine at depth 0 and at depth 1 (idle at the end: no
pending step context, overlapped steps taken), and the MeshEngine on a
(g=2, r=4) mesh, so that witness id 4 lies inside mesh addressing: a
follower read, a leader transfer, a snapshot and a restart on the mesh,
then the witness, which escalates the group to the host engines on both
sides, and a restart whose admission refuses the mesh on both sides.

End to end (``auto_run=True``): one cluster of three device-resident
voters and a witness takes the reference's witness checks (METADATA
only, commits with a voter down, no eviction) and the port form of
``tests/test_monkey.py::test_kernel_engine_partition_linearizable``.
"""

import time

import numpy as np
import pytest
import torch

from dragonboat_tpu import request as ref_request
from dragonboat_tpu.config import Config as RefConfig
from dragonboat_tpu.config import EngineConfig as RefEngineConfig
from dragonboat_tpu.config import ExpertConfig as RefExpertConfig
from dragonboat_tpu.config import MeshSpec as RefMeshSpec
from dragonboat_tpu.config import NodeHostConfig as RefNodeHostConfig
from dragonboat_tpu.nodehost import NodeHost as RefNodeHost
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch import lockstep as ls_
from dragonboat_tpu_torch import request as port_request
from dragonboat_tpu_torch.config import (
    Config,
    EngineConfig,
    ExpertConfig,
    MeshSpec,
    NodeHostConfig,
)
from dragonboat_tpu_torch.lockstep import VOTERS, WITNESS, Lockstep, Side
from dragonboat_tpu_torch.nodehost import NodeHost

from test_nodehost import KVStateMachine as RefKV
from test_torch_engine import _reductions_equal, _script
from test_torch_nodehost import RTT_MS, KVStateMachine, engine_expert

torch.set_num_threads(1)


def _ref_leaves(eng, tree):
    return {f: None if v is None else np.asarray(v)
            for f, v in zip(tree._fields, tree)}


SIDES = {
    "r": Side(RefNodeHost, RefNodeHostConfig, RefExpertConfig,
              RefEngineConfig, RefConfig, RefMeshSpec, RefKV, {},
              _ref_leaves, ref_request),
    "p": Side(NodeHost, NodeHostConfig, ExpertConfig, EngineConfig, Config,
              MeshSpec, KVStateMachine, {"device": "cpu"},
              lambda eng, tree: convert.to_numpy(tree), port_request),
}
#: the monkey's least partition seconds and completed operations a window
#: (``lockstep.monkey``): with the eager engine step on the CPU, three
#: engines taking turns at ~0.1 s a step, client calls get 3 s
MONKEY_S, MONKEY_OPS = 2.0, 4


@pytest.fixture
def wit_snaps(monkeypatch):
    """Rows whose step set ``s_wit_snap`` (a stripped witness snapshot
    to send), counted per side where the engines build their messages."""
    from dragonboat_tpu.engine import kernel_engine as ref_ke
    from dragonboat_tpu_torch.engine import kernel_engine as ke

    counts = {}
    for side, mod in (("r", ref_ke), ("p", ke)):
        counts[side] = 0
        orig = mod.KernelEngine._emit_messages

        def emit(self, g, n, o, fl, *rest, _orig=orig, _side=side,
                 _col=mod._F_WITSNAP):
            if fl[_col] and np.asarray(o["s_wit_snap"][g]).any():
                counts[_side] += 1
            return _orig(self, g, n, o, fl, *rest)

        monkeypatch.setattr(mod.KernelEngine, "_emit_messages", emit)
    return counts


@pytest.mark.parametrize("depth", [0, 1])
def test_ops_kernel_engine_lockstep(tmp_path, depth, wit_snaps):
    """Cases (a) and (b): the KernelEngine at depths 0 and 1."""
    ls = Lockstep(SIDES, tmp_path, f"op{depth}x{time.monotonic_ns()}",
                  _reductions_equal, depth=depth)
    try:
        seen = ls_.kernel_ops(ls, iter(_script(3, 100_000)))
        assert seen["ring_snap_index"] > 0
        assert wit_snaps["r"] > 0 and wit_snaps["p"] == wit_snaps["r"]
        port = ls.hosts["p"].values()
        if depth:
            assert sum(nh.events.metrics.snapshot().get(
                "engine.pipeline.overlapped", 0) for nh in port) > 0
        assert all(nh.kernel_engine.last_invariants["violations_seen"] == 0
                   for nh in port if nh.kernel_engine is not None)
    finally:
        ls.close_all()


def test_ops_mesh_engine_lockstep(tmp_path):
    """Case (c): the MeshEngine on a (g=2, r=4) mesh."""
    ls = Lockstep(SIDES, tmp_path, f"opm{time.monotonic_ns()}",
                  _reductions_equal, mesh=True)
    try:
        assert all(nh.kernel_engine is None and nh.nodes[1].peer is None
                   for h in ls.hosts.values() for nh in h.values())
        ls_.mesh_ops(ls, iter(_script(11, 100_000)))
    finally:
        ls.close_all()


def test_witness_and_partition_linearizable_end_to_end():
    """Three device-resident voters and a host witness, ``auto_run``:
    the witness's log holds METADATA only; the reference's partition
    monkey's history is linearizable; with one voter closed the witness's
    acks carry the quorum and the leader's shard stays on its engine."""
    prefix = f"opE{time.monotonic_ns()}"
    addrs = {r: f"{prefix}-{r}" for r in (*VOTERS, WITNESS)}
    hosts = {}

    def start(rid):
        nh = NodeHost(NodeHostConfig(raft_address=addrs[rid],
                                     rtt_millisecond=RTT_MS,
                                     expert=engine_expert()), device="cpu")
        wit = rid == WITNESS
        nh.start_replica({} if wit else {r: addrs[r] for r in VOTERS}, wit,
                         KVStateMachine, Config(
                             shard_id=1, replica_id=rid, election_rtt=10,
                             heartbeat_rtt=1, is_witness=wit,
                             device_resident=not wit))
        hosts[rid] = nh

    try:
        for r in VOTERS:
            start(r)
        assert all(hosts[r].nodes[1].peer is None for r in VOTERS)
        start(WITNESS)     # up before it is added (lockstep's docstring)
        ls_.add_witness_sync(hosts, addrs[WITNESS])
        lid = ls_.writes(hosts, [f"k{i}=v{i}" for i in range(10)])
        ls_.metadata_only(hosts[WITNESS], 10)
        assert 1 in hosts[lid].kernel_engine.by_shard

        seen = ls_.monkey(hosts, MONKEY_S, MONKEY_OPS, op_timeout_s=3.0)
        assert seen["linearizable"]

        down = next(r for r in VOTERS if r != ls_.majority_leader(hosts))
        hosts.pop(down).close()
        lid = ls_.writes(hosts, [f"solo{i}=v{i}" for i in range(5)])
        assert hosts[lid].stale_read(1, "solo4") == "v4"
        assert 1 in hosts[lid].kernel_engine.by_shard
        ls_.metadata_only(hosts[WITNESS], 15)
    finally:
        for nh in hosts.values():
            nh.close()
