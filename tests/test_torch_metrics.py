"""The reductions behind the port's NodeHost, its metrics endpoint and the
capacity model, on the CPU.

Ports of the reference's live-engine cases (``tests/test_health.py``,
``tests/test_invariants.py``): the invariant probe and the health digest
ride the engine's decimation at pipeline depths 0 and 1, and
``shard_info``'s device row equals a recount from the full state and
round-trips through ``/debug/group/<id>``.  The port's ``MetricsServer``
(a verbatim copy of the reference's) answers ``/healthz`` honestly and
stickily, and the reference's doctor scripts, which are plain HTTP
clients, read it; their payloads pass the port's validators.  The
capacity model's predicted bytes equal the bytes the port's structures
allocate, digests included, at the reference's three geometries.
"""

import importlib.util
import json
import os
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from dragonboat_tpu import capacity as ref_capacity
from dragonboat_tpu.core.params import KernelParams as RefKernelParams
from dragonboat_tpu_torch import capacity, convert
from dragonboat_tpu_torch.core import health, kstate
from dragonboat_tpu_torch.core import invariants as inv
from dragonboat_tpu_torch.core.params import KernelParams
from dragonboat_tpu_torch.server.metrics_http import MetricsServer

from test_torch_nodehost import close_all, engine_expert, make_cluster

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cluster(prefix, depth):
    return make_cluster(f"{prefix}{time.monotonic_ns()}", metrics=True,
                        expert=engine_expert(kernel_capacity=4,
                                             fleet_stats_every=5,
                                             kernel_pipeline_depth=depth))


def _wait(cond, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return cond()


def _leader_host(hosts):
    for rid, h in hosts.items():
        lid, ok = h.get_leader_id(1)
        if ok and lid:
            return rid
    return None


@pytest.mark.parametrize("depth", [0, 1])
def test_probe_rides_decimation_on_live_engine(depth):
    """The probe ticks with the fleet-stats decimation on the live
    engine, at depth 0 and through the overlapped donating step loop at
    depth 1, and a healthy cluster stays violation-free (sticky counter
    included)."""
    hosts = _cluster(f"tip{depth}x", depth)
    try:
        assert _wait(lambda: _leader_host(hosts) is not None, 45)
        eng = hosts[1].kernel_engine
        assert _wait(lambda: eng._inv_seq >= 3, 30), "no probe ticks"
        with eng.mu:
            seq = eng._inv_seq
            last = dict(eng.last_invariants)
            ticks = eng._inv_digest.ticks.numpy().copy()
        inv.validate_invariants(last)
        assert last["total"] == 0 and last["violations_seen"] == 0, last
        assert last["checked"] >= 1
        # dirty-lane re-seeds only lower single lanes, never past seq
        assert max(int(t) for t in ticks) <= seq
        assert hosts[1]._invariants_snapshot()["violations_seen"] == 0
    finally:
        close_all(hosts)


@pytest.mark.parametrize("depth", [0, 1])
def test_digest_carries_across_decimated_ticks(depth):
    """The health digest advances one tick per collection on the live
    engine, at both pipeline depths; a healthy cluster trips no class."""
    hosts = _cluster(f"thc{depth}x", depth)
    try:
        assert _wait(lambda: _leader_host(hosts) is not None, 45)
        eng = hosts[1].kernel_engine
        assert _wait(lambda: eng._health_seq >= 3, 30), "no health ticks"
        with eng.mu:
            seq = eng._health_seq
            ticks = eng._health_digest.ticks.numpy().copy()
            lane = hosts[1].nodes[1].lane
        assert int(ticks[lane]) == seq
        assert all(int(t) == seq for t in ticks)
        assert _wait(lambda: eng.last_health is not None
                     and not any(eng.last_health["class_count"].values()),
                     10)
    finally:
        close_all(hosts)


def test_shard_info_matches_device_row_recount():
    """shard_info's device row equals a recount of that row from the
    full state, and round-trips through /debug/group/<id>; /debug/groups
    serves info() under the same schema; an unknown group is a 404."""
    hosts = _cluster("tsi", 0)
    try:
        assert _wait(lambda: _leader_host(hosts) is not None, 45)
        nh = hosts[_leader_host(hosts)]
        eng = nh.kernel_engine
        assert _wait(lambda: eng._health_seq >= 1, 30)
        node = nh.nodes[1]
        g = node.lane
        with eng.mu:
            inbox = eng._fleet_inbox_from()
            row = health.shard_row(eng.state, inbox, eng._health_digest, g,
                                   thresholds=eng.health_thresholds)
            state_h = convert.to_numpy(eng.state)
            digest_h = {f: v.numpy().copy() for f, v in
                        zip(eng._health_digest._fields, eng._health_digest)}
            from_eng = eng.health_row(g)
        got = health.row_to_dict(row)
        assert got == from_eng
        for f in ("role", "term", "vote", "leader", "committed", "applied",
                  "last", "stable", "processed", "snap_index", "snap_term"):
            assert got[f] == int(state_h[f][g]), f
        assert got["inbox_occ"] == int((inbox.numpy()[g] != 0).sum())
        for f in ("leaderless_ticks", "stall_ticks", "lag_ticks",
                  "churn_score", "runaway_ticks"):
            assert got[f] == int(digest_h[f][g]), f

        si = nh.shard_info(1)
        health.validate_shard_info(si)
        assert si["resident"] == "device" and si["device"] is not None
        addr = nh.metrics_address
        got_ep = json.loads(urllib.request.urlopen(
            f"http://{addr}/debug/group/1", timeout=5).read())
        health.validate_shard_info(got_ep)
        assert set(got_ep) == set(si)
        assert got_ep["membership"] == json.loads(json.dumps(si["membership"]))
        groups = json.loads(urllib.request.urlopen(
            f"http://{addr}/debug/groups", timeout=5).read())
        assert health.validate_info(groups) == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://{addr}/debug/group/99", timeout=5)
        assert ei.value.code == 404
    finally:
        close_all(hosts)


def _mk_server(snapshot):
    state = {"h": snapshot}
    info = {"node_host_id": "nhid-test", "raft_address": "t-1",
            "health": snapshot,
            "shards": [{"shard_id": 1, "replica_id": 2, "leader_id": 3,
                        "term": 4, "is_leader": False, "last_applied": 5,
                        "membership": {"addresses": {1: "t-1"},
                                       "non_votings": {}, "witnesses": {},
                                       "config_change_id": 1},
                        "resident": "device"}]}
    srv = MetricsServer([], address="127.0.0.1:0",
                        health_source=lambda: state["h"],
                        info_source=lambda: dict(info, health=state["h"]),
                        shard_info_source=lambda sid: None)
    return srv, state


def test_healthz_honest_on_anomalies():
    srv, state = _mk_server(health.empty_dict())
    try:
        ok = urllib.request.urlopen(f"http://{srv.address}/healthz",
                                    timeout=5)
        assert ok.status == 200 and ok.read() == b"ok\n"
        bad = health.empty_dict()
        bad["class_count"]["commit_stall"] = 2
        bad["anomalous"] = 2
        state["h"] = bad
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://{srv.address}/healthz",
                                   timeout=5)
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body["status"] == "degraded"
        assert body["class_count"]["commit_stall"] == 2
        state["h"] = health.empty_dict()
        ok = urllib.request.urlopen(f"http://{srv.address}/healthz",
                                    timeout=5)
        assert ok.status == 200
    finally:
        srv.close()


def test_healthz_degrades_sticky_on_violation():
    """A violations_seen that latched (live total back to zero) still
    degrades /healthz."""
    counters = dict(inv.empty_dict(), violations_seen=0)
    srv = MetricsServer([], address="127.0.0.1:0",
                        invariants_source=lambda: dict(counters))
    try:
        status, body, _ = srv.healthz()
        assert status == 200, body
        counters["violations_seen"] = 3
        status, body, _ = srv.healthz()
        assert status == 503
        payload = json.loads(body)
        assert payload["invariants"]["violations_seen"] == 3
        assert payload["invariants"]["total"] == 0
    finally:
        srv.close()


def test_fleet_doctor_cli_and_metrics_dump_doctor(capsys):
    """The reference's doctor scripts (plain HTTP clients) read the port's
    endpoint; what they print passes the port's validators."""
    fd = _load_script("fleet_doctor")
    md = _load_script("metrics_dump")
    srv, state = _mk_server(health.empty_dict())
    argv = sys.argv
    try:
        sys.argv = ["fleet_doctor.py", srv.address]
        assert fd.main() == 0
        out = capsys.readouterr().out
        assert "health: OK" in out and "shard 1" in out
        bad = health.empty_dict()
        bad["class_count"]["leaderless"] = 1
        bad["anomalous"] = 1
        bad["worst"] = [dict({f: 0 for f in health.ROW_FIELDS},
                             lane=3, score=24, flags=1,
                             classes=["leaderless"], engine="kernel")]
        state["h"] = bad
        sys.argv = ["fleet_doctor.py", srv.address]
        assert fd.main() == 1
        out = capsys.readouterr().out
        assert "DEGRADED" in out and "worst offenders" in out
        sys.argv = ["fleet_doctor.py", srv.address, "--json"]
        assert fd.main() == 1
        cli = json.loads(capsys.readouterr().out)
        ep = json.loads(urllib.request.urlopen(
            f"http://{srv.address}/debug/groups", timeout=5).read())
        assert cli == ep
        assert health.validate_info(cli) == 1
        health.validate_health(cli["health"])
        sys.argv = ["metrics_dump.py", srv.address, "--doctor"]
        assert md.main() == 0
        captured = capsys.readouterr()
        doctor = json.loads(captured.out)
        assert doctor == ep and health.validate_info(doctor) == 1
        assert "ok: 1 shard(s)" in captured.err
    finally:
        sys.argv = argv
        srv.close()


GEOMETRIES = [
    ("default", dict(), 4),
    ("inline-payloads", dict(inline_payloads=True), 6),
    ("custom", dict(num_peers=5, log_cap=256, readindex_cap=8), 3),
]


@pytest.mark.parametrize("name,kw,groups", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_model_matches_measured_bytes(name, kw, groups):
    """The capacity model's bytes per group (the reference's, from the
    CONTRACTS grammar) equal what the port's constructors allocate, per
    class, digests included."""
    kp = KernelParams(**kw)
    state = kstate.init_state(kp, groups, replica_id=1,
                              peer_ids=list(range(1, kp.num_peers + 1)),
                              device="cpu")
    trees = {"ShardState": state,
             "Inbox": kstate.empty_inbox(kp, groups, device="cpu"),
             "StepInput": kstate.empty_input(kp, groups, device="cpu"),
             "HealthDigest": health.empty_digest(groups, "cpu"),
             "InvariantDigest": inv.empty_digest(groups, "cpu")}
    per = capacity.model_bytes_per_group(kp, tuple(trees))
    assert per == ref_capacity.model_bytes_per_group(
        RefKernelParams(**kw), tuple(trees))
    for cls, tree in trees.items():
        measured = capacity.measure_tree_bytes(tree)
        assert measured > 0 and per[cls] * groups == measured, \
            (name, cls, per[cls] * groups, measured)
    assert capacity.predict_bytes(kp, groups, tuple(trees)) == \
        sum(capacity.measure_tree_bytes(t) for t in trees.values())
