"""Composed chaos schedules, the runtime invariant probe and the health
detector on the port (``dragonboat_tpu_torch.chaos``), on the CPU.

The port's runner is the reference's ``chaos/runner.py`` over the port's
NodeHost; its plans come from the host copy of ``faultplan``, so a seed
yields the reference's plan byte for byte.  Each schedule runs a 3-replica
MemFS cluster under a write workload and must pass the reference's
convergence oracle: zero acknowledged-entry loss, identical committed
prefixes, monotone applied indices, equal hash oracles, the telemetry
invariants and a silent invariant probe.

The port's step is eager, so a device-resident cluster on the CPU elects
in 5-30 s and commits a write in about one; one case per family runs
here (``LEFT_OUT`` names the rest), the device-resident schedule with one
write per plan step where the reference writes four; ``chip_smoke.py
--verify`` runs every fast seed, the reference's write load, the mesh
schedule, the detector differential and the hotspot on the card.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from dragonboat_tpu.chaos import FaultPlan as RefFaultPlan
from dragonboat_tpu.core import health as ref_health
from dragonboat_tpu_torch import flight
from dragonboat_tpu_torch.chaos import FaultPlan, run_schedule
from dragonboat_tpu_torch.chaos import runner
from dragonboat_tpu_torch.core import health
from dragonboat_tpu_torch.engine import kernel_engine as ke
from dragonboat_tpu_torch.model_check import load_kernel_module
from dragonboat_tpu_torch.server.metrics_http import MetricsServer

from test_torch_nodehost import close_all, engine_expert, make_cluster, propose_retry, wait_leader

FAST_SEEDS = (1, 7, 9, 13, 25)
#: what the reference's tier-1 chaos tests run that this file does not,
#: and where it runs instead
LEFT_OUT = {
    "test_schedule_converges_fast": "seeds 1, 7, 25 on the host path: "
                                    "chip_smoke.py --verify, device-resident",
    "test_schedule_partitioned_mesh_link_falls_back_to_hub":
        "seed 7 mesh-resident: chip_smoke.py --verify",
    "test_hotspot_drains_and_converges": "run_hotspot(11): chip_smoke.py --verify",
    "run_detector_differential(1)": "chip_smoke.py (both runs); its health "
                                    "report against the recount is held here "
                                    "on a live engine",
}


def _check(r):
    assert r.report.ok, (r.seed, r.report.failures)
    assert r.acked_count > 0, r.seed
    return r


@pytest.mark.parametrize("seed", FAST_SEEDS)
def test_faultplan_equals_reference(seed):
    """The host copy of faultplan generates the reference's plan."""
    assert FaultPlan.generate(seed, n_replicas=3, steps=6).to_json() == \
        RefFaultPlan.generate(seed, n_replicas=3, steps=6).to_json()


def test_schedule_converges_host_path():
    """Seed 13 (partition + clean crash_write + reorder) on host-resident
    shards."""
    _check(run_schedule(13, device="cpu"))


def test_schedule_trace_is_byte_identical_and_replayable():
    """The deterministic-replay contract: the same seed twice yields
    byte-identical fault traces, and the recorded plan JSON replays to
    the same trace (seed 9: torn crash_write + duplicate)."""
    a = _check(run_schedule(9, device="cpu"))
    b = _check(run_schedule(9, device="cpu"))
    assert a.trace_json == b.trace_json
    assert a.plan_json == b.plan_json
    replay = run_schedule(9, plan=FaultPlan.from_json(a.plan_json),
                          device="cpu")
    assert replay.report.ok, replay.report.failures
    assert replay.trace_json == a.trace_json


def test_schedule_converges_on_pipelined_device_resident_shards():
    """Seed 1 (kill + torn crash_write + breaker + drop) on device-resident
    shards served through the depth-1 pipelined engine loop: faults land
    while a step is in flight.  One write per plan step (the reference
    writes four), and the runner's wall-clock windows x4: the eager step
    on the CPU elects at depth 1 in ~20 s, past the reference's 10 s."""
    torch.set_num_threads(1)
    r = run_schedule(1, device_resident=True, pipeline_depth=1,
                     proposals_per_step=1, time_scale=4.0, device="cpu")
    _check(r)
    assert r.report.invariant_probe["violations_seen"] == 0


@pytest.fixture(scope="module")
def mutated_cluster():
    """A live device-resident 3-replica cluster whose engines step the
    model checker's commit_without_quorum kernel, proposing until the
    probe latches (or 60 s)."""
    torch.set_num_threads(1)
    mut = load_kernel_module("commit_without_quorum")
    with pytest.MonkeyPatch.context() as mp:
        # the engine binds these module globals at construction time
        mp.setattr(ke, "kernel_step", mut.step)
        mp.setattr(ke, "kernel_step_donated", mut.step_donated)
        hosts = make_cluster("tmutq", expert=engine_expert(
            fleet_stats_every=1))
    try:
        lead = wait_leader(hosts, timeout=60)
        nh = hosts[lead]
        deadline = time.time() + 60
        snap = nh._invariants_snapshot()
        i = 0
        while time.time() < deadline and not snap["violations_seen"]:
            try:
                propose_retry({lead: nh}, f"m{i}=x".encode())
            except Exception:
                pass
            i += 1
            snap = nh._invariants_snapshot()
        yield hosts, nh, snap
    finally:
        close_all(hosts)


def test_probe_catches_commit_without_quorum_mutation(mutated_cluster):
    """The runtime probe on a live cluster serving the mutated kernel
    trips ``leader_commit_quorum``: the flight recorder's
    invariant_violation edge, sticky ``violations_seen``, /healthz 503."""
    _, nh, snap = mutated_cluster
    assert snap["violations_seen"] > 0, snap
    edges = [r for r in flight.RECORDER.tail(256)
             if r.get("kind") == flight.INVARIANT_VIOLATION]
    assert edges, "no invariant_violation flight record"
    assert snap["per_invariant"]["leader_commit_quorum"] > 0 \
        or any("leader_commit_quorum" in r["invariants"] for r in edges), \
        (snap, edges)
    server = MetricsServer([nh.events.metrics.registry],
                           invariants_source=nh._invariants_snapshot)
    try:
        status, body, _ = server.healthz()
        assert status == 503, (status, body)
        assert json.loads(body)["invariants"]["violations_seen"] > 0
    finally:
        server.close()


def test_health_differential_equals_reference(mutated_cluster):
    """One live engine's (state, inbox, digest): the port's fleet_health
    equals its recount (the runner's ``_health_differential``) and the
    reference's fleet_health and recount on the same arrays."""
    _, nh, _ = mutated_cluster
    eng = nh.kernel_engine
    ok, dev, rec = runner._health_differential(eng)
    assert ok, (dev, rec)
    with eng.mu:
        st = type(eng.state)(*(None if v is None else v.clone()
                               for v in eng.state))
        # the serial engine's staged inbox: a host array, as the
        # reference's (the reduction uploads it)
        inbox = torch.as_tensor(eng._fleet_inbox_from()).clone()
        digest = health.HealthDigest(*(v.clone() for v in eng._health_digest))
        th, k = eng.health_thresholds, eng.health_top_k
    got, _ = health.fleet_health(st, inbox, digest, thresholds=th, k=k)
    np_state = type(st)(*(None if v is None else v.numpy() for v in st))
    ref_digest = ref_health.HealthDigest(*(v.numpy() for v in digest))
    ref_th = ref_health.HealthThresholds(*th)
    report, _ = ref_health.fleet_health(np_state, inbox.numpy(), ref_digest,
                                        thresholds=ref_th, k=k)
    assert health.report_to_dict(got) == ref_health.report_to_dict(report)
    ref_rec, _ = ref_health.recount(np_state, inbox.numpy(), ref_digest,
                                    thresholds=ref_th, k=k)
    assert ref_rec == health.report_to_dict(got)
