"""Schedule runner — executes a FaultPlan against a live MemFS cluster.

The port of the reference's ``chaos/runner.py``: the same runner, its
text with the package prefix rewritten, over the port's NodeHost.  Three
things differ.  Every entry point takes ``device``, the device each
host's kernel engine runs on (the CUDA card unless the caller names the
CPU; with no card and no device it raises).  Every entry point takes
``time_scale``, one factor for how much slower the port's eager engine
step is than the reference's compiled one: it multiplies the workload's
wall-clock windows (proposal timeouts, settle, pump, fault and
convergence windows) and the hotspot's host-hot threshold, which the
reference sets between its idle (10-15 ms) and loaded (~90 ms) engine
step, so it moves with the step.  1.0 gives the reference's windows; the
factor goes once the port's step is as fast (ROADMAP item 17).  And the
health differential reads the engine's tensors to numpy instead of
through JAX.

One run builds ``n_replicas`` durable NodeHosts, each over its OWN
MemFS (so per-host power loss is ``that_fs.crash()``) wrapped in a
:class:`CrashPointFS` (so storage faults arm per host), all joined by
the chan transport.  The plan's steps interleave with a write workload;
every executed event is recorded, and the recorded trace is canonical
JSON — running the same seed twice yields byte-identical traces
(tests/test_torch_chaos.py asserts exactly that).

This module intentionally uses the wall clock: it WAITS on real raft
progress (elections, replication, restart recovery), so it is excluded
from the determinism lint's replay-path globs.  The deterministic
contract lives in faultplan/crashfs/oracle, which are covered.
"""

from __future__ import annotations

import struct
import time
import zlib
from dataclasses import dataclass, field
from random import Random

from dragonboat_tpu_torch import flight
from dragonboat_tpu_torch.chaos.crashfs import CrashPointFS
from dragonboat_tpu_torch.chaos.faultplan import FaultPlan, canonical_json
from dragonboat_tpu_torch.chaos.oracle import (OracleReport, check_convergence,
                                         check_hot_drained,
                                         check_invariant_probe,
                                         check_journals_equal,
                                         check_no_acked_loss)
from dragonboat_tpu_torch.convert import tensor_to_numpy
from dragonboat_tpu_torch.config import (
    Config,
    ExpertConfig,
    LogDBConfig,
    MeshSpec,
    NodeHostConfig,
)
from dragonboat_tpu_torch.devices import resolve_device
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.statemachine import IStateMachine, Result
from dragonboat_tpu_torch.vfs import MemFS


class ChaosKV(IStateMachine):
    """Workload SM: kv store plus an append-only journal of every
    applied command — the committed-prefix observable the oracle
    compares across replicas (monkey-test HashKV with history)."""

    def __init__(self, shard_id, replica_id):
        self.kv = {}
        self.journal: list[bytes] = []

    def update(self, entry):
        cmd = bytes(entry.cmd)
        self.journal.append(cmd)
        k, v = cmd.decode().split("=", 1)
        self.kv[k] = v
        return Result(value=len(self.journal))

    def lookup(self, query):
        return self.kv.get(query)

    def save_snapshot(self, w, files, done):
        blob = b"\x00".join(self.journal)
        w.write(struct.pack("<I", len(blob)))
        w.write(blob)

    def recover_from_snapshot(self, r, files, done):
        (n,) = struct.unpack("<I", r.read(4))
        blob = r.read(n)
        self.journal = blob.split(b"\x00") if blob else []
        self.kv = {}
        for cmd in self.journal:
            k, v = cmd.decode().split("=", 1)
            self.kv[k] = v

    def get_hash(self) -> int:
        return zlib.crc32(b"\x00".join(self.journal))


def _counter_pred(every: int):
    """Deterministic per-message predicate: True on every Nth call."""
    state = {"n": 0}

    def pred(_m) -> bool:
        state["n"] += 1
        return state["n"] % every == 0
    return pred


@dataclass
class ScheduleResult:
    seed: int
    trace_json: str
    report: OracleReport
    acked_count: int
    plan_json: str


@dataclass
class _Cluster:
    seed: int
    n: int
    # run shards as lanes of the batched device kernel instead of host
    # Peers, optionally through the depth-1 software pipeline — chaos
    # then exercises crash/restart with a donated step in flight
    device_resident: bool = False
    pipeline_depth: int = 0
    # run shards as rows of the shared MESH engine (one replica per
    # device along axis 'r'): partition/delay/drop faults then drive the
    # round-17 per-link cut masks and hub fallback instead of the chan
    # transport alone
    mesh_resident: bool = False
    # extra ExpertConfig kwargs (detector differentials tune the health
    # cadence/thresholds per fault kind)
    expert_overrides: dict = field(default_factory=dict)
    # shard ids started on every host and the workload SM they run; the
    # hotspot differential skews proposals across two shards to heat
    # exactly one of them
    shards: tuple = (1,)
    sm_cls: type = ChaosKV
    # the device every host's kernel engine runs on (None: the CUDA card)
    device: object = None
    # multiplies every wall-clock window of the workload (module docstring)
    time_scale: float = 1.0
    hosts: dict = field(default_factory=dict)      # rid -> NodeHost
    mems: dict = field(default_factory=dict)       # rid -> MemFS
    fss: dict = field(default_factory=dict)        # rid -> CrashPointFS
    addrs: dict = field(default_factory=dict)
    cfgs: dict = field(default_factory=dict)       # (rid, shard) -> Config
    epochs: dict = field(default_factory=dict)     # rid -> restart epoch
    # acked-proposal counters harvested from hosts REPLACED by a process
    # restart (a fresh NodeHost starts a fresh registry at zero); the
    # telemetry invariant sums these with every current host's counter
    acked_base: dict = field(default_factory=dict)  # rid -> int

    SHARD = 1

    def start(self) -> None:
        self.device = resolve_device(self.device)
        self.addrs = {rid: f"cs{self.seed}-{rid}"
                      for rid in range(1, self.n + 1)}
        for rid in sorted(self.addrs):
            self.mems[rid] = MemFS()
            self.epochs[rid] = 0
            self._spawn(rid)

    def _nhconfig(self, rid: int) -> NodeHostConfig:
        kw = dict(
            fs=self.fss[rid],
            kernel_log_cap=256, kernel_capacity=4,
            kernel_pipeline_depth=self.pipeline_depth,
            logdb=LogDBConfig(shards=1, recovery_mode="quarantine"))
        if self.mesh_resident:
            # one shared ('g','r') = (1, n) mesh across the hosts; the
            # spec name keys the engine registry so every host attaches
            # to the SAME engine (one device per replica slot)
            kw["mesh"] = MeshSpec(name=f"cs{self.seed}-mesh", g_size=1,
                                  replicas=self.n, n_local=1)
        kw.update(self.expert_overrides)
        return NodeHostConfig(
            raft_address=self.addrs[rid], rtt_millisecond=5,
            node_host_dir="/data",
            expert=ExpertConfig(**kw))

    def _spawn(self, rid: int) -> None:
        """Fresh NodeHost (+ fresh CrashPointFS) over rid's MemFS."""
        old = self.hosts.get(rid)
        if old is not None:
            self.acked_base[rid] = (self.acked_base.get(rid, 0)
                                    + self._acked_counter(old))
        self.fss[rid] = CrashPointFS(self.mems[rid])
        nh = NodeHost(self._nhconfig(rid), device=self.device)
        for sid in self.shards:
            cfg = Config(shard_id=sid, replica_id=rid, election_rtt=10,
                         heartbeat_rtt=1, snapshot_entries=0,
                         compaction_overhead=5,
                         device_resident=self.device_resident,
                         mesh_resident=self.mesh_resident)
            self.cfgs[(rid, sid)] = cfg
            nh.start_replica(dict(self.addrs), False, self.sm_cls, cfg)
        self.hosts[rid] = nh

    # -- liveness --------------------------------------------------------

    def live(self, rid: int) -> bool:
        nh = self.hosts[rid]
        return nh.fatal_error is None and not nh._stopped

    def live_rids(self) -> list:
        return [rid for rid in sorted(self.hosts) if self.live(rid)]

    def reset_breakers(self) -> None:
        """Post-heal: close every breaker so recovery is not paced by
        leftover backoff cooldowns (production relies on the backoff
        probes; the harness heals instantly to keep schedules fast)."""
        for rid in self.live_rids():
            hub = self.hosts[rid].hub
            for addr in sorted(self.addrs.values()):
                hub.breaker(addr).succeed()

    # -- telemetry observations ------------------------------------------

    @staticmethod
    def _acked_counter(nh) -> int:
        try:
            snap = nh.events.metrics.snapshot()
            return int(snap.get("raft.proposals_acked", 0))
        except Exception:
            return 0

    def acked_total(self) -> int:
        """Acked-proposal counter summed across every host epoch: dead
        hosts' registries are still readable (snapshot is a pure dict
        walk), and replaced hosts' counts live in ``acked_base``."""
        total = sum(self.acked_base.values())
        for rid in sorted(self.hosts):
            total += self._acked_counter(self.hosts[rid])
        return total

    def leaderless_total(self) -> int:
        """Sum of the ``health.leaderless_now`` callback gauge over
        live, unpartitioned hosts (evaluated through the legacy snapshot
        view so this exercises the same path a scrape does).  The health
        engine's merged snapshot counts host-resident shards alongside
        device/mesh rows, so the oracle and the anomaly detector read
        ONE source of truth."""
        total = 0
        for rid in self.live_rids():
            nh = self.hosts[rid]
            if nh._partitioned:
                continue
            snap = nh.events.metrics.snapshot()
            total += int(snap.get("health.leaderless_now", 0))
        return total

    def invariant_counters(self) -> dict:
        """Invariant-probe counters merged across every live host's
        engines (the same `_invariants_snapshot` view a scrape reads).
        ``violations_seen`` is sticky per engine lifetime, so a
        transient mid-schedule trip survives to this harvest."""
        from dragonboat_tpu_torch.core import invariants as _invariants

        base = _invariants.empty_dict()
        base["violations_seen"] = 0
        for rid in self.live_rids():
            d = self.hosts[rid]._invariants_snapshot()
            _invariants.merge_into(base, d, engine=f"r{rid}")
            base["violations_seen"] += int(d.get("violations_seen", 0))
        return base

    # -- event execution -------------------------------------------------

    def execute(self, ev) -> dict:
        flight.record(flight.CHAOS_FAULT, fault=ev.kind, target=ev.target,
                      params=dict(ev.params))
        fn = getattr(self, "_ev_" + ev.kind)
        return fn(ev.target, dict(ev.params))

    def _ev_drop(self, rid: int, p: dict) -> dict:
        self.hosts[rid].transport.drop_predicate = _counter_pred(p["every"])
        # device-resident mesh links never see transport predicates —
        # force this host's links onto the hub so the fault applies
        self.hosts[rid]._set_mesh_hub_served(True)
        return {"applied": self.live(rid)}

    def _ev_delay(self, rid: int, p: dict) -> dict:
        secs = p["seconds"]
        self.hosts[rid].transport.delay_func = lambda m: secs
        self.hosts[rid]._set_mesh_hub_served(True)
        return {"applied": self.live(rid)}

    def _ev_duplicate(self, rid: int, p: dict) -> dict:
        self.hosts[rid].transport.duplicate_predicate = _counter_pred(
            p["every"])
        return {"applied": self.live(rid)}

    def _ev_reorder(self, rid: int, p: dict) -> dict:
        self.hosts[rid].transport.reorder_rng = Random(p["seed"])
        return {"applied": self.live(rid)}

    def _ev_heal_transport(self, rid: int, p: dict) -> dict:
        t = self.hosts[rid].transport
        t.drop_predicate = None
        t.delay_func = None
        t.duplicate_predicate = None
        t.reorder_rng = None
        # restore this host's mesh links resident (drop/delay cut them)
        self.hosts[rid]._set_mesh_hub_served(False)
        return {"applied": True}

    def _ev_partition(self, rid: int, p: dict) -> dict:
        self.hosts[rid].partition_node()
        return {"applied": True}

    def _ev_restore_partition(self, rid: int, p: dict) -> dict:
        self.hosts[rid].restore_partitioned_node()
        self.reset_breakers()
        return {"applied": True}

    def _ev_breaker_trip(self, rid: int, p: dict) -> dict:
        target_addr = self.addrs[rid]
        for other in self.live_rids():
            if other != rid:
                self.hosts[other].hub.trip_breaker(
                    target_addr, count=p["count"])
        return {"applied": True}

    def _ev_heal_breaker(self, rid: int, p: dict) -> dict:
        self.reset_breakers()
        return {"applied": True}

    def _ev_crash_write(self, rid: int, p: dict) -> dict:
        self.fss[rid].arm(p["after_ops"], torn=p["torn"])
        tripped = self._pump_until(
            lambda: self.hosts[rid].fatal_error is not None, timeout=15.0)
        return {"tripped": tripped}

    def _ev_restart_inplace(self, rid: int, p: dict) -> dict:
        self.fss[rid].heal()
        self.hosts[rid].restart()
        self.epochs[rid] += 1
        self.reset_breakers()
        return {"restarted": True}

    def _ev_kill(self, rid: int, p: dict) -> dict:
        self.hosts[rid].simulate_kill()
        # the process is gone: unsynced bytes vanish, its flocks release
        self.mems[rid].crash()
        return {"killed": True}

    def _ev_restart_process(self, rid: int, p: dict) -> dict:
        self._spawn(rid)
        self.epochs[rid] += 1
        self.reset_breakers()
        return {"restarted": True}

    # -- workload --------------------------------------------------------

    def propose(self, cmd: bytes, timeout: float = 8.0,
                shard: int | None = None) -> bool:
        """Propose through any live host (host routing forwards to the
        leader); True once acked.  Duplicate commits from retried
        timeouts are fine — the oracle compares journals for equality,
        and a duplicate lands identically on every replica."""
        sid = self.SHARD if shard is None else shard
        deadline = time.time() + timeout * self.time_scale
        while time.time() < deadline:
            for rid in self.live_rids():
                nh = self.hosts[rid]
                if nh._partitioned:
                    continue
                try:
                    nh.sync_propose(nh.get_noop_session(sid), cmd,
                                    timeout_s=1.5 * self.time_scale)
                    return True
                except Exception:
                    continue
            time.sleep(0.02)
        return False

    def _pump_until(self, cond, timeout: float) -> bool:
        """Feed proposals until ``cond`` holds (durability traffic is
        what walks an armed CrashPointFS to its trip)."""
        deadline = time.time() + timeout * self.time_scale
        i = 0
        while time.time() < deadline:
            if cond():
                return True
            self.propose(f"pump{i}=x".encode(), timeout=1.0)
            i += 1
        return cond()

    # -- observations ----------------------------------------------------

    def sample(self, applied_samples: dict) -> None:
        for rid in self.live_rids():
            nh = self.hosts[rid]
            if nh._partitioned:
                continue
            try:
                applied = nh._node(self.SHARD).sm.get_last_applied()
            except Exception:
                continue
            applied_samples.setdefault(rid, []).append(
                (self.epochs[rid], applied))

    def journals(self, shard: int | None = None) -> dict:
        sid = self.SHARD if shard is None else shard
        out = {}
        for rid in self.live_rids():
            try:
                out[rid] = list(
                    self.hosts[rid]._node(sid).sm.sm.journal)
            except Exception:
                continue
        return out

    def hashes(self, kind: str) -> dict:
        fn = {"sm": "get_sm_hash", "session": "get_session_hash",
              "membership": "get_membership_hash"}[kind]
        out = {}
        for rid in self.live_rids():
            try:
                out[rid] = getattr(self.hosts[rid], fn)(self.SHARD)
            except Exception:
                continue
        return out

    def close(self) -> None:
        for rid in sorted(self.hosts):
            nh = self.hosts[rid]
            try:
                if nh.fatal_error is not None and nh._stopped:
                    continue        # killed/crashed and never restarted
                nh.close()
            except Exception:
                pass


def run_schedule(seed: int, plan: FaultPlan | None = None,
                 n_replicas: int = 3, steps: int = 6,
                 proposals_per_step: int = 4,
                 converge_timeout: float = 30.0,
                 device_resident: bool = False,
                 pipeline_depth: int = 0,
                 mesh_resident: bool = False,
                 device=None, time_scale: float = 1.0) -> ScheduleResult:
    """Execute one composed fault schedule; returns the recorded trace
    (canonical JSON) and the oracle report.  Pass ``plan`` to replay a
    recorded trace (``FaultPlan.from_json``) instead of generating.
    ``device_resident=True`` runs the shards on the batched kernel
    engine, ``pipeline_depth=1`` additionally through the overlapped
    donating step loop — so faults land while a step is in flight.
    ``mesh_resident=True`` runs them as rows of one shared mesh engine:
    transport faults then exercise the per-link cut masks (hub
    fallback) instead of the chan transport alone.  ``device`` is the
    device of every host's kernel engine (None: the CUDA card; raises
    with no card); ``time_scale`` multiplies the wall-clock windows
    (module docstring)."""
    device = resolve_device(device)
    if plan is None:
        plan = FaultPlan.generate(seed, n_replicas=n_replicas, steps=steps)
    cluster = _Cluster(seed=seed, n=plan.n_replicas,
                       device_resident=device_resident,
                       pipeline_depth=pipeline_depth,
                       mesh_resident=mesh_resident, device=device,
                       time_scale=time_scale)
    executed: list = []
    acked: list = []
    applied_samples: dict = {}
    report = OracleReport()
    try:
        cluster.start()
        # settle: a leader before the first fault
        cluster.propose(b"genesis=1", timeout=10.0) or report.fail(
            "no initial commit — cluster never settled")
        for step in range(plan.steps + 1):
            for ev in plan.events_at(step):
                outcome = cluster.execute(ev)
                executed.append({**ev.as_dict(), "outcome": outcome})
                if outcome.get("tripped") is False:
                    report.fail(f"crash point on replica {ev.target} "
                                "never tripped")
            if step < plan.steps:
                for i in range(proposals_per_step):
                    cmd = f"s{step}i{i}=v{seed}".encode()
                    if cluster.propose(cmd):
                        acked.append(cmd)
                cluster.sample(applied_samples)
        # every replica is healed now; wait for full convergence
        deadline = time.time() + converge_timeout * time_scale
        converged = False
        while time.time() < deadline and not converged:
            cluster.sample(applied_samples)
            js = cluster.journals()
            if len(js) == cluster.n:
                vals = list(js.values())
                have = set(vals[0])
                converged = all(v == vals[0] for v in vals[1:]) and all(
                    c in have for c in acked)
            if not converged:
                time.sleep(0.1)
        if not converged:
            report.fail("cluster did not converge after final heal")
        report.merge(check_convergence(
            acked, cluster.journals(), applied_samples,
            cluster.hashes("sm"), cluster.hashes("session"),
            cluster.hashes("membership")))
        # telemetry invariants — the observability layer must agree with
        # the oracle's ground truth after every schedule:
        # 1. every ack the workload observed is in some host's acked
        #    counter (counters also see pump/genesis traffic, so >=)
        acked_seen = cluster.acked_total()
        if acked_seen < len(acked):
            report.fail(f"acked-proposal counter {acked_seen} < "
                        f"{len(acked)} oracle-observed acks — telemetry "
                        "lost acked writes")
        # 2. the leaderless gauge returns to 0 once converged.  A
        #    follower may learn the leader an append after the journals
        #    equalize, so this is a deadline-bounded wait — but EVENT-
        #    driven, not a sleep-poll: every transition that can clear
        #    leaderlessness lands a flight record (leader_change from
        #    host-resident elections, anomaly_cleared from the device
        #    health engines), so the oracle re-reads the gauge exactly
        #    when the recorder wakes it
        if converged:
            deadline = time.time() + 5.0 * time_scale
            seq = flight.RECORDER.next_seq
            leaderless = cluster.leaderless_total()
            while leaderless and time.time() < deadline:
                # wait for record #seq to land (anything after the gauge
                # read), capped so a transition the recorder missed
                # (e.g. a pre-sample race) still re-checks promptly
                flight.RECORDER.wait_beyond(
                    seq, timeout=min(0.5, max(0.0,
                                              deadline - time.time())))
                seq = flight.RECORDER.next_seq
                leaderless = cluster.leaderless_total()
            if leaderless:
                report.fail(f"health.leaderless_now gauge stuck at "
                            f"{leaderless} after convergence")
        # 3. the runtime invariant probe stayed silent: no interleaving
        #    of faults may produce a protocol-invariant violation.  The
        #    harvested counters ride the report either way, so every
        #    schedule's verdict records what the probe observed.
        report.invariant_probe = cluster.invariant_counters()
        report.merge(check_invariant_probe(report.invariant_probe))
        if not report.ok:
            # attach the flight-recorder tail so a failure report carries
            # the recent structured transitions (leader changes, trips,
            # chaos faults) alongside the oracle verdict
            report.flight_tail = flight.RECORDER.tail(64)
    finally:
        cluster.close()
    return ScheduleResult(
        seed=seed, trace_json=canonical_json(executed), report=report,
        acked_count=len(acked), plan_json=plan.to_json())


# -- detector differential --------------------------------------------------
#
# The fleet-health engine (core/health.py) is itself under chaos test:
# each fault kind below must raise its MAPPED anomaly class during the
# fault window (observed via the flight recorder's anomaly_raised edge,
# so a one-tick flag cannot be missed by a polling race), every class
# must clear to zero after the heal converges, and at sampled instants
# the device report is cross-checked byte-for-byte against the
# pure-python recount oracle.

#: fault kind -> the anomaly class it must raise
DETECTOR_FAULT_CLASS = {
    # no quorum anywhere: every lane sits candidate/leaderless
    "isolate_quorum": "leaderless",
    # back-to-back leadership transfers: known-leader -> known-leader
    # handoffs pump the churn leaky bucket
    "leader_flap": "churn",
    # a partitioned replica campaigns forever (pre_vote off), its term
    # rising tick over tick
    "campaign_storm": "term_runaway",
}
DETECTOR_FAULTS = tuple(sorted(DETECTOR_FAULT_CLASS))


@dataclass
class DetectorResult:
    seed: int
    fault: str
    anomaly_class: str
    raised: bool              # mapped class raised inside the window
    cleared: bool             # ALL classes zero after convergence
    differential_checks: int  # recount cross-checks performed
    failures: list

    @property
    def ok(self) -> bool:
        return not self.failures


def _health_differential(eng) -> tuple[bool, dict, dict]:
    """Sample one engine's (state, inbox, digest) under its lock and
    compare the device fleet_health report against the pure-python
    recount — the device detector and the oracle must agree exactly."""
    from dragonboat_tpu_torch.core import health as _health

    with eng.mu:
        if eng._health_digest is None:
            eng._health_digest = eng._make_health_digest()
        state, inbox = eng.state, eng._fleet_inbox_from()
        digest = eng._health_digest
        report, _ = _health.fleet_health(
            state, inbox, digest, thresholds=eng.health_thresholds,
            k=eng.health_top_k)
        state_h = type(state)(*(None if v is None else tensor_to_numpy(v)
                                for v in state))
        inbox_h = tensor_to_numpy(inbox)
        digest_h = type(digest)(*(tensor_to_numpy(v) for v in digest))
    dev = _health.report_to_dict(report)
    ref, _ = _health.recount(state_h, inbox_h, digest_h,
                             thresholds=eng.health_thresholds,
                             k=eng.health_top_k)
    return dev == ref, dev, ref


def _wait_anomaly_raised(cls: str, since_seq: int, deadline: float) -> bool:
    """Event-driven wait for an anomaly_raised flight record of ``cls``
    recorded at sequence >= ``since_seq``."""
    while True:
        scanned_to = flight.RECORDER.next_seq
        for rec in flight.RECORDER.tail():
            if (rec["seq"] >= since_seq
                    and rec["kind"] == flight.ANOMALY_RAISED
                    and rec.get("cls") == cls):
                return True
        remaining = deadline - time.time()
        if remaining <= 0:
            return False
        # block until record #scanned_to lands (anything newer than the
        # tail scan above), capped for safety against ring overwrite
        flight.RECORDER.wait_beyond(scanned_to,
                                    timeout=min(0.5, remaining))


def run_detector_differential(seed: int, fault: str | None = None,
                              n_replicas: int = 3,
                              fault_window: float = 25.0,
                              converge_timeout: float = 30.0,
                              device=None, time_scale: float = 1.0
                              ) -> DetectorResult:
    """Run ONE fault schedule against a device-resident cluster and
    check the health engine's verdicts (see module comment above).
    ``fault`` defaults to ``DETECTOR_FAULTS[seed % 3]`` so consecutive
    seeds sweep the taxonomy.  ``device`` and ``time_scale`` as in
    ``run_schedule``."""
    from dragonboat_tpu_torch.core import health as _health

    device = resolve_device(device)

    if fault is None:
        fault = DETECTOR_FAULTS[seed % len(DETECTOR_FAULTS)]
    cls = DETECTOR_FAULT_CLASS[fault]
    # fast health ticks; per-fault threshold tuning keeps the windows
    # short without loosening what is being detected
    overrides: dict = {"fleet_stats_every": 5}
    if fault == "leader_flap":
        # one observed known->known handoff trips the bucket
        overrides["health_churn_trip"] = _health.CHURN_INC
    elif fault == "campaign_storm":
        # campaigns fire every ~election timeout; stretch the tick so
        # each consecutive pair of ticks sees a higher term
        overrides["fleet_stats_every"] = 20
        overrides["health_runaway_ticks"] = 2
    cluster = _Cluster(seed=seed, n=n_replicas, device_resident=True,
                       expert_overrides=overrides, device=device,
                       time_scale=time_scale)
    failures: list = []
    raised = False
    cleared = False
    diff_checks = 0

    def check_diff(rid: int, where: str) -> None:
        nonlocal diff_checks
        eng = cluster.hosts[rid].kernel_engine
        if eng is None:
            failures.append(f"{where}: replica {rid} has no kernel engine")
            return
        ok, dev, ref = _health_differential(eng)
        diff_checks += 1
        if not ok:
            failures.append(f"{where}: device report diverged from "
                            f"recount: {dev} != {ref}")

    def wait_leader(timeout: float) -> int:
        deadline = time.time() + timeout * time_scale
        while time.time() < deadline:
            for rid in cluster.live_rids():
                nh = cluster.hosts[rid]
                if nh._partitioned:
                    continue
                try:
                    lid, ok = nh.get_leader_id(cluster.SHARD)
                except Exception:
                    continue
                if ok and lid:
                    return lid
            time.sleep(0.05)
        return 0

    try:
        cluster.start()
        # generous settle: the FIRST device-resident cluster in a
        # process pays the kernels' first build inside this window
        if not cluster.propose(b"genesis=1", timeout=45.0):
            failures.append("no initial commit — cluster never settled")
        lid = wait_leader(10.0)
        if not lid:
            failures.append("no leader before fault injection")
        start_seq = flight.RECORDER.next_seq
        deadline = time.time() + fault_window * time_scale
        rids = sorted(cluster.hosts)
        healed: list = []

        if fault == "isolate_quorum":
            # partition the leader AND one follower: the remaining host
            # campaigns without quorum, so every engine's lane persists
            # leaderless past the threshold
            victims = [lid] + [r for r in rids if r != lid][:1]
            for r in victims:
                cluster.hosts[r].partition_node()
                healed.append(r)
            raised = _wait_anomaly_raised(cls, start_seq, deadline)
            observe = next(r for r in rids if r not in victims)
            check_diff(observe, "mid-fault")
        elif fault == "leader_flap":
            # transfer leadership round-robin until the churn bucket
            # trips (two transfers usually suffice; the loop is bounded
            # by the fault window)
            while not raised and time.time() < deadline:
                cur = wait_leader(5.0)
                if not cur:
                    continue
                target = next(r for r in rids if r != cur)
                try:
                    cluster.hosts[cur].request_leader_transfer(
                        cluster.SHARD, target)
                except Exception:
                    pass
                raised = _wait_anomaly_raised(
                    cls, start_seq,
                    min(deadline, time.time() + 2.0 * time_scale))
            check_diff(rids[0], "mid-fault")
        elif fault == "campaign_storm":
            victim = next(r for r in rids if r != lid)
            cluster.hosts[victim].partition_node()
            healed.append(victim)
            raised = _wait_anomaly_raised(cls, start_seq, deadline)
            check_diff(victim, "mid-fault")
        else:
            raise ValueError(f"unknown detector fault {fault!r}")
        if not raised:
            failures.append(f"fault {fault} never raised anomaly class "
                            f"{cls} within {fault_window * time_scale}s")

        # heal and converge (the convergence oracle of run_schedule,
        # reduced to its journal-equality core)
        for r in healed:
            cluster.hosts[r].restore_partitioned_node()
        cluster.reset_breakers()
        marker = f"healed{seed}=1".encode()
        if not cluster.propose(marker, timeout=15.0):
            failures.append("post-heal proposal never acked")
        deadline = time.time() + converge_timeout * time_scale
        converged = False
        while time.time() < deadline and not converged:
            js = cluster.journals()
            if len(js) == cluster.n:
                vals = list(js.values())
                converged = (all(v == vals[0] for v in vals[1:])
                             and marker in vals[0])
            if not converged:
                time.sleep(0.1)
        if not converged:
            failures.append("cluster did not converge after heal")

        # every class must clear to zero — event-driven on the flight
        # recorder (anomaly_cleared / leader_change wake the re-check)
        def counts_all_zero() -> bool:
            for rid in cluster.live_rids():
                eng = cluster.hosts[rid].kernel_engine
                d = getattr(eng, "last_health", None)
                if d and any(d["class_count"].values()):
                    return False
            return True

        deadline = time.time() + converge_timeout * time_scale
        cleared = counts_all_zero()
        while not cleared and time.time() < deadline:
            seq = flight.RECORDER.next_seq
            flight.RECORDER.wait_beyond(
                seq, timeout=min(0.5, max(0.0, deadline - time.time())))
            cleared = counts_all_zero()
        if not cleared:
            failures.append("anomaly classes did not clear to zero "
                            "after convergence")
        check_diff(rids[0], "post-convergence")
    finally:
        cluster.close()
    return DetectorResult(seed=seed, fault=fault, anomaly_class=cls,
                          raised=raised, cleared=cleared,
                          differential_checks=diff_checks,
                          failures=failures)


# -- hotspot differential ---------------------------------------------------
#
# The elastic controller (control.py) is itself under chaos test: a
# zipfian proposal skew (HOTSPOT_SKEW:1) lands on ONE seeded-choice
# shard whose apply path is deliberately slow.  The engine retires
# apply outputs inside its step-timer window, so the backlog throttles
# the whole engine round and the hosts' step-latency EWMA
# (engine.kernel_step.ewma_us) climbs an order of magnitude — the
# host_hot signal the controller keys on (device commit→apply lag
# stays flow-controlled to a constant window, so lag_divergence is by
# design NOT the observable here).  The controller on the hot leader's
# host must flight-record a hysteresis-guarded control_transfer with
# its evidence row and leadership must actually leave the initially
# hot replica, all with zero acked-write loss across the handoff.

#: hot:cold proposals per pump round (the "100:1 onto one host" skew)
HOTSPOT_SKEW = 100
#: per-entry apply cost of HotspotKV — enough to inflate the engine
#: round well past HOTSPOT_HOT_EWMA_US under the skew, small enough
#: that the capped backlog drains well inside the convergence window
HOTSPOT_APPLY_DELAY_S = 0.01
#: host-hot threshold for the run: idle CPU steps measure ~10-15 ms,
#: the pump pushes the EWMA to ~90 ms, so 30 ms separates cleanly in
#: both directions
HOTSPOT_HOT_EWMA_US = 30_000
#: pump backpressure: stop firing once this many proposals are
#: unresolved — bounds the post-drain apply time (cap * delay) without
#: capping the overload signal (the EWMA saturates long before this)
HOTSPOT_MAX_PENDING = 800


class HotspotKV(ChaosKV):
    """ChaosKV with a deliberately slow apply path: under skewed load
    the apply backlog backpressures the engine round, inflating the
    step-latency EWMA the controller's host_hot gate reads."""

    def update(self, entry):
        time.sleep(HOTSPOT_APPLY_DELAY_S)
        return super().update(entry)


@dataclass
class HotspotResult:
    seed: int
    hot_shard: int
    cold_shard: int
    initial_leader: int       # replica leading the hot shard at pump start
    final_leader: int         # replica leading it after the drain
    transfers: list           # control_transfer flight records (hot shard)
    acked_count: int
    report: OracleReport

    @property
    def ok(self) -> bool:
        return self.report.ok


def run_hotspot(seed: int, n_replicas: int = 3,
                transfer_window: float = 30.0,
                converge_timeout: float = 45.0,
                device=None, time_scale: float = 1.0) -> HotspotResult:
    """Drive the zipfian skew onto one device-resident shard and check
    the observe→act loop end to end: the controller drains the hot
    host within the window (check_hot_drained), every acked write
    survives the handoff (check_no_acked_loss + journal equality per
    shard), the leaderless gauge returns to zero, and the runtime
    invariant probe stayed silent throughout.  ``device`` and
    ``time_scale`` as in ``run_schedule`` (the host-hot threshold on the
    step-latency EWMA scales with it too)."""
    device = resolve_device(device)
    rng = Random(seed)
    hot_ewma_us = int(HOTSPOT_HOT_EWMA_US * time_scale)
    shards = (1, 2)
    hot = rng.choice(shards)
    cold = shards[0] if hot == shards[1] else shards[1]
    overrides = dict(
        # fast decimated observations; two consecutive hot observations
        # satisfy the hysteresis; the step-latency EWMA is the hot
        # signal (see the section comment)
        fleet_stats_every=5,
        control_enabled=True, control_hysteresis=2,
        control_cooldown_obs=8, control_max_transfers=1,
        control_seed=seed, control_hot_ewma_us=hot_ewma_us)
    cluster = _Cluster(seed=seed, n=n_replicas, device_resident=True,
                       expert_overrides=overrides, shards=shards,
                       sm_cls=HotspotKV, device=device,
                       time_scale=time_scale)
    report = OracleReport()
    transfers: list = []
    pending: list = []        # (shard, cmd, RequestState) fired async
    initial_leader = 0
    final_leader = 0
    acked: dict = {hot: [], cold: []}

    def wait_leader(sid: int, timeout: float) -> int:
        deadline = time.time() + timeout * time_scale
        while time.time() < deadline:
            for rid in cluster.live_rids():
                try:
                    lid, ok = cluster.hosts[rid].get_leader_id(sid)
                except Exception:
                    continue
                if ok and lid:
                    return lid
            time.sleep(0.05)
        return 0

    def fire(sid: int, cmd: bytes) -> None:
        # async propose: the futures are harvested after the pump stops.
        # The backlog IS the fault — a sync ack per proposal would
        # throttle the skew down to the apply rate and no lag would
        # ever build
        rids = cluster.live_rids()
        nh = cluster.hosts[rids[len(pending) % len(rids)]]
        try:
            rs = nh.propose(nh.get_noop_session(sid), cmd,
                            timeout_s=15.0 * time_scale)
        except Exception:
            return            # book full / not ready: a drop, not an ack
        pending.append((sid, cmd, rs))

    def unresolved() -> int:
        return sum(1 for _, _, rs in pending if not rs._event.is_set())

    def max_ewma() -> int:
        return max((int(cluster.hosts[rid].events.metrics.snapshot()
                        .get("engine.kernel_step.ewma_us", 0))
                    for rid in cluster.live_rids()), default=0)

    try:
        cluster.start()
        # settle both shards (the first device-resident cluster in a
        # process pays the kernels' first build inside this window)
        for sid in shards:
            if not cluster.propose(f"genesis{sid}=1".encode(),
                                   timeout=45.0, shard=sid):
                report.fail(f"shard {sid}: no initial commit — cluster "
                            "never settled")
        # warmup: the first steps carry the first-call cost, so every
        # host's EWMA starts far above the threshold.  The policy's
        # warmup_obs suppresses controller action on that noise; the
        # harness additionally waits for the decay so the baseline
        # leader is read from a quiet fleet and start_seq excludes any
        # residual warmup decisions
        deadline = time.time() + 60.0 * time_scale
        while max_ewma() >= hot_ewma_us and time.time() < deadline:
            time.sleep(0.25)
        if max_ewma() >= hot_ewma_us:
            report.fail("engines never settled below the hot threshold "
                        "after compile warmup")
        initial_leader = wait_leader(hot, 10.0)
        if not initial_leader:
            report.fail("no leader on the hot shard before the pump")
        start_seq = flight.RECORDER.next_seq
        deadline = time.time() + transfer_window * time_scale
        i = 0
        while time.time() < deadline and not transfers:
            if unresolved() < HOTSPOT_MAX_PENDING:
                batch = [hot] * HOTSPOT_SKEW + [cold]
                rng.shuffle(batch)
                for sid in batch:
                    fire(sid, f"h{sid}i{i}=v{seed}".encode())
                    i += 1
            transfers = [
                r for r in flight.RECORDER.tail()
                if r["seq"] >= start_seq
                and r["kind"] == flight.CONTROL_TRANSFER
                and r.get("shard_id") == hot]
            # let the apply backlog shape the next health digest before
            # re-scanning (the scan itself is cheap; the controller acts
            # on decimated ticks, not on our polling cadence)
            time.sleep(0.05)
        # bounded drain: leadership must actually leave the hot replica
        if transfers:
            deadline = time.time() + 15.0 * time_scale
            while time.time() < deadline:
                lid = wait_leader(hot, 5.0)
                if lid and lid != initial_leader:
                    final_leader = lid
                    break
                time.sleep(0.05)
            if not final_leader:
                final_leader = wait_leader(hot, 1.0)
        report.merge(check_hot_drained(initial_leader, final_leader,
                                       transfers))
        # pump stopped: resolve the outstanding futures (the backlog
        # drains at the slow-apply rate), then the completed ones are
        # exactly the acked set the loss oracle holds the fleet to
        deadline = time.time() + converge_timeout * time_scale
        while unresolved() and time.time() < deadline:
            time.sleep(0.1)
        if unresolved():
            report.fail(f"{unresolved()} proposals still unresolved "
                        "after the drain window")
        for sid, cmd, rs in pending:
            if rs.wait(0).completed():
                acked[sid].append(cmd)
        # post-drain liveness: the fleet still commits on both shards
        # under the new leadership, and the marker doubles as the
        # convergence fence for the journal comparison
        markers = {}
        for sid in shards:
            markers[sid] = f"drained{sid}x{seed}=1".encode()
            if not cluster.propose(markers[sid], timeout=15.0, shard=sid):
                report.fail(f"shard {sid}: post-drain proposal never "
                            "acked")
        deadline = time.time() + converge_timeout * time_scale
        converged = False
        while time.time() < deadline and not converged:
            converged = True
            for sid in shards:
                js = cluster.journals(shard=sid)
                vals = list(js.values())
                if (len(js) != cluster.n
                        or any(v != vals[0] for v in vals[1:])
                        or markers[sid] not in vals[0]):
                    converged = False
                    break
            if not converged:
                time.sleep(0.1)
        if not converged:
            report.fail("cluster did not converge after the drain")
        for sid in shards:
            js = cluster.journals(shard=sid)
            report.merge(check_journals_equal(js))
            report.merge(check_no_acked_loss(acked[sid], js))
        # the leaderless gauge returns to zero once converged —
        # event-driven on the flight recorder, as in run_schedule
        if converged:
            deadline = time.time() + 5.0 * time_scale
            seq = flight.RECORDER.next_seq
            leaderless = cluster.leaderless_total()
            while leaderless and time.time() < deadline:
                flight.RECORDER.wait_beyond(
                    seq, timeout=min(0.5, max(0.0,
                                              deadline - time.time())))
                seq = flight.RECORDER.next_seq
                leaderless = cluster.leaderless_total()
            if leaderless:
                report.fail(f"health.leaderless_now gauge stuck at "
                            f"{leaderless} after the drain")
        report.invariant_probe = cluster.invariant_counters()
        report.merge(check_invariant_probe(report.invariant_probe))
        if not report.ok:
            report.flight_tail = flight.RECORDER.tail(64)
    finally:
        cluster.close()
    return HotspotResult(
        seed=seed, hot_shard=hot, cold_shard=cold,
        initial_leader=initial_leader, final_leader=final_leader,
        transfers=transfers, acked_count=sum(map(len, acked.values())),
        report=report)
