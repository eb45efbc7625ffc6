"""NodeHost — the public façade of the framework.

The port of the reference's ``nodehost.py``.  Parity with the reference's
``nodehost.go``: one NodeHost per process (or several, for in-process
clusters over the chan transport) hosting many raft shards; all client
entry points (SyncPropose :576, SyncRead :600, Propose :805, ReadIndex
:840, StaleRead :894, RequestSnapshot :963, membership changes
:1038-1237, RequestLeaderTransfer :1238, GetNodeHostInfo :1359) and the
engine/tick machinery (:1824+).

The loopback engine steps nodes synchronously on an engine thread (the
reference's partitioned worker pools collapse to one executor here); the
port's ``KernelEngine`` runs device-resident shards as rows of one
``[G]`` state on the host's ``device`` — the CUDA card unless the caller
names the CPU (``NodeHost(..., device="cpu")``).  Mesh-resident shards
(``Config.mesh_resident`` with ``ExpertConfig.mesh``) attach to the port's
process-wide ``MeshEngine``, whose mesh positions all live on that same
device (``parallel/ici.py``).

Replicas are addressed by raft address or, with
``address_by_node_host_id``, by NodeHostID through the gossip view
(``gossip.py``), over either transport (chan or ``transport/tcp.py``).
Refused at construction: the JAX compile cache
(``ExpertConfig.compile_cache``).  CUDA graphs are captured in each
process, and no cache carries a captured graph across processes.  The
default
``ExpertConfig`` runs as is: the engine's decimated device reductions
feed ``shard_info``'s device row and the opt-in ``enable_metrics``
endpoint (``/metrics``, ``/healthz``, ``/debug/*``).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.client import Session
from dragonboat_tpu_torch.config import Config, NodeHostConfig
from dragonboat_tpu_torch.devices import resolve_device
from dragonboat_tpu_torch.events import EventHub
from dragonboat_tpu_torch.logdb.memdb import MemLogDB
from dragonboat_tpu_torch.logdb.sharded import ShardedLogDB
from dragonboat_tpu_torch.server.env import Env
from dragonboat_tpu_torch.node import Node, _SnapshotRequest
from dragonboat_tpu_torch.raftio import ILogDB, NodeInfo, SnapshotInfo
from dragonboat_tpu_torch.registry import Registry
from dragonboat_tpu_torch.request import (
    LogicalClock,
    RequestDroppedError,
    RequestError,
    RequestRejectedError,
    RequestState,
    RequestResultCode,
)
from dragonboat_tpu_torch.rsm.statemachine import StateMachine
from dragonboat_tpu_torch.statemachine import Result
from dragonboat_tpu_torch import fabric
from dragonboat_tpu_torch.transport.chan import ChanTransportFactory
from dragonboat_tpu_torch.transport.chunks import ChunkSink
from dragonboat_tpu_torch.transport.hub import TransportHub, _msg_size
from dragonboat_tpu_torch.logger import get_logger

_LOG = get_logger("nodehost")

DEFAULT_TIMEOUT_S = 5.0


class ShardNotFoundError(RequestError):
    pass


class AdmissionRefusedError(RequestError):
    """StartReplica refused by the capacity admission controller
    (control.check_admission): the host is at or past its derated
    device-capacity watermark.  Carries the evidence row so callers can
    act on it (retry elsewhere, raise the budget, relax the policy)."""

    def __init__(self, shard_id: int, evidence: dict) -> None:
        super().__init__(
            f"shard {shard_id}: device admission refused "
            f"(occupied {evidence.get('occupied')} >= "
            f"limit {evidence.get('limit')})")
        self.shard_id = shard_id
        self.evidence = dict(evidence)


def _refuse_off_path(nhconfig: NodeHostConfig) -> None:
    """Raise for the NodeHost settings the port does not carry, saying
    why (never skipped silently)."""
    ex = nhconfig.expert
    if ex.compile_cache:
        raise ValueError("ExpertConfig.compile_cache: CUDA graphs are "
                         "captured in each process; no cache carries a "
                         "captured graph across processes")


@dataclass
class ShardInfo:
    shard_id: int
    replica_id: int
    leader_id: int
    term: int
    is_leader: bool
    membership: pb.Membership
    last_applied: int


@dataclass
class NodeHostInfo:
    node_host_id: str
    raft_address: str
    shard_info_list: list[ShardInfo] = field(default_factory=list)


class NodeHost:
    # serializes the process-global threading.stack_size() window below
    _stack_size_mu = threading.Lock()

    def __init__(self, nhconfig: NodeHostConfig,
                 logdb: ILogDB | None = None,
                 auto_run: bool = True,
                 device=None) -> None:
        nhconfig.validate()
        _refuse_off_path(nhconfig)
        # the device the kernel engine's state lives on: the CUDA card
        # unless the caller names the CPU (raises with no card)
        self.device = resolve_device(device)
        self.config = nhconfig
        from dragonboat_tpu_torch.vfs import default_fs

        self.fs = (nhconfig.expert.fs if nhconfig.expert.fs is not None
                   else default_fs())
        # durable mode: with a NodeHostDir, the data dir is locked, the
        # flag file validated, identity persisted, and the tan log engine
        # is the default LogDB (nodehost.go NewNodeHost → server.NewEnv →
        # CreateNodeHostDir / LockNodeHostDir / CheckNodeHostDir)
        self.env: Env | None = None
        if nhconfig.node_host_dir:
            # NodeHostDir always drives env services (lock, flag file,
            # identity, snapshot placement) — a custom LogDB only swaps
            # the engine, as in the reference (config.LogDBFactory)
            self.env = Env(nhconfig.node_host_dir, nhconfig.raft_address,
                           nhconfig.deployment_id,
                           wal_dir=nhconfig.wal_dir, fs=self.fs)
            self.env.lock()
            try:
                custom = logdb is not None or nhconfig.logdb_factory is not None
                if logdb is not None:
                    self.logdb: ILogDB = logdb
                    self.env.check_node_host_dir(self.logdb.name())
                elif nhconfig.logdb_factory is not None:
                    self.logdb = nhconfig.logdb_factory.create()  # type: ignore[union-attr]
                    self.env.check_node_host_dir(self.logdb.name())
                else:
                    # validate the dir BEFORE tan touches the wal root so a
                    # refused reopen leaves no stray log files behind;
                    # legacy flat-"tan" dirs migrate in place and get the
                    # flag bumped so a rolled-back binary refuses them
                    # instead of seeing an empty log
                    engine = nhconfig.expert.logdb.engine
                    self.env.check_node_host_dir(
                        f"sharded-{engine}",
                        compatible=("tan",) if engine == "tan" else ())
                    self.logdb = ShardedLogDB(
                        self.env.logdb_dir,
                        num_shards=nhconfig.expert.logdb.shards,
                        fs=self.fs, engine=engine,
                        recovery_mode=nhconfig.expert.logdb.recovery_mode)
                self.id = self.env.node_host_id()
            except Exception:
                db = getattr(self, "logdb", None)
                if db is not None and db is not logdb:
                    db.close()
                self.env.close()
                raise
        else:
            self.id = f"nhid-{uuid.uuid4()}"
            self.logdb = logdb if logdb is not None else (
                nhconfig.logdb_factory.create()  # type: ignore[union-attr]
                if nhconfig.logdb_factory else MemLogDB()
            )
        if nhconfig.address_by_node_host_id:
            # dynamic addressing: targets are NodeHostIDs, resolved through
            # the gossip view (registry/gossip.go:99)
            from dragonboat_tpu_torch.gossip import GossipManager, GossipRegistry

            self.registry = GossipRegistry(GossipManager(
                self.id, nhconfig.raft_address,
                nhconfig.gossip.bind_address,
                nhconfig.gossip.advertise_address,
                list(nhconfig.gossip.seed),
                shard_info_fn=self._local_shard_views,
            ))
        else:
            self.registry = Registry()
        self.events = EventHub(
            raft_listener=nhconfig.raft_event_listener,
            system_listener=nhconfig.system_event_listener,
        )
        self.mu = threading.RLock()
        self.nodes: dict[int, Node] = {}
        # merged fleet telemetry view: host-resident replicas recounted
        # at scrape time + the engines' decimated device reductions
        # (core/fleet.py).  Registered BEFORE any engine exists, so the
        # engines' standalone device-only registration no-ops on this
        # registry and the merged view owns the family names
        from dragonboat_tpu_torch.core import fleet as _fleet

        _fleet.register_exposition(self.events.metrics.registry,
                                   self._fleet_snapshot, replace=True)
        # merged anomaly-health view (core/health.py), same ownership
        # protocol: the host's merged snapshot claims the family names
        # before any engine's device-only registration can
        from dragonboat_tpu_torch.core import health as _health

        _health.register_exposition(self.events.metrics.registry,
                                    self._health_snapshot, replace=True)
        # merged protocol-invariant view (core/invariants.py), same
        # ownership protocol.  Host-resident replicas contribute nothing
        # (the probe is a device reduction); the merged view exists so a
        # violation on EITHER engine degrades this host's /healthz
        from dragonboat_tpu_torch.core import invariants as _invariants

        _invariants.register_exposition(self.events.metrics.registry,
                                        self._invariants_snapshot,
                                        replace=True)
        # merged capacity view (capacity.py), same ownership protocol
        from dragonboat_tpu_torch import capacity as _capacity

        _capacity.register_exposition(self.events.metrics.registry,
                                      self._capacity_snapshot, replace=True)
        # a directly-injected ILogDB object cannot be reopened by
        # restart() (no recipe to rebuild it); factories can
        self._injected_logdb = logdb is not None
        # start_replica arguments per shard, so restart() can rebuild
        # every replica from disk after a controlled crash
        self._replica_specs: dict[int, tuple] = {}        # guarded-by: mu
        # ONE logical clock for every node's request books — advanced
        # once per tick round by the ticker (absolute deadline stamps;
        # the per-lane per-book advance walk was the 100k election
        # pump's dominant cost, PERF.md)
        self.logical_clock = LogicalClock()
        self._tick_round_no = 0
        self.chunk_sink = ChunkSink(
            snapshot_dir=os.path.join(tempfile.gettempdir(),
                                      "dragonboat_tpu", self.id, "incoming"),
            deployment_id=nhconfig.deployment_id,
            deliver=self._on_snapshot_reassembled,
        )
        factory = nhconfig.transport_factory or ChanTransportFactory()
        self.transport = factory.create(
            nhconfig, self._handle_message_batch, self.chunk_sink.add)
        self.transport.start()
        self.hub = TransportHub(
            source_address=nhconfig.raft_address,
            deployment_id=nhconfig.deployment_id,
            transport=self.transport,
            resolver=self.registry,
            unreachable_cb=self._on_unreachable,
            events=self.events,
            snapshot_send_bps=nhconfig.max_snapshot_send_bytes_per_second,
            max_send_queue_bytes=nhconfig.max_send_queue_size,
        )
        self._stopped = False
        # a storage-layer failure is a controlled crash (the reference arms
        # an engine crash channel for injected FS errors, nodehost.go:361):
        # the host stops accepting work and records the fault for the
        # operator; restart from disk is the recovery path
        self.fatal_error: Exception | None = None
        # monkey-test partition flag (monkey.go:170 PartitionNode)
        self._partitioned = False
        self._work = threading.Event()
        self._engine_thread: threading.Thread | None = None
        self._tick_interval = nhconfig.rtt_millisecond / 1000.0
        # the batched device engine, created on the first device-resident
        # shard (engine/kernel_engine.py)
        self.kernel_engine = None
        # the shared mesh engine, attached on the first mesh-resident
        # shard (engine/mesh_engine.py)
        self.mesh_engine = None
        # elastic fleet controller (control.py): consumes each decimated
        # health observation on the engine ticker thread (_control_round)
        # and plans rate-limited, hysteresis-guarded leader transfers off
        # this host.  Single-owner state: only the ticker touches it
        from dragonboat_tpu_torch import control as _control

        _ex = nhconfig.expert
        self._controller = _control.FleetController(_control.ControlPolicy(
            enabled=_ex.control_enabled,
            hot_score=_ex.control_hot_score,
            lag_hot=_ex.control_lag_hot,
            hysteresis=_ex.control_hysteresis,
            cooldown_obs=_ex.control_cooldown_obs,
            max_transfers=_ex.control_max_transfers,
            seed=_ex.control_seed,
            warmup_obs=_ex.control_warmup_obs))
        self._ctrl_seen_seq = 0   # engine health observations consumed
        # partitioned step workers (engine.go:1107 workerPool: shards hash
        # onto fixed workers so each node is stepped by exactly one
        # thread; the sharded LogDB gives each partition its own active
        # file + lock, so different workers' fsyncs genuinely overlap —
        # logdb/sharded.py, parity internal/logdb/sharded.go:34)
        import os as _os

        self._num_workers = max(1, min(
            nhconfig.expert.engine.exec_shards, _os.cpu_count() or 1, 8))
        self._worker_events = [threading.Event()
                               for _ in range(self._num_workers)]
        self._workers: list[threading.Thread] = []
        # the workers with a host-resident node to step: worker 0 always
        # (it also runs the device engines).  A worker whose shards are
        # all device-resident (KernelNode.step is a no-op) sleeps until
        # the node set changes instead of polling: each poll takes the
        # GIL, and the eager step's ~1000 torch calls each wait for it
        self._host_workers = {0}
        self._nodes_dirty = False
        # dedicated RSM-apply workers (engine.go:1153 applyWorkerMain): a
        # slow user SM occupies one of these, never a step worker
        from dragonboat_tpu_torch.engine.apply_pool import ApplyPool

        # NOT capped by cpu_count: apply workers exist to absorb BLOCKED
        # user SMs (the reference runs a fixed 16 regardless of cores)
        self._apply_pool = ApplyPool(
            num_workers=max(1, min(nhconfig.expert.engine.apply_shards, 16)),
            on_work_done=self._work.set, name=f"apply-{self.id[:8]}")
        # proposal-lifecycle tracing (lifecycle.py): re-point the
        # process-global tracer at this host's expert knobs — the tracer
        # is process-wide (like flight.RECORDER) so spans stay whole
        # when a proposal crosses hosts over the in-proc transport
        from dragonboat_tpu_torch import lifecycle as _lifecycle

        _lifecycle.TRACER.configure(
            sample_every=nhconfig.expert.trace_sample_every,
            slow_commit_us=nhconfig.expert.trace_slow_commit_us)
        # fabric link telemetry + hop census (fabric.py): the meter is
        # process-wide for the same reason the tracer is — links span
        # hosts, so one registry must see both ends
        fabric.METER.configure(enabled=nhconfig.expert.fabric_telemetry)
        # the JAX compile cache is refused above (_refuse_off_path).
        # opt-in Prometheus /metrics endpoint (enable_metrics): serves
        # this host's registry + the process-global one (module-scoped
        # producers like the logdb latency histograms live there)
        self._metrics_server = None
        if nhconfig.enable_metrics:
            from dragonboat_tpu_torch.server.metrics_http import MetricsServer
            from dragonboat_tpu_torch.telemetry import GLOBAL

            self._metrics_server = MetricsServer(
                [self.events.metrics.registry, GLOBAL],
                address=nhconfig.metrics_address or "127.0.0.1:0",
                health_source=self._health_snapshot,
                info_source=self.info,
                shard_info_source=self._shard_info_or_none,
                capacity_source=self._capacity_snapshot,
                invariants_source=self._invariants_snapshot,
                fabric_source=fabric.METER.snapshot,
                fabric_trace_source=fabric.METER.chrome_events)
            _LOG.info("NodeHost %s metrics endpoint on %s",
                      nhconfig.raft_address, self._metrics_server.address)
        self._auto_run = auto_run
        if auto_run:
            self._start_engine_threads()

    @property
    def metrics_address(self) -> str | None:
        """The bound host:port of the /metrics endpoint (None when
        enable_metrics is off)."""
        return (self._metrics_server.address
                if self._metrics_server is not None else None)

    def _fleet_snapshot(self) -> dict:
        """Scrape-time fleet view: the engines' cached device reductions
        merged with a host-side recount of host-resident replicas (a
        plain 3-replica cluster has no device state to reduce, but
        /metrics must still answer role/leaderless/lag questions)."""
        from dragonboat_tpu_torch.core import fleet as _fleet

        base = _fleet.empty_dict()
        for eng in (self.kernel_engine, self.mesh_engine):
            d = getattr(eng, "last_fleet", None)
            if d:
                _fleet.merge_into(base, d)
        with self.mu:
            nodes = list(self.nodes.values())
        for n in nodes:
            if getattr(n, "engine", None) is not None:
                continue        # device-resident: covered by the reduction
            try:
                raft = n.peer.raft if n.peer is not None else None
                if raft is None:
                    _fleet.add_host_shard(base, "follower", False, 0, 0)
                    continue
                lag = max(0, int(raft.log.committed)
                          - int(raft.log.processed))
                _fleet.add_host_shard(
                    base, raft.state.name.lower(),
                    int(raft.leader_id) == 0, int(raft.term), lag)
            except Exception:
                # a replica being torn down mid-scrape still counts
                _fleet.add_host_shard(base, "follower", False, 0, 0)
        return base

    def _health_snapshot(self) -> dict:
        """Scrape-time anomaly view: the engines' cached O(K) device
        reports merged (offenders tagged by engine) with a host-side
        recount of host-resident replicas.  The anomaly-class detectors
        are device-side only, so host replicas contribute just the
        instantaneous leaderless count — the single source of truth the
        chaos convergence oracle reads."""
        from dragonboat_tpu_torch.core import health as _health

        base = _health.empty_dict()
        for name, eng in (("kernel", self.kernel_engine),
                          ("mesh", self.mesh_engine)):
            d = getattr(eng, "last_health", None)
            if d:
                _health.merge_into(base, d, engine=name)
        with self.mu:
            nodes = list(self.nodes.values())
        for n in nodes:
            if getattr(n, "engine", None) is not None:
                continue        # device-resident: covered by the report
            try:
                if int(n.leader_id()) == 0:
                    base["leaderless_now"] += 1
            except Exception:
                base["leaderless_now"] += 1   # torn down mid-scrape
        return base

    def _invariants_snapshot(self) -> dict:
        """Scrape-time protocol-invariant view: the engines' cached O(1)
        probe reports merged (first offender tagged by engine).  The
        probe is device-side only — host-resident replicas contribute
        nothing.  A nonzero ``violations_seen`` is sticky for each
        engine's lifetime: /healthz stays degraded after a transient
        step-scope violation (it is a bug either way)."""
        from dragonboat_tpu_torch.core import invariants as _invariants

        base = _invariants.empty_dict()
        base["violations_seen"] = 0
        for name, eng in (("kernel", self.kernel_engine),
                          ("mesh", self.mesh_engine)):
            d = getattr(eng, "last_invariants", None)
            if d:
                _invariants.merge_into(base, d, engine=name)
                base["violations_seen"] += d.get("violations_seen", 0)
        return base

    def _capacity_snapshot(self) -> dict:
        """Scrape-time capacity view: the engines' cached decimated
        capacity snapshots merged, compile entries tagged by engine.
        Host-resident replicas hold no device state — only the engines
        contribute."""
        from dragonboat_tpu_torch import capacity as _capacity

        base = _capacity.empty_dict()
        for name, eng in (("kernel", self.kernel_engine),
                          ("mesh", self.mesh_engine)):
            d = getattr(eng, "last_capacity", None)
            if d:
                _capacity.merge_into(base, d, engine=name)
        return base

    def _start_engine_threads(self) -> None:
        """Spawn the engine ticker + step workers (also from restart()).

        Worker threads jit-compile the step kernel on their first
        engine iteration; XLA's compile recursion on large graphs
        overflows the default pthread stack (observed as a segfault
        inside backend_compile in exec-0 threads, 2026-07-31), so
        engine threads get a deep stack.  stack_size() is process-
        global for threads created while set — the class lock keeps
        concurrent NodeHost constructions from racing the window."""
        with NodeHost._stack_size_mu:
            prev_stack = threading.stack_size()
            try:
                threading.stack_size(64 << 20)
            except (ValueError, RuntimeError):
                prev_stack = None
            try:
                self._engine_thread = threading.Thread(
                    target=self._engine_main,
                    name=f"engine-{self.id[:12]}", daemon=True)
                self._engine_thread.start()
                for w in range(self._num_workers):
                    t = threading.Thread(
                        target=self._worker_main, args=(w,),
                        name=f"exec-{w}-{self.id[:8]}", daemon=True)
                    t.start()
                    self._workers.append(t)
            finally:
                if prev_stack is not None:
                    threading.stack_size(prev_stack)

    # -- lifecycle ------------------------------------------------------

    def _detach_mesh(self, nodes) -> None:
        """Take this host's replicas off the shared mesh engine and drop
        this host's reference to it (the last host's detach closes it)."""
        if self.mesh_engine is None:
            return
        from dragonboat_tpu_torch.engine.mesh_engine import detach_mesh_engine

        self.mesh_engine.remove_replicas(
            [n for n in nodes if getattr(n, "engine", None) is self.mesh_engine])
        detach_mesh_engine(self.mesh_engine)
        self.mesh_engine = None

    def close(self) -> None:
        self.events.node_host_shutting_down()
        with self.mu:
            self._stopped = True
            nodes = list(self.nodes.values())
            self.nodes.clear()
            self._nodes_dirty = True
        self._detach_mesh(nodes)
        self._work.set()
        for ev in self._worker_events:
            ev.set()
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=5)
        for t in self._workers:
            t.join(timeout=5)
        # drain in-flight applies before destroying SMs: sm.close() must
        # not run concurrently with its own update()
        for n in nodes:
            if not self._apply_pool.flush(n.shard_id, timeout=5):
                _LOG.warning("shard %d: apply still running at close",
                             n.shard_id)
        self._apply_pool.stop()
        for n in nodes:
            n.destroy()
            self.events.node_unloaded(NodeInfo(n.shard_id, n.replica_id))
        if self.kernel_engine is not None:
            # flushes a DRAGONBOAT_TPU_TRACE_DIR-armed profiler capture
            # while the backend is still alive (atexit-only flush races
            # interpreter shutdown)
            self.kernel_engine.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        self.transport.close()
        try:
            self.logdb.close()
        except OSError:
            # a storage fault mid-shutdown must not abort the close: the
            # fsync that failed was already surfaced as fatal_error
            _LOG.exception("logdb close failed")
        self.events.close()
        close_registry = getattr(self.registry, "close", None)
        if close_registry is not None:
            close_registry()
        if self.env is not None:
            self.env.close()

    def restart(self, timeout_s: float = 5.0) -> None:
        """Recover IN PLACE from a controlled storage crash: reopen the
        log engine from the data dir and rebuild every replica that was
        running when ``_on_fatal`` halted the host.

        The reference's ErrorFS crash arming panics the process and the
        operator restarts it (nodehost.go:361-367) — a library host
        cannot exec itself, so this is that operator restart: same
        process, same Env lock, fresh LogDB + Nodes from what reached
        stable storage.  Acks sent after the failed fsync were never
        acted on (the host halted immediately), so replaying the disk
        state is exactly the durable prefix."""
        with self.mu:
            if not self._stopped:
                raise RequestError("restart requires a stopped host")
            if self._injected_logdb:
                raise RequestError(
                    "cannot restart: the injected LogDB object has no "
                    "reopen recipe (use a logdb_factory)")
            if self.config.logdb_factory is None and self.env is None:
                raise RequestError(
                    "cannot restart: no durable data dir to recover from")
            nodes = list(self.nodes.values())
            self.nodes.clear()
            self._nodes_dirty = True
            specs = sorted(self._replica_specs.items())
            self._replica_specs.clear()
        self._detach_mesh(nodes)
        self.kernel_engine = None
        self._work.set()
        for ev in self._worker_events:
            ev.set()
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=timeout_s)
        for t in self._workers:
            t.join(timeout=timeout_s)
        self._workers = []
        self._engine_thread = None
        for n in nodes:
            self._apply_pool.flush(n.shard_id, timeout=timeout_s)
            n.destroy()
            self.events.node_unloaded(NodeInfo(n.shard_id, n.replica_id))
        try:
            self.logdb.close()
        except OSError:
            # the engine that failed its fsync may fail the closing one
            # too; the reopen below rereads whatever IS durable
            _LOG.exception("logdb close failed during restart")
        if self.config.logdb_factory is not None:
            self.logdb = self.config.logdb_factory.create()
        else:
            self.logdb = ShardedLogDB(
                self.env.logdb_dir,
                num_shards=self.config.expert.logdb.shards,
                fs=self.fs, engine=self.config.expert.logdb.engine,
                recovery_mode=self.config.expert.logdb.recovery_mode)
        with self.mu:
            self.fatal_error = None
            self._stopped = False
        if self._auto_run:
            self._start_engine_threads()
        for _sid, (members, join, create_sm, cfg) in specs:
            self.start_replica(members, join, create_sm, cfg)
        _LOG.info("NodeHost %s restarted with %d replica(s)",
                  self.id, len(specs))

    def simulate_kill(self) -> None:
        """Chaos surface: die like a killed process — stop every thread
        and drop every in-memory structure WITHOUT the orderly close's
        final log fsync or Env unlock.  What survives is exactly what
        reached stable storage; on a shared MemFS the companion call is
        ``fs.crash(prefix)``, which also reverts unsynced bytes and
        releases the dead process's file locks."""
        with self.mu:
            self._stopped = True
            if self.fatal_error is None:
                self.fatal_error = RequestError("simulated process kill")
            nodes = list(self.nodes.values())
            self.nodes.clear()
            self._nodes_dirty = True
            self._replica_specs.clear()
        self._detach_mesh(nodes)
        self._work.set()
        for ev in self._worker_events:
            ev.set()
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=5)
        for t in self._workers:
            t.join(timeout=5)
        # brief drain so sm.close() cannot race an in-flight update()
        # on these in-process threads (a real kill has no such race)
        for n in nodes:
            self._apply_pool.flush(n.shard_id, timeout=1)
        self._apply_pool.stop()
        for n in nodes:
            n.destroy()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        self.transport.close()
        self.events.close()
        close_registry = getattr(self.registry, "close", None)
        if close_registry is not None:
            close_registry()
        # deliberately NOT closed: self.logdb (its close() fsyncs — a
        # dead process never runs it) and self.env (the kernel releases
        # a dead process's flocks; MemFS.crash models that)

    def start_replica(self, initial_members: dict[int, str], join: bool,
                      create_sm, cfg: Config) -> None:
        """StartReplica (nodehost.go:499) for a regular/concurrent SM
        factory ``create_sm(shard_id, replica_id)``."""
        cfg.validate()
        mesh = (cfg.mesh_resident and not cfg.is_witness
                and self.config.expert.mesh is not None)
        device = cfg.device_resident and not cfg.is_witness and not mesh
        if device:
            # build the engine BEFORE registering the shard: a refused
            # engine configuration raises here, with nothing half-started
            self._ensure_kernel_engine()
        self._admit_replica(cfg)
        with self.mu:
            if cfg.shard_id in self.nodes:
                raise RequestError("shard already started")
            # bootstrap-record check (startShard, nodehost.go:1526)
            bootstrap = self.logdb.get_bootstrap_info(
                cfg.shard_id, cfg.replica_id)
            new_node = bootstrap is None
            if new_node:
                self.logdb.save_bootstrap_info(
                    cfg.shard_id, cfg.replica_id,
                    pb.Bootstrap(addresses=dict(initial_members), join=join),
                )
            elif bootstrap.addresses and initial_members and not join:
                if bootstrap.addresses != initial_members:
                    raise RequestError("initial members mismatch")
            user_sm = create_sm(cfg.shard_id, cfg.replica_id)
            sm = StateMachine(cfg.shard_id, cfg.replica_id, user_sm,
                              cfg.ordered_config_change,
                              cfg.snapshot_compression, fs=self.fs)
            snapshot_dir = (
                self.env.snapshot_dir(cfg.shard_id, cfg.replica_id)
                if self.env is not None
                else os.path.join(tempfile.gettempdir(), "dragonboat_tpu",
                                  self.id, "snapshots")
            )
            node_cls = Node
            if device or mesh:
                from dragonboat_tpu_torch.engine.kernel_engine import KernelNode

                node_cls = KernelNode
            node = node_cls(cfg, self.logdb, sm, self._send_message,
                            snapshot_dir, events=self.events, fs=self.fs,
                            worker_id=cfg.shard_id % self._num_workers,
                            clock=self.logical_clock)
            node.membership_changed_cb = (
                lambda cc, sid=cfg.shard_id: self._on_membership_change(sid, cc)
            )
            node.stream_snapshot_cb = self._stream_snapshot
            node.notify_commit = self.config.notify_commit
            node.apply_pool = self._apply_pool
            members = initial_members if not join else {}
            node.start(members, initial=not join, new_node=new_node)
            for rid, addr in (members or {}).items():
                self.registry.add(cfg.shard_id, rid, addr)
            # when re-starting, membership from the RSM rebuilds the registry
            m = sm.get_membership()
            for rid, addr in {**m.addresses, **m.non_votings, **m.witnesses}.items():
                self.registry.add(cfg.shard_id, rid, addr)
            self.nodes[cfg.shard_id] = node
            self._nodes_dirty = True
            self._replica_specs[cfg.shard_id] = (
                dict(initial_members), join, create_sm, cfg)
        if mesh:
            self._inject_mesh_shard(node, members)
        elif device:
            # outside self.mu: the engine lock orders engine.mu -> host.mu
            # on the eviction path, so injection must not hold host.mu
            self._inject_kernel_shard(node, members)
        self.events.node_ready(NodeInfo(cfg.shard_id, cfg.replica_id))
        self._work.set()

    def stop_replica(self, shard_id: int) -> None:
        with self.mu:
            node = self.nodes.pop(shard_id, None)
            self._nodes_dirty = True
            self._replica_specs.pop(shard_id, None)
        if node is None:
            raise ShardNotFoundError(f"shard {shard_id} not found")
        if self.mesh_engine is not None and getattr(
                node, "engine", None) is self.mesh_engine:
            self.mesh_engine.remove_replica(node)
        elif self.kernel_engine is not None:
            self.kernel_engine.remove_shard(shard_id)
        self._apply_pool.flush(shard_id)
        node.destroy()
        self.events.node_unloaded(NodeInfo(shard_id, node.replica_id))

    # -- kernel engine glue ----------------------------------------------

    def _admit_replica(self, cfg: Config) -> None:
        """Capacity-driven admission (control.check_admission): a
        device-resident StartReplica past the derated capacity watermark
        is refused under policy "enforce", recorded-but-admitted under
        "warn".  The limit is max_g_for_budget over the explicit device
        budget (else the backend-reported bytes_limit) derated by the
        headroom watermark; with no resolvable budget the gate never
        refuses — capacity unknown is not capacity exhausted."""
        from dragonboat_tpu_torch import capacity as _capacity
        from dragonboat_tpu_torch import control as _control
        from dragonboat_tpu_torch import flight as _flight

        ex = self.config.expert
        mode = ex.admission_policy
        if mode not in (_control.ADMISSION_ENFORCE, _control.ADMISSION_WARN):
            return
        mesh = (cfg.mesh_resident and not cfg.is_witness
                and ex.mesh is not None)
        if not (cfg.device_resident and not cfg.is_witness and not mesh):
            return
        self.events.metrics.inc("control_admission_total")
        budget = ex.capacity_device_budget_bytes
        if budget <= 0:
            budget = max((r["bytes_limit"]
                          for r in _capacity.device_memory_stats()),
                         default=0)
        limit = _control.admission_limit(
            self._kernel_params(), budget, ex.capacity_watermark_pct,
            _capacity.max_g_for_budget)
        with self.mu:
            occupied = sum(
                1 for n in self.nodes.values()
                if getattr(n, "engine", None) is not None
                and getattr(n, "lane", -1) >= 0)
        d = _control.check_admission(cfg.shard_id, occupied, limit,
                                     mode=mode)
        if d is None:
            return
        self.events.metrics.inc("control_admission_refused")
        _flight.record(_flight.ADMISSION_REFUSED,
                       tick=self._tick_round_no, shard_id=d.shard_id,
                       mode=mode, evidence=d.evidence)
        if mode == _control.ADMISSION_ENFORCE:
            raise AdmissionRefusedError(cfg.shard_id, d.evidence)
        _LOG.warning("shard %d: admission watermark exceeded (%s) — "
                     "admitted under policy 'warn'",
                     cfg.shard_id, d.evidence)

    def _ensure_kernel_engine(self):
        """The host's device engine, built on first use on ``self.device``
        with the ExpertConfig's reduction, health and capacity settings."""
        from dragonboat_tpu_torch.engine.kernel_engine import KernelEngine

        with self.mu:
            if self.kernel_engine is None:
                ex = self.config.expert
                eng = KernelEngine(
                    self._kernel_params(), ex.kernel_capacity,
                    self._send_message, events=self.events,
                    fleet_stats_every=ex.fleet_stats_every,
                    pipeline_depth=ex.kernel_pipeline_depth,
                    health_top_k=ex.health_top_k,
                    health_thresholds=self._health_thresholds(),
                    invariant_probe=ex.invariant_probe,
                    capacity_watermark_pct=ex.capacity_watermark_pct,
                    capacity_budget_bytes=ex.capacity_device_budget_bytes,
                    device=self.device)
                eng.on_evict = self._on_kernel_evict
                self.kernel_engine = eng
            return self.kernel_engine

    def _health_thresholds(self):
        from dragonboat_tpu_torch.core import health as _health

        ex = self.config.expert
        return _health.HealthThresholds(
            leaderless_ticks=ex.health_leaderless_ticks,
            stall_ticks=ex.health_stall_ticks,
            lag_ticks=ex.health_lag_ticks,
            churn_trip=ex.health_churn_trip,
            runaway_ticks=ex.health_runaway_ticks)

    def _inject_kernel_shard(self, node, members: dict[int, str]) -> None:
        """Move a freshly-bootstrapped shard onto the device kernel: the
        pycore Peer built by node.start() provides the persisted state;
        its in-memory tail (bootstrap config changes) rides along."""
        self._ensure_kernel_engine()
        init = self._build_lane_init(node, members)
        self._inject_into_engine(self.kernel_engine, node, init,
                                 "device-resident")

    def _kernel_params(self, min_inbox: int = 0):
        from dragonboat_tpu_torch.core import params as KP

        ex = self.config.expert
        return KP.KernelParams(
            num_peers=ex.kernel_num_peers,
            log_cap=ex.kernel_log_cap,
            inbox_cap=max(ex.kernel_inbox_cap, min_inbox),
            msg_entries=ex.kernel_msg_entries,
            proposal_cap=ex.kernel_proposal_cap,
            readindex_cap=ex.kernel_readindex_cap,
            apply_batch=ex.kernel_apply_batch,
            compaction_overhead=ex.kernel_compaction_overhead,
            # platform-tuned read lowering (params.py onehot_reads),
            # picked from the engine's device as bench_loop.bench_params
            # does: the one-hot form on the card, indexing on the CPU
            onehot_reads=(self.device.type != "cpu"),
        )

    def _build_lane_init(self, node, members: dict[int, str]):
        """Capture persisted state from the bootstrapped pycore Peer and
        make it durable BEFORE a device engine takes over (the lane is
        injected with stable == last; idempotent on restart)."""
        from dragonboat_tpu_torch.core import params as KP
        from dragonboat_tpu_torch.engine.kernel_engine import _LaneInit

        raft = node.peer.raft
        log = raft.log
        first, last = log.first_index(), log.last_index()
        entries = log.get_entries(first, last + 1) if last >= first else []
        ss = self.logdb.get_snapshot(node.shard_id, node.replica_id)
        m = node.sm.get_membership()
        peers = ([(rid, KP.K_VOTER) for rid in sorted(m.addresses)]
                 + [(rid, KP.K_NON_VOTING) for rid in sorted(m.non_votings)]
                 + [(rid, KP.K_WITNESS) for rid in sorted(m.witnesses)])
        if not peers:
            peers = [(rid, KP.K_VOTER) for rid in sorted(members)]
        init = _LaneInit(
            term=raft.term, vote=raft.vote, committed=log.committed,
            applied=node.sm.get_last_applied(),
            snap_index=ss.index if ss is not None else 0,
            snap_term=ss.term if ss is not None else 0,
            entries=entries, peers=peers,
        )
        self.logdb.save_raft_state([pb.Update(
            shard_id=node.shard_id, replica_id=node.replica_id,
            state=pb.State(term=raft.term, vote=raft.vote,
                           commit=log.committed),
            entries_to_save=tuple(entries),
        )], worker_id=0)
        return init

    def _fallback_host_side(self, node, kind: str, err) -> None:
        """Run a shard host-side rather than leaving a dead device shard
        registered (its bootstrap state is already durable)."""
        node.peer = None
        self._on_kernel_evict(node, [])
        import logging

        logging.getLogger("dragonboat_tpu_torch.nodehost").warning(
            "shard %d: not %s (%s); running host-side",
            node.shard_id, kind, err)

    def _inject_into_engine(self, engine, node, init, kind: str) -> None:
        try:
            if len(init.entries) > engine.kp.log_cap:
                raise RequestError(
                    "log tail larger than the kernel ring")
            if len(init.peers) > engine.kp.num_peers:
                raise RequestError(
                    "membership larger than the kernel peer book")
            node.peer = None  # the lane owns the protocol state now
            node.on_evict_cb = self._on_kernel_evict
            engine.add_shard(node, init)
        except Exception as e:
            self._fallback_host_side(node, kind, e)

    def _inject_mesh_shard(self, node, members: dict[int, str]) -> None:
        """Place this replica onto the process-wide mesh engine (the mesh
        serving path, engine/mesh_engine.py): its peers are the other
        rows of its group, possibly attached by other NodeHosts sharing
        the MeshSpec."""
        from dragonboat_tpu_torch.engine.mesh_engine import attach_mesh_engine

        # persist the bootstrap state FIRST: every fallback below rebuilds
        # the shard host-side from the LogDB
        init = self._build_lane_init(node, members)
        spec = self.config.expert.mesh
        if self.mesh_engine is None:
            try:
                kp = self._kernel_params(min_inbox=5 * (spec.replicas - 1))
                self.mesh_engine = attach_mesh_engine(
                    kp, spec, events=self.events,
                    fleet_stats_every=self.config.expert.fleet_stats_every,
                    pipeline_depth=self.config.expert.kernel_pipeline_depth,
                    health_top_k=self.config.expert.health_top_k,
                    health_thresholds=self._health_thresholds(),
                    invariant_probe=self.config.expert.invariant_probe,
                    capacity_watermark_pct=(
                        self.config.expert.capacity_watermark_pct),
                    capacity_budget_bytes=(
                        self.config.expert.capacity_device_budget_bytes),
                    device=self.device)
            except Exception as e:
                # geometry, kernel params or device mismatch with an
                # already-attached engine
                self._fallback_host_side(node, "mesh-resident", e)
                return
        self._inject_into_engine(self.mesh_engine, node, init,
                                 "mesh-resident")

    def _on_kernel_evict(self, knode, carry: list[pb.Message]) -> None:
        """needs_host slow path: rebuild the shard as a host-resident
        pycore Node from the (already durable) LogDB state and keep every
        in-flight request future alive."""
        cfg = knode.cfg
        with self.mu:
            if self._stopped or self.nodes.get(cfg.shard_id) is not knode:
                return  # stopped/replaced concurrently — do not resurrect
        node = Node(cfg, self.logdb, knode.sm, self._send_message,
                    knode.snapshot_dir, events=self.events, fs=self.fs,
                    worker_id=cfg.shard_id % self._num_workers,
                    clock=self.logical_clock)
        node.membership_changed_cb = (
            lambda cc, sid=cfg.shard_id: self._on_membership_change(sid, cc))
        node.stream_snapshot_cb = self._stream_snapshot
        node.apply_pool = self._apply_pool
        # transplant the books so callers' futures survive the move
        for attr in ("pending_proposals", "pending_reads",
                     "pending_config_change", "pending_snapshot",
                     "pending_transfer", "pending_log_query",
                     "pending_compaction", "rate_limiter", "notify_commit"):
            setattr(node, attr, getattr(knode, attr))
        node.start({}, initial=False, new_node=False)
        for m in carry:
            node.handle_message(m)
        # atomic handoff: _moved is set under knode.mu, THEN the queues
        # and scalar requests are drained under the same lock — any later
        # ingress (Node._post) sees _moved and lands on the successor
        with knode.mu:
            knode._moved = node
            node.incoming_msgs.extend(knode.incoming_msgs)
            knode.incoming_msgs = []
            node.incoming_proposals.extend(knode.incoming_proposals)
            knode.incoming_proposals = []
            for f in ("config_change_entry", "transfer_target",
                      "snapshot_request", "log_query_range",
                      "compaction_request_key"):
                v = getattr(knode, f)
                if v is not None and getattr(node, f) is None:
                    setattr(node, f, v)
                setattr(knode, f, None)
            node._transfer_awaiting = knode._transfer_awaiting
            node._last_leader = (knode._leader_cache,
                                 knode._leader_term_cache)
        with self.mu:
            if self.nodes.get(cfg.shard_id) is knode:
                self.nodes[cfg.shard_id] = node
                self._nodes_dirty = True
            # else: stop_replica raced us and already destroyed the books
        self._work.set()

    stop_shard = stop_replica

    # -- engine ---------------------------------------------------------

    def _engine_main(self) -> None:
        """Ticker + work fan-out (the reference's nodeTicker plus the
        signal side of the worker ready queues, engine.go:1107+)."""
        last_tick = time.monotonic()
        while not self._stopped:
            self._work.wait(timeout=self._tick_interval / 4)
            self._work.clear()
            now = time.monotonic()
            if now - last_tick >= self._tick_interval:
                last_tick = now
                self._do_tick_round()
                self.chunk_sink.tick()
            for w in self._refresh_host_workers():
                self._worker_events[w].set()

    def _refresh_host_workers(self) -> set[int]:
        """The workers that step a host-resident node, worker 0 always;
        recounted only after the node set changed."""
        from dragonboat_tpu_torch.engine.kernel_engine import KernelNode

        with self.mu:
            if self._nodes_dirty:
                self._nodes_dirty = False
                self._host_workers = {0} | {
                    sid % self._num_workers for sid, n in self.nodes.items()
                    if not isinstance(n, KernelNode)}
            return self._host_workers

    def _worker_main(self, w: int) -> None:
        """One step worker: advances the shards hashed to partition w
        (shard_id % workers), plus the kernel engine on worker 0."""
        ev = self._worker_events[w]
        while not self._stopped:
            # an idle worker is woken by _engine_main or by close()
            ev.wait(timeout=self._tick_interval / 2
                    if w in self._host_workers else None)
            ev.clear()
            progressed = True
            while progressed and not self._stopped:
                progressed = False
                with self.mu:
                    nodes = [n for sid, n in self.nodes.items()
                             if sid % self._num_workers == w]
                for n in nodes:
                    try:
                        if n.step():
                            progressed = True
                    except OSError as e:
                        self._on_fatal(e)
                        return
                    except Exception:
                        _LOG.exception("shard %d step failed", n.shard_id)
                if w == 0:
                    for eng in (self.kernel_engine, self.mesh_engine):
                        if eng is None:
                            continue
                        try:
                            if eng.step_all():
                                progressed = True
                        except OSError as e:
                            self._on_fatal(e)
                            return
                        except Exception:
                            _LOG.exception("device engine step failed")

    def run_once(self) -> int:
        """Step every node until quiescent; returns steps executed."""
        steps = 0
        progressed = True
        while progressed and not self._stopped:
            progressed = False
            with self.mu:
                nodes = list(self.nodes.values())
            for n in nodes:
                try:
                    if n.step():
                        progressed = True
                        steps += 1
                except OSError as e:
                    self._on_fatal(e)
                    return steps
                except Exception:
                    _LOG.exception("shard %d step failed", n.shard_id)
            for eng in (self.kernel_engine, self.mesh_engine):
                if eng is None:
                    continue
                try:
                    if eng.step_all():
                        progressed = True
                        steps += 1
                except OSError as e:
                    self._on_fatal(e)
                    return steps
                except Exception:
                    _LOG.exception("device engine step failed")
        return steps

    def _on_fatal(self, exc: Exception) -> None:
        """Controlled crash on a storage failure: a raft log or snapshot
        write that did not reach stable storage voids every ack sent after
        it, so the host stops stepping immediately (the reference panics
        the process; a library records the fault and halts —
        nodehost.go:361-367 ErrorFS crash arming)."""
        with self.mu:
            if self.fatal_error is None:
                self.fatal_error = exc
            self._stopped = True
        _LOG.critical("storage failure, halting NodeHost: %s", exc)
        self._work.set()
        for ev in self._worker_events:
            ev.set()

    def _do_tick_round(self, sweep_every: int = 8) -> None:
        """One tick round: advance the shared clock ONCE, tick the
        host-resident nodes, and hand engine-registered lanes to their
        engine as a single pending round (consumed as one vectorized
        [G]-bool broadcast at the next device step).  Per-lane Python
        here was the 100k election pump's wall clock (~25 s/round);
        request-timeout GC over engine lanes is an amortized sweep
        (books compare absolute deadline stamps, so skipped rounds
        cannot drift the deadline — only delay its firing by at most
        ``sweep_every`` rounds)."""
        self.logical_clock.advance()
        self._tick_round_no += 1
        sweep = (self._tick_round_no % sweep_every) == 0
        with self.mu:
            nodes = list(self.nodes.values())
        for n in nodes:
            if getattr(n, "engine", None) is not None and n.lane >= 0:
                if sweep:
                    n.gc_books()
                continue
            n.tick()
        for eng in (self.kernel_engine, self.mesh_engine):
            if eng is not None:
                eng.tick_round()
        self._control_round()

    def tick_all(self) -> None:
        """Manual tick for auto_run=False test drivers (books GC every
        round — deterministic timeouts for tests)."""
        self._do_tick_round(sweep_every=1)

    def _control_round(self) -> None:
        """Close the observe→act loop once per NEW decimated health
        observation: feed the kernel engine's cached top-K digest (plus
        the step-latency EWMA) to the FleetController and apply the
        planned transfers.  Runs on the engine ticker thread, outside
        engine.mu (lock order engine.mu -> node.mu: the transfer call
        takes node locks, so it must never run under the engine's)."""
        eng = self.kernel_engine
        if eng is None or not self._controller.policy.enabled:
            return
        seq = int(getattr(eng, "_health_seq", 0))
        if seq <= self._ctrl_seen_seq:
            return            # no new observation since the last plan
        self._ctrl_seen_seq = seq
        health = getattr(eng, "last_health", None) or {}
        worst = health.get("worst", [])
        lanes = {int(w.get("lane", -1)) for w in worst}
        hot_us = self.config.expert.control_hot_ewma_us
        host_hot = bool(hot_us) and int(self.events.metrics.snapshot().get(
            "engine.kernel_step.ewma_us", 0)) >= hot_us
        # digest offenders are the candidate set — except under host-
        # level overload, where every led shard qualifies (the planner's
        # host_hot semantics), so the snapshot must include them all
        with self.mu:
            nodes = [n for n in self.nodes.values()
                     if getattr(n, "engine", None) is eng
                     and (host_hot or getattr(n, "lane", -1) in lanes)]
        shards = []
        for n in nodes:
            try:
                mb = n.sm.get_membership()
                shards.append({
                    "shard_id": int(n.shard_id),
                    "replica_id": int(n.replica_id),
                    "lane": int(n.lane),
                    "is_leader": bool(n.is_leader()),
                    "term": int(n.node_term()),
                    "membership": {"addresses": {
                        int(r): str(a) for r, a in mb.addresses.items()}},
                })
            except Exception:
                continue      # torn down mid-plan: skip this round's row
        from dragonboat_tpu_torch import flight as _flight

        for d in self._controller.observe(worst, shards,
                                          host_hot=host_hot):
            _flight.record(_flight.CONTROL_TRANSFER,
                           tick=self._tick_round_no, shard_id=d.shard_id,
                           target=d.target, evidence=d.evidence)
            try:
                self.request_leader_transfer(d.shard_id, d.target)
                self.events.metrics.inc("control_transfer_issued")
            except RequestError as e:
                self.events.metrics.inc("control_transfer_failed")
                _LOG.warning("control transfer shard %d -> %d failed: %s",
                             d.shard_id, d.target, e)

    def _stream_snapshot(self, node: Node, m: pb.Message) -> None:
        """Live-stream an on-disk SM's snapshot to a lagging peer
        (nodehost.go:1888-1891 → rsm.ChunkWriter + transport job.go):
        the image is produced by the SM directly into transport chunks —
        no sender-side file.  Runs as a background job so a large stream
        never stalls the step workers."""
        import queue as _queue

        from dragonboat_tpu_torch.rsm.chunkwriter import ChunkWriter

        class _Aborted(Exception):
            pass

        def job() -> None:
            q: _queue.Queue = _queue.Queue(maxsize=8)
            DONE, FAIL = object(), object()
            aborted = threading.Event()

            def emit(c) -> None:
                # never block forever: if the consumer abandoned the
                # stream (breaker open, send error), the producer must
                # unwind instead of deadlocking inside the SM lock
                while not aborted.is_set():
                    try:
                        q.put(c, timeout=0.2)
                        return
                    except _queue.Full:
                        continue
                raise _Aborted()

            cw = ChunkWriter(
                emit, shard_id=node.shard_id, to_replica=m.to,
                from_=node.replica_id,
                deployment_id=self.config.deployment_id,
                source_address=self.config.raft_address,
            )

            def on_meta(index, term, membership):
                from dataclasses import replace

                cw.index, cw.term = index, term
                cw.message = replace(m, snapshot=pb.Snapshot(
                    index=index, term=term, membership=membership,
                    shard_id=node.shard_id, type=node.sm.sm_type,
                    on_disk_index=index,
                ))

            def producer() -> None:
                try:
                    node.sm.stream_snapshot(cw, on_meta=on_meta)
                    cw.close()
                    q.put(DONE)
                except _Aborted:
                    pass  # consumer gone; nothing to report
                except Exception:
                    _LOG.exception("snapshot stream save failed")
                    # deliver FAIL with the same patience as emit: the
                    # consumer may be paced; dropping it would leave the
                    # consumer blocked in q.get() forever
                    while not aborted.is_set():
                        try:
                            q.put(FAIL, timeout=0.2)
                            break
                        except _queue.Full:
                            continue

            t = threading.Thread(target=producer, name="snapshot-save-stream",
                                 daemon=True)
            t.start()

            def chunks():
                while True:
                    item = q.get()
                    if item is DONE:
                        return
                    if item is FAIL:
                        raise RuntimeError("stream producer failed")
                    yield item

            try:
                self.hub.send_snapshot_chunks(m, chunks())
            finally:
                # unwind the producer whether or not the send completed
                aborted.set()
                while t.is_alive():
                    try:
                        q.get_nowait()
                    except _queue.Empty:
                        pass
                    t.join(timeout=0.05)

        threading.Thread(target=job, name="snapshot-stream-job",
                         daemon=True).start()

    # -- transport glue --------------------------------------------------

    def _send_message(self, m: pb.Message) -> None:
        if self._partitioned:
            return  # monkey partition: silence sends (nodehost.go:1877)
        self.hub.send(m)
        self._work.set()

    def _handle_message_batch(self, batch: pb.MessageBatch) -> None:
        """Inbound dispatch (messageHandler.HandleMessageBatch,
        nodehost.go:2072)."""
        if batch.deployment_id != self.config.deployment_id:
            return  # transport.go:306-311 deployment-id gate
        if self._partitioned:
            return  # monkey partition: silence receive (nodehost.go:2076)
        # learn the sender's address so responses resolve even before any
        # membership entry applies locally (transport.go:317-324).  Not in
        # gossip mode: targets there are NodeHostIDs, and pinning a raw
        # address would permanently bypass gossip re-resolution after the
        # sender moves
        if batch.source_address and not self.config.address_by_node_host_id:
            for m in batch.requests:
                if m.from_ != 0:
                    self.registry.add(m.shard_id, m.from_, batch.source_address)
        # fabric inbound seam: BOTH transports funnel here, so one call
        # covers per-link recv accounting, delivery latency off the
        # header's sender stamp, hub_recv span stamping (the round 7 fix),
        # and the remote child span + hop-census bookkeeping.  The byte
        # estimate mirrors the hub's send-side _msg_size so the two ends
        # of a link stay comparable
        fabric.METER.on_batch_received(
            self.config.raft_address, batch,
            nbytes=sum(_msg_size(m) for m in batch.requests))
        for m in batch.requests:
            with self.mu:
                node = self.nodes.get(m.shard_id)
            if node is not None:
                # hub delivery skips links the mesh serves: a resident
                # link's copy is a stray (the exchange already carried
                # it) and accepting it would double-deliver; cut links
                # and off-mesh senders keep the hub as their carrier
                eng = self.mesh_engine
                if (eng is not None
                        and getattr(node, "engine", None) is eng
                        and not eng.hub_accepts(node, m)):
                    continue
                node.handle_message(m)
        self._work.set()

    def _on_snapshot_reassembled(self, m: pb.Message,
                                 source_address: str) -> None:
        """A chunk stream completed: deliver the rebuilt InstallSnapshot
        (chunk.go:106 → nodehost.go:2072 handoff).  The sender address rides
        chunk 0 so a joining replica can respond before any membership
        entry applies locally."""
        self.events.snapshot_received(SnapshotInfo(
            shard_id=m.shard_id, replica_id=m.to, from_=m.from_,
            index=m.snapshot.index, term=m.snapshot.term))
        self._handle_message_batch(pb.MessageBatch(
            requests=(m,), deployment_id=self.config.deployment_id,
            source_address=source_address))

    def _on_unreachable(self, m: pb.Message) -> None:
        with self.mu:
            node = self.nodes.get(m.shard_id)
        if node is not None:
            node.handle_message(m)

    def _on_membership_change(self, shard_id: int, cc: pb.ConfigChange) -> None:
        if cc.type in (pb.ConfigChangeType.ADD_NODE,
                       pb.ConfigChangeType.ADD_NON_VOTING,
                       pb.ConfigChangeType.ADD_WITNESS) and cc.address:
            self.registry.add(shard_id, cc.replica_id, cc.address)
        elif cc.type == pb.ConfigChangeType.REMOVE_NODE:
            self.registry.remove(shard_id, cc.replica_id)
        with self.mu:
            node = self.nodes.get(shard_id)
        if node is not None:
            self.events.membership_changed(
                NodeInfo(shard_id, node.replica_id))
            if (cc.type == pb.ConfigChangeType.REMOVE_NODE
                    and cc.replica_id == node.replica_id):
                self.events.node_deleted(NodeInfo(shard_id, node.replica_id))

    # -- helpers ---------------------------------------------------------

    def _node(self, shard_id: int) -> Node:
        # fail fast after a controlled crash: workers no longer step, so
        # every request would otherwise ride its full timeout
        if self.fatal_error is not None:
            raise RequestError(
                f"node host halted by storage failure: {self.fatal_error}")
        with self.mu:
            node = self.nodes.get(shard_id)
        if node is None:
            raise ShardNotFoundError(f"shard {shard_id} not found")
        return node

    def _ticks(self, timeout_s: float) -> int:
        return max(2, int(timeout_s * 1000 / self.config.rtt_millisecond))

    # -- client API: writes ----------------------------------------------

    def propose(self, session: Session, cmd: bytes,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> RequestState:
        node = self._node(session.shard_id)
        rs = node.propose(session, cmd, self._ticks(timeout_s))
        self._work.set()
        return rs

    def sync_propose(self, session: Session, cmd: bytes,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Result:
        rs = self.propose(session, cmd, timeout_s)
        result = rs.get(timeout_s)
        # acked-write accounting: rs.get raised on anything but a
        # committed+applied proposal, so this counts exactly the writes
        # a client may rely on (the chaos telemetry invariant checks it
        # against the oracle's committed-entry count)
        self.events.metrics.inc("raft.proposals_acked")
        if not session.is_noop_session():
            session.proposal_completed()
        return result

    # -- client API: sessions --------------------------------------------

    def sync_get_session(self, shard_id: int,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> Session:
        s = Session.new_session(shard_id)
        s.prepare_for_register()
        node = self._node(shard_id)
        rs = node.propose_session_op(s, self._ticks(timeout_s))
        self._work.set()
        rs.get(timeout_s)
        s.prepare_for_propose()
        return s

    def sync_close_session(self, session: Session,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        session.prepare_for_unregister()
        node = self._node(session.shard_id)
        rs = node.propose_session_op(session, self._ticks(timeout_s))
        self._work.set()
        rs.get(timeout_s)

    def get_noop_session(self, shard_id: int) -> Session:
        return Session.new_noop_session(shard_id)

    # -- client API: reads -----------------------------------------------

    def read_index(self, shard_id: int,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> RequestState:
        node = self._node(shard_id)
        rs = node.read(self._ticks(timeout_s))
        self._work.set()
        return rs

    def read_local_node(self, shard_id: int, query: object) -> object:
        return self._node(shard_id).sm.lookup(query)

    def na_read_local_node(self, shard_id: int, query: object) -> object:
        """NAReadLocalNode (nodehost.go:877): the no-copy byte-slice
        variant — Python has no owned/borrowed distinction, so this is
        read_local_node under the reference's name."""
        return self.read_local_node(shard_id, query)

    def get_log_reader(self, shard_id: int):
        """GetLogReader (nodehost.go:617): the shard's read-only log
        reader (first/last index, term lookups, entry ranges)."""
        return self._node(shard_id).log_reader

    def get_node_host_registry(self):
        """GetNodeHostRegistry (nodehost.go:463): (registry, ok) — ok
        only when gossip addressing is active (the registry then carries
        other hosts' metadata)."""
        from dragonboat_tpu_torch.gossip import GossipRegistry

        return self.registry, isinstance(self.registry, GossipRegistry)

    @property
    def raft_address(self) -> str:
        """RaftAddress (nodehost.go:447)."""
        return self.config.raft_address

    def get_node_user(self, shard_id: int) -> "NodeUser":
        """GetNodeUser (nodehost.go:1324): a per-shard handle bundling
        propose/read_index for one shard (INodeUser API shape; calls
        resolve the shard live so eviction/stop is always respected)."""
        self._node(shard_id)  # raises ShardNotFoundError when absent
        return NodeUser(self, shard_id)

    def sync_read(self, shard_id: int, query: object,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> object:
        rs = self.read_index(shard_id, timeout_s)
        rs.get(timeout_s)
        return self.read_local_node(shard_id, query)

    def stale_read(self, shard_id: int, query: object) -> object:
        """StaleRead (nodehost.go:894): local lookup, no linearizability."""
        return self.read_local_node(shard_id, query)

    # -- membership ------------------------------------------------------

    def _sync_request_config_change(
        self, shard_id: int, cc_type: pb.ConfigChangeType, replica_id: int,
        target: str, config_change_index: int, timeout_s: float,
    ) -> None:
        rs = self._request_config_change(
            shard_id, cc_type, replica_id, target, config_change_index,
            timeout_s)
        rs.get(timeout_s)

    def sync_request_add_replica(self, shard_id: int, replica_id: int,
                                 target: str, config_change_index: int = 0,
                                 timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        self._sync_request_config_change(
            shard_id, pb.ConfigChangeType.ADD_NODE, replica_id, target,
            config_change_index, timeout_s)

    def sync_request_add_nonvoting(self, shard_id: int, replica_id: int,
                                   target: str, config_change_index: int = 0,
                                   timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        self._sync_request_config_change(
            shard_id, pb.ConfigChangeType.ADD_NON_VOTING, replica_id, target,
            config_change_index, timeout_s)

    def sync_request_add_witness(self, shard_id: int, replica_id: int,
                                 target: str, config_change_index: int = 0,
                                 timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        self._sync_request_config_change(
            shard_id, pb.ConfigChangeType.ADD_WITNESS, replica_id, target,
            config_change_index, timeout_s)

    def sync_request_delete_replica(self, shard_id: int, replica_id: int,
                                    config_change_index: int = 0,
                                    timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        self._sync_request_config_change(
            shard_id, pb.ConfigChangeType.REMOVE_NODE, replica_id, "",
            config_change_index, timeout_s)

    def sync_get_shard_membership(self, shard_id: int,
                                  timeout_s: float = DEFAULT_TIMEOUT_S
                                  ) -> pb.Membership:
        rs = self.read_index(shard_id, timeout_s)
        rs.get(timeout_s)
        return self._node(shard_id).sm.get_membership()

    def get_shard_membership(self, shard_id: int) -> pb.Membership:
        return self._node(shard_id).sm.get_membership()

    # -- async request variants (nodehost.go:963-1238: the Request*
    # family returns the future; the Sync* family above waits on it) ----

    def request_snapshot(self, shard_id: int,
                         timeout_s: float = DEFAULT_TIMEOUT_S,
                         export_path: str = "",
                         compaction_overhead: int | None = None
                         ) -> RequestState:
        """RequestSnapshot (nodehost.go:963) — the async variant."""
        node = self._node(shard_id)
        req = _SnapshotRequest(
            exported=bool(export_path),
            path=export_path,
            override_compaction=compaction_overhead is not None,
            compaction_overhead=compaction_overhead or 0,
        )
        rs = node.request_snapshot(req, self._ticks(timeout_s))
        self._work.set()
        return rs

    def request_compaction(self, shard_id: int,
                           timeout_s: float = DEFAULT_TIMEOUT_S
                           ) -> RequestState:
        """RequestCompaction (nodehost.go:993) — the async variant."""
        rs = self._node(shard_id).request_compaction(self._ticks(timeout_s))
        self._work.set()
        return rs

    def _request_config_change(
        self, shard_id: int, cc_type: pb.ConfigChangeType, replica_id: int,
        target: str, config_change_index: int, timeout_s: float,
    ) -> RequestState:
        node = self._node(shard_id)
        cc = pb.ConfigChange(
            config_change_id=config_change_index,
            type=cc_type, replica_id=replica_id, address=target,
        )
        rs = node.request_config_change(cc, self._ticks(timeout_s))
        self._work.set()
        return rs

    def request_add_replica(self, shard_id: int, replica_id: int,
                            target: str, config_change_index: int = 0,
                            timeout_s: float = DEFAULT_TIMEOUT_S
                            ) -> RequestState:
        return self._request_config_change(
            shard_id, pb.ConfigChangeType.ADD_NODE, replica_id, target,
            config_change_index, timeout_s)

    def request_add_nonvoting(self, shard_id: int, replica_id: int,
                              target: str, config_change_index: int = 0,
                              timeout_s: float = DEFAULT_TIMEOUT_S
                              ) -> RequestState:
        return self._request_config_change(
            shard_id, pb.ConfigChangeType.ADD_NON_VOTING, replica_id,
            target, config_change_index, timeout_s)

    def request_add_witness(self, shard_id: int, replica_id: int,
                            target: str, config_change_index: int = 0,
                            timeout_s: float = DEFAULT_TIMEOUT_S
                            ) -> RequestState:
        return self._request_config_change(
            shard_id, pb.ConfigChangeType.ADD_WITNESS, replica_id, target,
            config_change_index, timeout_s)

    def request_delete_replica(self, shard_id: int, replica_id: int,
                               config_change_index: int = 0,
                               timeout_s: float = DEFAULT_TIMEOUT_S
                               ) -> RequestState:
        return self._request_config_change(
            shard_id, pb.ConfigChangeType.REMOVE_NODE, replica_id, "",
            config_change_index, timeout_s)

    def propose_session(self, session: Session,
                        timeout_s: float = DEFAULT_TIMEOUT_S
                        ) -> RequestState:
        """ProposeSession (nodehost.go:816): propose the session's
        current lifecycle op (the caller prepared it for register or
        unregister) and return the future."""
        node = self._node(session.shard_id)
        rs = node.propose_session_op(session, self._ticks(timeout_s))
        self._work.set()
        return rs

    # -- leadership ------------------------------------------------------

    def request_leader_transfer(self, shard_id: int, target: int) -> None:
        node = self._node(shard_id)
        node.request_leader_transfer(target, self._ticks(DEFAULT_TIMEOUT_S))
        self._work.set()

    def get_leader_id(self, shard_id: int) -> tuple[int, bool]:
        node = self._node(shard_id)
        lid = node.leader_id()
        return lid, lid != 0

    # -- snapshots -------------------------------------------------------

    def sync_request_snapshot(self, shard_id: int,
                              timeout_s: float = DEFAULT_TIMEOUT_S,
                              export_path: str = "",
                              compaction_overhead: int | None = None) -> int:
        rs = self.request_snapshot(shard_id, timeout_s,
                                   export_path=export_path,
                                   compaction_overhead=compaction_overhead)
        r = rs.wait(timeout_s)
        if r.code != RequestResultCode.COMPLETED:
            raise RequestError(f"snapshot failed: {r.code.name}")
        return r.snapshot_index

    def sync_request_compaction(self, shard_id: int,
                                timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        """SyncRequestCompaction: LogDB compaction up to the snapshotter's
        compacted-to index, processed on the engine thread
        (nodehost.go RequestCompaction → node.go:972)."""
        rs = self.request_compaction(shard_id, timeout_s)
        r = rs.wait(timeout_s)
        if r.code == RequestResultCode.REJECTED:
            raise RequestRejectedError(
                "nothing to compact (no snapshot taken yet)")
        if r.code != RequestResultCode.COMPLETED:
            raise RequestError(f"compaction failed: {r.code.name}")

    def remove_data(self, shard_id: int, replica_id: int) -> None:
        """RemoveData (nodehost.go:1295): purge a stopped replica's
        state; raises while the shard is still running."""
        with self.mu:
            if shard_id in self.nodes:
                raise RequestError("shard still running")
        self.logdb.remove_node_data(shard_id, replica_id)

    def sync_remove_data(self, shard_id: int, replica_id: int,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        """SyncRemoveData (nodehost.go:1259)."""
        self.remove_data(shard_id, replica_id)

    # -- log queries -----------------------------------------------------

    def query_raft_log(self, shard_id: int, first: int, last: int,
                       max_size: int = 0,
                       timeout_s: float = DEFAULT_TIMEOUT_S):
        """QueryRaftLog (nodehost.go:781): the request rides the engine's
        step loop and the result comes back on the Update path
        (node.go:1238 handleLogQuery → node.go:319 processLogQuery)."""
        node = self._node(shard_id)
        rs = node.query_raft_log(first, last, max_size,
                                 self._ticks(timeout_s))
        self._work.set()
        r = rs.wait(timeout_s)
        if r.code == RequestResultCode.COMPLETED:
            return rs.log_query_result
        if r.code == RequestResultCode.REJECTED:
            raise RequestError("log query out of range")
        raise RequestError(f"log query failed: {r.code.name}")

    # -- info ------------------------------------------------------------

    def _local_shard_views(self):
        """This host's shards as ShardViews for the gossip exchange
        (view.go:77 toShardViewList): replica addresses come from the
        replicated membership, leadership from the live node (a
        device-resident node reads the engine's leader edge)."""
        from dragonboat_tpu_torch.gossip import ShardView

        with self.mu:
            nodes = list(self.nodes.values())
        out = []
        for n in nodes:
            mb = n.sm.get_membership()
            out.append(ShardView(
                shard_id=n.shard_id,
                replicas=dict(mb.addresses),
                config_change_index=mb.config_change_id,
                leader_id=n.leader_id(),
                term=n.node_term(),
            ))
        return out

    def get_node_host_info(self) -> NodeHostInfo:
        with self.mu:
            nodes = list(self.nodes.values())
        infos = [
            ShardInfo(
                shard_id=n.shard_id,
                replica_id=n.replica_id,
                leader_id=n.leader_id(),
                term=n.node_term(),
                is_leader=n.is_leader(),
                membership=n.sm.get_membership(),
                last_applied=n.sm.get_last_applied(),
            )
            for n in nodes
        ]
        return NodeHostInfo(
            node_host_id=self.id,
            raft_address=self.config.raft_address,
            shard_info_list=infos,
        )

    @staticmethod
    def _membership_dict(mb) -> dict:
        return {
            "addresses": {int(r): str(a) for r, a in mb.addresses.items()},
            "non_votings": {int(r): str(a)
                            for r, a in mb.non_votings.items()},
            "witnesses": {int(r): str(a) for r, a in mb.witnesses.items()},
            "config_change_id": int(mb.config_change_id),
        }

    def info(self) -> dict:
        """JSON-able ``NodeHostInfo`` parity view plus the merged health
        snapshot — the ``/debug/groups`` payload and ``fleet_doctor``'s
        per-host input.  Same shard fields as ``get_node_host_info``,
        with each shard's residency (host / device / mesh) attached."""
        nhi = self.get_node_host_info()
        with self.mu:
            nodes = dict(self.nodes)
        shards = []
        for si in nhi.shard_info_list:
            n = nodes.get(si.shard_id)
            shards.append({
                "shard_id": int(si.shard_id),
                "replica_id": int(si.replica_id),
                "leader_id": int(si.leader_id),
                "term": int(si.term),
                "is_leader": bool(si.is_leader),
                "last_applied": int(si.last_applied),
                "membership": self._membership_dict(si.membership),
                "resident": self._residency(n),
                "lane": int(getattr(n, "lane", -1)),
            })
        return {
            "node_host_id": nhi.node_host_id,
            "raft_address": nhi.raft_address,
            "health": self._health_snapshot(),
            "capacity": self._capacity_snapshot(),
            "fleet": self._fleet_snapshot(),
            "fabric": fabric.METER.snapshot(),
            "shards": shards,
        }

    def _residency(self, node) -> str:
        eng = getattr(node, "engine", None)
        if eng is None:
            return "host"
        return "mesh" if eng is self.mesh_engine else "device"

    def _shard_info_or_none(self, shard_id: int) -> dict | None:
        """HTTP-callback form of ``shard_info``: None for a 404 instead
        of a raised ShardNotFoundError."""
        try:
            return self.shard_info(shard_id)
        except (ShardNotFoundError, RequestError):
            return None

    def shard_info(self, shard_id: int) -> dict:
        """Drill-down for ONE group: the device row fetched O(1) by
        dynamic_index (never a full-state materialization) merged with
        every host-side register — pending books, logdb range + snapshot
        meta, peer breaker states, and this host's gossip ShardView."""
        node = self._node(shard_id)
        mb = node.sm.get_membership()
        reads = node.pending_reads
        with reads.mu:
            reads_pending = (len(reads.batching)
                             + sum(len(v) for v in reads.pending.values())
                             + len(reads.waiting))
        info = {
            "shard_id": int(shard_id),
            "replica_id": int(node.replica_id),
            "leader_id": int(node.leader_id()),
            "term": int(node.node_term()),
            "is_leader": bool(node.is_leader()),
            "last_applied": int(node.sm.get_last_applied()),
            "membership": self._membership_dict(mb),
            "resident": self._residency(node),
            "pending": {
                "proposals": len(node.pending_proposals.pending),
                "read_indexes": reads_pending,
            },
        }
        rs = self.logdb.read_raft_state(shard_id, node.replica_id, 0)
        ss = self.logdb.get_snapshot(shard_id, node.replica_id)
        info["logdb"] = {
            "first_index": int(rs.first_index) if rs is not None else 0,
            "last_index": (int(rs.first_index + rs.entry_count - 1)
                           if rs is not None else 0),
            "entry_count": int(rs.entry_count) if rs is not None else 0,
            "snapshot": ({"index": int(ss.index), "term": int(ss.term)}
                         if ss is not None and ss.index else None),
        }
        me = self.config.raft_address
        info["breakers"] = {
            str(addr): self.hub.breaker(addr).state()
            for addr in sorted(set(mb.addresses.values()))
            if addr and addr != me
        }
        info["shard_view"] = {
            "shard_id": int(shard_id),
            "replicas": {int(r): str(a) for r, a in mb.addresses.items()},
            "config_change_index": int(mb.config_change_id),
            "leader_id": int(node.leader_id()),
            "term": int(node.node_term()),
        }
        eng = getattr(node, "engine", None)
        info["device"] = (eng.health_row(node.lane)
                          if eng is not None else None)
        return info

    def has_node_info(self, shard_id: int, replica_id: int) -> bool:
        return self.logdb.get_bootstrap_info(shard_id, replica_id) is not None

    def metrics(self) -> dict[str, int]:
        """Counter snapshot (the reference's Prometheus surface); the
        transport hub shares the same registry under ``transport.*``."""
        return self.events.metrics.snapshot()

    # -- chaos-test surface (monkey.go, build tag dragonboat_monkeytest) --

    def partition_node(self) -> None:
        """Silence this host's sends AND receives (monkey.go:170
        PartitionNode): the cluster sees a dead machine while local
        clients keep timing out against it."""
        self._partitioned = True
        t = self.transport
        if hasattr(t, "partitioned"):
            t.partitioned = True
        self._set_mesh_partitioned(True)

    def restore_partitioned_node(self) -> None:
        """monkey.go:178 RestorePartitionedNode."""
        self._partitioned = False
        t = self.transport
        if hasattr(t, "partitioned"):
            t.partitioned = False
        self._set_mesh_partitioned(False)
        self._work.set()

    def _set_mesh_partitioned(self, cut: bool) -> None:
        """Mesh traffic never crosses the host transport, so a monkey
        partition of this host also masks its mesh rows device-side."""
        if self.mesh_engine is None:
            return
        with self.mu:
            nodes = list(self.nodes.values())
        for n in nodes:
            if getattr(n, "engine", None) is self.mesh_engine:
                self.mesh_engine.set_partitioned(n, cut)

    def _set_mesh_hub_served(self, served: bool) -> None:
        """Force every mesh link of THIS host's replicas onto the hub
        (symmetrically, both endpoints) so transport faults — drop,
        delay — apply to its consensus traffic like any other hub
        traffic.  Healing restores the links resident; a concurrent
        fault on a peer's host sharing a link is healed with it (chaos
        plans schedule soft transport faults one host at a time)."""
        eng = self.mesh_engine
        if eng is None:
            return
        with self.mu:
            nodes = list(self.nodes.values())
        for n in nodes:
            if getattr(n, "engine", None) is not eng:
                continue
            for rid in range(1, eng.spec.replicas + 1):
                if rid != n.replica_id:
                    eng.set_link_hub_served(n, rid, served)

    def get_session_hash(self, shard_id: int) -> int:
        """Convergence oracle over the session book (monkey.go:117)."""
        return self._node(shard_id).sm.get_session_hash()

    def get_membership_hash(self, shard_id: int) -> int:
        """Convergence oracle over membership (monkey.go:118)."""
        return self._node(shard_id).sm.get_membership_hash()

    def get_sm_hash(self, shard_id: int) -> int:
        """User-SM convergence oracle (monkey.go:114 GetStateMachineHash);
        the user SM must expose ``get_hash() -> int``."""
        sm = self._node(shard_id).sm.sm
        get_hash = getattr(sm, "get_hash", None)
        if get_hash is None:
            raise RequestError(
                "state machine does not implement get_hash()")
        return int(get_hash())


class NodeUser:
    """Per-shard client handle (nodehost.go:1324 GetNodeUser /
    INodeUser): Propose and ReadIndex bound to one shard; the futures
    are the same RequestStates the NodeHost API returns."""

    __slots__ = ("_nh", "shard_id")

    def __init__(self, nh: NodeHost, shard_id: int) -> None:
        self._nh = nh
        self.shard_id = shard_id

    def propose(self, session: Session, cmd: bytes,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> RequestState:
        if session.shard_id != self.shard_id:
            raise RequestError("session targets a different shard")
        return self._nh.propose(session, cmd, timeout_s)

    def read_index(self, timeout_s: float = DEFAULT_TIMEOUT_S
                   ) -> RequestState:
        return self._nh.read_index(self.shard_id, timeout_s)
