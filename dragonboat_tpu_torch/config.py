"""Config / NodeHostConfig — parity with the reference's config package
(``config/config.go:58-198`` per-shard Config, ``:300+`` NodeHostConfig,
``Expert`` engine knobs ``:887-899``)."""

from __future__ import annotations

from dataclasses import dataclass, field


class ConfigError(ValueError):
    pass


@dataclass
class Config:
    """Per-shard raft configuration (config/config.go:58-198)."""

    replica_id: int = 0
    shard_id: int = 0
    check_quorum: bool = False
    pre_vote: bool = False
    election_rtt: int = 10
    heartbeat_rtt: int = 1
    snapshot_entries: int = 0        # 0 disables auto snapshots
    compaction_overhead: int = 0
    ordered_config_change: bool = False
    max_in_mem_log_size: int = 0     # 0 = unlimited
    is_non_voting: bool = False
    is_witness: bool = False
    quiesce: bool = False
    wait_ready: bool = False
    disable_auto_compaction: bool = False
    # compression envelope for snapshot files (config.CompressionType
    # Snappy analog; V3 per-block zlib in rsm/snapshotio.py)
    snapshot_compression: bool = False
    # per-shard proposal-payload compression (config.go:161
    # EntryCompressionType): "no-compression" (default), "snappy"
    # (go-wire interoperable — the reference's dio snappy block), or
    # "zlib" (repo extension: C-fast, NOT understood by Go fleets).
    # Applied at propose time (EncodedEntry envelope, rsm/encoded.py),
    # unwrapped at apply on every replica.
    entry_compression: str = "no-compression"
    # TPU-native surface: run this shard as a lane of the host's batched
    # device kernel instead of a host-Python Peer (engine/kernel_engine.py)
    device_resident: bool = False
    # run this shard's replica as a row of the process-wide multi-chip
    # mesh engine (ExpertConfig.mesh places it; engine/mesh_engine.py) —
    # replicas live on different devices and exchange messages over ICI
    mesh_resident: bool = False

    def validate(self) -> None:
        if self.replica_id == 0:
            raise ConfigError("invalid ReplicaID")
        if self.shard_id == 0:
            raise ConfigError("invalid ShardID")
        if self.heartbeat_rtt == 0:
            raise ConfigError("HeartbeatRTT must be > 0")
        if self.election_rtt == 0 or self.election_rtt <= 2 * self.heartbeat_rtt:
            raise ConfigError(
                "ElectionRTT must be > 2 * HeartbeatRTT"
            )
        if self.is_witness and self.snapshot_entries > 0:
            raise ConfigError("witness can not take snapshots")
        if self.is_witness and self.is_non_voting:
            raise ConfigError("witness can not be a non-voting member")
        if self.max_in_mem_log_size != 0 and self.max_in_mem_log_size < 256:
            raise ConfigError("MaxInMemLogSize must be >= 256")
        from dragonboat_tpu_torch.rsm.encoded import COMPRESSION_TYPES

        if self.entry_compression not in COMPRESSION_TYPES:
            raise ConfigError(
                f"unknown EntryCompressionType {self.entry_compression!r}"
            )
        if self.is_witness and self.entry_compression != "no-compression":
            raise ConfigError("witness does not carry proposal payloads")


@dataclass
class EngineConfig:
    """Expert engine geometry (config/config.go:887-899).  The TPU engine
    maps ExecShards onto kernel batch slots rather than goroutine pools."""

    exec_shards: int = 16
    commit_shards: int = 16
    apply_shards: int = 16
    snapshot_shards: int = 48
    close_shards: int = 32


@dataclass
class LogDBConfig:
    """Expert log-engine geometry (config/config.go:780,845): the durable
    log is split into ``shards`` single-writer partitions so concurrent
    step workers flush different files (internal/logdb/sharded.go:34).

    ``engine`` picks the per-partition storage engine — ``"tan"`` (the
    purpose-built log-file engine, the default) or ``"kv"`` (the
    sorted-KV LSM engine, the analog of the reference's Pebble logdb);
    the choice is pinned into the on-disk layout on first open.

    ``recovery_mode`` governs what a tan partition does with a bad
    checksum in a NON-tail log file on open: ``"strict"`` refuses to
    open (historical behavior), ``"quarantine"`` truncates at the
    corruption, clamps the persisted commit to the entries still
    contiguously present, and lets raft re-replicate the rest from the
    quorum (snapshot fallback when the entries were compacted away)."""

    shards: int = 16
    engine: str = "tan"
    recovery_mode: str = "strict"


@dataclass(frozen=True)
class MeshSpec:
    """Placement of device-resident shards onto a multi-chip mesh.

    NodeHosts (one per replica slot in the common deployment) that share
    a ``name`` attach to one process-wide MeshEngine whose state spans a
    ``Mesh(('g','r'))`` of ``g_size * replicas`` devices; intra-group
    raft traffic rides ICI collectives instead of the host transport
    (the reference's multi-NodeHost TCP topology, transport.go:86-101,
    collapsed into the jitted step).  Mesh-resident shards must use
    replica ids 1..replicas (the device router's fixed addressing);
    anything else falls back / evicts to the host engine.
    """

    name: str = "default"
    g_size: int = 1          # mesh axis 'g' (disjoint group sets)
    replicas: int = 3        # mesh axis 'r' (one device per replica slot)
    n_local: int = 8         # group lanes per 'g' block


@dataclass
class ExpertConfig:
    engine: EngineConfig = field(default_factory=EngineConfig)
    logdb: LogDBConfig = field(default_factory=LogDBConfig)
    # multi-chip placement for mesh_resident shards (None = single-device
    # kernel engine only)
    mesh: MeshSpec | None = None
    # pluggable filesystem (config.go Expert.FS / vfs.IFS): OSFS by
    # default; MemFS for diskless tests; ErrorFS for fault injection
    fs: object | None = None
    # kernel geometry overrides (TPU-specific expert surface)
    kernel_log_cap: int = 1024
    kernel_inbox_cap: int = 8
    kernel_msg_entries: int = 8
    kernel_proposal_cap: int = 8
    kernel_num_peers: int = 5
    kernel_readindex_cap: int = 4
    kernel_apply_batch: int = 64
    kernel_compaction_overhead: int = 64
    # max device-resident shards per NodeHost (lanes of the batched state)
    kernel_capacity: int = 1024
    # device-side fleet telemetry decimation: the engines run the jitted
    # fleet_stats reduction (core/fleet.py) every N steps and fetch one
    # small struct to host; 0 disables the reduction entirely
    fleet_stats_every: int = 10
    # engine software-pipeline depth (engine/kernel_engine.py): 0 runs
    # the serial stage->dispatch->fetch->process loop (the differential
    # oracle); 1 overlaps host staging/output-retirement with the device
    # step, dispatching through the donating jit entry
    kernel_pipeline_depth: int = 0
    # device-side health engine (core/health.py): rides the
    # fleet_stats_every decimation, classifying every group into the
    # anomaly taxonomy and fetching one O(K) triage report to host.
    # health_top_k sizes the worst-offender list; 0 disables the pass
    health_top_k: int = 8
    # anomaly trip points, in health ticks (churn_trip is a leaky-bucket
    # level: each observed leadership handoff adds CHURN_INC=4, the
    # bucket drains 1/tick)
    health_leaderless_ticks: int = 3
    health_stall_ticks: int = 3
    health_lag_ticks: int = 3
    health_churn_trip: int = 8
    health_runaway_ticks: int = 4
    # runtime protocol-invariant probe (core/invariants.py): rides the
    # fleet_stats_every decimation, evaluating the declared
    # core/kstate.py INVARIANTS over every group and fetching one O(1)
    # verdict report.  Any violation is a BUG (kernel or declaration):
    # it raises an invariant_violation flight event and degrades
    # /healthz.  False disables the pass
    invariant_probe: bool = True
    # proposal-lifecycle tracing (lifecycle.py): every Nth proposal key
    # carries an end-to-end span stamped at each host hop (propose,
    # stage, dispatch, retire, save, fsync, apply, ack) and feeds the
    # commit_stage_us{stage=} histograms + the /trace Chrome-trace ring;
    # 0 disables sampling entirely
    trace_sample_every: int = 64
    # slow-commit SLO in microseconds: a sampled commit whose
    # propose->ack total exceeds this records a flight-recorder
    # slow_commit event with the full stage breakdown; 0 disables (the
    # default keeps chaos-replay flight tails byte-identical, since the
    # breakdown carries measured wall durations)
    trace_slow_commit_us: int = 0
    # fabric observability (fabric.py): per-(src,dst)-link transport
    # telemetry, the cross-host trace header on outbound batches, and
    # the commit-path hop census behind /debug/fabric and
    # info()["fabric"].  False stops link accounting and keeps frames
    # header-free (sampled spans still stamp hub_send/hub_recv
    # in-process)
    fabric_telemetry: bool = True
    # capacity rail (capacity.py): memory_pressure trips when headroom
    # against the device budget drops below the watermark; budget 0 uses
    # the backend-reported bytes_limit (and disables the trip where the
    # backend reports none, e.g. CPU)
    capacity_watermark_pct: float = 10.0
    capacity_device_budget_bytes: int = 0
    # elastic fleet controller (control.py): when enabled, each
    # decimated health observation may plan hysteresis-guarded,
    # rate-limited leader transfers off this host; decisions are a pure
    # function of digest contents + control_seed (flight-recorded as
    # control_transfer with evidence)
    control_enabled: bool = False
    control_hot_score: int = 8
    control_lag_hot: int = 64
    control_hysteresis: int = 2
    control_cooldown_obs: int = 8
    control_max_transfers: int = 2
    control_seed: int = 0
    # observations during which the host-hot latency input is ignored
    # (jit compile inflates the step EWMA at process start)
    control_warmup_obs: int = 8
    # host-hot gate for the controller: engine step-latency EWMA
    # (engine.kernel_step.ewma_us — the measure() window includes
    # output retirement, so apply backpressure shows up here) above
    # this marks every led shard a drain candidate; 0 disables the
    # latency input
    control_hot_ewma_us: int = 0
    # capacity-driven admission (control.check_admission): StartReplica
    # of a device-resident shard past the derated max_g_for_budget
    # watermark is refused ("enforce"), recorded only ("warn"), or
    # ungated ("off").  Needs a resolvable device budget
    # (capacity_device_budget_bytes or backend-reported bytes_limit) —
    # capacity unknown never refuses
    admission_policy: str = "off"
    # opt into the persistent JAX compilation cache at host startup
    # (hostenv.enable_compile_cache; DRAGONBOAT_TPU_COMPILE_CACHE=0
    # vetoes).  Off by default: the cache dir is process-global state
    compile_cache: bool = False


@dataclass
class GossipConfig:
    bind_address: str = ""
    advertise_address: str = ""
    seed: list[str] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not (self.bind_address or self.advertise_address or self.seed)


@dataclass
class NodeHostConfig:
    """Host-level configuration (config/config.go NodeHostConfig)."""

    deployment_id: int = 0
    wal_dir: str = ""
    node_host_dir: str = ""
    rtt_millisecond: int = 200
    raft_address: str = ""
    address_by_node_host_id: bool = False
    listen_address: str = ""
    mutual_tls: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    enable_metrics: bool = False
    # /metrics listen address when enable_metrics is True; port 0 binds
    # an ephemeral port (reported by NodeHost.metrics_address)
    metrics_address: str = "127.0.0.1:0"
    notify_commit: bool = False
    max_send_queue_size: int = 0
    max_receive_queue_size: int = 0
    max_snapshot_send_bytes_per_second: int = 0
    max_snapshot_recv_bytes_per_second: int = 0
    gossip: GossipConfig = field(default_factory=GossipConfig)
    expert: ExpertConfig = field(default_factory=ExpertConfig)
    # pluggable factories (parity: config.LogDBFactory / TransportFactory)
    logdb_factory: object | None = None
    transport_factory: object | None = None
    raft_event_listener: object | None = None
    system_event_listener: object | None = None

    def validate(self) -> None:
        if self.rtt_millisecond == 0:
            raise ConfigError("invalid RTTMillisecond")
        if not self.raft_address:
            raise ConfigError("RaftAddress not set")
        if self.address_by_node_host_id:
            if self.gossip.is_empty():
                raise ConfigError(
                    "gossip must be configured for AddressByNodeHostID")
            if not self.gossip.bind_address:
                raise ConfigError("gossip.bind_address not set")
        if self.mutual_tls:
            for field_name in ("ca_file", "cert_file", "key_file"):
                if not getattr(self, field_name):
                    raise ConfigError(
                        f"MutualTLS requires {field_name} to be set")

    def prepare(self) -> None:
        if not self.node_host_dir:
            raise ConfigError("NodeHostDir not set")
