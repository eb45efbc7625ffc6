"""KernelEngine — device-resident shards behind the real client API.

The port of the reference's ``engine/kernel_engine.py`` to PyTorch.  The
reference advances each shard with per-shard goroutine work queues
(engine.go:1107-1364: step workers → one batched fsync → send → apply).
Here every device-resident shard is one row of a batched ``[G]`` kernel
state (core/kernel.py) living on the engine's ``device`` (the CUDA card
unless the caller names the CPU), and ONE eager step advances all of
them — its commit rule launches K1 (``parallel/fabric_kernels``) on the
card; the host's job per step is pure marshaling:

  1. drain client/transport queues into ``StepInput`` lanes + ``Inbox``
     slots (payloads stay in a host-side mirror — the device ring holds
     terms only, kstate.py:59);
  2. run the step;
  3. assemble one ``pb.Update`` batch and call ``save_raft_state`` once
     (THE fsync — raftio/logdb.go:78-83), sending Replicates before it
     (thesis §10.2.1, engine.go:1332-1343) and everything else after;
  4. release committed entries to the RSMs, complete request futures,
     and fire events.

Shards escalate out of the kernel (``needs_host``: a peer needs an
InstallSnapshot stream, the ring overflowed, a restore arrived) by
EVICTION: all state is already durable through the shared LogDB, so the
host builds a regular pycore ``Node`` from the persisted state and the
shard continues on the loopback engine.  That is the slow path the
VERDICT's round-1 review found missing — produced but never consumed.

ReadIndex across hosts: a follower-host read forwards a READ_INDEX
message to the leader host (raft.go:1296 leader-forwarding), the leader
feeds it to its kernel lane as a batched-read ctx and answers with
READ_INDEX_RESP — the kernel itself only ever sees leader-local reads.

Pipelining (``pipeline_depth``): at depth 0 each ``step_all`` runs the
serial loop — stage, dispatch, fetch, process — and is the differential
oracle.  At depth 1 the loop is software-pipelined: staging for step N
builds into the ALTERNATE half of a double-buffered inbox/input pair
while the device still executes step N-1; step N-1's outputs are then
retired (the async fetch is consumed one step late) BEFORE step N is
dispatched through the donating entry (core/kernel.py ``step_donated``)
— the retire-before-dispatch order is the donation contract: dispatch
hands the state/inbox/input tensors over, so every read of the previous
state (lt rows for the update batch, the wit-snap compaction floor) must
complete first, and the host never touches a buffer again after its
dispatch.  On the card the step's kernels run asynchronously on the
stream, so the retire's fetches are where the host first waits.

Host writes into the state (lane injection, lane clearing, membership
updates) are out of place (``Tensor.index_put``, as the reference's
``.at[].set``): the StepOutput of an in-flight step may share tensors with
the state it produced, and its retire must see the values it was made
with.

Every ``fleet_stats_every`` steps the engine runs the three decimated
device reductions (``core/fleet``, ``core/health``, ``core/invariants``:
plain PyTorch tensor ops on the state's device, the invariant probe's
``quorum(match)`` term a K1 launch on the card) and the capacity tick, at
the point of ``step_all`` the reference runs them: after the dispatch, so
at pipeline depth 1 they read the state the in-flight step produced and
their one fetch each waits for that step.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace as _dc_replace

import numpy as np
import torch

from dragonboat_tpu_torch import capacity as _capacity
from dragonboat_tpu_torch import graphs
from dragonboat_tpu_torch import lifecycle
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.tracing import annotate, stop_env_trace
from dragonboat_tpu_torch.config import Config
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.core.kernel import (
    FLAG_CLASSES,
    output_row_flags,
    row_flags,
    step as kernel_step,
    step_donated as kernel_step_donated,
)
from dragonboat_tpu_torch.core import router as _router
from dragonboat_tpu_torch.core.kstate import (
    Inbox,
    ShardState,
    StepInput,
    init_state,
)
from dragonboat_tpu_torch.devices import (
    put_rows as _put_rows,
    resolve_device,
    upload as _upload,
)
from dragonboat_tpu_torch.events import EventHub
from dragonboat_tpu_torch.logger import get_logger
from dragonboat_tpu_torch.node import Node, _SnapshotRequest
from dragonboat_tpu_torch.parallel import ici
from dragonboat_tpu_torch.raftio import LeaderInfo
from dragonboat_tpu_torch.request import RequestResultCode
from dragonboat_tpu_torch.statemachine import Result

_LOG = get_logger("engine")

MT = pb.MessageType

# message types a kernel lane consumes directly (core/kernel.py
# _process_family dispatch set)
_KERNEL_MTYPES = frozenset({
    MT.REPLICATE, MT.REPLICATE_RESP, MT.HEARTBEAT, MT.HEARTBEAT_RESP,
    MT.REQUEST_VOTE, MT.REQUEST_VOTE_RESP, MT.REQUEST_PREVOTE,
    MT.REQUEST_PREVOTE_RESP, MT.TIMEOUT_NOW, MT.UNREACHABLE,
    MT.SNAPSHOT_STATUS,
})

# column per message class in the [G, C] output_row_flags matrix
# (core/kernel.py FLAG_CLASSES order)
_F = {c: i for i, c in enumerate(FLAG_CLASSES)}
_F_RESP, _F_REP, _F_HB, _F_VOTE = _F["resp"], _F["rep"], _F["hb"], _F["vote"]
_F_TIMEOUT, _F_WITSNAP, _F_RTR = _F["timeout_now"], _F["wit_snap"], _F["rtr"]


class _LazyOut:
    """Field-lazy host view of a ``StepOutput``: one device->host fetch
    (``.cpu().numpy()``, a sync on the card) per field on FIRST access
    only.  The eager 42-field fetch blocked the host on
    the whole async device step even when the activity mask would prove
    most fields dead (PERF.md's ~80%%-of-wall-clock stall); lanes with no
    replicates never pay for ``s_ent_term`` and friends."""

    __slots__ = ("_out", "_np")

    def __init__(self, out) -> None:
        self._out = out
        self._np: dict[str, np.ndarray] = {}

    def __getitem__(self, f: str) -> np.ndarray:
        v = self._np.get(f)
        if v is None:
            with _capacity.METER.sanctioned("lazy_out"):
                v = ici.to_host(getattr(self._out, f))
            self._np[f] = v
        return v


@dataclass
class _StepCtx:
    """Everything the deferred output pass of ONE dispatched step needs,
    captured at dispatch time: staging for the NEXT step rebinds
    ``n._staged_props`` / ``n._staged_ri`` before a pipelined step's
    outputs are retired, so fates and read ctxs must ride the ctx, not
    the node."""

    nodes: dict[int, "KernelNode"]
    fates: dict[int, list]                  # row -> [(entry, origin), ...]
    staged_ri: dict[int, pb.SystemCtx]      # row -> staged ReadIndex ctx
    staged_rows: set[int]
    out: object = None                      # device StepOutput (async)
    dead: set[int] = field(default_factory=set)   # rows removed in flight
    # lifecycle-sampled proposal keys riding this step (dispatch/retire
    # stamps); keys of rows scrubbed in flight stay here harmlessly —
    # stamp() is a no-op once the book's dropped() scrubbed the span
    traced: list = field(default_factory=list)


class KernelNode(Node):
    """A device-resident shard: client surface + books + RSM live on the
    host exactly like ``Node``; the raft state machine lives in a kernel
    lane and is advanced by the owning ``KernelEngine``."""

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self.lane: int = -1
        self.engine: KernelEngine | None = None
        # set (under self.mu) when the shard is evicted: every later
        # ingress mutation is redirected to the host-resident successor
        self._moved: Node | None = None
        # payload mirror: log index -> full pb.Entry (device holds terms).
        # On a mesh engine all replicas of a shard share one dict (the
        # in-process form of payload distribution).
        self.mirror: dict[int, pb.Entry] = {}
        # (entry, origin_node) staged into prop lanes this step, by slot —
        # origin tracks whose books own the future (mesh engines forward
        # follower-host proposals onto the leader row)
        self._staged_props: list[tuple[pb.Entry, "KernelNode"]] = []
        self._staged_ri: pb.SystemCtx | None = None
        # remote ReadIndex ctxs forwarded from follower hosts, FIFO
        self._remote_reads: list[tuple[int, pb.SystemCtx]] = []
        # ctx.low -> requesting replica, for remote reads riding the
        # quorum path (answered when the rtr lane lands, steps later)
        self._remote_ri_inflight: dict[int, int] = {}
        self._local_ri_pending: dict[int, pb.SystemCtx] = {}
        self._tick_pending = 0
        self._leader_cache = 0
        self._leader_term_cache = 0
        self._staged_ri_from = 0
        self._committed_cache = 0
        self.applied_since_snapshot = 0

    # the engine drives everything; the loopback step must not touch peer
    def step(self) -> bool:  # pragma: no cover - engine-driven
        return False

    def _post(self, mutate) -> None:
        """Ingress choke point: after eviction, redirect atomically to the
        successor Node so nothing lands in a dead queue (the drain in
        _on_kernel_evict runs under self.mu after _moved is set).  Every
        ingress dirties the lane so the engine's staging pass visits it
        (mark_dirty is lock-free — taking engine.mu here would invert
        the step path's engine.mu -> node.mu order)."""
        with self.mu:
            if self._moved is None:
                mutate(self)
                eng, lane = self.engine, self.lane
                if eng is not None and lane >= 0:
                    eng.mark_dirty(lane)
                return
            target = self._moved
        target._post(mutate)

    def leader_id(self) -> int:
        return self._leader_cache

    def node_term(self) -> int:
        return self._leader_term_cache

    def is_leader(self) -> bool:
        return self._leader_cache == self.replica_id

    def read(self, timeout_ticks: int):
        """Reads enqueue into the book WITHOUT the _post choke point
        (no node-state mutation), so the lane must be dirtied here or
        the staging pass would never pick the batch up — before the
        engine-wide tick broadcast (r5), the per-tick dirty-marking of
        every lane masked this."""
        rs = super().read(timeout_ticks)
        eng, lane = self.engine, self.lane
        if eng is not None and lane >= 0:
            eng.mark_dirty(lane)
        return rs

    def tick(self) -> None:
        """Direct per-lane tick (tests / pre-injection): the NodeHost
        ticker never calls this for engine-registered lanes — it hands
        the whole round to the engine as one pending broadcast
        (KernelEngine.tick_round)."""
        self._tick_pending += 1
        eng, lane = self.engine, self.lane
        if eng is not None and lane >= 0:
            eng.mark_dirty(lane)
        if self._owns_clock:
            self._clock.advance()
        self.gc_books()

    def _take_snapshot(self, req: _SnapshotRequest) -> None:
        """Snapshot for a device-resident shard: the device compacts its
        term ring itself (kernel.py device-side compaction), so the host
        only persists the RSM image + snapshot record and truncates the
        durable log (node.go:739 doSave without the logreader cache)."""
        import os as _os

        from dragonboat_tpu_torch.raftio import EntryInfo, SnapshotInfo  # noqa: F401

        index0 = self.sm.get_last_applied()
        if index0 == 0:
            if req.key:
                self.pending_snapshot.done(req.key,
                                           RequestResultCode.REJECTED)
            return
        path = req.path if req.exported else self._snapshot_path(index0)
        self.fs.makedirs(_os.path.dirname(path) or ".")
        index, term, membership, files = \
            self.sm.save_snapshot_with_files(path)
        ss = pb.Snapshot(
            filepath=path, file_size=self.fs.getsize(path),
            index=index, term=term, membership=membership,
            shard_id=self.shard_id, type=self.sm.sm_type, files=files,
        )
        if req.exported:
            from dragonboat_tpu_torch.tools import write_export_metadata

            write_export_metadata(path, ss, fs=self.fs)
        else:
            self.logdb.save_snapshots([pb.Update(
                shard_id=self.shard_id, replica_id=self.replica_id,
                snapshot=ss)])
            self.events.snapshot_created(SnapshotInfo(
                shard_id=self.shard_id, replica_id=self.replica_id,
                from_=self.replica_id, index=index, term=term))
            overhead = (req.compaction_overhead if req.override_compaction
                        else self.cfg.compaction_overhead)
            compact_to = max(0, index - overhead)
            if compact_to > 0 and not self.cfg.disable_auto_compaction:
                self.logdb.remove_entries_to(
                    self.shard_id, self.replica_id, compact_to)
                self.compacted_to = compact_to
                self.events.log_compacted(EntryInfo(
                    shard_id=self.shard_id, replica_id=self.replica_id,
                    index=compact_to))
        self.applied_since_snapshot = 0
        if req.key:
            self.pending_snapshot.done(
                req.key, RequestResultCode.COMPLETED, snapshot_index=index)

    def _on_config_change_applied(self, entry: pb.Entry, r) -> None:
        """CC apply for a lane: the RSM's membership store is the truth
        and the engine refreshes the device peer book after the apply
        batch; there is no pycore Peer to notify."""
        cc = pb.decode_config_change(entry.cmd)
        if not r.rejected:
            self.membership_changed_cb(cc)
        code = (RequestResultCode.REJECTED if r.rejected
                else RequestResultCode.COMPLETED)
        self.pending_config_change.done(
            entry.key, code, Result(value=entry.index))


@dataclass
class _LaneInit:
    """State captured from a bootstrapped pycore Peer for lane injection."""

    term: int
    vote: int
    committed: int
    applied: int
    snap_index: int
    snap_term: int
    entries: list[pb.Entry]
    peers: list[tuple[int, int]]   # (replica_id, kind)


class KernelEngine:
    """Owns one batched kernel state and every KernelNode mapped onto it."""

    # class-wide: serializes the FIRST step across engines (see
    # step_all; on the card the first step builds and loads the kernel
    # library, which kernels.library() also serializes)
    _first_compile_mu = threading.Lock()
    # class-wide: one engine at a time runs step_all in a process.  An
    # eager step is ~1000 small torch calls, each of which releases the
    # GIL; with several engines in one process (one per NodeHost), an
    # engine in a pure-Python phase (staging, output processing) then
    # holds the GIL for up to the switch interval while another waits to
    # return from each call — the steps crawl at milliseconds per op.
    # Engines that take turns keep every step uncontended.
    _step_mu = threading.Lock()

    def __init__(self, kp: KP.KernelParams, capacity: int,
                 send_message, events: EventHub | None = None,
                 election_rtt: int = 10, heartbeat_rtt: int = 1,
                 fleet_stats_every: int = 10,
                 pipeline_depth: int = 0,
                 health_top_k: int = 8,
                 health_thresholds=None,
                 invariant_probe: bool = True,
                 capacity_watermark_pct: float = 10.0,
                 capacity_budget_bytes: int = 0,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.kp = kp
        self.capacity = capacity
        self.send_message = send_message
        self.events = events or EventHub()
        self.mu = threading.RLock()
        # lane -> node
        self.nodes: dict[int, KernelNode] = {}     # guarded-by: _admit_mu
        self.by_shard: dict[int, KernelNode] = {}  # guarded-by: _admit_mu
        # guards registration (nodes, by_shard, _free, _pending_inject)
        # so admissions need not wait for a step; order engine.mu ->
        # _admit_mu
        self._admit_mu = threading.Lock()
        self._free = list(range(capacity - 1, -1, -1))  # guarded-by: _admit_mu
        self.state: ShardState = init_state(
            kp, capacity,
            replica_id=np.ones((capacity,), np.int32),
            peer_ids=np.zeros((capacity, kp.num_peers), np.int32),
            election_timeout=election_rtt,
            heartbeat_timeout=heartbeat_rtt,
            device=self.device,
        )
        # all lanes start ABSENT: no peers -> non-single, no campaigns
        # (mask: a lane with kind all K_ABSENT and tick never set is inert)
        # per-lane (term, vote, commit) as persisted — an np array so the
        # outputs pass can find changed lanes with one vectorized compare
        # (-1 rows = absent lane: the first real triple always differs)
        self._triple_np = np.full((capacity, 3), -1, np.int64)
        # host mirrors of per-lane leader caches, same reason
        self._lead_np = np.zeros((capacity,), np.int64)
        self._lead_term_np = np.zeros((capacity,), np.int64)
        # lanes with possibly-pending host work (see mark_dirty); its
        # own tiny lock — NOT engine.mu (ingress holds node.mu and the
        # documented order is engine.mu -> node.mu)
        self._dirty: set[int] = set()  # guarded-by: _dirty_mu
        self._dirty_mu = threading.Lock()
        # occupancy vector for the output activity mask (absent lanes
        # must not pass it — the -1 triple sentinel vs device term 0
        # would make every empty lane "active" forever)
        self._occ_np = np.zeros((capacity,), bool)
        # rows that received staged proposals this step (bounds the
        # fate-reset and fate-processing loops)
        self._staged_rows: set[int] = set()  # guarded-by: mu
        # nodes removed since the last step (same-thread evictions during
        # staging land here); step_all drains it instead of sweeping all
        # [capacity] rows for vanished registrations
        self._removed_nodes: list[KernelNode] = []  # guarded-by: mu
        # first-call guard for the cross-engine compile serialization in
        # step_all (the class-wide _first_compile_mu)
        self._compiled_once = False
        # host mirrors of the device peer books: pids/kinds only change
        # on injection/membership updates, so the output path must not
        # pay a device->host transfer for them every step
        self._kind_np = np.zeros((capacity, kp.num_peers), np.int32)
        self._pid_np = np.zeros((capacity, kp.num_peers), np.int32)
        # admissions queued for the next step's batched injection
        # (lane -> (node, init, pids, kinds)); see _flush_injections
        self._pending_inject: dict[int, tuple] = {}  # guarded-by: _admit_mu
        # whole-engine tick rounds queued by the host ticker; each step
        # consumes ONE round as a vectorized [G]-bool broadcast (the
        # per-lane Python tick walk was ~25 s/round at 100k lanes).
        # Capped so a long no-node idle cannot bank a burst of rounds
        # that would fast-forward election timers on the first admission
        self._tick_rounds_pending = 0
        self._tick_mu = threading.Lock()
        # persistent staging buffers, zeroed per step (the step
        # needs fixed [capacity] shapes anyway; reallocating every engine
        # iteration would cost ~G*K*E ints of fresh numpy per step).
        # TWO pairs: at pipeline depth 1 staging for step N writes the
        # alternate pair while step N-1 (whose device inbox may alias
        # its numpy staging on CPU backends, and whose buffers are
        # donated) is still in flight; a pair is only rewritten after
        # the step that used it has retired
        # mesh subclasses set _slot_exact_replicas BEFORE super().__init__
        # so hub-fallback staging lands at route()'s exact slot layout
        mesh_r = getattr(self, "_slot_exact_replicas", None)
        self._bufs = tuple(
            (_InboxBuilder(capacity, kp.inbox_cap, kp.msg_entries,
                           mesh_replicas=mesh_r, device=self.device),
             _InputBuilder(capacity, kp.proposal_cap, device=self.device))
            for _ in range(2))
        self._buf_idx = 0
        # aliases to the pair of the most recent dispatch (fleet stats
        # and tests read the staged inbox through these)
        self._inbox_buf, self._input_buf = self._bufs[0]
        # software pipeline: 0 = serial oracle (stage, dispatch, fetch,
        # process in one pass), 1 = retire step N-1 while N is staged,
        # dispatching N through the donating entry
        self.pipeline_depth = max(0, min(1, int(pipeline_depth)))
        self._pending_ctx: _StepCtx | None = None
        # pipeline occupancy accounting: a dispatch is "overlapped" when
        # a previous step was still unretired at its staging
        self._pipe_steps = 0
        self._pipe_overlapped = 0
        # step-latency accounting + opt-in torch.profiler capture
        from dragonboat_tpu_torch.tracing import StepTimer, maybe_start_from_env

        self._step_timer = StepTimer(self.events.metrics,
                                     "engine.kernel_step")
        maybe_start_from_env()
        self.events.metrics.set("engine.pipeline.depth", self.pipeline_depth)
        # decimated device-side fleet telemetry (core/fleet.py): every N
        # steps one reduction over the resident state fetches ONE small
        # struct to host; 0 disables
        self.fleet_stats_every = max(0, int(fleet_stats_every))
        self._fleet_countdown = self.fleet_stats_every
        self.last_fleet: dict | None = None
        # standalone engines (no NodeHost) still expose the device-only
        # view; a NodeHost registers its merged host+device view over the
        # same names FIRST in its __init__, so this is a no-op there
        from dragonboat_tpu_torch.core import fleet as _fleet

        _fleet.register_exposition(self.events.metrics.registry,
                                   lambda: self.last_fleet)
        # decimated device-side anomaly classification (core/health.py):
        # rides the fleet countdown; the per-group digest carry stays
        # device resident and only the O(K) report crosses to host.
        # health_top_k=0 disables the pass entirely
        from dragonboat_tpu_torch.core import health as _health

        self.health_top_k = max(0, int(health_top_k))
        self.health_thresholds = (
            _health.HealthThresholds(*health_thresholds)
            if health_thresholds is not None
            else _health.DEFAULT_THRESHOLDS)
        self._health_digest = None      # built lazily at the first tick
        self.last_health: dict | None = None
        self._health_seq = 0            # health ticks taken (flight stamp)
        _health.register_exposition(self.events.metrics.registry,
                                    lambda: self.last_health)
        # decimated protocol-invariant probe (core/invariants.py): the
        # runtime leg of the safety verifier, riding the same fleet
        # countdown.  The prev-field digest carry stays device resident;
        # one O(1) InvariantReport crosses to host.  A violation is
        # ALWAYS a bug, so sightings are sticky (violations_seen) — a
        # transient step-scope violation must not vanish from /healthz
        # at the next clean window
        from dragonboat_tpu_torch.core import invariants as _invariants

        self.invariant_probe = bool(invariant_probe)
        self._inv_digest = None         # built lazily at the first tick
        self.last_invariants: dict | None = None
        self._inv_seq = 0               # probe ticks taken (flight stamp)
        self._inv_violations_seen = 0   # sticky cumulative violation total
        # lanes injected/cleared since the last probe tick: their digest
        # prev-columns describe a DIFFERENT occupant, so the probe must
        # re-seed them (ticks=0) or a fresh shard's lower term would
        # read as a bogus term_monotone violation
        self._inv_dirty: set[int] = set()  # guarded-by: mu
        _invariants.register_exposition(self.events.metrics.registry,
                                        lambda: self.last_invariants)
        # capacity rail (capacity.py): call-count wrappers around every
        # entry this engine dispatches (eager entries record no compile),
        # plus decimated device-memory accounting on the fleet cadence
        self.capacity_watermark_pct = float(capacity_watermark_pct)
        self.capacity_budget_bytes = max(0, int(capacity_budget_bytes))
        # the ONE dispatch backend (engine/dispatch.py): subclasses pick
        # a backend through the _make_dispatch seam instead of overriding
        # step-loop internals
        self._dispatch = self._make_dispatch()
        # the output flag reduction's graphs, in the backend's pool
        self._row_flags = row_flags.fork(self._dispatch.pool)
        self._cap_entries = self._capacity_entries()
        self.last_capacity: dict | None = None
        self._capacity_seq = 0          # capacity ticks (flight stamp)
        self._capacity_peak = 0         # high-water live tree bytes
        _capacity.register_exposition(self.events.metrics.registry,
                                      lambda: self.last_capacity)

    # -- lane lifecycle ---------------------------------------------------

    def add_shard(self, node: KernelNode, init: _LaneInit) -> None:
        """Register a bootstrapped shard in a free lane and queue its
        injection; the next step writes the lane into the state
        (``_flush_injections``), so a running step never sees the lane
        half-made.  Only the admission lock is taken, not the engine lock:
        waiting for engine.mu meant waiting for a whole step, and an engine
        thread stepping back to back starved the admitting thread (1024
        shards x 3 took 1137 s to admit that way on an H100)."""
        with self._admit_mu:
            if not self._free:
                raise RuntimeError("kernel engine is at capacity")
            lane = self._free.pop()
            node.lane = lane
            node.engine = self
            self.nodes[lane] = node
            self.by_shard[node.shard_id] = node
            self._pending_inject[lane] = self._inject(lane, node, init)

    def remove_shard(self, shard_id: int) -> KernelNode | None:
        with self.mu, self._admit_mu:
            node = self.by_shard.pop(shard_id, None)
            if node is None:
                return None
            self.nodes.pop(node.lane, None)
            self._free.append(node.lane)
            self._inv_dirty.add(node.lane)
            self._clear_lane(node.lane, self._pending_inject.pop(
                node.lane, None) is not None)
            self._removed_nodes.append(node)
        return node

    def close(self) -> None:
        """Engine teardown.  Flushes a DRAGONBOAT_TPU_TRACE_DIR-armed
        profiler capture while the CUDA context is unambiguously alive —
        relying on atexit for it races interpreter/backend shutdown and
        can leave the trace dir empty (a user-started ``start_trace``
        capture is deliberately left to its owner)."""
        stop_env_trace()

    def _inject(self, lane: int, node: KernelNode, init: _LaneInit) -> tuple:
        """One lane injection, returned for ``add_shard`` to queue under
        the admission lock; the next ``step_all`` flushes every
        queued lane in ONE vectorized state update.  The eager form was
        ~30 full-[capacity] array copies PER admission — O(n·capacity)
        total, the first structure to fall over at 100k groups.  Host
        bookkeeping (kind cache, payload mirror, writeback triple) is
        done here so non-state readers see the shard immediately."""
        kp = self.kp
        pids = np.zeros((kp.num_peers,), np.int32)
        kinds = np.zeros((kp.num_peers,), np.int32)
        for i, (rid, kind) in enumerate(init.peers[:kp.num_peers]):
            pids[i], kinds[i] = rid, kind
        self._kind_np[lane] = kinds
        self._pid_np[lane] = pids
        for e in init.entries:
            node.mirror[e.index] = e
        self._triple_np[lane] = (init.term, init.vote, init.committed)
        self._lead_np[lane] = 0
        self._lead_term_np[lane] = 0
        self._occ_np[lane] = True
        self.mark_dirty(lane)
        return node, init, pids, kinds

    def _flush_injections(self, pending: dict) -> None:
        """One out-of-place ``index_put`` per state field for every
        admission queued since the last step (``pending``, taken with
        the step's node snapshot) — O(capacity + n) instead of
        O(n·capacity)."""
        if not pending:
            return
        kp = self.kp
        items = sorted(pending.items())
        n = len(items)
        lanes_np = np.array([g for g, _ in items], np.int32)
        f32 = {k: np.zeros((n,), np.int32) for k in (
            "replica_id", "seed", "rand_timeout", "e_timeout", "h_timeout",
            "role", "term", "vote", "applied", "snap_index", "snap_term",
            "last", "committed")}
        fb = {k: np.zeros((n,), bool) for k in ("check_quorum", "pre_vote",
                                                "quiesce_on")}
        pid_rows = np.zeros((n, kp.num_peers), np.int32)
        kind_rows = np.zeros((n, kp.num_peers), np.int32)
        lt_rows = np.zeros((n, kp.log_cap), np.int32)
        lcc_rows = np.zeros((n, kp.log_cap), bool)
        for j, (lane, (node, init, pids, kinds)) in enumerate(items):
            # the probe re-seeds the lane's digest: its prev columns
            # describe the lane's previous occupant.  Marked here, where
            # the lane's state is written (admission does not hold
            # engine.mu, so marking there could let a probe re-seed the
            # lane before the write and compare across occupants after it)
            with self.mu:
                self._inv_dirty.add(lane)
            pid_rows[j], kind_rows[j] = pids, kinds
            for e in init.entries:
                lt_rows[j, e.index & (kp.log_cap - 1)] = e.term
                lcc_rows[j, e.index & (kp.log_cap - 1)] = \
                    e.is_config_change()
            last = init.entries[-1].index if init.entries \
                else init.snap_index
            role = KP.FOLLOWER
            my_kind = dict(init.peers).get(node.replica_id, KP.K_VOTER)
            if my_kind == KP.K_NON_VOTING:
                role = KP.NON_VOTING
            elif my_kind == KP.K_WITNESS:
                role = KP.WITNESS
            cfg = node.cfg
            # per-(shard, replica) PRNG stream: lanes injected on
            # different hosts must NOT share election-timeout sequences
            # or symmetric campaigns livelock (randomizedElectionTimeout,
            # raft.go:659)
            seed = int(KP.splitmix32(
                (node.shard_id * 2654435761 + node.replica_id * 40503)
                & 0xFFFFFFFF)) & 0x7FFFFFFF
            f32["replica_id"][j] = node.replica_id
            f32["seed"][j] = seed
            f32["rand_timeout"][j] = KP.randomized_timeout(
                seed, 0, cfg.election_rtt)
            f32["e_timeout"][j] = cfg.election_rtt
            f32["h_timeout"][j] = max(1, cfg.heartbeat_rtt)
            fb["check_quorum"][j] = cfg.check_quorum
            fb["pre_vote"][j] = cfg.pre_vote
            fb["quiesce_on"][j] = cfg.quiesce
            f32["role"][j] = role
            f32["term"][j] = init.term
            f32["vote"][j] = init.vote
            f32["applied"][j] = init.applied
            f32["snap_index"][j] = init.snap_index
            f32["snap_term"][j] = init.snap_term
            f32["last"][j] = last
            f32["committed"][j] = init.committed
        last = f32["last"]
        with _capacity.METER.sanctioned("inject_up"):
            # each row lands in the position that owns it (one device
            # unless the mesh is split, parallel/ici.py)
            self.state = ici.write_rows(self.state, lanes_np, dict(
                replica_id=f32["replica_id"],
                seed=f32["seed"],
                rand_timeout=f32["rand_timeout"],
                rand_counter=0,
                e_timeout=f32["e_timeout"],
                h_timeout=f32["h_timeout"],
                check_quorum=fb["check_quorum"],
                pre_vote=fb["pre_vote"],
                role=f32["role"],
                term=f32["term"],
                vote=f32["vote"],
                leader=0,
                applied=f32["applied"],
                e_tick=0,
                h_tick=0,
                pending_cc=False,
                ltt=0,
                is_ltt=False,
                pid=pid_rows,
                kind=kind_rows,
                match=0,
                next=(last + 1)[:, None],
                pstate=KP.R_RETRY,
                active=False,
                psnap=0,
                vresp=False,
                vgrant=False,
                lt=lt_rows,
                lcc=lcc_rows,
                snap_index=f32["snap_index"],
                snap_term=f32["snap_term"],
                last=last,
                committed=f32["committed"],
                processed=f32["applied"],
                stable=last,
                ri_head=0,
                ri_count=0,
                needs_host=False,
                quiesce_on=fb["quiesce_on"],
                idle_tick=0,
                quiesced=False,
                quiesce_epoch=0,
            ))

    def _clear_lane(self, lane: int, queued: bool) -> None:
        """Vacate a lane (``queued``: its injection was still queued)."""
        if queued:
            # evicted before its injection ever flushed: the lane state
            # was never written, so there is nothing to clear on device
            self._kind_np[lane] = KP.K_ABSENT
            self._pid_np[lane] = 0
            self._triple_np[lane] = -1
            self._occ_np[lane] = False
            return
        self.state = ici.write_rows(self.state, lane, dict(
            kind=KP.K_ABSENT,
            pid=0,
            needs_host=False,
            # a vacated lane must not linger in the fleet quiesced count
            quiesce_on=False,
            quiesced=False,
        ))
        self._kind_np[lane] = KP.K_ABSENT
        self._pid_np[lane] = 0
        self._triple_np[lane] = -1
        self._occ_np[lane] = False

    def update_lane_membership(self, node: KernelNode) -> None:
        """Re-derive the lane's peer book from the RSM membership (host
        applies config changes; the device book follows).  A membership
        larger than the fixed [P] peer book cannot be modeled on device —
        quorum over a truncated book would be unsafe — so the shard is
        evicted to the host engine instead."""
        m = node.sm.get_membership()
        kp = self.kp
        total = len(m.addresses) + len(m.non_votings) + len(m.witnesses)
        if total > kp.num_peers:
            self._evict(node, reason=f"membership {total} > "
                                     f"kernel peer book {kp.num_peers}")
            return
        pids = np.zeros((kp.num_peers,), np.int32)
        kinds = np.zeros((kp.num_peers,), np.int32)
        i = 0
        for rid in sorted(m.addresses):
            if i < kp.num_peers:
                pids[i], kinds[i] = rid, KP.K_VOTER
                i += 1
        for rid in sorted(m.non_votings):
            if i < kp.num_peers:
                pids[i], kinds[i] = rid, KP.K_NON_VOTING
                i += 1
        for rid in sorted(m.witnesses):
            if i < kp.num_peers:
                pids[i], kinds[i] = rid, KP.K_WITNESS
                i += 1
        g = node.lane
        with _capacity.METER.sanctioned("membership_up"):
            self.state = ici.write_rows(self.state, g, dict(
                pid=pids[None, :],
                kind=kinds[None, :],
                # the applied CC releases the one-in-flight gate (pycore
                # add_node/add_non_voting/... clear pending_config_change
                # on apply; without this a lane accepts exactly ONE
                # config change in its lifetime and drops every later one)
                pending_cc=False,
            ))
        self._kind_np[g] = kinds
        self._pid_np[g] = pids

    # -- the step ---------------------------------------------------------

    def tick_round(self) -> None:
        """Queue one tick round for EVERY registered lane (called once
        per host tick interval; consumed in step_all as one vectorized
        broadcast)."""
        with self._tick_mu:
            if self._tick_rounds_pending < 8:
                self._tick_rounds_pending += 1

    def mark_dirty(self, lane: int) -> None:
        """Flag a lane for the next staging pass.  Guarded by its own
        lock rather than engine.mu (ingress already holds node.mu, and
        the step path's order is engine.mu -> node.mu): a bare set.add
        could land in a set the step thread just swapped out and be
        silently dropped."""
        with self._dirty_mu:
            self._dirty.add(lane)

    def step_all(self) -> bool:
        """One engine iteration; returns True if any lane had work
        (messages, ticks, proposals, reads) or an in-flight pipelined
        step was retired.  Only DIRTY lanes stage — the full-scan form
        cost 16 µs/lane of Python per step (1.6 s at 100k lanes) whether
        or not anything was pending.  Runs under the engine lock: lane
        injection/eviction and the device state update must not
        interleave with a step.

        Pipeline order at depth 1 (every part of it is load-bearing):
        (1) stage step N into the alternate buffer pair — host marshaling
        overlaps the device compute of step N-1; (2) retire step N-1's
        deferred outputs — this is the first point the host blocks on
        the device, and it must run BEFORE (3) dispatches step N with
        donated buffers, because retiring reads previous-state leaves
        (lt rows, the wit-snap floor) that donation hands over."""
        with KernelEngine._step_mu, self.mu:
            # the node snapshot and the injections queued for exactly
            # those nodes, taken together (admissions run concurrently)
            with self._admit_mu:
                nodes = dict(self.nodes)
                pending_inject, self._pending_inject = self._pending_inject, {}
            if not nodes:
                if self._pending_ctx is not None:
                    # every lane vanished with a step in flight: fail the
                    # removed nodes' staged futures, then retire the step
                    # so nothing hangs on an answer that cannot land
                    removed, self._removed_nodes = self._removed_nodes, []
                    for n in removed:
                        if not self._is_registered(n):
                            self._scrub_pending_ctx(n)
                            self._drop_staged_fates(n)
                    ctx, self._pending_ctx = self._pending_ctx, None
                    with annotate("kernel_engine.process_outputs"):
                        self._process_outputs(ctx)
                    return True
                return False
            self._flush_injections(pending_inject)
            inbox, inp = self._bufs[self._buf_idx]
            self._inbox_buf, self._input_buf = inbox, inp
            with annotate("kernel_engine.stage"):
                inbox.reset()
                inp.reset()
                had_work = False

                # swap out the dirty set; arrivals during this step land in
                # the fresh set and stage next iteration
                with self._dirty_mu:
                    dirty, self._dirty = self._dirty, set()
                staged = [(g, nodes[g]) for g in sorted(dirty) if g in nodes]
                # staging may target OTHER rows' prop slots (mesh engines
                # forward follower-host proposals to the leader row); only
                # rows recorded as prop targets can hold stale fates.  The
                # pending ctx (if any) captured the OLD list objects, so the
                # rebind here cannot lose in-flight fates
                self._slot_cursor: dict[int, int] = {}
                for g in self._staged_rows:
                    n = nodes.get(g)
                    if n is not None:
                        n._staged_props = []
                self._staged_rows = set()
                for g, n in staged:
                    if self._stage_lane(g, n, inbox, inp):
                        had_work = True
                # consume one queued engine-wide tick round: every
                # registered lane ticks via ONE vectorized bool write —
                # no per-lane Python, no dirty-marking the whole batch
                with self._tick_mu:
                    tick_round = self._tick_rounds_pending > 0
                    if tick_round:
                        self._tick_rounds_pending -= 1
                if tick_round:
                    lanes = np.fromiter(nodes.keys(), np.int64, len(nodes))
                    inp._tick[lanes] = True
                    had_work = True
            # an eviction while staging (InstallSnapshot; whole-GROUP on a
            # mesh engine) may remove rows staged EARLIER in this loop —
            # drop them, failing any proposals forwarded onto them so the
            # origin futures fail fast instead of timing out.  Removals
            # are drained from the explicit log remove_shard keeps (the
            # full [capacity] registration sweep this replaces was a fixed
            # ~16 µs/lane of Python per step at 100k lanes).  An in-flight
            # pipelined step is scrubbed FIRST: its captured fates are the
            # removed node's un-reset lists, and the scrub empties them so
            # _drop_staged_fates cannot fail the same futures twice
            removed, self._removed_nodes = self._removed_nodes, []
            for n in removed:
                if self._is_registered(n):
                    continue  # re-admitted since removal
                self._scrub_pending_ctx(n)
                self._drop_staged_fates(n)
                if nodes.get(n.lane) is n:
                    nodes.pop(n.lane)
            if not (had_work or self._device_pending()):
                if self._pending_ctx is not None:
                    # nothing new to dispatch — drain the pipeline: the
                    # in-flight step's outputs still owe applies, futures
                    # and events, and retiring re-dirties its lanes so
                    # follow-on work stages next iteration
                    ctx, self._pending_ctx = self._pending_ctx, None
                    with annotate("kernel_engine.process_outputs"):
                        self._process_outputs(ctx)
                    return True
                return False

            ctx = _StepCtx(
                nodes=nodes,
                fates={g: nodes[g]._staged_props
                       for g in self._staged_rows if g in nodes},
                staged_ri={g: n._staged_ri for g, n in staged
                           if n._staged_ri is not None},
                staged_rows=set(self._staged_rows),
            )
            if lifecycle.TRACER.enabled:
                ctx.traced = [e.key for fl in ctx.fates.values()
                              for e, _origin in fl
                              if e.key and lifecycle.TRACER.sampled(e.key)]
            with self._step_timer.measure():
                overlapped = self._pending_ctx is not None
                if overlapped:
                    # retire step N-1 BEFORE the donating dispatch of N
                    pending, self._pending_ctx = self._pending_ctx, None
                    with annotate("kernel_engine.process_outputs"):
                        self._process_outputs(pending)
                with annotate("kernel_engine.step"):
                    if not self._compiled_once:
                        # serialize FIRST calls across engines: on the
                        # card the first step builds and loads the kernel
                        # library; after it the lock is never touched
                        with KernelEngine._first_compile_mu:
                            state, out = self._kernel_call(inbox, inp)
                        self._compiled_once = True
                    else:
                        state, out = self._kernel_call(inbox, inp)
                self.state = state
                ctx.out = out
                for k in ctx.traced:
                    lifecycle.TRACER.stamp(k, lifecycle.STAGE_DISPATCH)
                self._pipe_steps += 1
                if self.pipeline_depth > 0:
                    # defer the fetch: the outputs are consumed one step
                    # late, overlapping device step N+1 with this retire
                    self._pending_ctx = ctx
                    self._buf_idx ^= 1
                    if overlapped:
                        self._pipe_overlapped += 1
                    m = self.events.metrics
                    m.inc("engine.pipeline.steps")
                    if overlapped:
                        m.inc("engine.pipeline.overlapped")
                    m.set("engine.pipeline.occupancy_pct",
                          100 * self._pipe_overlapped
                          // max(1, self._pipe_steps))
                else:
                    with annotate("kernel_engine.process_outputs"):
                        self._process_outputs(ctx)
            if self.fleet_stats_every > 0:
                self._fleet_countdown -= 1
                if self._fleet_countdown <= 0:
                    self._fleet_countdown = self.fleet_stats_every
                    self._collect_fleet_stats()
                    if self.health_top_k > 0:
                        self._collect_health()
                    if self.invariant_probe:
                        self._collect_invariants()
                    self._collect_capacity()
            return True

    def _is_registered(self, n: KernelNode) -> bool:
        # identity, not membership: with a deferred (pipelined) output
        # pass the same shard id can be re-admitted as a NEW node while
        # the old one's step is still in flight
        return self.by_shard.get(n.shard_id) is n

    @staticmethod
    def _fail_fates(fates) -> None:
        for entry, origin in fates:
            if entry.is_config_change():
                origin.pending_config_change.done(
                    entry.key, RequestResultCode.DROPPED)
            else:
                origin._rl_release(entry.key)
                origin.pending_proposals.dropped(entry.key)

    def _drop_staged_fates(self, n: KernelNode) -> None:
        self._fail_fates(n._staged_props)
        n._staged_props = []

    def _scrub_pending_ctx(self, n: KernelNode) -> None:
        """Remove a dead node's rows from the in-flight step ctx: fail
        its staged-proposal futures now (the retire pass will skip the
        row) rather than letting them time out against a node whose
        books no longer exist."""
        ctx = self._pending_ctx
        if ctx is None or ctx.nodes.get(n.lane) is not n:
            return
        fates = ctx.fates.pop(n.lane, None)
        if fates:
            if n._staged_props is fates:
                n._staged_props = []
            self._fail_fates(fates)
        ctx.staged_ri.pop(n.lane, None)
        ctx.dead.add(n.lane)

    def _make_dispatch(self):
        """Dispatch-backend factory — the sanctioned seam an engine
        subclass uses to change WHERE the step runs (serial step vs the
        parallel/ici.py shard_map path) without growing a second step
        loop.  Called once at the end of __init__."""
        from dragonboat_tpu_torch.engine.dispatch import SerialDispatch

        # bind THIS module's globals at construction: chaos tests swap
        # kernel_step/kernel_step_donated for mutated kernels here
        return SerialDispatch(self.kp, kernel_step, kernel_step_donated)

    def _device_pending(self) -> bool:
        """True while the dispatch backend carries undelivered messages
        between steps (the mesh backend's device-resident inbox); the
        serial backend re-stages from host queues and never does."""
        return self._dispatch.pending()

    def _fleet_inbox_from(self) -> torch.Tensor:
        """[G, K] sender ids feeding the inbox-occupancy histogram: the
        backend picks the host-staged builder (a host array, which the
        reduction uploads inside its caller's sanctioned crossing, as the
        reference's jitted reductions take it) or its carried box (already
        on the device)."""
        return self._dispatch.inbox_from(self._inbox_buf)

    def _collect_fleet_stats(self) -> None:
        """Decimated fleet telemetry: one reduction over the resident
        state, one small struct fetched to host (core/fleet.py).  Runs
        under engine.mu right after a step, so the state it reads is
        exactly the state the step produced."""
        from dragonboat_tpu_torch.core import fleet as _fleet

        with _capacity.METER.sanctioned("fleet_down"):
            stats = self._cap_entries["fleet_stats"](
                self._dispatch.join(self.state), self._fleet_inbox_from())
            self.last_fleet = _fleet.stats_to_dict(stats)

    def _make_health_digest(self):
        """Fresh all-zero digest matching the engine's lane geometry on
        the engine's device, placed by the dispatch backend."""
        from dragonboat_tpu_torch.core import health as _health

        return self._dispatch.shard(
            _health.empty_digest(self.capacity, self.device))

    def _collect_health(self) -> None:
        """Decimated anomaly classification (core/health.py), on the
        same cadence (and under the same engine.mu post-step window) as
        ``_collect_fleet_stats``.  The digest carry never leaves the
        device; one O(K) HealthReport is fetched.  Class-count edges
        (0 -> nonzero and back) are recorded as flight-recorder
        anomaly_raised/anomaly_cleared events stamped with the engine's
        health-tick sequence — never the wall clock."""
        from dragonboat_tpu_torch import flight
        from dragonboat_tpu_torch.core import health as _health

        if self._health_digest is None:
            self._health_digest = self._make_health_digest()
        with _capacity.METER.sanctioned("health_down"):
            report, self._health_digest = self._cap_entries["fleet_health"](
                self._dispatch.join(self.state), self._fleet_inbox_from(),
                self._health_digest,
                thresholds=self.health_thresholds, k=self.health_top_k)
            cur = _health.report_to_dict(report)
        prev = self.last_health
        self._health_seq += 1
        self.last_health = cur
        prev_counts = prev["class_count"] if prev else {}
        for cls, n in cur["class_count"].items():
            was = prev_counts.get(cls, 0)
            if n > 0 and was == 0:
                flight.record(flight.ANOMALY_RAISED, cls=cls, count=n,
                              tick=self._health_seq)
            elif n == 0 and was > 0:
                flight.record(flight.ANOMALY_CLEARED, cls=cls,
                              tick=self._health_seq)

    def _make_invariant_digest(self):
        """Fresh all-zero invariant digest matching the engine's lane
        geometry on the engine's device (same placement story as the
        health digest)."""
        from dragonboat_tpu_torch.core import invariants as _invariants

        return self._dispatch.shard(
            _invariants.empty_digest(self.capacity, self.device))

    def _collect_invariants(self) -> None:
        """Decimated protocol-invariant probe (core/invariants.py), on
        the same cadence (and under the same engine.mu post-step window)
        as ``_collect_fleet_stats``.  Lanes whose occupant changed since
        the last probe tick are re-seeded (ticks=0, out of place) so
        step-scoped invariants never compare across occupants.  A 0 ->
        nonzero violation edge is recorded as an ``invariant_violation``
        flight event stamped with the probe-tick sequence — never the
        wall clock."""
        from dragonboat_tpu_torch import flight
        from dragonboat_tpu_torch.core import invariants as _invariants

        if self._inv_digest is None:
            self._inv_digest = self._make_invariant_digest()
        with _capacity.METER.sanctioned("invariants_down"):
            with self.mu:
                dirty, self._inv_dirty = self._inv_dirty, set()
            if dirty:
                lanes = _upload(np.array(sorted(dirty), np.int64),
                                self.device)
                d = self._inv_digest
                self._inv_digest = d._replace(
                    ticks=_put_rows(d.ticks, lanes, 0))
            report, self._inv_digest = self._cap_entries[
                "check_invariants"](self._dispatch.join(self.state),
                                    self._inv_digest)
            cur = _invariants.report_to_dict(report)
        prev = self.last_invariants
        self._inv_seq += 1
        self._inv_violations_seen += cur["total"]
        cur["violations_seen"] = self._inv_violations_seen
        self.last_invariants = cur
        was = prev["total"] if prev else 0
        if cur["total"] > 0 and was == 0:
            first = cur["first"] or {}
            flight.record(flight.INVARIANT_VIOLATION,
                          total=cur["total"],
                          lane=first.get("lane", -1),
                          invariants=first.get("invariants", []),
                          tick=self._inv_seq)

    def _capacity_entries(self) -> dict:
        """Call-count wrappers for every entry this engine dispatches:
        the backend's step entries plus the shared telemetry reductions.
        Each engine wraps independently (own counters).  On the card
        the step entries are CUDA graphs (``graphs.py``): a capture
        counts as the entry's compile.  The reductions run eagerly and
        record none."""
        from dragonboat_tpu_torch.core import fleet as _fleet
        from dragonboat_tpu_torch.core import health as _health
        from dragonboat_tpu_torch.core import invariants as _invariants

        entries = dict(self._dispatch.entries)
        entries.update({
            "fleet_stats": _capacity.TRACKER.wrap(
                "fleet_stats", _fleet.fleet_stats),
            "fleet_health": _capacity.TRACKER.wrap(
                "fleet_health", _health.fleet_health),
            "check_invariants": _capacity.TRACKER.wrap(
                "check_invariants", _invariants.check_invariants),
        })
        return entries

    def _capacity_trees(self) -> tuple:
        """Device-resident trees this engine keeps alive between steps
        (the mesh backend adds its carried inbox)."""
        return (self.state, self._health_digest, self._inv_digest) \
            + self._dispatch.resident_trees()

    def _capacity_model_classes(self) -> tuple:
        """Contract classes resident on device for this engine's
        geometry: the serial backend re-stages its inbox from host each
        step, so only state + digests persist."""
        return ("ShardState", "HealthDigest", "InvariantDigest") \
            + self._dispatch.resident_classes()

    def _collect_capacity(self) -> None:
        """Decimated capacity accounting, riding the fleet cadence under
        the same engine.mu post-step window: live bytes of the resident
        trees (shape-derived — no device sync), allocator stats where
        the backend reports them, the contracts capacity model at this
        geometry, and the call counters.  The memory_pressure watermark
        crossing is recorded as an edge-triggered flight event stamped
        with the capacity tick — never the wall clock."""
        from dragonboat_tpu_torch import flight

        live = _capacity.measure_tree_bytes(*self._capacity_trees())
        self._capacity_seq += 1
        self._capacity_peak = max(self._capacity_peak, live)
        prev = self.last_capacity
        cur = _capacity.engine_snapshot(
            self.kp, self.capacity, live, self._capacity_peak,
            {name: w.stats() for name, w in self._cap_entries.items()},
            budget_bytes=self.capacity_budget_bytes,
            watermark_pct=self.capacity_watermark_pct,
            ticks=self._capacity_seq,
            classes=self._capacity_model_classes())
        self.last_capacity = cur
        was = bool(prev and prev["memory_pressure"])
        if cur["memory_pressure"] and not was:
            flight.record(flight.MEMORY_PRESSURE,
                          bytes_in_use=cur["bytes_in_use"],
                          budget_bytes=cur["budget_bytes"],
                          headroom_pct=cur["headroom_pct"],
                          tick=self._capacity_seq)

    def health_row(self, lane: int) -> dict:
        """One lane's drill-down row (NodeHost.shard_info): O(1) scalars
        picked on the device and fetched in one crossing — the full
        ShardState is never materialized on host."""
        from dragonboat_tpu_torch.core import health as _health

        with self.mu:
            if self._health_digest is None:
                self._health_digest = self._make_health_digest()
            with _capacity.METER.sanctioned("health_row"):
                row = _health.shard_row(
                    self._dispatch.join(self.state), self._fleet_inbox_from(),
                    self._health_digest, lane,
                    thresholds=self.health_thresholds)
                return _health.row_to_dict(row)

    def _kernel_call(self, inbox: _InboxBuilder, inp: _InputBuilder):
        # depth > 0 routes through the backend's donating entry.  After
        # a donating dispatch the host must not read the passed-in state
        # again — step_all's retire-before-dispatch order upholds that
        return self._dispatch.dispatch(
            self.state, inbox, inp, donate=self.pipeline_depth > 0)

    # -- staging ----------------------------------------------------------

    def _stage_lane(self, g: int, n: KernelNode, inbox: _InboxBuilder,
                    inp: _InputBuilder) -> bool:
        work = False
        with n.mu:
            msgs, n.incoming_msgs = n.incoming_msgs, []
            props, n.incoming_proposals = n.incoming_proposals, []
            cc_entry, n.config_change_entry = n.config_change_entry, None
            transfer, n.transfer_target = n.transfer_target, None
            ss_req, n.snapshot_request = n.snapshot_request, None
            lq, n.log_query_range = n.log_query_range, None
            compact_key, n.compaction_request_key = (
                n.compaction_request_key, None)
            ticks, n._tick_pending = n._tick_pending, 0
            # sticky transfer lease: the kernel aborts an armed transfer
            # at its next check-quorum round (core/kernel.py abort_tr),
            # which under apply backpressure fires before the transferee
            # can catch up — a one-shot staging then loses the request
            # forever.  Re-arm every step while the transfer future is
            # live; the re-arm is a no-op while ltt is set, and the book
            # timeout (pending_transfer.gc) bounds the lease
            if transfer is None and n._transfer_awaiting is not None:
                if n.pending_transfer.outstanding is not None:
                    transfer = n._transfer_awaiting[0]
                else:
                    n._transfer_awaiting = None    # timed out: lease over

        # an InstallSnapshot forces eviction — restore everything drained
        # so the successor Node inherits it intact
        if any(m.type == MT.INSTALL_SNAPSHOT for m in msgs):
            with n.mu:
                n.incoming_msgs = (
                    [m for m in msgs if m.type != MT.INSTALL_SNAPSHOT]
                    + n.incoming_msgs)
                n.incoming_proposals = props + n.incoming_proposals
                n.config_change_entry = n.config_change_entry or cc_entry
                n.transfer_target = n.transfer_target or transfer
                n.snapshot_request = n.snapshot_request or ss_req
                n.log_query_range = n.log_query_range or lq
                n.compaction_request_key = (n.compaction_request_key
                                            or compact_key)
            self._evict(n, reason="install-snapshot",
                        carry=[m for m in msgs
                               if m.type == MT.INSTALL_SNAPSHOT])
            return True

        # host-side ops that never touch the device
        if lq is not None:
            self._answer_log_query(n, lq)
        if compact_key is not None:
            n._process_compaction(compact_key)

        requeue: list[pb.Message] = []
        for m in msgs:
            if m.type == MT.LOCAL_TICK:
                ticks += 1
            elif m.type == MT.READ_INDEX:
                # a follower host forwarded a read (hint carries its ctx)
                n._remote_reads.append(
                    (m.from_, pb.SystemCtx(low=m.hint, high=m.hint_high)))
            elif m.type == MT.READ_INDEX_RESP:
                n._local_ri_pending.pop(m.hint, None)
                n.pending_reads.add_ready(
                    pb.SystemCtx(low=m.hint, high=m.hint_high), m.log_index)
                n.pending_reads.applied(n.sm.get_last_applied())
            elif m.type in _KERNEL_MTYPES:
                if not inbox.add(g, m, n):
                    requeue.append(m)
                work = True
            # other local/quiesce messages: ignored on the kernel path
        if requeue:
            with n.mu:
                n.incoming_msgs = requeue + n.incoming_msgs

        # proposals -> prop lanes (payload staged by slot, fate correlated
        # in _process_outputs)
        if cc_entry is not None or props:
            self._stage_props(g, n, inp, cc_entry, props)
            work = True

        # one batched ReadIndex ctx per step: prefer a forwarded remote
        # read, else the local batch (node.go:1296)
        n._staged_ri = None
        ri_from = 0
        if n._remote_reads:
            ri_from, ctx = n._remote_reads.pop(0)
            n._staged_ri = ctx
            n._remote_ri_inflight[ctx.low] = ri_from
            inp.read(g, ctx)
            work = True
        else:
            ctx = n.pending_reads.peep()
            if ctx is not None:
                if n.is_leader() or len(self._peers_of(n)) == 1:
                    n._staged_ri = ctx
                    n._local_ri_pending[ctx.low] = ctx
                    inp.read(g, ctx)
                elif n._leader_cache != 0:
                    # forward to the leader host (raft.go ReadIndex
                    # leader forwarding)
                    n._local_ri_pending[ctx.low] = ctx
                    n.send_message(pb.Message(
                        type=MT.READ_INDEX, from_=n.replica_id,
                        to=n._leader_cache, shard_id=n.shard_id,
                        hint=ctx.low, hint_high=ctx.high))
                else:
                    n.pending_reads.dropped(ctx)
                work = True
        n._staged_ri_from = ri_from

        if transfer is not None:
            inp.transfer(g, transfer)
            work = True
        if ss_req is not None:
            self._take_lane_snapshot(n, ss_req)
        if ticks:
            inp.tick(g)
            work = True
        inp.applied(g, n.sm.get_last_applied())
        # anything left queued (inbox overflow requeues, extra remote
        # reads, an unserved local read batch) re-stages next step
        with n.mu:
            residual = bool(n.incoming_msgs or n.incoming_proposals
                            or n._remote_reads
                            or n.config_change_entry is not None
                            or n.transfer_target is not None
                            or n._transfer_awaiting is not None
                            or n.snapshot_request is not None
                            or n.log_query_range is not None
                            or n.compaction_request_key is not None
                            or n._tick_pending)
        # non-destructive batch probe: peep() here would move the batch
        # under a fresh ctx that nothing ever stages — its readers would
        # sit in pending until the timeout GC fires
        if residual or n.pending_reads.batching:
            self.mark_dirty(g)
        return work

    def _prop_target(self, n: KernelNode) -> tuple[int, KernelNode]:
        """(row, node) whose prop lanes this node's proposals stage into.
        The single-device engine always proposes on its own lane (the
        kernel drops non-leader proposals and the client retries); mesh
        engines override to forward to the group's leader row."""
        return n.lane, n

    def _stage_props(self, g: int, n: KernelNode, inp: _InputBuilder,
                     cc_entry, props) -> None:
        """Stage cc + proposals into prop slots, remembering the origin
        node per slot so fates (drop/mirror) land on the right books."""
        tg, tn = self._prop_target(n)
        with self.mu:
            self._staged_rows.add(tg)
        slot = self._slot_cursor.get(tg, 0)
        if cc_entry is not None:
            if slot < inp.B:
                inp.prop(tg, slot, True)
                tn._staged_props.append((cc_entry, n))
                slot += 1
            else:
                with n.mu:
                    n.config_change_entry = n.config_change_entry or cc_entry
        for e in props:
            if slot >= inp.B:
                with n.mu:
                    n.incoming_proposals.append(e)
                continue
            inp.prop(tg, slot, False)
            tn._staged_props.append((e, n))
            if e.key:
                lifecycle.TRACER.stamp(e.key, lifecycle.STAGE_STAGE)
            slot += 1
        self._slot_cursor[tg] = slot

    def _peers_of(self, n: KernelNode) -> dict[int, str]:
        m = n.sm.get_membership()
        return {**m.addresses, **m.non_votings, **m.witnesses}

    # -- output processing -------------------------------------------------

    def _process_outputs(self, ctx: _StepCtx) -> None:
        """Retire one dispatched step: resolve proposal fates, emit
        messages, persist, apply, complete reads, fire events.  Serial
        mode calls this inline; pipelined mode one step late (the ctx
        carries the fates/read ctxs that staging has since rebound).

        The fetch is MASKED: a [G, C] per-class activity matrix (one
        tiny reduction, core/kernel.py output_row_flags) plus the
        cheap [G] scalars decide which lanes and which message classes
        are live, and only those fields are pulled to host (_LazyOut) —
        the eager 42-field np.asarray sweep was ~80% of step wall clock
        at 20k lanes."""
        nodes, out = ctx.nodes, ctx.out
        for k in ctx.traced:
            lifecycle.TRACER.stamp(k, lifecycle.STAGE_RETIRE)
        with _capacity.METER.sanctioned("output_flags"):
            if isinstance(out, graphs.Split):
                # per position, on its device
                flags = np.concatenate([
                    output_row_flags(o, self._row_flags).cpu().numpy()
                    for o in out])
            else:
                flags = output_row_flags(out, self._row_flags).cpu().numpy()
        # the dispatch backend derives drain-pending from the same flags
        # (MeshDispatch dropped its per-step pending-scalar download)
        self._dispatch.note_output_flags(flags)
        o = _LazyOut(out)
        pid = self._pid_np
        kind = self._kind_np
        # shards whose witness peer needs a snapshot but have no recorded
        # snapshot to strip — they take the regular eviction slow path
        self._wit_snap_fallback: set[int] = set()

        updates: list[pb.Update] = []
        replicates: list[pb.Message] = []
        others: list[pb.Message] = []
        # lanes with anything to process, found VECTORIZED — per-lane
        # Python here was 16 us/lane/step at 100k lanes.  The mask must
        # cover every consumer below: emitted messages and snapshot
        # needs (all eight flag columns), save/apply windows and quiet
        # term/vote/commit changes (_build_update persists a bump even
        # when no message went out), dropped reads (_complete_reads),
        # leader-cache deltas (_leader_edge), and escalation flags;
        # staged proposal fates ride ctx.staged_rows below.
        active = (
            flags.any(1)
            | (o["save_last"] >= o["save_first"])
            | (o["apply_last"] >= o["apply_first"])
            | o["ri_dropped"]
            | o["needs_host"]
            | (o["term"] != self._triple_np[:, 0])
            | (o["vote"] != self._triple_np[:, 1])
            | (o["commit"] != self._triple_np[:, 2])
            | (o["leader"] != self._lead_np)
            | (o["leader_term"] != self._lead_term_np)
        ) & self._occ_np
        cand_ids = set(np.nonzero(active)[0].tolist())
        cand_ids.update(ctx.staged_rows)
        cand_ids.difference_update(ctx.dead)
        # identity check, not membership: a row whose node was removed
        # (and possibly re-admitted) while the step was in flight must
        # not have stale outputs applied to the successor's books
        cand = [(g, nodes[g]) for g in sorted(cand_ids)
                if g in nodes and self.nodes.get(g) is nodes[g]]
        # every processed lane re-stages once next step: multi-window
        # pipelines (apply batches, read books, ring compaction) advance
        # by re-examination, exactly as the full scan did
        with self._dirty_mu:
            self._dirty.update(g for g, _n in cand)
        save_rows = [g for g, n in cand
                     if o["save_last"][g] >= o["save_first"][g]]
        lt_rows = {}
        if save_rows:
            with _capacity.METER.sanctioned("lt_rows"):
                lt_rows = dict(zip(save_rows,
                                   ici.take_rows(self.state.lt, save_rows)))

        for g, n in cand:
            # 1. proposal fates (origin holds the future's books — on a
            # mesh engine forwarded proposals stage on the leader row)
            fates = ctx.fates.get(g)
            if fates:
                for slot, (entry, origin) in enumerate(fates):
                    if o["prop_accepted"][g, slot]:
                        index = int(o["prop_index"][g, slot])
                        term = int(o["prop_term"][g, slot])
                        n.mirror[index] = _dc_replace(
                            entry, index=index, term=term)
                    else:
                        if entry.is_config_change():
                            origin.pending_config_change.done(
                                entry.key, RequestResultCode.DROPPED)
                        else:
                            origin._rl_release(entry.key)
                            origin.pending_proposals.dropped(entry.key)
            if fates is not None and n._staged_props is fates:
                # serial mode retires before the next staging rebinds
                # the list; pipelined mode's rebind already happened
                n._staged_props = []

            # 2. outgoing messages, gated per class on the flag row
            self._emit_messages(g, n, o, flags[g], pid, kind,
                                replicates, others)

            # 3. persistence batch
            ud = self._build_update(g, n, o, lt_rows.get(g))
            if ud is not None:
                updates.append((n, ud))

        # replicate-before-fsync (engine.go:1332-1343)
        for sender, m in replicates:
            self._send(sender, m)
        if updates:
            # one batched fsync per LogDB (nodes of a shared mesh engine
            # belong to different NodeHosts, each with its own LogDB)
            by_db: dict[int, tuple[object, list]] = {}
            for n, ud in updates:
                by_db.setdefault(id(n.logdb), (n.logdb, []))[1].append(ud)
                if lifecycle.TRACER.enabled:
                    for e in ud.entries_to_save:
                        if e.key:
                            lifecycle.TRACER.stamp(
                                e.key, lifecycle.STAGE_SAVE)
            for db, uds in by_db.values():
                db.save_raft_state(uds, worker_id=0)
        for sender, m in others:
            self._send(sender, m)

        for g, n in cand:
            # a whole-group eviction earlier in THIS loop (mesh engine)
            # already handed the sibling rows to host-resident successor
            # nodes — touching their SMs/books here would race them
            if not self._is_registered(n):
                continue
            n._committed_cache = int(o["commit"][g])
            # 4. ReadIndex results
            self._complete_reads(g, n, o, flags[g], ctx.staged_ri.get(g))
            # 5. apply released entries
            self._apply(g, n, o)
            # 6. leader edges
            self._leader_edge(g, n, int(o["leader"][g]),
                              int(o["leader_term"][g]))
            self._lead_np[g] = int(o["leader"][g])
            self._lead_term_np[g] = int(o["leader_term"][g])
            # 7. escalation
            if o["needs_host"][g]:
                self._evict(n, reason="kernel escalation")
            elif n.shard_id in self._wit_snap_fallback:
                self._evict(n, reason="witness snapshot without record")

    def _emit_messages(self, g, n, o, fl, pid, kind,
                       replicates, others) -> None:
        """Build this row's outgoing messages.  ``fl`` is the row of the
        [G, C] class-activity matrix: a class whose bit is clear is
        never indexed, so its wide output field is never fetched."""
        E = self.kp.msg_entries
        shard = n.shard_id
        # response lanes
        if fl[_F_RESP]:
            for k in range(o["r_type"].shape[1]):
                rt = int(o["r_type"][g, k])
                if rt == 0:
                    continue
                others.append((n, pb.Message(
                    type=pb.MessageType(rt), to=int(o["r_to"][g, k]),
                    from_=n.replica_id, shard_id=shard,
                    term=int(o["r_term"][g, k]),
                    log_index=int(o["r_log_index"][g, k]),
                    reject=bool(o["r_reject"][g, k]),
                    hint=int(o["r_hint"][g, k]),
                    hint_high=int(o["r_hint_high"][g, k]),
                )))
        rep, hb = bool(fl[_F_REP]), bool(fl[_F_HB])
        vote, tnow = bool(fl[_F_VOTE]), bool(fl[_F_TIMEOUT])
        wsnap = bool(fl[_F_WITSNAP])
        if not (rep or hb or vote or tnow or wsnap):
            return
        # per-peer lanes
        for p in range(pid.shape[1]):
            to = int(pid[g, p])
            if to == 0 or to == n.replica_id:
                continue
            to_witness = int(kind[g, p]) == KP.K_WITNESS
            if rep and o["s_rep"][g, p]:
                prev = int(o["s_prev_index"][g, p])
                cnt = int(o["s_n_ent"][g, p])
                ents = []
                for j in range(cnt):
                    idx = prev + 1 + j
                    e = n.mirror.get(idx)
                    term = int(o["s_ent_term"][g, p, j])
                    if e is None:
                        e = pb.Entry(index=idx, term=term)
                    elif e.term != term:
                        e = _dc_replace(e, term=term)
                    if to_witness and not e.is_config_change():
                        # witnesses never see payloads (raft.go:770
                        # makeMetadataEntries); CCs ship in full
                        e = pb.Entry(index=idx, term=term,
                                     type=pb.EntryType.METADATA)
                    ents.append(e)
                replicates.append((n, pb.Message(
                    type=MT.REPLICATE, to=to, from_=n.replica_id,
                    shard_id=shard, term=int(o["term"][g]),
                    log_index=prev, log_term=int(o["s_prev_term"][g, p]),
                    commit=int(o["s_commit"][g, p]),
                    entries=tuple(ents),
                )))
            if wsnap and o["s_wit_snap"][g, p]:
                # witness peer fell behind compaction: answer with the
                # stripped file-less snapshot built from the recorded
                # snapshot (raft.go:713-735) — no stream, no eviction.
                # The record must cover the DEVICE compaction floor: the
                # device paused the peer at psnap = snap_index, and a
                # stale older record would leave a gap the witness can
                # never bridge (re-sent forever) — evict instead.
                ss = n.logdb.get_snapshot(n.shard_id, n.replica_id)
                with _capacity.METER.sanctioned("wit_snap_floor"):
                    floor = int(ici.take_rows(  # wit_snap only
                        self.state.snap_index, [g])[0])
                if ss is not None and not ss.is_empty() \
                        and ss.index >= floor:
                    others.append((n, pb.Message(
                        type=MT.INSTALL_SNAPSHOT, to=to,
                        from_=n.replica_id, shard_id=shard,
                        term=int(o["term"][g]),
                        snapshot=_dc_replace(
                            ss, filepath="", file_size=0, files=(),
                            witness=True, dummy=False),
                    )))
                else:
                    # no record, or one below the device floor — the
                    # regular escalation path recovers the shard
                    self._wit_snap_fallback.add(n.shard_id)
            if hb and o["s_hb"][g, p]:
                others.append((n, pb.Message(
                    type=MT.HEARTBEAT, to=to, from_=n.replica_id,
                    shard_id=shard, term=int(o["term"][g]),
                    commit=int(o["s_hb_commit"][g, p]),
                    hint=int(o["s_hb_low"][g, p]),
                    hint_high=int(o["s_hb_high"][g, p]),
                )))
            sv = int(o["s_vote"][g, p]) if vote else 0
            if sv:
                others.append((n, pb.Message(
                    type=(MT.REQUEST_VOTE if sv == 1
                          else MT.REQUEST_PREVOTE),
                    to=to, from_=n.replica_id, shard_id=shard,
                    term=int(o["s_vote_term"][g, p]),
                    log_index=int(o["s_vote_lindex"][g, p]),
                    log_term=int(o["s_vote_lterm"][g, p]),
                    hint=int(o["s_vote_hint"][g, p]),
                )))
            if tnow and o["s_timeout_now"][g, p]:
                others.append((n, pb.Message(
                    type=MT.TIMEOUT_NOW, to=to, from_=n.replica_id,
                    shard_id=shard, term=int(o["term"][g]))))

    def _build_update(self, g, n, o, lt_row) -> pb.Update | None:
        first, last = int(o["save_first"][g]), int(o["save_last"][g])
        triple = (int(o["term"][g]), int(o["vote"][g]), int(o["commit"][g]))
        entries: list[pb.Entry] = []
        if lt_row is not None and last >= first:
            cap = self.kp.log_cap
            for idx in range(first, last + 1):
                term = int(lt_row[idx & (cap - 1)])
                e = n.mirror.get(idx)
                if e is None or e.term != term:
                    e = (_dc_replace(e, term=term) if e is not None
                         else pb.Entry(index=idx, term=term))
                    n.mirror[idx] = e
                entries.append(e)
        state_changed = tuple(self._triple_np[n.lane]) != triple
        if not entries and not state_changed:
            return None
        self._triple_np[n.lane] = triple
        return pb.Update(
            shard_id=n.shard_id, replica_id=n.replica_id,
            state=pb.State(term=triple[0], vote=triple[1], commit=triple[2]),
            entries_to_save=tuple(entries),
        )

    def _complete_reads(self, g, n, o, fl, staged_ri) -> None:
        """``staged_ri`` is the ReadIndex ctx staged into THIS step (from
        the step ctx — staging for the next step rebinds ``n._staged_ri``
        before a pipelined retire runs)."""
        if fl[_F_RTR]:
            rtr = o["rtr_valid"][g]
            for j in range(rtr.shape[0]):
                if not rtr[j]:
                    continue
                low = int(o["rtr_low"][g, j])
                high = int(o["rtr_high"][g, j])
                index = int(o["rtr_index"][g, j])
                ctx = pb.SystemCtx(low=low, high=high)
                if low in n._local_ri_pending:
                    n._local_ri_pending.pop(low)
                    n.pending_reads.add_ready(ctx, index)
                elif low in n._remote_ri_inflight:
                    # remote read answered: respond to the requester
                    self._send(n, pb.Message(
                        type=MT.READ_INDEX_RESP,
                        to=n._remote_ri_inflight.pop(low),
                        from_=n.replica_id, shard_id=n.shard_id,
                        log_index=index, hint=low, hint_high=high))
        if o["ri_dropped"][g] and staged_ri is not None:
            low = staged_ri.low
            if low in n._local_ri_pending:
                n._local_ri_pending.pop(low)
                n.pending_reads.dropped(staged_ri)
            n._remote_ri_inflight.pop(low, None)
        n.pending_reads.applied(n.sm.get_last_applied())

    def _apply(self, g, n, o) -> None:
        first, last = int(o["apply_first"][g]), int(o["apply_last"][g])
        if last < first:
            return
        entries = []
        for idx in range(first, last + 1):
            e = n.mirror.get(idx)
            if e is None:
                e = pb.Entry(index=idx, term=int(o["term"][g]))
                n.mirror[idx] = e
            entries.append(e)
        for e in entries:
            if e.key:
                n._rl_release(e.key)
        if n.notify_commit:
            for e in entries:
                if e.key:
                    n.pending_proposals.committed(e.key)
        results = n.sm.handle(entries)
        if lifecycle.TRACER.enabled:
            for e in entries:
                if e.key:
                    lifecycle.TRACER.stamp(e.key, lifecycle.STAGE_APPLY)
        cc_applied = False
        for r in results:
            entry = next(e for e in entries if e.index == r.index)
            if entry.is_config_change():
                n._on_config_change_applied(entry, r)
                cc_applied = True
            elif r.key:
                n.pending_proposals.applied(
                    r.key, r.client_id, r.series_id, r.result, r.rejected)
        if cc_applied:
            self.update_lane_membership(n)
        n.applied_since_snapshot += len(results)
        n.pending_reads.applied(n.sm.get_last_applied())
        # auto snapshot + mirror pruning (node.go:694 saveSnapshotRequired)
        if (n.cfg.snapshot_entries > 0
                and n.applied_since_snapshot >= n.cfg.snapshot_entries):
            self._take_lane_snapshot(n, _SnapshotRequest())
        self._prune_mirror(n)

    def _mirror_floor(self, n: KernelNode) -> int:
        """Lowest applied cursor that still needs mirror payloads.  On a
        shared mesh mirror this is the MINIMUM across the shard's
        replicas (a lagging/cut member must still find its entries)."""
        return n.sm.get_last_applied()

    def _prune_mirror(self, n: KernelNode) -> None:
        floor = self._mirror_floor(n) - self.kp.compaction_overhead
        if floor <= 0 or len(n.mirror) <= self.kp.log_cap:
            return
        for idx in [i for i in n.mirror if i < floor]:
            del n.mirror[idx]

    def _take_lane_snapshot(self, n: KernelNode,
                            req: _SnapshotRequest) -> None:
        """Host-side RSM snapshot for a kernel shard (the device compacts
        its ring itself; this makes restart/install possible)."""
        n._take_snapshot(req)

    def _answer_log_query(self, n: KernelNode,
                          lq: tuple[int, int, int]) -> None:
        """QueryRaftLog for a device shard, answered host-side from the
        durable log (every committed entry is persisted before release,
        so the LogDB is authoritative up to the lane's commit cursor)."""
        first, last, max_size = lq
        committed = n._committed_cache
        rs = n.logdb.read_raft_state(n.shard_id, n.replica_id, 0)
        avail_first = rs.first_index if rs is not None else 1
        if first < avail_first:
            n._on_log_query_result(pb.LogQueryResult(
                error=1, first_index=avail_first,
                last_index=committed + 1))
            return
        hi = min(last, committed + 1)
        entries = tuple(n.logdb.iterate_entries(
            n.shard_id, n.replica_id, first, hi, max_size)) if hi > first \
            else ()
        n._on_log_query_result(pb.LogQueryResult(
            error=0, first_index=avail_first, last_index=committed + 1,
            entries=entries))

    def _leader_edge(self, g, n: KernelNode, leader: int, term: int) -> None:
        if (leader, term) == (n._leader_cache, n._leader_term_cache):
            return
        n._leader_cache, n._leader_term_cache = leader, term
        n._last_leader = (leader, term)
        # the node's OWN hub: on a shared mesh engine each replica's
        # listeners live on its attaching NodeHost, not the engine's
        n.events.leader_updated(LeaderInfo(
            shard_id=n.shard_id, replica_id=n.replica_id,
            term=term, leader_id=leader))
        with n.mu:
            awaiting = n._transfer_awaiting
        if awaiting is not None and leader == awaiting[0]:
            n._finish_transfer(RequestResultCode.COMPLETED, leader)

    # -- escalation --------------------------------------------------------

    def _evict(self, n: KernelNode, reason: str,
               carry: list[pb.Message] | None = None) -> None:
        """Move a shard from the kernel to the loopback engine: state is
        already durable via the shared LogDB, so the host rebuilds a
        pycore Node from disk and the shard continues there."""
        if self.remove_shard(n.shard_id) is None:
            return  # already evicted/stopped concurrently
        _LOG.info("shard %d: leaving the kernel (%s)", n.shard_id, reason)
        if self.on_evict is not None:
            self.on_evict(n, carry or [])

    on_evict = None  # set by NodeHost

    def _send(self, n: KernelNode, m: pb.Message) -> None:
        # local delivery between lanes of this engine happens through the
        # sending node's NodeHost dispatch (same path as remote; on a
        # shared mesh engine each node routes via its own host)
        n.send_message(m)


# ---------------------------------------------------------------------------
# staging buffers (numpy first, one device transfer per step)
# ---------------------------------------------------------------------------


_FAMILY_OF_TYPE = {
    int(pb.MessageType.REPLICATE): "rep",
    int(pb.MessageType.HEARTBEAT): "hb",
    int(pb.MessageType.REQUEST_VOTE): "vote",
    int(pb.MessageType.REQUEST_PREVOTE): "vote",
    int(pb.MessageType.TIMEOUT_NOW): "vote",
}
# everything else (responses, NOOP, UNREACHABLE, SNAPSHOT_STATUS) -> "resp"


def _upload_into(into, builder, renamed: dict | None = None,
                 rows: slice = slice(None)):
    """Copy rows ``rows`` of a builder's staging arrays into the device
    tree ``into`` (a compiled step's static input), field by field;
    ``renamed`` maps a field to its array, or to None for a field that
    stays all zero."""
    renamed = renamed or {}
    for f, dst in zip(into._fields, into):
        if dst is None:
            continue
        a = renamed[f] if f in renamed else getattr(builder, f)
        if a is None:
            dst.zero_()
        else:
            dst.copy_(torch.from_numpy(a[rows]))
    return into


# the Inbox fields a builder stages, in order (inline payload lanes stay
# None)
_STAGED_INBOX_FIELDS = ("mtype", "from_", "term", "log_term", "log_index",
                        "commit", "reject", "hint", "hint_high", "n_ent",
                        "ent_term", "ent_cc")


class _InboxBuilder:
    def __init__(self, G: int, K: int, E: int,
                 mesh_replicas: int | None = None, device=None) -> None:
        self.K, self.E = K, E
        self.device = resolve_device(device)
        # typed slot layout (params.slot_families): a message may only be
        # staged into a slot whose family accepts its type ('any' accepts
        # all) — the kernel compiles family-specialized handlers per slot
        fams = KP.slot_families(K)
        self._slots_for = {}
        for fam in ("rep", "hb", "vote", "resp"):
            self._slots_for[fam] = tuple(
                k for k, f in enumerate(fams) if f in (fam, "any"))
        # slot-exact mode (mesh engines): hub-fallback deliveries must
        # land at the SAME route() slot the mesh exchange would have
        # used, so the merged carried inbox is bit-identical to a fully
        # resident exchange (core/router.py slot_candidates)
        self._mesh_R = mesh_replicas
        self.mtype = np.zeros((G, K), np.int32)
        self.from_ = np.zeros((G, K), np.int32)
        self.term = np.zeros((G, K), np.int32)
        self.log_term = np.zeros((G, K), np.int32)
        self.log_index = np.zeros((G, K), np.int32)
        self.commit = np.zeros((G, K), np.int32)
        self.reject = np.zeros((G, K), bool)
        self.hint = np.zeros((G, K), np.int32)
        self.hint_high = np.zeros((G, K), np.int32)
        self.n_ent = np.zeros((G, K), np.int32)
        self.ent_term = np.zeros((G, K, E), np.int32)
        self.ent_cc = np.zeros((G, K, E), bool)

    def reset(self) -> None:
        for a in (self.mtype, self.from_, self.term, self.log_term,
                  self.log_index, self.commit, self.reject, self.hint,
                  self.hint_high, self.n_ent, self.ent_term, self.ent_cc):
            a.fill(0)

    def add(self, g: int, m: pb.Message, n: KernelNode) -> bool:
        if self._mesh_R is not None:
            R = self._mesh_R
            if m.from_ == n.replica_id or not (1 <= m.from_ <= R):
                # unroutable on the mesh layout: a stray delivery, not a
                # full inbox — swallow it (True = no requeue) like the
                # pre-round-17 hub drop did
                return True
            cands = _router.slot_candidates(
                n.replica_id, m.from_, R, int(m.type))
        else:
            cands = self._slots_for[_FAMILY_OF_TYPE.get(int(m.type), "resp")]
        k = -1
        for cand in cands:
            if self.mtype[g, cand] == 0:
                k = cand
                break
        if k < 0:
            return False  # family full this step; host requeues the message
        self.mtype[g, k] = int(m.type)
        self.from_[g, k] = m.from_
        self.term[g, k] = m.term
        self.log_term[g, k] = m.log_term
        self.log_index[g, k] = m.log_index
        self.commit[g, k] = m.commit
        self.reject[g, k] = m.reject
        self.hint[g, k] = m.hint
        self.hint_high[g, k] = m.hint_high
        ents = m.entries[:self.E]
        self.n_ent[g, k] = len(ents)
        for j, e in enumerate(ents):
            self.ent_term[g, k, j] = e.term
            self.ent_cc[g, k, j] = e.is_config_change()
            # stage payloads; the kernel decides acceptance, and content
            # at-or-below commit is invariant so overwrites are safe
            n.mirror[e.index] = e
        return True

    def to_device(self, into: Inbox | None = None,
                  pieces: list | None = None):
        """The staged inbox on the device; written into ``into`` (a
        compiled step's static inbox) when given.  ``pieces`` (a split
        mesh): one ``(device, rows, into)`` per position, and the result
        is the positions' inboxes as a ``graphs.Split``, staged in one
        crossing."""

        def stage(into, d, rows):
            if into is not None:
                return _upload_into(into, self, rows=rows)
            return Inbox(*[_upload(getattr(self, f)[rows], d)
                           for f in _STAGED_INBOX_FIELDS])

        with _capacity.METER.sanctioned("inbox_up"):
            if pieces is not None:
                return graphs.Split(stage(i, d, r) for d, r, i in pieces)
            return stage(into, self.device, slice(None))


class _InputBuilder:
    def __init__(self, G: int, B: int, device=None) -> None:
        self.B = B
        self.device = resolve_device(device)
        self.prop_valid = np.zeros((G, B), bool)
        self.prop_cc = np.zeros((G, B), bool)
        self.ri_valid = np.zeros((G,), bool)
        self.ri_low = np.zeros((G,), np.int32)
        self.ri_high = np.zeros((G,), np.int32)
        self.transfer_to = np.zeros((G,), np.int32)
        self._tick = np.zeros((G,), bool)
        self._applied = np.zeros((G,), np.int32)

    def reset(self) -> None:
        for a in (self.prop_valid, self.prop_cc, self.ri_valid, self.ri_low,
                  self.ri_high, self.transfer_to, self._tick, self._applied):
            a.fill(0)

    def prop(self, g: int, slot: int, is_cc: bool) -> None:
        self.prop_valid[g, slot] = True
        self.prop_cc[g, slot] = is_cc

    def read(self, g: int, ctx: pb.SystemCtx) -> None:
        self.ri_valid[g] = True
        self.ri_low[g] = ctx.low & 0x7FFFFFFF
        self.ri_high[g] = ctx.high & 0x7FFFFFFF

    def transfer(self, g: int, target: int) -> None:
        self.transfer_to[g] = target

    def tick(self, g: int) -> None:
        self._tick[g] = True

    def applied(self, g: int, v: int) -> None:
        self._applied[g] = v

    def to_device(self, into: StepInput | None = None,
                  pieces: list | None = None):
        """The staged input on the device; written into ``into`` (a
        compiled step's static input) when given.  ``pieces`` (a split
        mesh): one ``(device, rows, into)`` per position, and the result
        is the positions' inputs as a ``graphs.Split``, staged in one
        crossing."""

        def stage(into, d, rows):
            if into is not None:
                return _upload_into(into, self, {
                    "tick": self._tick, "applied": self._applied,
                    "quiesced": None}, rows)
            return StepInput(
                prop_valid=_upload(self.prop_valid[rows], d),
                prop_cc=_upload(self.prop_cc[rows], d),
                ri_valid=_upload(self.ri_valid[rows], d),
                ri_low=_upload(self.ri_low[rows], d),
                ri_high=_upload(self.ri_high[rows], d),
                transfer_to=_upload(self.transfer_to[rows], d),
                tick=_upload(self._tick[rows], d),
                quiesced=torch.zeros(self._tick[rows].shape,
                                     dtype=torch.bool, device=d),
                applied=_upload(self._applied[rows], d),
            )

        with _capacity.METER.sanctioned("input_up"):
            if pieces is not None:
                return graphs.Split(stage(i, d, r) for d, r, i in pieces)
            return stage(into, self.device, slice(None))
