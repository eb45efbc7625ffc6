"""Fabric observability: per-link transport telemetry, cross-host trace
propagation, and the commit-path hop census.

ROADMAP item 2 ("device-resident message fabric") defines success as
the lifecycle tracer's hub_send/hub_recv spans *disappearing* from
sampled commit paths; this module makes that criterion measurable.
Three legs, one process-global ``FabricMeter`` (``METER`` — the same
one-recorder doctrine as ``flight.RECORDER`` and ``lifecycle.TRACER``;
links span hosts, so the registry must too):

- **per-link telemetry**: every (src, dst) host pair the transport hub
  touches gets typed instruments — send/recv counters labeled by
  message class (request_vote / append / heartbeat / read_index /
  snapshot_chunk / other), byte totals + batch-size histograms, and a
  per-link delivery-latency histogram off the sender's stamped clock —
  exposed at ``/debug/fabric`` and merged into ``NodeHost.info()``.
  Hub queue depths and breaker states are folded into the snapshot
  through weakly-held hub references (``attach_hub``).

- **cross-host trace propagation**: sampled proposals carry a compact
  ``raftpb.FabricHeader`` on the transport frame (native wire: a
  magic-guarded trailer old decoders ignore; go wire: an unknown
  protobuf field reference peers skip).  The receiving host stamps the
  proposal span's ``hub_recv`` on EVERY transport — fixing the round 7
  in-proc-only caveat — and opens a child *remote span* (remote_recv →
  remote_step → ack_return) that ``chrome_events()`` exports with
  ``pid`` = host, stitching into one Chrome trace at ``/trace``.

- **the hop census**: each header crossing increments the traced
  commit's host-hub hop count and distinct-host set; the lifecycle
  tracer's finish/scrub hooks retire the census into a hop-count
  histogram plus the ``fabric.p50_commit_host_hops`` gauge — the
  baseline ROADMAP item 2 must drive to zero
  (``scripts/metrics_dump.py --fabric`` emits it as
  ``build/fabric_census.json``).

Discipline: this module is in BOTH the concurrency and determinism
lint scopes.  It never names a wall clock — the microsecond clock is
injected (``tracing.monotonic_us`` by default, a counter in tests), the
same instruments-observe-caller-values doctrine as lifecycle.py — and
all mutable state is ``guarded-by: mu``.  Distinct-host sets are kept
as insertion-ordered dicts so no set iteration can leak process-varying
order into a snapshot.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque

from dragonboat_tpu_torch import lifecycle
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch import telemetry
from dragonboat_tpu_torch.tracing import monotonic_us

# -- message-class taxonomy (per-link counter labels) -----------------------

CLASS_REQUEST_VOTE = "request_vote"
CLASS_APPEND = "append"
CLASS_HEARTBEAT = "heartbeat"
CLASS_READ_INDEX = "read_index"
CLASS_SNAPSHOT = "snapshot_chunk"
CLASS_OTHER = "other"

MESSAGE_CLASSES = (CLASS_REQUEST_VOTE, CLASS_APPEND, CLASS_HEARTBEAT,
                   CLASS_READ_INDEX, CLASS_SNAPSHOT, CLASS_OTHER)

#: carrier classes for a co-located link (round 17): ``resident`` =
#: consensus traffic rides the in-step mesh collective, ``hub`` = cut /
#: partitioned, host-hub delivered (the fallback matrix in README)
LINK_CLASS_RESIDENT = "resident"
LINK_CLASS_HUB = "hub"
LINK_CLASSES = (LINK_CLASS_RESIDENT, LINK_CLASS_HUB)

_CLASS_OF = {
    pb.MessageType.REQUEST_VOTE: CLASS_REQUEST_VOTE,
    pb.MessageType.REQUEST_VOTE_RESP: CLASS_REQUEST_VOTE,
    pb.MessageType.REQUEST_PREVOTE: CLASS_REQUEST_VOTE,
    pb.MessageType.REQUEST_PREVOTE_RESP: CLASS_REQUEST_VOTE,
    pb.MessageType.REPLICATE: CLASS_APPEND,
    pb.MessageType.REPLICATE_RESP: CLASS_APPEND,
    pb.MessageType.HEARTBEAT: CLASS_HEARTBEAT,
    pb.MessageType.HEARTBEAT_RESP: CLASS_HEARTBEAT,
    pb.MessageType.READ_INDEX: CLASS_READ_INDEX,
    pb.MessageType.READ_INDEX_RESP: CLASS_READ_INDEX,
    pb.MessageType.INSTALL_SNAPSHOT: CLASS_SNAPSHOT,
}


def class_of(mtype) -> str:
    """Message-class label for a raftpb.MessageType."""
    return _CLASS_OF.get(mtype, CLASS_OTHER)


# remote child-span stages (chrome_events pid=host rows); ack_return is
# shared with the origin span's taxonomy — the same instant closes both
STAGE_REMOTE_RECV = "remote_recv"    # header ctx arrived at a remote host
STAGE_REMOTE_STEP = "remote_step"    # remote host sent its quorum response
STAGE_ACK_RETURN = lifecycle.STAGE_ACK_RETURN

# byte-scaled buckets for the per-link batch-size histograms (the
# shared telemetry default is microsecond-scaled)
BYTES_BUCKETS = (64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0,
                 262144.0, 1048576.0)
# host-hub hops per commit are small integers; one bucket per count
HOPS_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)

# Chrome-trace pid offset for host rows: lifecycle spans use
# pid=shard_id (small ints) — remote spans must never collide with them
HOST_PID_BASE = 1_000_000


class _Link:
    """Mutable per-(src, dst) tallies.  Owned by FabricMeter, every
    field mutated only under the meter's ``mu``."""

    __slots__ = ("sent", "recv", "bytes_sent", "bytes_recv",
                 "batches_sent", "batches_recv", "delivery_us")

    def __init__(self, delivery_samples: int) -> None:
        self.sent = dict.fromkeys(MESSAGE_CLASSES, 0)
        self.recv = dict.fromkeys(MESSAGE_CLASSES, 0)
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.batches_sent = 0
        self.batches_recv = 0
        # recent per-batch delivery latencies (sender stamp -> receive)
        self.delivery_us: deque = deque(maxlen=delivery_samples)


def _quantile(samples: list, q: float) -> float:
    """Nearest-rank quantile of a non-empty sorted list."""
    return float(samples[min(len(samples) - 1, int(q * len(samples)))])


class FabricMeter:
    """Process-wide link registry + remote-span book + hop census."""

    def __init__(self, clock=None, registry=None, enabled: bool = True,
                 delivery_samples: int = 512, ring_size: int = 256,
                 max_census: int = 4096, max_remote: int = 4096) -> None:
        self.mu = threading.Lock()
        self._clock = clock if clock is not None else monotonic_us
        self._enabled = bool(enabled)
        self._delivery_samples = max(1, int(delivery_samples))
        self._max_census = max(1, int(max_census))
        self._max_remote = max(1, int(max_remote))
        self._links: dict[tuple[str, str], _Link] = {}      # guarded-by: mu
        # carrier class per directed link ("resident" | "hub"), kept by
        # the mesh engine's cut-mask transitions (round 17)
        self._link_classes: dict[tuple[str, str], str] = {}  # guarded-by: mu
        # hop census per traced proposal key: origin, crossings so far,
        # distinct hosts (insertion-ordered dict used as a set — the
        # determinism lint bans bare set iteration)
        self._census: dict[int, dict] = {}                  # guarded-by: mu
        self._hops_done: deque = deque(maxlen=ring_size)    # guarded-by: mu
        self._census_finished = 0                           # guarded-by: mu
        self._census_dropped = 0                            # guarded-by: mu
        # remote child spans keyed (host, key): stamp lists like the
        # lifecycle tracer's, retired to a bounded ring on ack_return
        self._remote: dict[tuple[str, int], list] = {}      # guarded-by: mu
        self._remote_ring: deque = deque(maxlen=ring_size)  # guarded-by: mu
        # quorum-ack return contexts parked at a remote host, keyed
        # (host, shard): attached to the next response batch home
        self._returns: dict[tuple[str, int], list] = {}     # guarded-by: mu
        # weakly-held transport hubs for queue-depth/breaker folding
        self._hubs: dict[str, object] = {}                  # guarded-by: mu
        # stable Chrome pid per host address, in first-seen order
        self._host_pids: dict[str, int] = {}                # guarded-by: mu
        reg = registry if registry is not None else telemetry.GLOBAL
        self._sent_ctr = reg.counter(
            "fabric.link_sent",
            help="messages sent per (src, dst) link by message class",
            labelnames=("src", "dst", "cls"))
        self._recv_ctr = reg.counter(
            "fabric.link_recv",
            help="messages received per (src, dst) link by message class",
            labelnames=("src", "dst", "cls"))
        self._bytes_hist = reg.histogram(
            "fabric.link_batch_bytes",
            help="per-batch payload bytes per (src, dst) link",
            buckets=BYTES_BUCKETS, labelnames=("src", "dst"))
        self._delivery_hist = reg.histogram(
            "fabric.link_delivery_us",
            help="per-batch delivery latency (sender stamp to receive) "
                 "per (src, dst) link",
            labelnames=("src", "dst"))
        self._hops_hist = reg.histogram(
            "fabric.commit_host_hops",
            help="host-hub hops traversed per sampled commit's quorum "
                 "round (ROADMAP item 2 baseline)",
            buckets=HOPS_BUCKETS)
        reg.gauge_fn(
            "fabric.p50_commit_host_hops", self._p50_hops_fn,
            help="median host-hub hops per sampled commit (recent ring)")
        reg.gauge_fn(
            "fabric.queue_depth", self._queue_depth_fn,
            help="transport-hub send-queue depth per attached host",
            labelnames=("host",))

    # -- configuration ----------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def configure(self, enabled: bool | None = None) -> None:
        """Re-point the process-global meter at a host's expert config
        (NodeHost.__init__); None leaves the knob unchanged."""
        with self.mu:
            if enabled is not None:
                self._enabled = bool(enabled)

    def attach_hub(self, addr: str, hub) -> None:
        """Weakly register a host's TransportHub so snapshots can fold
        in queue depths and breaker states without owning its life."""
        with self.mu:
            self._hubs[addr] = weakref.ref(hub)

    def set_link_class(self, src: str, dst: str, cls: str) -> None:
        """Classify one directed link's carrier for the doctor view:
        ``resident`` (the mesh collective carries it; the hub never
        sees its consensus traffic) or ``hub`` (cut / partitioned /
        off-mesh — host-hub delivered).  The mesh engine refreshes
        these on admission and on every per-link cut flip; unregistered
        links are hub links by construction."""
        if cls not in LINK_CLASSES:
            raise ValueError(f"unknown link class {cls!r} "
                             f"(want one of {sorted(LINK_CLASSES)})")
        with self.mu:
            self._link_classes[(str(src), str(dst))] = cls

    def drop_link_classes(self, addr: str) -> None:
        """Forget every link class touching ``addr`` (replica detached:
        its resident links are gone, not healed)."""
        with self.mu:
            for key in [k for k in self._link_classes
                        if addr in k]:
                del self._link_classes[key]

    def reset(self) -> None:
        """Drop links, census, spans and hub attachments (tests)."""
        with self.mu:
            self._links.clear()
            self._link_classes.clear()
            self._census.clear()
            self._hops_done.clear()
            self._census_finished = 0
            self._census_dropped = 0
            self._remote.clear()
            self._remote_ring.clear()
            self._returns.clear()
            self._hubs.clear()
            self._host_pids.clear()

    # -- gauge callbacks (collect-time, must not hold two locks) ----------

    def _p50_hops_fn(self) -> float:
        with self.mu:
            done = sorted(self._hops_done)
        return _quantile(done, 0.50) if done else 0.0

    def _queue_depth_fn(self) -> dict:
        with self.mu:
            hubs = list(self._hubs.items())
        out = {}
        for addr, ref in hubs:
            hub = ref()
            if hub is None:
                continue
            with hub.mu:
                out[(addr,)] = float(sum(
                    len(q) for q in hub.queues.values()))
        return out

    # -- send path (transport hub flush) ----------------------------------

    def header_for(self, src: str, dst: str,
                   msgs) -> pb.FabricHeader | None:
        """The fabric header for an outbound batch ``src -> dst``:
        sampled replicate entry keys become outbound contexts, and any
        quorum-ack contexts parked here for ``dst`` ride home with
        their hop count advanced.  None when there is nothing to carry
        (the frame stays byte-identical to an old peer's)."""
        if not self._enabled:
            return None
        ctxs: list[pb.FabricContext] = []
        if lifecycle.TRACER.enabled:
            for m in msgs:
                if m.type == pb.MessageType.REPLICATE:
                    for e in m.entries:
                        if e.key and lifecycle.TRACER.sampled(e.key):
                            ctxs.append(pb.FabricContext(
                                key=e.key, origin=src, hop=0,
                                shard_id=m.shard_id))
        resp_shards = {m.shard_id: True for m in msgs
                       if m.type == pb.MessageType.REPLICATE_RESP}
        if resp_shards:
            with self.mu:
                for sid in resp_shards:
                    parked = self._returns.get((src, sid))
                    if not parked:
                        continue
                    keep = []
                    for c in parked:
                        if c.origin == dst:
                            ctxs.append(c)
                        else:
                            keep.append(c)
                    if keep:
                        self._returns[(src, sid)] = keep
                    else:
                        del self._returns[(src, sid)]
        if not ctxs:
            return None
        return pb.FabricHeader(sent_us=self._clock(), ctxs=tuple(ctxs))

    def on_send(self, src: str, dst: str, msgs, nbytes: int,
                header: pb.FabricHeader | None = None) -> None:
        """Successful batch send ``src -> dst``: link counters plus one
        census crossing (and a remote_step stamp) per carried context."""
        if not self._enabled:
            return
        t = self._clock()
        with self.mu:
            link = self._links.get((src, dst))
            if link is None:
                link = self._links[(src, dst)] = \
                    _Link(self._delivery_samples)
            for m in msgs:
                link.sent[class_of(m.type)] += 1
            link.bytes_sent += nbytes
            link.batches_sent += 1
            if header is not None:
                for c in header.ctxs:
                    # one hop-census crossing per carried context
                    cen = self._census.get(c.key)
                    if cen is None:
                        if len(self._census) >= self._max_census:
                            # leak upstream degrades the census, never
                            # host memory (same doctrine as the
                            # tracer's max_active bound)
                            self._census.pop(next(iter(self._census)))
                            self._census_dropped += 1
                        cen = self._census[c.key] = {
                            "origin": c.origin, "hops": 0,
                            "hosts": {c.origin: True}}
                    cen["hops"] += 1
                    cen["hosts"][src] = True
                    cen["hosts"][dst] = True
                    if c.origin != src:
                        # a remote host sending the quorum ack home
                        sp = self._remote.get((src, c.key))
                        if sp is not None:
                            sp.append((STAGE_REMOTE_STEP, t))
        for m in msgs:
            self._sent_ctr.labels(src, dst, class_of(m.type)).inc()
        self._bytes_hist.labels(src, dst).observe(nbytes)

    def on_chunk_sent(self, src: str, dst: str, nbytes: int) -> None:
        """One snapshot chunk left ``src`` for ``dst`` (the chunk path
        bypasses MessageBatch frames)."""
        if not self._enabled:
            return
        with self.mu:
            link = self._links.get((src, dst))
            if link is None:
                link = self._links[(src, dst)] = \
                    _Link(self._delivery_samples)
            link.sent[CLASS_SNAPSHOT] += 1
            link.bytes_sent += nbytes
        self._sent_ctr.labels(src, dst, CLASS_SNAPSHOT).inc()

    # -- receive path (NodeHost inbound seam) -----------------------------

    def on_batch_received(self, local: str, batch: pb.MessageBatch,
                          nbytes: int = 0) -> None:
        """Inbound batch at host ``local``: recv counters, delivery
        latency off the header's sender stamp, hub_recv stamping for
        carried trace contexts (every transport — the round 7 fix), child
        remote spans, and return-context parking for the quorum ack."""
        header = batch.fabric
        if lifecycle.TRACER.enabled:
            if header is not None:
                self._walk_ctxs(local, header)
            else:
                # headerless frame (old peer / fabric off at the
                # sender): the in-proc fallback round 7 shipped — sampled
                # replicate entries stamp straight off the batch
                for m in batch.requests:
                    if m.type == pb.MessageType.REPLICATE:
                        for e in m.entries:
                            if e.key:
                                lifecycle.TRACER.stamp(
                                    e.key, lifecycle.STAGE_HUB_RECV)
        if not self._enabled:
            return
        src = batch.source_address
        if not src:
            return
        delivery = None
        if header is not None:
            delivery = max(0, self._clock() - header.sent_us)
        with self.mu:
            link = self._links.get((src, local))
            if link is None:
                link = self._links[(src, local)] = \
                    _Link(self._delivery_samples)
            for m in batch.requests:
                link.recv[class_of(m.type)] += 1
            link.bytes_recv += nbytes
            link.batches_recv += 1
            if delivery is not None:
                link.delivery_us.append(delivery)
        for m in batch.requests:
            self._recv_ctr.labels(src, local, class_of(m.type)).inc()
        if delivery is not None:
            self._delivery_hist.labels(src, local).observe(delivery)

    def _walk_ctxs(self, local: str, header: pb.FabricHeader) -> None:
        """Per-context receive actions (tracer enabled)."""
        t = self._clock()
        for c in header.ctxs:
            if c.origin == local:
                # the quorum ack came home: close the remote child span
                lifecycle.TRACER.stamp(c.key, STAGE_ACK_RETURN)
                with self.mu:
                    retired = []
                    for hk in list(self._remote):
                        if hk[1] == c.key:
                            sp = self._remote.pop(hk)
                            sp.append((STAGE_ACK_RETURN, t))
                            retired.append(
                                {"host": hk[0], "key": c.key,
                                 "stamps": sp})
                    self._remote_ring.extend(retired)
            else:
                # an outbound replicate landed on a remote host
                lifecycle.TRACER.stamp(c.key, lifecycle.STAGE_HUB_RECV)
                with self.mu:
                    if (local, c.key) not in self._remote:
                        if len(self._remote) >= self._max_remote:
                            continue
                        self._remote[(local, c.key)] = [
                            (STAGE_REMOTE_RECV, t)]
                    parked = self._returns.setdefault(
                        (local, c.shard_id), [])
                    returned = pb.FabricContext(
                        key=c.key, origin=c.origin, hop=c.hop + 1,
                        shard_id=c.shard_id)
                    if len(parked) < self._max_remote:
                        parked.append(returned)

    # -- hop census -------------------------------------------------------

    def _census_finish(self, key: int, kind: str) -> None:
        """Lifecycle finish hook: retire the commit's census entry."""
        if kind != "proposal":
            return
        with self.mu:
            cen = self._census.pop(key, None)
            if cen is None:
                return
            self._census_finished += 1
            self._hops_done.append(cen["hops"])
            # the span is over: any unreturned contexts / open remote
            # spans for this key are garbage now
            for hk in [hk for hk in self._remote if hk[1] == key]:
                del self._remote[hk]
            for rk in list(self._returns):
                kept = [c for c in self._returns[rk] if c.key != key]
                if kept:
                    self._returns[rk] = kept
                else:
                    del self._returns[rk]
        self._hops_hist.observe(cen["hops"])

    def _census_drop(self, key: int, kind: str) -> None:
        """Lifecycle scrub hook: a traced commit died uncommitted."""
        if kind != "proposal":
            return
        with self.mu:
            if self._census.pop(key, None) is not None:
                self._census_dropped += 1

    # -- export -----------------------------------------------------------

    def host_pid(self, addr: str) -> int:
        """Stable Chrome-trace pid for a host address."""
        with self.mu:
            pid = self._host_pids.get(addr)
            if pid is None:
                pid = self._host_pids[addr] = (
                    HOST_PID_BASE + len(self._host_pids))
            return pid

    def chrome_events(self) -> list[dict]:
        """Retired remote child spans as complete Chrome trace events:
        ``pid`` = host (offset so shard rows never collide), ``tid`` =
        the proposal key — the same tid as the origin's lifecycle span,
        so Perfetto stitches the two timelines into one trace."""
        with self.mu:
            retired = [dict(sp, stamps=list(sp["stamps"]))
                       for sp in self._remote_ring]
        events = []
        for sp in retired:
            pid = self.host_pid(sp["host"])
            stamps = sp["stamps"]
            for i, (stage, ts) in enumerate(stamps):
                dur = (stamps[i + 1][1] - ts) if i + 1 < len(stamps) else 0
                events.append({
                    "name": stage, "cat": "fabric", "ph": "X",
                    "ts": ts, "dur": max(0, dur),
                    "pid": pid, "tid": sp["key"],
                    "args": {"host": sp["host"], "key": sp["key"]},
                })
        return events

    def snapshot(self) -> dict:
        """The merged JSON-able fabric view (``/debug/fabric``,
        ``NodeHost.info()["fabric"]``).  Validated by
        ``validate_fabric`` — the same strict-schema doctrine as
        ``capacity.validate_capacity``."""
        with self.mu:
            links = []
            for (src, dst) in sorted(self._links):
                li = self._links[(src, dst)]
                samples = sorted(li.delivery_us)
                links.append({
                    "src": src, "dst": dst,
                    "sent": dict(li.sent), "recv": dict(li.recv),
                    "bytes_sent": li.bytes_sent,
                    "bytes_recv": li.bytes_recv,
                    "batches_sent": li.batches_sent,
                    "batches_recv": li.batches_recv,
                    "delivery_count": len(samples),
                    "delivery_p50_us": (
                        _quantile(samples, 0.50) if samples else 0.0),
                    "delivery_p99_us": (
                        _quantile(samples, 0.99) if samples else 0.0),
                })
            done = sorted(self._hops_done)
            hop_counts: dict[str, int] = {}
            for h in done:
                hop_counts[str(h)] = hop_counts.get(str(h), 0) + 1
            census = {
                "active": len(self._census),
                "finished": self._census_finished,
                "dropped": self._census_dropped,
                "p50_commit_host_hops": (
                    _quantile(done, 0.50) if done else 0.0),
                "hop_counts": hop_counts,
            }
            remote = {"active": len(self._remote),
                      "retired": len(self._remote_ring)}
            link_classes = {f"{src}->{dst}": cls
                            for (src, dst), cls
                            in sorted(self._link_classes.items())}
            hubs = list(self._hubs.items())
            enabled = self._enabled
        hub_view = {}
        for addr, ref in hubs:
            hub = ref()
            if hub is None:
                continue
            with hub.mu:
                depth = sum(len(q) for q in hub.queues.values())
                qbytes = sum(hub.queue_bytes.values())
                breakers = list(hub.breakers.items())
            # breaker states evaluated outside the hub lock (each takes
            # its own) — the snapshot thread never holds two locks
            hub_view[addr] = {
                "queue_msgs": depth,
                "queue_bytes": qbytes,
                "breakers": {peer: b.state()
                             for peer, b in sorted(breakers)},
            }
        return {"enabled": enabled, "links": links, "census": census,
                "remote_spans": remote, "hubs": hub_view,
                "link_classes": link_classes}


def validate_fabric(obj, where: str = "fabric") -> int:
    """Strict schema validation of a ``FabricMeter.snapshot()`` payload;
    returns the link count.  Raises ``ValueError`` on any missing key,
    wrong type, unknown message class, unknown breaker state, or
    negative counter — the same parser-strictness doctrine as
    ``telemetry.parse_exposition``."""
    if not isinstance(obj, dict):
        raise ValueError(f"{where}: must be an object, "
                         f"got {type(obj).__name__}")
    for req in ("enabled", "links", "census", "remote_spans", "hubs",
                "link_classes"):
        if req not in obj:
            raise ValueError(f"{where}: missing required key {req!r}")
    lc = obj["link_classes"]
    if not isinstance(lc, dict):
        raise ValueError(f"{where}.link_classes: must be an object")
    for link, cls in lc.items():
        if not isinstance(link, str) or "->" not in link:
            raise ValueError(f"{where}.link_classes: key {link!r} must "
                             f"be a 'src->dst' string")
        if cls not in LINK_CLASSES:
            raise ValueError(f"{where}.link_classes.{link}: unknown "
                             f"link class {cls!r}")
    if not isinstance(obj["enabled"], bool):
        raise ValueError(f"{where}.enabled: must be a bool")
    if not isinstance(obj["links"], list):
        raise ValueError(f"{where}.links: must be an array")
    for i, li in enumerate(obj["links"]):
        w = f"{where}.links[{i}]"
        if not isinstance(li, dict):
            raise ValueError(f"{w}: must be an object")
        for req in ("src", "dst", "sent", "recv", "bytes_sent",
                    "bytes_recv", "batches_sent", "batches_recv",
                    "delivery_count", "delivery_p50_us",
                    "delivery_p99_us"):
            if req not in li:
                raise ValueError(f"{w}: missing required key {req!r}")
        for s in ("src", "dst"):
            if not isinstance(li[s], str) or not li[s]:
                raise ValueError(f"{w}.{s}: must be a non-empty string")
        for side in ("sent", "recv"):
            d = li[side]
            if not isinstance(d, dict):
                raise ValueError(f"{w}.{side}: must be an object")
            for cls, n in d.items():
                if cls not in MESSAGE_CLASSES:
                    raise ValueError(
                        f"{w}.{side}: unknown message class {cls!r}")
                if not isinstance(n, int) or n < 0:
                    raise ValueError(f"{w}.{side}.{cls}: must be a "
                                     f"non-negative int, got {n!r}")
        for k in ("bytes_sent", "bytes_recv", "batches_sent",
                  "batches_recv", "delivery_count"):
            if not isinstance(li[k], int) or li[k] < 0:
                raise ValueError(f"{w}.{k}: must be a non-negative int, "
                                 f"got {li[k]!r}")
        for k in ("delivery_p50_us", "delivery_p99_us"):
            if not isinstance(li[k], (int, float)) or li[k] < 0:
                raise ValueError(f"{w}.{k}: must be a non-negative "
                                 f"number, got {li[k]!r}")
    cen = obj["census"]
    if not isinstance(cen, dict):
        raise ValueError(f"{where}.census: must be an object")
    for req in ("active", "finished", "dropped", "p50_commit_host_hops",
                "hop_counts"):
        if req not in cen:
            raise ValueError(f"{where}.census: missing required "
                             f"key {req!r}")
    for k in ("active", "finished", "dropped"):
        if not isinstance(cen[k], int) or cen[k] < 0:
            raise ValueError(f"{where}.census.{k}: must be a "
                             f"non-negative int, got {cen[k]!r}")
    if (not isinstance(cen["p50_commit_host_hops"], (int, float))
            or cen["p50_commit_host_hops"] < 0):
        raise ValueError(f"{where}.census.p50_commit_host_hops: must be "
                         f"a non-negative number")
    if not isinstance(cen["hop_counts"], dict):
        raise ValueError(f"{where}.census.hop_counts: must be an object")
    for h, n in cen["hop_counts"].items():
        if not h.isdigit() or not isinstance(n, int) or n <= 0:
            raise ValueError(f"{where}.census.hop_counts[{h!r}]: must "
                             f"map a digit string to a positive int")
    rem = obj["remote_spans"]
    if not isinstance(rem, dict):
        raise ValueError(f"{where}.remote_spans: must be an object")
    for k in ("active", "retired"):
        if (k not in rem or not isinstance(rem[k], int) or rem[k] < 0):
            raise ValueError(f"{where}.remote_spans.{k}: must be a "
                             f"non-negative int")
    if not isinstance(obj["hubs"], dict):
        raise ValueError(f"{where}.hubs: must be an object")
    for addr, hv in obj["hubs"].items():
        w = f"{where}.hubs[{addr!r}]"
        if not isinstance(hv, dict):
            raise ValueError(f"{w}: must be an object")
        for k in ("queue_msgs", "queue_bytes"):
            if (k not in hv or not isinstance(hv[k], int) or hv[k] < 0):
                raise ValueError(f"{w}.{k}: must be a non-negative int")
        if "breakers" not in hv or not isinstance(hv["breakers"], dict):
            raise ValueError(f"{w}.breakers: must be an object")
        for peer, state in hv["breakers"].items():
            if state not in ("closed", "open", "half-open"):
                raise ValueError(f"{w}.breakers[{peer!r}]: unknown "
                                 f"state {state!r}")
    return len(obj["links"])


# process-wide meter: the transport hubs and the NodeHost inbound seam
# account here so one registry shows every link in the process (the
# same one-recorder doctrine as flight.RECORDER / lifecycle.TRACER).
# NodeHost.__init__ re-points ``enabled`` at its expert config.
METER = FabricMeter()

# census retirement rides the tracer's completion hooks: finish
# observes the hop count, scrub drops the entry (proposal spans only —
# read spans are host-local).  Registered for the GLOBAL meter alone;
# test-private meters wire their own tracer's hooks explicitly.
lifecycle.TRACER.set_hooks(on_finish=METER._census_finish,
                           on_scrub=METER._census_drop)
