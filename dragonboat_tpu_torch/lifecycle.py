"""Proposal-lifecycle tracer: end-to-end spans over the commit path.

round 4's fleet telemetry answers "what is the p50"; this module answers
"where does it go".  A deterministic 1-in-N sample of proposal keys
(``ExpertConfig.trace_sample_every``; entry keys are process-unique,
``request.PendingProposal._seq``) gets a span attached at ``propose``;
every later hop of the host plumbing stamps a monotonic timestamp onto
it — staging build, dispatch, pipelined retirement, logdb save/fsync,
apply, in-proc transport send/recv — and the future's ack completes it.

Completed traces feed three sinks:

- per-stage latency attribution: ``commit_stage_us{stage=...}``
  histograms in the shared telemetry registry (each stage's value is
  the delta from the previous stamp — the stage's own dwell time);
- a bounded ring of full traces, exported as Chrome-trace-event JSON
  (Perfetto / ``chrome://tracing`` loadable) from ``/trace`` on the
  metrics endpoint.  Span names match the ``tracing.annotate`` device
  annotations (``ANNOTATION_OF``) so a host trace loads side by side
  with a ``jax.profiler`` capture of the same run;
- slow-commit flight-recorder events: a sampled commit slower than the
  configured SLO records a ``flight.SLOW_COMMIT`` with its full stage
  breakdown.

Discipline: this module is in BOTH the concurrency and determinism
lint scopes.  It never names a wall clock — the microsecond clock is
injected (``tracing.monotonic_us`` by default, a counter in tests), the
same instruments-observe-caller-values doctrine as telemetry.py — and
all mutable state is ``guarded-by: mu``.  Spans that can no longer
complete (dropped/timed-out/terminated futures, in-flight node
removals on the pipelined path) are SCRUBBED, not leaked: every
completion verb of the proposal book ends its span.
"""

from __future__ import annotations

import threading
from collections import deque

from dragonboat_tpu_torch import flight
from dragonboat_tpu_torch import telemetry
from dragonboat_tpu_torch.tracing import monotonic_us

# -- stage taxonomy (canonical order along the commit path) -----------------

STAGE_PROPOSE = "propose"          # client enqueue (request book)
STAGE_STAGE = "stage"              # host staging build (_stage_props)
STAGE_DISPATCH = "dispatch"        # jitted step / step_donated issued
STAGE_RETIRE = "retire"            # output pass entered (_process_outputs;
#                                    one step late on the pipelined path)
STAGE_SAVE = "save"                # pb.Update batch assembled
STAGE_FSYNC = "fsync"              # durable logdb flush completed
STAGE_APPLY_QUEUE = "apply_queue"  # handed to the apply pool
STAGE_APPLY = "apply"              # RSM update executed
STAGE_HUB_SEND = "hub_send"        # replicate left the transport hub
STAGE_HUB_RECV = "hub_recv"        # replicate arrived (every transport)
STAGE_ACK_RETURN = "ack_return"    # quorum ack returned to the origin
#                                    host (stamped by fabric.METER off
#                                    the trace header's return context)
STAGE_ACK = "ack"                  # future completed

STAGES = (STAGE_PROPOSE, STAGE_STAGE, STAGE_DISPATCH, STAGE_RETIRE,
          STAGE_SAVE, STAGE_FSYNC, STAGE_APPLY_QUEUE, STAGE_APPLY,
          STAGE_HUB_SEND, STAGE_HUB_RECV, STAGE_ACK_RETURN, STAGE_ACK)

# read-path stage taxonomy (ROADMAP item 3's attribution prerequisite):
# a sampled ReadIndex gets its own span kind with these stamps
STAGE_READ_PROPOSE = "read_propose"  # ReadIndex enqueued (request book)
STAGE_READ_QUORUM = "read_quorum"    # quorum round confirmed the index
STAGE_READ_SERVE = "read_serve"      # applied index caught up, read served

READ_STAGES = (STAGE_READ_PROPOSE, STAGE_READ_QUORUM, STAGE_READ_SERVE)

KIND_PROPOSAL = "proposal"
KIND_READ = "read"

# host stage -> the tracing.annotate span name covering the same work in
# a jax.profiler device capture; Perfetto shows both timelines and these
# names line the two up
ANNOTATION_OF = {
    STAGE_DISPATCH: "kernel_engine.step",
    STAGE_RETIRE: "kernel_engine.process_outputs",
}

DEFAULT_SAMPLE_EVERY = 64


class _Span:
    """One sampled span's stamp list (append-only, time-ordered)."""

    __slots__ = ("key", "shard_id", "kind", "stamps")

    def __init__(self, key: int, shard_id: int,
                 kind: str = KIND_PROPOSAL) -> None:
        self.key = key
        self.shard_id = shard_id
        self.kind = kind
        self.stamps: list[tuple[str, int]] = []   # (stage, t_us)


class LifecycleTracer:
    """Process-wide span book + completed-trace ring + sinks."""

    def __init__(self, sample_every: int = 0, clock=None,
                 ring_size: int = 256, max_active: int = 4096,
                 slow_commit_us: int = 0, registry=None,
                 recorder=None) -> None:
        if ring_size <= 0:
            raise ValueError(f"ring_size must be positive, got {ring_size}")
        self.mu = threading.Lock()
        self._clock = clock if clock is not None else monotonic_us
        self._every = max(0, int(sample_every))
        self._slow_us = max(0, int(slow_commit_us))
        self._max_active = max(1, int(max_active))
        self._spans: dict[int, _Span] = {}          # guarded-by: mu
        self._ring: deque = deque(maxlen=ring_size)  # guarded-by: mu
        self._dropped = 0        # spans refused at the active cap
        self._scrubbed = 0       # spans ended without an ack
        self._finished = 0       # spans completed through finish()
        self._registry = registry if registry is not None \
            else telemetry.GLOBAL
        self._recorder = recorder if recorder is not None \
            else flight.RECORDER
        # completion hooks (fabric.py's hop census): fired OUTSIDE mu
        # with (key, kind) after a span finishes / is scrubbed
        self._on_finish = None
        self._on_scrub = None
        self._stage_hist = self._registry.histogram(
            "commit_stage_us",
            help="per-stage commit latency attribution of sampled "
                 "proposals (stage=total is propose->ack)",
            labelnames=("stage",))

    # -- configuration / cheap hot-path guards ----------------------------

    @property
    def enabled(self) -> bool:
        return self._every > 0

    def sampled(self, key: int) -> bool:
        """Deterministic 1-in-N selection over process-unique keys."""
        every = self._every
        return every > 0 and key % every == 0

    def configure(self, sample_every: int | None = None,
                  slow_commit_us: int | None = None) -> None:
        """Re-point the process-global tracer at a host's expert config
        (NodeHost.__init__); None leaves a knob unchanged."""
        with self.mu:
            if sample_every is not None:
                self._every = max(0, int(sample_every))
            if slow_commit_us is not None:
                self._slow_us = max(0, int(slow_commit_us))

    def set_hooks(self, on_finish=None, on_scrub=None) -> None:
        """Register span-completion callbacks ``fn(key, kind)``, fired
        outside ``mu`` after ``finish``/``scrub`` retire a live span.
        One consumer (``fabric.METER``'s hop census); later writers
        replace earlier ones.  Callbacks must not call back into the
        tracer's span verbs for the same key."""
        with self.mu:
            self._on_finish = on_finish
            self._on_scrub = on_scrub

    # -- span lifecycle ----------------------------------------------------

    def begin(self, key: int, shard_id: int = 0) -> bool:
        """Open a span for a sampled key (no-op otherwise).  Bounded: at
        ``max_active`` live spans new ones are counted and refused — a
        leak upstream must degrade the sample, never host memory."""
        if not self.sampled(key):
            return False
        t = self._clock()
        sp = _Span(key, shard_id)
        sp.stamps.append((STAGE_PROPOSE, t))
        with self.mu:
            if key in self._spans:
                return False
            if len(self._spans) >= self._max_active:
                self._dropped += 1
                return False
            self._spans[key] = sp
        return True

    def begin_read(self, key: int, shard_id: int = 0) -> bool:
        """Open a READ span for a sampled ReadIndex key: same book and
        bounds as ``begin``, first stamp ``read_propose``, completed by
        ``finish`` at serve time with a ``read_total`` observation."""
        if not self.sampled(key):
            return False
        t = self._clock()
        sp = _Span(key, shard_id, kind=KIND_READ)
        sp.stamps.append((STAGE_READ_PROPOSE, t))
        with self.mu:
            if key in self._spans:
                return False
            if len(self._spans) >= self._max_active:
                self._dropped += 1
                return False
            self._spans[key] = sp
        return True

    def stamp(self, key: int, stage: str) -> None:
        """Record one stage stamp on a live sampled span (cheap no-op
        for unsampled keys and completed/scrubbed spans)."""
        if not self.sampled(key):
            return
        t = self._clock()
        with self.mu:
            sp = self._spans.get(key)
            if sp is not None:
                sp.stamps.append((stage, t))

    def finish(self, key: int) -> None:
        """Complete a span at future-ack time: stamp the closing stage
        (``ack`` for proposals, ``read_serve`` for reads), feed the
        per-stage histograms, retire the trace into the ring, and record
        a slow-commit flight event when the SLO is exceeded."""
        if not self.sampled(key):
            return
        t = self._clock()
        with self.mu:
            sp = self._spans.pop(key, None)
            if sp is None:
                return
            closing = STAGE_ACK if sp.kind == KIND_PROPOSAL \
                else STAGE_READ_SERVE
            sp.stamps.append((closing, t))
            self._finished += 1
            total = sp.stamps[-1][1] - sp.stamps[0][1]
            trace = {"key": sp.key, "shard_id": sp.shard_id,
                     "kind": sp.kind, "stamps": list(sp.stamps),
                     "total_us": total}
            self._ring.append(trace)
            slow = (sp.kind == KIND_PROPOSAL and self._slow_us > 0
                    and total >= self._slow_us)
            hook = self._on_finish
        # sinks run outside mu: the histogram and recorder take their
        # own locks, and nothing here needs the span book anymore
        prev = sp.stamps[0][1]
        for stage, ts in sp.stamps[1:]:
            self._stage_hist.labels(stage).observe(ts - prev)
            prev = ts
        self._stage_hist.labels(
            "total" if sp.kind == KIND_PROPOSAL else "read_total"
        ).observe(total)
        if slow:
            t0 = sp.stamps[0][1]
            self._recorder.record(
                flight.SLOW_COMMIT, key=sp.key, shard_id=sp.shard_id,
                total_us=total, slo_us=self._slow_us,
                stages=[[stage, ts - t0] for stage, ts in sp.stamps])
        if hook is not None:
            hook(key, sp.kind)

    def scrub(self, key: int) -> None:
        """End a span that can no longer complete (dropped / timed-out /
        terminated future, in-flight node removal) — the span is
        discarded, never retired as a trace and never fed to the sinks."""
        if not self.sampled(key):
            return
        with self.mu:
            sp = self._spans.pop(key, None)
            if sp is not None:
                self._scrubbed += 1
            hook = self._on_scrub
        if sp is not None and hook is not None:
            hook(key, sp.kind)

    # -- introspection / export -------------------------------------------

    def active_count(self) -> int:
        with self.mu:
            return len(self._spans)

    def counts(self) -> dict:
        with self.mu:
            return {"active": len(self._spans), "finished": self._finished,
                    "scrubbed": self._scrubbed, "dropped": self._dropped}

    def completed(self) -> list[dict]:
        """Retained completed traces, oldest first (fresh copies)."""
        with self.mu:
            return [dict(tr, stamps=list(tr["stamps"]))
                    for tr in self._ring]

    def reset(self) -> None:
        """Drop spans, traces and counters (test isolation)."""
        with self.mu:
            self._spans.clear()
            self._ring.clear()
            self._dropped = 0
            self._scrubbed = 0
            self._finished = 0

    def export_chrome_trace(self) -> dict:
        """The completed-trace ring as a Chrome-trace-event JSON object
        (the ``traceEvents`` array form Perfetto and chrome://tracing
        load directly).  One complete ``"ph": "X"`` event per stage,
        ``dur`` = dwell until the next stamp; ``pid`` groups by shard,
        ``tid`` is the proposal key, so each proposal renders as one
        row of contiguous stage blocks.  ``args.annotation`` carries the
        matching ``tracing.annotate`` span name for stitching against a
        ``jax.profiler`` capture of the same run."""
        events = []
        for tr in self.completed():
            stamps = tr["stamps"]
            for i, (stage, ts) in enumerate(stamps):
                dur = (stamps[i + 1][1] - ts) if i + 1 < len(stamps) else 0
                events.append({
                    "name": stage, "cat": tr.get("kind", KIND_PROPOSAL),
                    "ph": "X", "ts": ts, "dur": dur,
                    "pid": tr["shard_id"], "tid": tr["key"],
                    "args": {"key": tr["key"],
                             "annotation": ANNOTATION_OF.get(stage, "")},
                })
        return {"traceEvents": events}


def validate_chrome_trace(obj) -> int:
    """Strict validation of a Chrome-trace-event JSON object; returns
    the event count.  Raises ``ValueError`` on: a non-``traceEvents``
    shape, a missing required key (``name``/``ph``/``ts``/``pid``/
    ``tid``), a negative timestamp or duration, or timestamps that go
    BACKWARDS within one (pid, tid) span — the stamps of a span are
    appended in clock order, so a regression means a corrupt export.
    Shared by the exporter's tests and ``scripts/metrics_dump.py
    --trace`` (the same parser-strictness doctrine as
    ``telemetry.parse_exposition``)."""
    if isinstance(obj, dict):
        events = obj.get("traceEvents")
    elif isinstance(obj, list):   # Chrome also accepts the bare array
        events = obj
    else:
        raise ValueError(f"trace must be an object or array, "
                         f"got {type(obj).__name__}")
    if not isinstance(events, list):
        raise ValueError("traceEvents must be an array")
    last_ts: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for req in ("name", "ph", "ts", "pid", "tid"):
            if req not in ev:
                raise ValueError(f"event {i}: missing required key {req!r}")
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: ts must be a non-negative "
                             f"number, got {ts!r}")
        dur = ev.get("dur", 0)
        if not isinstance(dur, (int, float)) or dur < 0:
            raise ValueError(f"event {i}: dur must be a non-negative "
                             f"number, got {dur!r}")
        span = (ev["pid"], ev["tid"])
        prev = last_ts.get(span)
        if prev is not None and ts < prev:
            raise ValueError(
                f"event {i}: ts {ts} goes backwards within span "
                f"pid={ev['pid']} tid={ev['tid']} (prev {prev})")
        last_ts[span] = ts
    return len(events)


# process-wide tracer: the request books, engines, logdb and transport
# stamp here so one ring shows complete spans across every host in the
# process (the same one-recorder doctrine as flight.RECORDER).  Default
# sampling is 1/64; a NodeHost re-points it at its expert config.
TRACER = LifecycleTracer(sample_every=DEFAULT_SAMPLE_EVERY)
