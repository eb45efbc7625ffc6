"""Capacity & compilation observability — the third rail beside
telemetry (metrics) and lifecycle (proposal spans).

ROADMAP item 1 pushes toward 100k–1M groups on a real mesh, and the two
silent killers of that push are retrace storms (a shape leak recompiles
the step kernel mid-flight) and HBM exhaustion (a geometry that fits
analytically but OOMs in practice).  Three legs make both observable:

- **Compile telemetry** (:class:`CompileTracker`): every entry the
  engines dispatch (``step``, ``step_donated``) is wrapped in a tracked
  callable that counts its calls and detects a compile by sampling the
  callee's executable-cache size (``_cache_size``) around each call.
  On the port a compiled entry (``graphs.py``) reports its captured
  CUDA graphs there, so a capture counts as a compile; an eager entry
  has no probe, and its calls are counted with no compile.  Each compile is
  counted per entry, timed (the call's wall time is trace+lower+compile
  at that point), observed into ``compile_us{entry=...}`` histograms,
  and emitted as a Chrome-trace span that the ``/trace`` endpoint
  merges with the lifecycle ring.  A compile AFTER an entry reached
  steady state (>= 1 compile + a clean call) is a retrace; the first
  one per entry raises an edge-triggered ``retrace_storm`` flight
  event.

- **Device-memory accounting**: :func:`measure_tree_bytes` sums the
  engines' known resident trees (state / carried inbox / health
  digest); :func:`device_memory_stats` adds the CUDA caching
  allocator's stats (``torch.cuda.mem_get_info`` /
  ``torch.cuda.memory_stats``) where a card is present.  :func:`engine_snapshot` folds both
  into ``capacity_bytes_in_use`` / ``capacity_bytes_peak`` /
  ``capacity_headroom_pct`` gauges with a watermark-crossing
  ``memory_pressure`` flight event wired into ``/healthz``.

- **Contracts-derived capacity model**: the same machine-readable
  CONTRACTS grammar that powers the lint passes (analysis/common.py)
  encodes exactly what a group costs —
  :func:`model_bytes_per_group` walks the ShardState / Inbox /
  StepInput / StepOutput / HealthDigest contracts and multiplies axis
  extents (from KernelParams) by dtype widths, honoring the optional-
  field materialization rules of the kstate constructors.  The model is
  cross-checked against measured device bytes in a differential test
  and predicts max-G per device budget (:func:`max_g_for_budget`).

Determinism: this module is in the determinism lint scope.  The
tracker's microsecond clock is INJECTED (``tracing.monotonic_us`` lives
outside the scope, same doctrine as lifecycle.py); flight records are
stamped with per-entry call counts, never the wall clock.

Concurrency: tracker state is guarded by ``CompileTracker.mu``; the
wrapped jitted call itself runs outside the lock.
"""

from __future__ import annotations

import threading
from collections import deque

from dragonboat_tpu_torch import flight as _flight
from dragonboat_tpu_torch import telemetry as _telemetry
from dragonboat_tpu_torch.tracing import monotonic_us

# ---------------------------------------------------------------------------
# contracts-derived capacity model
# ---------------------------------------------------------------------------

#: bytes per element for the canonical contract dtypes (analysis/common.py
#: DTYPES); the kstate constructors build exactly these widths
DTYPE_BYTES = {"i32": 4, "u32": 4, "f32": 4, "bool": 1}

#: symbolic contract axis -> the KernelParams field holding its extent
#: (G is the free variable the model is *per*)
AXIS_PARAMS = {
    "P": "num_peers",
    "CAP": "log_cap",
    "K": "inbox_cap",
    "E": "msg_entries",
    "B": "proposal_cap",
    "RI": "readindex_cap",
}

#: contract classes with a leading-G per-group footprint.  HealthReport /
#: ShardRow are replicated O(K)/O(1) aggregates — not per-group cost
MODEL_CLASSES = ("ShardState", "Inbox", "StepInput", "StepOutput",
                 "HealthDigest", "InvariantDigest")

#: resident set: trees an engine holds for its lifetime (StepInput /
#: StepOutput are per-step transients) — the default for budget math
RESIDENT_CLASSES = ("ShardState", "Inbox", "HealthDigest",
                    "InvariantDigest")


def _optional_materialized(cls: str, fld: str, kp) -> bool:
    """Whether an ``optional`` contract field is actually allocated,
    mirroring the kstate constructors: payload columns exist only under
    ``inline_payloads``, and ``empty_input`` NEVER materializes
    ``prop_val`` (the host staging builders don't either)."""
    if (cls, fld) == ("StepInput", "prop_val"):
        return False
    return bool(kp.inline_payloads)


def _contract_table():
    from dragonboat_tpu_torch.analysis.common import parse_contracts
    from dragonboat_tpu_torch.core import health as _health
    from dragonboat_tpu_torch.core import invariants as _invariants
    from dragonboat_tpu_torch.core import kstate as _kstate

    table = dict(_kstate.CONTRACTS)
    table["HealthDigest"] = _health.CONTRACTS["HealthDigest"]
    table["InvariantDigest"] = _invariants.CONTRACTS["InvariantDigest"]
    return parse_contracts(table, "capacity")


def model_bytes_per_group(kp, classes=MODEL_CLASSES) -> dict:
    """Analytic bytes-per-group for each contract class at geometry
    ``kp``, plus ``"total"``.  Raises ValueError on a contract axis the
    model cannot size (a new axis must be added to AXIS_PARAMS)."""
    table = _contract_table()
    per: dict = {}
    for cls in classes:
        nbytes = 0
        for fld, fc in table[cls].items():
            if not fc.axes or fc.axes[0] != "G":
                raise ValueError(
                    f"capacity model: {cls}.{fld} has no leading G axis "
                    f"({fc.axes}) — not a per-group field")
            if fc.optional and not _optional_materialized(cls, fld, kp):
                continue
            n = DTYPE_BYTES[fc.dtype]
            for ax in fc.axes[1:]:
                if ax not in AXIS_PARAMS:
                    raise ValueError(
                        f"capacity model: {cls}.{fld} axis {ax!r} has no "
                        "KernelParams extent (update AXIS_PARAMS)")
                n *= int(getattr(kp, AXIS_PARAMS[ax]))
            nbytes += n
        per[cls] = nbytes
    per["total"] = sum(per[c] for c in classes)
    return per


def predict_bytes(kp, num_groups: int, classes=MODEL_CLASSES) -> int:
    """Analytic device bytes for ``num_groups`` groups of ``classes``."""
    return model_bytes_per_group(kp, classes)["total"] * int(num_groups)


def max_g_for_budget(kp, budget_bytes: int,
                     classes=RESIDENT_CLASSES) -> int:
    """Largest G whose resident footprint fits ``budget_bytes``."""
    per_group = model_bytes_per_group(kp, classes)["total"]
    if budget_bytes <= 0 or per_group <= 0:
        return 0
    return int(budget_bytes) // per_group


def bytes_for_contract(spec: str, kp, num_groups: int,
                       axis_extra: dict | None = None) -> int:
    """Closed-form bytes of one value declared as a contract string
    (``"[G, K] i32"``).  ``G`` resolves to ``num_groups``, symbolic axes
    through AXIS_PARAMS (kernel geometry) or ``axis_extra`` (host-side
    constants like histogram widths), decimal literals to themselves,
    and an empty axis list (``"[] i32"``) to a scalar.  Unlike
    ``model_bytes_per_group`` this sizes boundary crossings, which are
    not always per-group — hence no leading-G requirement."""
    from dragonboat_tpu_torch.analysis.common import parse_contract

    fc = parse_contract(spec, "transfer")
    n = DTYPE_BYTES[fc.dtype]
    for ax in fc.axes:
        if ax == "G":
            n *= int(num_groups)
        elif ax.isdigit():
            n *= int(ax)
        elif ax in AXIS_PARAMS:
            n *= int(getattr(kp, AXIS_PARAMS[ax]))
        elif axis_extra and ax in axis_extra:
            n *= int(axis_extra[ax])
        else:
            raise ValueError(
                f"transfer model: axis {ax!r} in {spec!r} has no extent "
                "(KernelParams AXIS_PARAMS or axis_extra)")
    return n


# ---------------------------------------------------------------------------
# device-memory accounting
# ---------------------------------------------------------------------------


def _tensor_leaves(tree):
    """Tensor leaves of a NamedTuple / tuple / list / dict tree."""
    if tree is None:
        return
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensor_leaves(v)


def measure_tree_bytes(*trees) -> int:
    """Sum of ``numel() * element_size()`` over the tensor leaves of the
    given trees (None subtrees and non-tensor leaves contribute 0).
    Shape-derived — never forces a device sync."""
    total = 0
    for tree in trees:
        for leaf in _tensor_leaves(tree):
            total += int(leaf.numel()) * int(leaf.element_size())
    return total


def device_memory_stats() -> list:
    """Per-card allocator stats (the CPU reports nothing).  Each row:
    platform, bytes_in_use (the caching allocator's allocated bytes),
    peak_bytes_in_use (its peak), bytes_limit (the card's total memory,
    ``torch.cuda.mem_get_info``)."""
    import torch

    rows = []
    if not torch.cuda.is_available():
        return rows
    for i in range(torch.cuda.device_count()):
        try:
            ms = torch.cuda.memory_stats(i)
            _free, total = torch.cuda.mem_get_info(i)
        except Exception:
            continue
        rows.append({
            "platform": "gpu",
            "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        })
    return rows


# ---------------------------------------------------------------------------
# compile telemetry
# ---------------------------------------------------------------------------

#: steady state = at least one compile followed by this many clean calls;
#: a compile after that is a retrace
STEADY_CLEAN_CALLS = 1


class _EntryState:
    """Counters for ONE wrapped callable.  Each ``wrap()`` call gets its
    own state (one per engine entry), so a legitimate first compile at a
    NEW engine's geometry is never mistaken for a retrace of another
    engine sharing the same underlying jitted function."""

    __slots__ = ("entry", "calls", "compiles", "retraces",
                 "compile_us_total", "last_compile_us", "clean_since",
                 "storm")

    def __init__(self, entry: str) -> None:
        self.entry = entry
        self.calls = 0
        self.compiles = 0
        self.retraces = 0
        self.compile_us_total = 0
        self.last_compile_us = 0
        self.clean_since = 0      # clean calls since the last compile
        self.storm = False        # latched on the first retrace


class TrackedEntry:
    """Callable wrapper around one jitted entry point.  A compile is
    detected by executable-cache growth (``fn._cache_size()``) across
    the call; functions without a cache probe are counted but never
    flagged.

    The cache size is global to the jitted function: if ANOTHER thread
    compiles the same function inside this wrapper's call window, the
    growth is attributed here.  Counters are exact whenever an engine's
    dispatches don't overlap another engine's first compile of a shared
    function (engines compile at startup, inside their own first
    calls); a concurrent late-joining engine can at worst smear its one
    legitimate compile into a peer's counters."""

    __slots__ = ("_tracker", "_fn", "_st")

    def __init__(self, tracker: "CompileTracker", fn, st: _EntryState
                 ) -> None:
        self._tracker = tracker
        self._fn = fn
        self._st = st

    def __call__(self, *args, **kwargs):
        size_of = getattr(self._fn, "_cache_size", None)
        before = size_of() if size_of is not None else -1
        clock = self._tracker._clock
        t0 = clock()
        result = self._fn(*args, **kwargs)
        elapsed = clock() - t0
        after = size_of() if size_of is not None else -1
        compiled = before >= 0 and after > before
        self._tracker._observe(self._st, compiled, t0, elapsed)
        return result

    def stats(self) -> dict:
        """Plain-int counter snapshot for this entry."""
        return self._tracker._stats_of(self._st)


class CompileTracker:
    """Counts traces/retraces per wrapped jit entry, times compiles into
    ``compile_us{entry=...}`` histograms and a bounded Chrome-trace span
    ring, and raises one edge-triggered ``retrace_storm`` flight event
    per entry that re-traces after steady state."""

    def __init__(self, clock=None, registry=None, recorder=None,
                 ring_size: int = 256,
                 steady_after: int = STEADY_CLEAN_CALLS) -> None:
        if ring_size <= 0:
            raise ValueError(f"ring_size must be positive, got {ring_size}")
        self.mu = threading.Lock()
        # injected microsecond clock (determinism doctrine: this module
        # names no wall clock; the default lives in tracing.py)
        self._clock = clock if clock is not None else monotonic_us
        self._registry = (registry if registry is not None
                          else _telemetry.GLOBAL)
        self._recorder = recorder if recorder is not None else _flight
        self.steady_after = max(0, int(steady_after))
        self._states: list = []                       # guarded-by: mu
        self._spans: deque = deque(maxlen=ring_size)  # guarded-by: mu
        self._hist = self._registry.histogram(
            "compile_us",
            help="trace+lower+compile wall time per jit entry",
            labelnames=("entry",))

    def wrap(self, entry: str, fn) -> TrackedEntry:
        """Wrap one jitted callable under label ``entry``.  Each wrap
        owns independent counters (see _EntryState)."""
        st = _EntryState(str(entry))
        with self.mu:
            self._states.append(st)
        return TrackedEntry(self, fn, st)

    def _observe(self, st: _EntryState, compiled: bool, t0: int,
                 elapsed_us: int) -> None:
        storm_edge = False
        with self.mu:
            st.calls += 1
            if not compiled:
                st.clean_since += 1
            else:
                retrace = (st.compiles > 0
                           and st.clean_since >= self.steady_after)
                st.compiles += 1
                st.clean_since = 0
                st.compile_us_total += int(elapsed_us)
                st.last_compile_us = int(elapsed_us)
                if retrace:
                    st.retraces += 1
                    if not st.storm:
                        st.storm = True
                        storm_edge = True
                self._spans.append({
                    "name": f"compile:{st.entry}", "cat": "compile",
                    "ph": "X", "ts": int(t0), "dur": int(elapsed_us),
                    "pid": "compile", "tid": st.entry,
                    "args": {"entry": st.entry, "calls": st.calls,
                             "compiles": st.compiles,
                             "retrace": retrace},
                })
            calls, compiles = st.calls, st.compiles
        if compiled:
            self._hist.labels(st.entry).observe(int(elapsed_us))
        if storm_edge:
            # edge-triggered, stamped with the entry's call count —
            # never the wall clock (flight doctrine)
            self._recorder.record(
                RETRACE_STORM, entry=st.entry, compiles=compiles,
                calls=calls, compile_us=int(elapsed_us), tick=calls)

    def _stats_of(self, st: _EntryState) -> dict:
        with self.mu:
            return {
                "calls": st.calls,
                "compiles": st.compiles,
                "retraces": st.retraces,
                "compile_us_total": st.compile_us_total,
                "last_compile_us": st.last_compile_us,
            }

    def chrome_events(self) -> list:
        """Completed compile spans as Chrome-trace events (merged into
        the /trace export beside the lifecycle ring; spans per
        (pid, tid) row are appended in clock order, so the strict
        validator's monotonicity holds)."""
        with self.mu:
            return [dict(ev, args=dict(ev["args"])) for ev in self._spans]

    def clear(self) -> None:
        """Forget recorded spans and wrapped states (dead engines drop
        out of snapshot(); live TrackedEntry wrappers keep their own
        counters but stop aggregating here).  For engine-recycling
        processes and test teardown."""
        with self.mu:
            self._states.clear()
            self._spans.clear()

    def snapshot(self) -> dict:
        """Aggregate counters by entry label across all wrapped states
        (two engines wrapping ``step`` sum into one ``step`` row)."""
        agg: dict = {}
        with self.mu:
            states = list(self._states)
        for st in states:
            row = agg.setdefault(st.entry, {
                "calls": 0, "compiles": 0, "retraces": 0,
                "compile_us_total": 0, "last_compile_us": 0})
            d = self._stats_of(st)
            for key in ("calls", "compiles", "retraces",
                        "compile_us_total"):
                row[key] += d[key]
            row["last_compile_us"] = max(row["last_compile_us"],
                                         d["last_compile_us"])
        return agg


#: process-wide tracker (same one-instance doctrine as flight.RECORDER /
#: lifecycle.TRACER): every engine's wrappers and the /trace merge read
#: one ring, so one export shows compiles across all engines
TRACKER = CompileTracker()

#: flight-record kinds this rail emits (declared in flight.py beside the
#: core transition kinds; re-exported here for callers of this module)
RETRACE_STORM = _flight.RETRACE_STORM
MEMORY_PRESSURE = _flight.MEMORY_PRESSURE


# ---------------------------------------------------------------------------
# transfer metering (host<->device boundary crossings)
# ---------------------------------------------------------------------------


def _card_in_use() -> bool:
    """Whether this process drives a CUDA card (the sync guard's scope)."""
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _set_sync_mode(mode) -> None:
    import torch

    torch.cuda.set_sync_debug_mode(mode)


class _SanctionedCrossing:
    """One declared boundary crossing: counts its tag, and — only while
    the card's sync guard is active — lifts it for its extent so every
    sync OUTSIDE a sanctioned scope keeps raising."""

    __slots__ = ("_meter", "_tag", "_lifted")

    def __init__(self, meter: "TransferMeter", tag: str) -> None:
        self._meter = meter
        self._tag = tag
        self._lifted = False

    def __enter__(self) -> "_SanctionedCrossing":
        m = self._meter
        with m.mu:
            m._counts[self._tag] = m._counts.get(self._tag, 0) + 1
            if m._card_guard:
                self._lifted = True
                m._lifts += 1
                if m._lifts == 1:
                    _set_sync_mode(0)
        return self

    def __exit__(self, *exc) -> bool:
        if self._lifted:
            self._lifted = False
            m = self._meter
            with m.mu:
                m._lifts -= 1
                if m._lifts == 0 and m._card_guard:
                    _set_sync_mode("error")
        return False


class _TransferGuard:
    """The transfer guard.  On the card it is
    ``torch.cuda.set_sync_debug_mode("error")``: a device->host sync
    outside a sanctioned scope raises.  The mode is process-wide, so the
    guard covers every thread of the process for its extent (engines in
    one process take turns through ``KernelEngine._step_mu``, and a
    sanctioned scope on any thread lifts it); the outermost guard sets it
    and restores the mode it found.  On the CPU there is no sync to catch:
    the guard only keeps the depth, and crossings are tallied under their
    tags."""

    __slots__ = ("_meter",)

    def __init__(self, meter: "TransferMeter") -> None:
        self._meter = meter

    def __enter__(self) -> "_TransferGuard":
        m = self._meter
        with m.mu:
            m._guard_depth += 1
            if m._guard_depth == 1 and _card_in_use():
                import torch

                m._prev_sync_mode = torch.cuda.get_sync_debug_mode()
                m._card_guard = True
                if m._lifts == 0:
                    _set_sync_mode("error")
        return self

    def __exit__(self, *exc) -> bool:
        m = self._meter
        with m.mu:
            m._guard_depth = max(0, m._guard_depth - 1)
            if m._guard_depth == 0 and m._card_guard:
                m._card_guard = False
                _set_sync_mode(m._prev_sync_mode)
        return False


class TransferMeter:
    """Live host<->device crossing counter behind the transfer-boundary
    contract (analysis/transfer.py).  Every declared crossing site in
    the engine layer wraps its transfer in ``sanctioned(tag)``; the
    transfer lint's dynamic leg and the engine differentials run the
    step loop under ``guard()`` and diff ``counts()`` against the
    static TRANSFER_LEDGER — on the card an unsanctioned sync raises, a
    sanctioned crossing is tallied under its declared tag (see
    ``_TransferGuard``)."""

    def __init__(self) -> None:
        self.mu = threading.Lock()
        self._counts: dict = {}    # guarded-by: mu  (tag -> crossings)
        self._guard_depth = 0      # guarded-by: mu
        self._card_guard = False   # guarded-by: mu  (sync mode "error" set)
        self._lifts = 0            # guarded-by: mu  (open sanctioned scopes)
        self._prev_sync_mode = 0   # guarded-by: mu

    def sanctioned(self, tag: str) -> _SanctionedCrossing:
        """Context manager for one declared crossing (see class doc)."""
        return _SanctionedCrossing(self, tag)

    def guard(self) -> _TransferGuard:
        """Disallow-undeclared-syncs context for tests and lint."""
        return _TransferGuard(self)

    def counts(self) -> dict:
        with self.mu:
            return dict(self._counts)

    def reset(self) -> None:
        with self.mu:
            self._counts.clear()


#: process-wide meter (one-instance doctrine, like TRACKER): the engine
#: layer's sanctioned scopes and the transfer lint's differential read
#: the same tallies
METER = TransferMeter()


# ---------------------------------------------------------------------------
# snapshot plumbing (engine.last_capacity / NodeHost merged view)
# ---------------------------------------------------------------------------

#: exact snapshot key set (validate_capacity rejects drift in either
#: direction)
_INT_KEYS = ("ticks", "capacity", "bytes_in_use", "bytes_peak",
             "device_bytes_in_use", "device_bytes_limit", "budget_bytes",
             "model_bytes_per_group", "model_predicted_bytes",
             "model_max_g_at_budget")
_BOOL_KEYS = ("memory_pressure", "retrace_storm")
_ENTRY_KEYS = ("calls", "compiles", "retraces", "compile_us_total",
               "last_compile_us")


def empty_dict() -> dict:
    """All-zero capacity snapshot (merge identity for hosts with no
    engine)."""
    d = {k: 0 for k in _INT_KEYS}
    d.update({k: False for k in _BOOL_KEYS})
    d["headroom_pct"] = 100.0
    d["entries"] = {}
    return d


def engine_snapshot(kp, num_groups: int, live_bytes: int, peak_bytes: int,
                    entries: dict, budget_bytes: int = 0,
                    watermark_pct: float = 10.0, ticks: int = 0,
                    classes=RESIDENT_CLASSES) -> dict:
    """Assemble one engine's capacity snapshot: measured live/peak tree
    bytes + allocator stats + the contracts model at this geometry +
    per-entry compile counters.  ``memory_pressure`` trips when headroom
    against the budget (explicit, else the device's reported
    bytes_limit) drops below ``watermark_pct``."""
    dev_rows = device_memory_stats()
    dev_in_use = max((r["bytes_in_use"] for r in dev_rows), default=0)
    dev_limit = max((r["bytes_limit"] for r in dev_rows), default=0)
    budget = int(budget_bytes) if budget_bytes > 0 else dev_limit
    used = max(int(live_bytes), dev_in_use)
    if budget > 0:
        headroom = max(0.0, 100.0 * (budget - used) / budget)
        pressure = headroom < float(watermark_pct)
    else:
        headroom, pressure = 100.0, False
    per_group = model_bytes_per_group(kp, classes)["total"]
    return {
        "ticks": int(ticks),
        "capacity": int(num_groups),
        "bytes_in_use": int(live_bytes),
        "bytes_peak": int(peak_bytes),
        "device_bytes_in_use": dev_in_use,
        "device_bytes_limit": dev_limit,
        "budget_bytes": budget,
        "headroom_pct": headroom,
        "memory_pressure": pressure,
        "retrace_storm": any(e["retraces"] > 0 for e in entries.values()),
        "model_bytes_per_group": per_group,
        "model_predicted_bytes": per_group * int(num_groups),
        "model_max_g_at_budget": (budget // per_group
                                  if budget > 0 and per_group > 0 else 0),
        "entries": {name: dict(e) for name, e in entries.items()},
    }


def merge_into(base: dict, other: dict, engine: str | None = None) -> None:
    """Accumulate ``other`` (empty_dict shape) into ``base``: per-engine
    footprints add, device/budget views take the widest, headroom takes
    the tightest, flags OR.  ``engine`` prefixes other's compile entries
    so a merged multi-engine view stays attributable."""
    base["ticks"] = max(base["ticks"], other["ticks"])
    for key in ("capacity", "bytes_in_use", "bytes_peak",
                "model_predicted_bytes"):
        base[key] += other[key]
    for key in ("device_bytes_in_use", "device_bytes_limit",
                "budget_bytes", "model_bytes_per_group"):
        base[key] = max(base[key], other[key])
    base["headroom_pct"] = min(base["headroom_pct"], other["headroom_pct"])
    for key in _BOOL_KEYS:
        base[key] = bool(base[key] or other[key])
    mg, og = base["model_max_g_at_budget"], other["model_max_g_at_budget"]
    base["model_max_g_at_budget"] = (min(mg, og) if mg and og
                                     else max(mg, og))
    for name, ent in other["entries"].items():
        tag = f"{engine}:{name}" if engine else name
        row = base["entries"].setdefault(
            tag, {k: 0 for k in _ENTRY_KEYS})
        for key in ("calls", "compiles", "retraces", "compile_us_total"):
            row[key] += ent[key]
        row["last_compile_us"] = max(row["last_compile_us"],
                                     ent["last_compile_us"])


def register_exposition(registry, source, replace: bool = False) -> None:
    """Register the capacity callback-gauge families on ``registry``,
    backed by ``source()`` -> capacity dict (or None for "no data
    yet").  Idempotent when ``replace`` is False (same ownership
    protocol as fleet/health.register_exposition: a NodeHost's merged
    view claims the names before any engine's device-only one)."""
    if not replace and registry.kind_of("capacity_bytes_in_use") is not None:
        return

    def _get() -> dict:
        d = source()
        return d if d is not None else empty_dict()

    registry.gauge_fn("capacity_bytes_in_use",
                      lambda: _get()["bytes_in_use"],
                      help="live bytes of the engines' resident trees")
    registry.gauge_fn("capacity_bytes_peak",
                      lambda: _get()["bytes_peak"],
                      help="peak live bytes since engine start")
    registry.gauge_fn("capacity_headroom_pct",
                      lambda: _get()["headroom_pct"],
                      help="% headroom against the device budget")
    registry.gauge_fn(
        "capacity_compile_total",
        lambda: {(n,): e["compiles"]
                 for n, e in _get()["entries"].items()},
        help="traces/compiles per jit entry",
        labelnames=("entry",))
    registry.gauge_fn(
        "capacity_retrace_total",
        lambda: {(n,): e["retraces"]
                 for n, e in _get()["entries"].items()},
        help="post-steady-state retraces per jit entry",
        labelnames=("entry",))


# ---------------------------------------------------------------------------
# strict schema validation (fleet_doctor / metrics_dump --capacity)
# ---------------------------------------------------------------------------


def _req_int(obj: dict, key: str, where: str) -> int:
    if key not in obj:
        raise ValueError(f"{where}: missing key {key!r}")
    v = obj[key]
    # bool is an int subclass; reject it where an int is required
    if isinstance(v, bool) or not isinstance(v, int) or v < 0:
        raise ValueError(f"{where}.{key}: expected non-negative int, "
                         f"got {v!r}")
    return v


def validate_capacity(cap: dict, where: str = "capacity") -> None:
    """Strictly check an ``empty_dict``-shaped capacity snapshot (the
    ``/debug/capacity`` payload and the ``/debug/groups`` ``capacity``
    section).  Raises ValueError naming the offending path."""
    if not isinstance(cap, dict):
        raise ValueError(f"{where}: expected dict, got {type(cap)}")
    for key in _INT_KEYS:
        _req_int(cap, key, where)
    for key in _BOOL_KEYS:
        if key not in cap:
            raise ValueError(f"{where}: missing key {key!r}")
        if not isinstance(cap[key], bool):
            raise ValueError(f"{where}.{key}: expected bool, "
                             f"got {cap[key]!r}")
    if "headroom_pct" not in cap:
        raise ValueError(f"{where}: missing key 'headroom_pct'")
    hr = cap["headroom_pct"]
    if isinstance(hr, bool) or not isinstance(hr, (int, float)) or hr < 0:
        raise ValueError(f"{where}.headroom_pct: expected non-negative "
                         f"number, got {hr!r}")
    if not isinstance(cap.get("entries"), dict):
        raise ValueError(f"{where}.entries: expected dict")
    for name, ent in cap["entries"].items():
        ew = f"{where}.entries[{name!r}]"
        if not isinstance(ent, dict):
            raise ValueError(f"{ew}: expected dict")
        for key in _ENTRY_KEYS:
            _req_int(ent, key, ew)
        extra = set(ent) - set(_ENTRY_KEYS)
        if extra:
            raise ValueError(f"{ew}: unexpected keys {sorted(extra)}")
    extra = set(cap) - set(_INT_KEYS) - set(_BOOL_KEYS) - {
        "headroom_pct", "entries"}
    if extra:
        raise ValueError(f"{where}: unexpected keys {sorted(extra)}")
