"""Typed metrics registry with Prometheus text exposition.

The reference exposes its counters through a Prometheus registry
(nodehost metrics + event.go); the seed's ``events.Metrics`` collapsed
all of that into one ``defaultdict(int)``, which silently conflates
monotonic counters with set-anywhere gauges.  This module is the typed
replacement: ``Counter`` / ``Gauge`` / ``Histogram`` instruments with
optional label families, callback gauges evaluated at collect time, and
a ``Registry`` that renders the Prometheus text format (0.0.4) plus a
strict parser for round-trip tests and the one-shot scraper.

Locking: the registry lock only guards the family table; instrument
values are guarded by per-instrument locks, and callback gauges are
evaluated with NO registry lock held, so a callback may take host locks
(e.g. NodeHost.mu) without inverting against engine threads that hold
host locks while bumping counters.

Determinism: this module is in the determinism lint scope — it never
reads the wall clock and never draws randomness; histograms observe
caller-supplied values and exposition output is sorted by name.
"""

from __future__ import annotations

import bisect
import re
import threading

from dragonboat_tpu_torch.logger import get_logger

_LOG = get_logger("telemetry")


class InstrumentTypeError(TypeError):
    """Wrong operation for the instrument's type — ``inc()`` on a gauge,
    ``set()`` on a counter, or re-registering a name as another kind."""


_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")

# fsync / write / step latencies in microseconds
DEFAULT_LATENCY_BUCKETS_US = (
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
    25000.0, 50000.0, 100000.0, 250000.0, 500000.0, 1000000.0)


def sanitize_name(name: str) -> str:
    """Legacy dotted name -> Prometheus metric name (dots become ``_``)."""
    out = _SANITIZE_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return repr(f)


class Counter:
    """Monotonic counter: ``inc()`` only; ``set()`` raises."""

    kind = "counter"

    def __init__(self, name: str) -> None:
        self.name = name
        self.mu = threading.Lock()
        self._value = 0                                   # guarded-by: mu

    def inc(self, delta: int = 1) -> None:
        if delta < 0:
            raise ValueError(
                f"counter {self.name!r}: inc({delta}) is negative "
                "(counters are monotonic; use a gauge)")
        with self.mu:
            self._value += delta

    def set(self, value) -> None:
        raise InstrumentTypeError(
            f"{self.name!r} is a counter: set() would break monotonicity "
            "(register a gauge instead)")

    def observe(self, value) -> None:
        raise InstrumentTypeError(
            f"{self.name!r} is a counter: observe() needs a histogram")

    def value(self):
        with self.mu:
            return self._value

    def _force_set(self, value) -> None:
        """Legacy-shim escape hatch (events.Metrics migration only)."""
        with self.mu:
            self._value = value


class Gauge:
    """Point-in-time value: ``set()`` only; ``inc()`` raises."""

    kind = "gauge"

    def __init__(self, name: str) -> None:
        self.name = name
        self.mu = threading.Lock()
        self._value = 0                                   # guarded-by: mu

    def set(self, value) -> None:
        with self.mu:
            self._value = value

    def inc(self, delta: int = 1) -> None:
        raise InstrumentTypeError(
            f"{self.name!r} is a gauge: inc() is a counter operation "
            "(register a counter instead)")

    def observe(self, value) -> None:
        raise InstrumentTypeError(
            f"{self.name!r} is a gauge: observe() needs a histogram")

    def value(self):
        with self.mu:
            return self._value

    def _force_add(self, delta) -> None:
        """Legacy-shim escape hatch (events.Metrics migration only)."""
        with self.mu:
            self._value += delta


class Histogram:
    """Fixed-bucket histogram: cumulative ``le`` exposition with
    ``_sum`` / ``_count``, +Inf bucket implicit."""

    kind = "histogram"

    def __init__(self, name: str, buckets=DEFAULT_LATENCY_BUCKETS_US
                 ) -> None:
        bounds = tuple(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"histogram {name!r}: needs >= 1 bucket bound")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram {name!r}: bucket bounds must be strictly "
                f"increasing, got {bounds}")
        self.name = name
        self.buckets = bounds
        self.mu = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)            # guarded-by: mu
        self._sum = 0.0                                   # guarded-by: mu
        self._total = 0                                   # guarded-by: mu

    def observe(self, value) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self.mu:
            self._counts[i] += 1
            self._sum += v
            self._total += 1

    def inc(self, delta: int = 1) -> None:
        raise InstrumentTypeError(
            f"{self.name!r} is a histogram: use observe(value)")

    def set(self, value) -> None:
        raise InstrumentTypeError(
            f"{self.name!r} is a histogram: use observe(value)")

    def snapshot_hist(self):
        """(cumulative counts per bound + +Inf, sum, total)."""
        with self.mu:
            counts = list(self._counts)
            total, s = self._total, self._sum
        cum, running = [], 0
        for c in counts:
            running += c
            cum.append(running)
        return cum, s, total


class Family:
    """One registered metric name: fixed label names, a child instrument
    per label-values tuple (the empty tuple for unlabeled metrics), or a
    callback evaluated at collect time."""

    def __init__(self, name: str, kind: str, labelnames, help: str,
                 ctor) -> None:
        self.name = name
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.help = help
        self.callback = None          # set by Registry.gauge_fn
        self.mu = threading.Lock()
        self._children: dict[tuple, object] = {}          # guarded-by: mu
        self._ctor = ctor

    def labels(self, *values, **kv):
        if kv:
            if values or sorted(kv) != sorted(self.labelnames):
                raise ValueError(
                    f"{self.name!r}: expected labels {self.labelnames}, "
                    f"got {tuple(sorted(kv))}")
            values = tuple(kv[k] for k in self.labelnames)
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name!r}: expected {len(self.labelnames)} label "
                f"value(s) for {self.labelnames}, got {len(key)}")
        with self.mu:
            child = self._children.get(key)
            if child is None:
                child = self._ctor()
                self._children[key] = child
        return child

    def children(self) -> dict:
        with self.mu:
            return dict(self._children)


class Registry:
    """Typed instrument registry + Prometheus text exposition."""

    def __init__(self) -> None:
        self.mu = threading.Lock()
        self._families: dict[str, Family] = {}            # guarded-by: mu

    # -- registration ---------------------------------------------------

    def _family(self, name: str, kind: str, labelnames, help: str,
                ctor) -> Family:
        with self.mu:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind, labelnames, help, ctor)
                self._families[name] = fam
                return fam
        if fam.kind != kind or fam.callback is not None:
            have = "callback gauge" if fam.callback is not None else fam.kind
            raise InstrumentTypeError(
                f"{name!r} is already registered as a {have}, "
                f"not a {kind}")
        if tuple(labelnames) != fam.labelnames:
            raise ValueError(
                f"{name!r}: label names {tuple(labelnames)} do not match "
                f"registered {fam.labelnames}")
        return fam

    def counter(self, name: str, help: str = "", labelnames=()):
        fam = self._family(name, "counter", labelnames, help,
                           lambda: Counter(name))
        return fam if labelnames else fam.labels()

    def gauge(self, name: str, help: str = "", labelnames=()):
        fam = self._family(name, "gauge", labelnames, help,
                           lambda: Gauge(name))
        return fam if labelnames else fam.labels()

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_LATENCY_BUCKETS_US, labelnames=()):
        fam = self._family(name, "histogram", labelnames, help,
                           lambda: Histogram(name, buckets))
        return fam if labelnames else fam.labels()

    def gauge_fn(self, name: str, fn, help: str = "", labelnames=()
                 ) -> None:
        """Register (or re-point, e.g. after a host restart rebuilds the
        producer) a gauge whose value is ``fn()`` at collect time.
        Unlabeled: ``fn() -> number``.  Labeled: ``fn() -> {label-values
        tuple (or single str): number}``."""
        with self.mu:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, "gauge", labelnames, help, None)
                fam.callback = fn
                self._families[name] = fam
                return
        if fam.kind != "gauge" or fam.callback is None:
            raise InstrumentTypeError(
                f"{name!r} is already registered as a non-callback "
                f"{fam.kind}")
        if tuple(labelnames) != fam.labelnames:
            raise ValueError(
                f"{name!r}: label names {tuple(labelnames)} do not match "
                f"registered {fam.labelnames}")
        fam.callback = fn

    def kind_of(self, name: str) -> str | None:
        with self.mu:
            fam = self._families.get(name)
        return None if fam is None else fam.kind

    # -- collection -----------------------------------------------------

    def _fam_samples(self, fam: Family):
        """[(suffix, {label: value}, number)] — registry lock NOT held,
        so callbacks may take producer locks."""
        out = []
        if fam.callback is not None:
            try:
                got = fam.callback()
            except Exception:
                _LOG.exception("callback gauge %r raised", fam.name)
                return out
            if fam.labelnames:
                for key in sorted(got, key=str):
                    kt = key if isinstance(key, tuple) else (key,)
                    labels = dict(zip(fam.labelnames,
                                      (str(k) for k in kt)))
                    out.append(("", labels, got[key]))
            else:
                out.append(("", {}, got))
            return out
        children = fam.children()
        for key in sorted(children):
            child = children[key]
            labels = dict(zip(fam.labelnames, key))
            if fam.kind == "histogram":
                cum, s, total = child.snapshot_hist()
                for bound, c in zip(child.buckets, cum[:-1]):
                    le = dict(labels)
                    le["le"] = _fmt_value(bound)
                    out.append(("_bucket", le, c))
                inf = dict(labels)
                inf["le"] = "+Inf"
                out.append(("_bucket", inf, cum[-1]))
                out.append(("_sum", labels, s))
                out.append(("_count", labels, total))
            else:
                out.append(("", labels, child.value()))
        return out

    def collect(self):
        """[(family, samples)] sorted by name; values read outside the
        registry lock."""
        with self.mu:
            fams = list(self._families.values())
        fams.sort(key=lambda f: f.name)
        return [(fam, self._fam_samples(fam)) for fam in fams]

    def exposition(self) -> str:
        """Prometheus text format 0.0.4."""
        lines = []
        for fam, samples in self.collect():
            pname = sanitize_name(fam.name)
            if fam.help:
                lines.append(f"# HELP {pname} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {pname} {fam.kind}")
            for suffix, labels, value in samples:
                if labels:
                    inner = ",".join(
                        f'{k}="{_escape_label(str(v))}"'
                        for k, v in labels.items())
                    label_str = "{" + inner + "}"
                else:
                    label_str = ""
                lines.append(
                    f"{pname}{suffix}{label_str} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Flat legacy view: unlabeled counters/gauges keep their exact
        registered (dotted) names; labeled samples render as
        ``name{k=v}``; histograms flatten to ``name.count`` /
        ``name.sum``.  Callback gauges are evaluated."""
        out: dict = {}
        for fam, samples in self.collect():
            for suffix, labels, value in samples:
                if fam.kind == "histogram":
                    if suffix == "_count":
                        key = fam.name + ".count"
                    elif suffix == "_sum":
                        key = fam.name + ".sum"
                    else:
                        continue
                    rest = {k: v for k, v in labels.items() if k != "le"}
                    if rest:
                        key += "{" + ",".join(
                            f"{k}={v}" for k, v in rest.items()) + "}"
                else:
                    key = fam.name
                    if labels:
                        key += "{" + ",".join(
                            f"{k}={v}" for k, v in labels.items()) + "}"
                out[key] = value
        return out


# process-global registry for module-scoped producers (logdb engines
# have no handle on a NodeHost's per-hub registry); the /metrics
# endpoint serves a host's registry concatenated with this one
GLOBAL = Registry()


def global_registry() -> Registry:
    return GLOBAL


# -- strict text-format parser (round-trip tests + metrics_dump) --------

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                        # optional label block
    r" (\+Inf|-Inf|NaN|[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)$")
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(?:,|$)')


def _unescape_label(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_exposition(text: str) -> dict:
    """Strict parser for the exposition subset this module emits.

    Returns ``{family: {"type": kind, "help": str, "samples":
    [(sample_name, {label: value}, float)]}}`` and raises ``ValueError``
    on anything malformed: samples without a preceding TYPE, duplicate
    TYPE lines, label syntax errors, non-cumulative histogram buckets,
    a missing ``+Inf`` bucket, or ``_count`` disagreeing with it.
    """
    families: dict[str, dict] = {}

    def family_of(sample_name: str) -> str | None:
        if sample_name in families:
            return sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix):
                base = sample_name[:-len(suffix)]
                if base in families and families[base]["type"] == \
                        "histogram":
                    return base
        return None

    for lineno, raw in enumerate(text.split("\n"), 1):
        line = raw.rstrip("\r")
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 3 or parts[0] != "#":
                raise ValueError(f"line {lineno}: malformed comment "
                                 f"{line!r}")
            if parts[1] == "HELP":
                name = parts[2]
                if not _METRIC_NAME_RE.match(name):
                    raise ValueError(
                        f"line {lineno}: bad metric name {name!r}")
                fam = families.setdefault(
                    name, {"type": None, "help": "", "samples": []})
                fam["help"] = parts[3] if len(parts) > 3 else ""
            elif parts[1] == "TYPE":
                if len(parts) != 4:
                    raise ValueError(f"line {lineno}: malformed TYPE "
                                     f"{line!r}")
                name, kind = parts[2], parts[3]
                if not _METRIC_NAME_RE.match(name):
                    raise ValueError(
                        f"line {lineno}: bad metric name {name!r}")
                if kind not in ("counter", "gauge", "histogram",
                                "summary", "untyped"):
                    raise ValueError(
                        f"line {lineno}: unknown type {kind!r}")
                fam = families.setdefault(
                    name, {"type": None, "help": "", "samples": []})
                if fam["type"] is not None:
                    raise ValueError(
                        f"line {lineno}: duplicate TYPE for {name!r}")
                if fam["samples"]:
                    raise ValueError(
                        f"line {lineno}: TYPE for {name!r} after its "
                        "samples")
                fam["type"] = kind
            else:
                raise ValueError(
                    f"line {lineno}: unknown comment {parts[1]!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        sname, labelblock, valstr = m.group(1), m.group(2), m.group(3)
        labels: dict[str, str] = {}
        if labelblock is not None:
            pos = 0
            while pos < len(labelblock):
                lm = _LABEL_RE.match(labelblock, pos)
                if lm is None:
                    raise ValueError(
                        f"line {lineno}: bad label syntax at offset "
                        f"{pos} in {labelblock!r}")
                if lm.group(1) in labels:
                    raise ValueError(
                        f"line {lineno}: duplicate label "
                        f"{lm.group(1)!r}")
                labels[lm.group(1)] = _unescape_label(lm.group(2))
                pos = lm.end()
        if valstr == "+Inf":
            value = float("inf")
        elif valstr == "-Inf":
            value = float("-inf")
        else:
            value = float(valstr)
        base = family_of(sname)
        if base is None:
            raise ValueError(
                f"line {lineno}: sample {sname!r} has no preceding "
                "TYPE declaration")
        if families[base]["type"] is None:
            raise ValueError(
                f"line {lineno}: sample {sname!r} before TYPE")
        families[base]["samples"].append((sname, labels, value))

    # histogram consistency: per label-set, buckets cumulative with a
    # +Inf bound equal to _count
    for name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        series: dict[tuple, list] = {}
        counts: dict[tuple, float] = {}
        for sname, labels, value in fam["samples"]:
            rest = tuple(sorted((k, v) for k, v in labels.items()
                                if k != "le"))
            if sname == name + "_bucket":
                if "le" not in labels:
                    raise ValueError(
                        f"{name}: _bucket sample without le label")
                series.setdefault(rest, []).append(
                    (labels["le"], value))
            elif sname == name + "_count":
                counts[rest] = value
        for rest, buckets in series.items():
            vals = [v for _, v in buckets]
            if vals != sorted(vals):
                raise ValueError(
                    f"{name}: histogram buckets not cumulative")
            les = [le for le, _ in buckets]
            if "+Inf" not in les:
                raise ValueError(f"{name}: histogram missing +Inf bucket")
            inf_val = dict(buckets)["+Inf"]
            if rest in counts and counts[rest] != inf_val:
                raise ValueError(
                    f"{name}: _count {counts[rest]} != +Inf bucket "
                    f"{inf_val}")
    return families
