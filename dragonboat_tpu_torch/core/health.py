"""Anomaly health: the host-side part.

The reference classifies every group on the device (leaderless, commit
stall, lag divergence, churn, runaway term) and ranks the worst K into a
``HealthReport`` every ``fleet_stats_every`` steps.  The port keeps the
host side of it: the class names and thresholds (``HealthThresholds``,
``DEFAULT_THRESHOLDS``), the struct layouts and contracts, the dict forms
(``report_to_dict``, ``row_to_dict``, ``empty_dict``, ``merge_into``), the
callback-gauge registration and the schema validators.  The device
reductions (the reference's ``fleet_health`` and ``shard_row``) and their
numpy ``recount`` oracle are ROADMAP.md Queue 1 item 7; until
they land the port's ``KernelEngine`` refuses a nonzero ``health_top_k``
at construction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _to_host(struct):
    """A struct of tensors with every leaf fetched to a numpy array."""
    return type(struct)(*(np.asarray(v.detach().cpu())
                          if isinstance(v, torch.Tensor) else v
                          for v in struct))


NUM_CLASSES = 5
CLASS_NAMES = ("leaderless", "commit_stall", "lag_divergence", "churn",
               "term_runaway")

#: columns of HealthReport.worst_rows (and the per-offender dict keys)
ROW_FIELDS = ("flags", "score", "term", "leader", "committed", "applied",
              "lag", "inbox", "leaderless_ticks", "stall_ticks",
              "lag_ticks", "churn_score", "runaway_ticks")
ROW_WIDTH = len(ROW_FIELDS)

DEFAULT_TOP_K = 8
#: leaky-bucket increment per observed leadership handoff (decay: 1/tick)
CHURN_INC = 4

#: severity weights per class counter — leaderless groups outrank laggy
#: ones in the triage list; within a class, longer-persisting is worse
_W_LEADERLESS, _W_STALL, _W_LAG, _W_CHURN, _W_RUNAWAY = 8, 4, 2, 2, 4


class HealthThresholds(NamedTuple):
    """Static (jit-time) anomaly trip points, in health ticks."""

    leaderless_ticks: int = 3
    stall_ticks: int = 3
    lag_ticks: int = 3
    churn_trip: int = 8      # leaky-bucket level, not ticks
    runaway_ticks: int = 4


DEFAULT_THRESHOLDS = HealthThresholds()

# Partition contract (grammar: core/kstate.py CONTRACTS; checked by
# analysis/partition.py and the contracts pass).  The digest is per-group
# device state sharded along G; the report is an aggregate over ALL
# groups — replicated, and produced by an intentional cross-G collective
# (`collective=declared` licenses the reductions/top_k/gather inside
# _fleet_health_impl that PS001 would otherwise flag).  Axis names C /
# TOPK / RW are host-side constants (NUM_CLASSES, k, ROW_WIDTH), not
# kernel geometry.
CONTRACTS = {
    "HealthDigest": {
        "prev_committed": "[G] i32 part=G",
        "prev_applied": "[G] i32 part=G",
        "prev_term": "[G] i32 part=G",
        "prev_leader": "[G] i32 part=G",
        "leaderless_ticks": "[G] i32 part=G",
        "stall_ticks": "[G] i32 part=G",
        "lag_ticks": "[G] i32 part=G",
        "churn_score": "[G] i32 part=G",
        "runaway_ticks": "[G] i32 part=G",
        "ticks": "[G] i32 part=G",
    },
    "HealthReport": {
        "class_count": "[C] i32 part=replicated collective=declared",
        "anomalous": "[] i32 part=replicated collective=declared",
        "leaderless_now": "[] i32 part=replicated collective=declared",
        "worst_idx": "[TOPK] i32 part=replicated collective=declared",
        "worst_score": "[TOPK] i32 part=replicated collective=declared",
        "worst_rows": "[TOPK,RW] i32 part=replicated collective=declared",
    },
    # one group's drill-down row (NodeHost.shard_info): every field is a
    # scalar selected out of the G-sharded state by dynamic_index — an
    # intentional cross-G fetch on the debug path, hence declared
    "ShardRow": {
        "role": "[] i32 part=replicated collective=declared",
        "term": "[] i32 part=replicated collective=declared",
        "vote": "[] i32 part=replicated collective=declared",
        "leader": "[] i32 part=replicated collective=declared",
        "committed": "[] i32 part=replicated collective=declared",
        "applied": "[] i32 part=replicated collective=declared",
        "last": "[] i32 part=replicated collective=declared",
        "stable": "[] i32 part=replicated collective=declared",
        "processed": "[] i32 part=replicated collective=declared",
        "snap_index": "[] i32 part=replicated collective=declared",
        "snap_term": "[] i32 part=replicated collective=declared",
        "inbox_occ": "[] i32 part=replicated collective=declared",
        "flags": "[] i32 part=replicated collective=declared",
        "leaderless_ticks": "[] i32 part=replicated collective=declared",
        "stall_ticks": "[] i32 part=replicated collective=declared",
        "lag_ticks": "[] i32 part=replicated collective=declared",
        "churn_score": "[] i32 part=replicated collective=declared",
        "runaway_ticks": "[] i32 part=replicated collective=declared",
    },
}


class HealthDigest(NamedTuple):
    """Fixed-width per-group carry between decimated health ticks."""

    prev_committed: torch.Tensor   # [G]
    prev_applied: torch.Tensor     # [G]
    prev_term: torch.Tensor        # [G]
    prev_leader: torch.Tensor      # [G]
    leaderless_ticks: torch.Tensor  # [G] consecutive leaderless ticks
    stall_ticks: torch.Tensor      # [G] consecutive frozen-commit ticks
    lag_ticks: torch.Tensor        # [G] consecutive growing-lag ticks
    churn_score: torch.Tensor      # [G] leaky bucket of handoffs
    runaway_ticks: torch.Tensor    # [G] consecutive rising-term ticks
    ticks: torch.Tensor            # [G] digest age (0 = no prior tick)


class HealthReport(NamedTuple):
    """One O(K) host transfer's worth of triage (all i32)."""

    class_count: torch.Tensor      # [NUM_CLASSES]
    anomalous: torch.Tensor        # [] groups with any class tripped
    leaderless_now: torch.Tensor   # [] instantaneous leaderless count
    worst_idx: torch.Tensor        # [K] lane indices, worst first
    worst_score: torch.Tensor      # [K] severity (0 = healthy padding)
    worst_rows: torch.Tensor       # [K, ROW_WIDTH] see ROW_FIELDS


class ShardRow(NamedTuple):
    """One group's introspection row: O(1) scalars, never the full
    state (see CONTRACTS)."""

    role: torch.Tensor
    term: torch.Tensor
    vote: torch.Tensor
    leader: torch.Tensor
    committed: torch.Tensor
    applied: torch.Tensor
    last: torch.Tensor
    stable: torch.Tensor
    processed: torch.Tensor
    snap_index: torch.Tensor
    snap_term: torch.Tensor
    inbox_occ: torch.Tensor
    flags: torch.Tensor
    leaderless_ticks: torch.Tensor
    stall_ticks: torch.Tensor
    lag_ticks: torch.Tensor
    churn_score: torch.Tensor
    runaway_ticks: torch.Tensor


def row_to_dict(row: ShardRow) -> dict:
    """Fetch the O(1) row to host and decode the class bitmask."""
    r = _to_host(row)
    d = {f: int(getattr(r, f)) for f in ShardRow._fields}
    d["classes"] = [CLASS_NAMES[c] for c in range(NUM_CLASSES)
                    if (d["flags"] >> c) & 1]
    return d


# ---------------------------------------------------------------------------
# host-side converters + exposition
# ---------------------------------------------------------------------------


def report_to_dict(report: HealthReport) -> dict:
    """Fetch to host and flatten into plain ints/dicts — the shape the
    callback gauges (and ``engine.last_health``) serve.  Healthy top-K
    padding (score 0) is dropped from ``worst``."""
    r = _to_host(report)
    worst = []
    for j in range(len(r.worst_idx)):
        sc = int(r.worst_score[j])
        if sc <= 0:
            continue
        row = r.worst_rows[j]
        entry = {"lane": int(r.worst_idx[j])}
        entry.update({name: int(row[i]) for i, name in enumerate(ROW_FIELDS)})
        entry["classes"] = [CLASS_NAMES[c] for c in range(NUM_CLASSES)
                            if (entry["flags"] >> c) & 1]
        worst.append(entry)
    return {
        "class_count": {CLASS_NAMES[i]: int(r.class_count[i])
                        for i in range(NUM_CLASSES)},
        "anomalous": int(r.anomalous),
        "leaderless_now": int(r.leaderless_now),
        "worst": worst,
    }


def empty_dict() -> dict:
    """All-zero health dict (merge identity for hosts with no engine)."""
    return {
        "class_count": {c: 0 for c in CLASS_NAMES},
        "anomalous": 0,
        "leaderless_now": 0,
        "worst": [],
    }


def merge_into(base: dict, other: dict, engine: str | None = None,
               k: int = DEFAULT_TOP_K) -> None:
    """Accumulate ``other`` (same shape as ``empty_dict``) into ``base``:
    counts add, worst lists merge by (score desc, lane asc) and truncate
    to ``k``.  ``engine`` tags other's offenders so a merged multi-engine
    view stays attributable."""
    base["anomalous"] += other["anomalous"]
    base["leaderless_now"] += other["leaderless_now"]
    for c in base["class_count"]:
        base["class_count"][c] += other["class_count"].get(c, 0)
    incoming = [dict(w) for w in other["worst"]]
    if engine is not None:
        for w in incoming:
            w.setdefault("engine", engine)
    merged = base["worst"] + incoming
    merged.sort(key=lambda w: (-w["score"], w["lane"]))
    base["worst"] = merged[:k]


def register_exposition(registry, source, replace: bool = False) -> None:
    """Register the health callback-gauge families on ``registry``,
    backed by ``source()`` -> health dict (or None for "no data yet").
    Idempotent when ``replace`` is False (same protocol as
    ``fleet.register_exposition``)."""
    if not replace and registry.kind_of("health_anomaly_count") is not None:
        return

    def _get() -> dict:
        d = source()
        return d if d is not None else empty_dict()

    registry.gauge_fn(
        "health_anomaly_count",
        lambda: {(c,): _get()["class_count"][c] for c in CLASS_NAMES},
        help="groups currently tripping each anomaly class",
        labelnames=("class",))
    registry.gauge_fn("health.anomalous_shards",
                      lambda: _get()["anomalous"],
                      help="groups with at least one anomaly class active")
    registry.gauge_fn("health.leaderless_now",
                      lambda: _get()["leaderless_now"],
                      help="instantaneous leaderless occupied groups")


# ---------------------------------------------------------------------------
# strict schema validation (fleet_doctor / metrics_dump --doctor)
# ---------------------------------------------------------------------------

#: breaker states transport/hub.py can report
_BREAKER_STATES = ("closed", "open", "half-open")
_RESIDENCIES = ("host", "device", "mesh")


def _req(obj: dict, key: str, typ, where: str):
    if key not in obj:
        raise ValueError(f"{where}: missing key {key!r}")
    v = obj[key]
    # bool is an int subclass; reject it where an int is required
    if typ is int and isinstance(v, bool):
        raise ValueError(f"{where}.{key}: expected int, got bool")
    if not isinstance(v, typ):
        raise ValueError(f"{where}.{key}: expected {typ}, got {type(v)}")
    return v


def _validate_offender(w: dict, where: str) -> None:
    _req(w, "lane", int, where)
    for f in ROW_FIELDS:
        _req(w, f, int, where)
    classes = _req(w, "classes", list, where)
    for c in classes:
        if c not in CLASS_NAMES:
            raise ValueError(f"{where}.classes: unknown class {c!r}")
    extra = set(w) - set(ROW_FIELDS) - {"lane", "classes", "engine"}
    if extra:
        raise ValueError(f"{where}: unexpected keys {sorted(extra)}")


def validate_health(h: dict, where: str = "health") -> None:
    """Strictly check an ``empty_dict``-shaped health snapshot (the
    ``/debug/groups`` ``health`` section and ``/healthz`` 503 body)."""
    counts = _req(h, "class_count", dict, where)
    if set(counts) != set(CLASS_NAMES):
        raise ValueError(f"{where}.class_count: classes {sorted(counts)} != "
                         f"{sorted(CLASS_NAMES)}")
    for c, n in counts.items():
        if isinstance(n, bool) or not isinstance(n, int) or n < 0:
            raise ValueError(f"{where}.class_count[{c!r}]: bad count {n!r}")
    _req(h, "anomalous", int, where)
    _req(h, "leaderless_now", int, where)
    for j, w in enumerate(_req(h, "worst", list, where)):
        _validate_offender(w, f"{where}.worst[{j}]")


def _validate_membership(mb: dict, where: str) -> None:
    for sect in ("addresses", "non_votings", "witnesses"):
        d = _req(mb, sect, dict, where)
        for r, a in d.items():
            if not str(r).lstrip("-").isdigit() or not isinstance(a, str):
                raise ValueError(f"{where}.{sect}: bad entry {r!r}: {a!r}")
    _req(mb, "config_change_id", int, where)


def validate_info(obj: dict, where: str = "/debug/groups") -> int:
    """Strictly check a ``NodeHost.info()`` payload; returns the shard
    count.  Raises ValueError naming the offending path."""
    _req(obj, "node_host_id", str, where)
    _req(obj, "raft_address", str, where)
    validate_health(_req(obj, "health", dict, where), f"{where}.health")
    shards = _req(obj, "shards", list, where)
    for i, s in enumerate(shards):
        w = f"{where}.shards[{i}]"
        if not isinstance(s, dict):
            raise ValueError(f"{w}: expected dict")
        for key in ("shard_id", "replica_id", "leader_id", "term",
                    "last_applied"):
            _req(s, key, int, w)
        _req(s, "is_leader", bool, w)
        _validate_membership(_req(s, "membership", dict, w),
                             f"{w}.membership")
        if _req(s, "resident", str, w) not in _RESIDENCIES:
            raise ValueError(f"{w}.resident: {s['resident']!r} not in "
                             f"{_RESIDENCIES}")
    return len(shards)


def validate_shard_info(obj: dict, where: str = "/debug/group") -> None:
    """Strictly check a ``NodeHost.shard_info()`` payload (one group's
    drill-down row + host registers)."""
    for key in ("shard_id", "replica_id", "leader_id", "term",
                "last_applied"):
        _req(obj, key, int, where)
    _req(obj, "is_leader", bool, where)
    _validate_membership(_req(obj, "membership", dict, where),
                         f"{where}.membership")
    if _req(obj, "resident", str, where) not in _RESIDENCIES:
        raise ValueError(f"{where}.resident: {obj['resident']!r}")
    pend = _req(obj, "pending", dict, where)
    _req(pend, "proposals", int, f"{where}.pending")
    _req(pend, "read_indexes", int, f"{where}.pending")
    ldb = _req(obj, "logdb", dict, where)
    for key in ("first_index", "last_index", "entry_count"):
        _req(ldb, key, int, f"{where}.logdb")
    snap = ldb.get("snapshot")
    if snap is not None:
        _req(snap, "index", int, f"{where}.logdb.snapshot")
        _req(snap, "term", int, f"{where}.logdb.snapshot")
    for addr, st in _req(obj, "breakers", dict, where).items():
        if st not in _BREAKER_STATES:
            raise ValueError(f"{where}.breakers[{addr!r}]: {st!r} not in "
                             f"{_BREAKER_STATES}")
    sv = _req(obj, "shard_view", dict, where)
    for key in ("shard_id", "config_change_index", "leader_id", "term"):
        _req(sv, key, int, f"{where}.shard_view")
    _req(sv, "replicas", dict, f"{where}.shard_view")
    if "device" not in obj:
        raise ValueError(f"{where}: missing key 'device'")
    dev = obj["device"]
    if dev is not None:
        for f in ShardRow._fields:
            _req(dev, f, int, f"{where}.device")
        for c in _req(dev, "classes", list, f"{where}.device"):
            if c not in CLASS_NAMES:
                raise ValueError(f"{where}.device.classes: {c!r}")
