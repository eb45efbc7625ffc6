"""Device-side fleet health engine: anomaly classification + top-K triage.

The port of the reference's ``core/health.py``: the passes below are plain
PyTorch tensor ops on the state's device (the reference's are XLA ops under
``jax.jit``).

``core/fleet.py`` answers "what does the fleet look like" with aggregate
histograms; this module answers "which groups are sick and why".  At
10^4–10^6 lanes neither question may be answered by iterating shards on
host, so the detection runs where the state lives: one pass over
the batched ``ShardState`` classifies every group into the anomaly
taxonomy below, carrying a compact fixed-width per-group ``HealthDigest``
(previous commit/applied/term/leader plus consecutive-tick counters)
between decimated health ticks, then reduces device-side to per-class
counts plus a top-K worst-offender list — so only O(K) bytes cross the
host boundary regardless of the group count.

Anomaly classes (bit ``c`` of a group's ``flags`` word):

- ``leaderless``      — occupied and leaderless for >= N consecutive
                        health ticks (persisting, not a blip)
- ``commit_stall``    — work is visibly pending (appended-but-
                        uncommitted log entries: ``last > committed``)
                        yet the commit index has been frozen for >= N
                        ticks.  Inbox occupancy is deliberately NOT the
                        pending signal — heartbeats keep inboxes
                        non-empty on a healthy idle fleet
- ``lag_divergence``  — the commit→apply lag is nonzero and has grown
                        across >= N consecutive digests
- ``churn``           — leadership handoffs (leader id changed between
                        two known leaders) arriving faster than a leaky
                        bucket drains (inc CHURN_INC, decay 1/tick)
- ``term_runaway``    — the term has risen on >= N consecutive ticks
                        (elections spinning without settling)

The digest stays device resident (``part=G``), and the ``HealthReport``
is the single small host transfer (one crossing, ``report_to_dict``),
riding the same ``fleet_stats_every`` decimation as FleetStats.  ``recount`` is the pure-python differential
oracle the tests cross-check against; it takes numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dragonboat_tpu_torch.core import params as P
from dragonboat_tpu_torch.devices import fetch_struct

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


def empty_digest(num_lanes: int, device=None) -> HealthDigest:
    """All-zero digest for ``num_lanes`` groups on ``device`` (ticks=0
    marks every delta-based detector invalid until the first carry).
    Each field is its own tensor."""
    return HealthDigest(*(torch.zeros((num_lanes,), dtype=torch.int32,
                                      device=device)
                          for _ in HealthDigest._fields))


def fleet_health(state, inbox_from: torch.Tensor, digest: HealthDigest,
                 thresholds: HealthThresholds = DEFAULT_THRESHOLDS,
                 k: int = DEFAULT_TOP_K
                 ) -> tuple[HealthReport, HealthDigest]:
    """One classification pass (the reference's ``_fleet_health_impl``):
    ``inbox_from [G, K]`` i32, a host array (uploaded here, as the
    reference's jit takes it) or a tensor on the state's device; every
    report and digest leaf is i32."""
    i32 = torch.int32
    inbox_from = torch.as_tensor(inbox_from, device=state.term.device)
    occ = (state.kind != P.K_ABSENT).any(dim=1)               # [G] bool
    valid = digest.ticks > 0                                  # [G] bool
    lag = state.committed - state.applied                     # [G] i32
    prev_lag = digest.prev_committed - digest.prev_applied
    inbox_occ = (inbox_from != 0).sum(dim=1, dtype=i32)      # [G]
    pending = state.last > state.committed

    leaderless = occ & (state.leader == P.NO_LEADER)
    leaderless_ticks = torch.where(leaderless, digest.leaderless_ticks + 1, 0)

    stalled = (occ & valid & pending
               & (state.committed == digest.prev_committed))
    stall_ticks = torch.where(stalled, digest.stall_ticks + 1, 0)

    diverging = occ & valid & (lag > prev_lag) & (lag > 0)
    lag_ticks = torch.where(diverging, digest.lag_ticks + 1, 0)

    # a handoff is leader A -> leader B, both known: gaining a first
    # leader (or regaining one after a leaderless window) is recovery
    handoff = (occ & valid & (state.leader != digest.prev_leader)
               & (state.leader != P.NO_LEADER)
               & (digest.prev_leader != P.NO_LEADER))
    churn_score = (torch.clamp(digest.churn_score - 1, min=0)
                   + torch.where(handoff, CHURN_INC, 0).to(i32))

    rising = occ & valid & (state.term > digest.prev_term)
    runaway_ticks = torch.where(rising, digest.runaway_ticks + 1, 0)

    flag_mat = torch.stack([
        leaderless_ticks >= thresholds.leaderless_ticks,
        stall_ticks >= thresholds.stall_ticks,
        lag_ticks >= thresholds.lag_ticks,
        churn_score >= thresholds.churn_trip,
        runaway_ticks >= thresholds.runaway_ticks,
    ], dim=1).to(i32)                                         # [G, C]
    class_count = flag_mat.sum(dim=0, dtype=i32)              # [C]
    bits = 1 << torch.arange(NUM_CLASSES, dtype=i32, device=flag_mat.device)
    flags = (flag_mat * bits[None, :]).sum(dim=1, dtype=i32)  # [G]
    any_flag = flags > 0
    anomalous = any_flag.sum(dtype=i32)
    leaderless_now = leaderless.sum(dtype=i32)

    score = (leaderless_ticks * _W_LEADERLESS + stall_ticks * _W_STALL
             + lag_ticks * _W_LAG + churn_score * _W_CHURN
             + runaway_ticks * _W_RUNAWAY)
    score = torch.where(any_flag, score, 0)
    # lax.top_k breaks ties toward the lower index and torch.topk does
    # not: a stable descending sort keeps equal scores in lane order, and
    # its first k are the triage list (k clamps to G, as the reference's)
    k = min(int(k), score.shape[0])
    order = torch.sort(score, descending=True, stable=True).indices[:k]
    worst_score = score[order]
    worst_idx = order.to(i32)
    rows = torch.stack([flags, score, state.term, state.leader,
                        state.committed, state.applied, lag, inbox_occ,
                        leaderless_ticks, stall_ticks, lag_ticks,
                        churn_score, runaway_ticks], dim=1)   # [G, RW]
    worst_rows = rows[order]                                  # [K, RW]

    report = HealthReport(
        class_count=class_count, anomalous=anomalous,
        leaderless_now=leaderless_now, worst_idx=worst_idx,
        worst_score=worst_score, worst_rows=worst_rows)
    # the prev columns are copies: a later out-of-place host write into the
    # state never reaches them, and neither can an in-place one
    new_digest = HealthDigest(
        prev_committed=state.committed.clone(),
        prev_applied=state.applied.clone(),
        prev_term=state.term.clone(), prev_leader=state.leader.clone(),
        leaderless_ticks=leaderless_ticks, stall_ticks=stall_ticks,
        lag_ticks=lag_ticks, churn_score=churn_score,
        runaway_ticks=runaway_ticks, ticks=digest.ticks + 1)
    return report, new_digest


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


def shard_row(state, inbox_from: torch.Tensor, digest: HealthDigest,
              lane: int,
              thresholds: HealthThresholds = DEFAULT_THRESHOLDS) -> ShardRow:
    """ONE group's row (the reference's ``_shard_row_impl``), every leaf
    an i32 scalar tensor on the state's device.  The anomaly flags reuse
    the digest's post-tick counters, so they agree with the report of the
    most recent health tick.  ``inbox_from`` as for ``fleet_health``."""
    i32 = torch.int32
    lane = int(lane)
    inbox_from = torch.as_tensor(inbox_from, device=state.term.device)

    def pick(arr):
        return arr[lane]

    counters = {f: pick(getattr(digest, f))
                for f in ("leaderless_ticks", "stall_ticks", "lag_ticks",
                          "churn_score", "runaway_ticks")}
    trips = (
        counters["leaderless_ticks"] >= thresholds.leaderless_ticks,
        counters["stall_ticks"] >= thresholds.stall_ticks,
        counters["lag_ticks"] >= thresholds.lag_ticks,
        counters["churn_score"] >= thresholds.churn_trip,
        counters["runaway_ticks"] >= thresholds.runaway_ticks,
    )
    flags = torch.stack(trips).to(i32)
    flags = (flags << torch.arange(NUM_CLASSES, dtype=i32,
                                   device=flags.device)).sum(dtype=i32)
    return ShardRow(
        role=pick(state.role), term=pick(state.term),
        vote=pick(state.vote), leader=pick(state.leader),
        committed=pick(state.committed), applied=pick(state.applied),
        last=pick(state.last), stable=pick(state.stable),
        processed=pick(state.processed), snap_index=pick(state.snap_index),
        snap_term=pick(state.snap_term),
        inbox_occ=(pick(inbox_from) != 0).sum(dtype=i32),
        flags=flags, **counters)


def row_to_dict(row: ShardRow) -> dict:
    """Fetch the O(1) row to host (one crossing) and decode the class
    bitmask."""
    r = fetch_struct(row)
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
    r = fetch_struct(report)
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


# ---------------------------------------------------------------------------
# pure-python differential oracle
# ---------------------------------------------------------------------------


def recount(state, inbox_from, digest,
            thresholds: HealthThresholds = DEFAULT_THRESHOLDS,
            k: int = DEFAULT_TOP_K) -> tuple[dict, dict]:
    """Recompute ``fleet_health`` with per-group host loops over fetched
    numpy arrays (fetch the inputs to the host first).  Returns
    ``(report_dict, digest_dict)`` where report_dict matches
    ``report_to_dict`` and digest_dict maps HealthDigest field -> list.
    This is the oracle the randomized differential and the chaos
    detector cross-check cite."""
    G = len(digest.ticks)
    out = {f: [0] * G for f in HealthDigest._fields}
    per_group = []
    counts = [0] * NUM_CLASSES
    anomalous = 0
    leaderless_now = 0
    for g in range(G):
        occ = any(int(kv) != P.K_ABSENT for kv in state.kind[g])
        valid = int(digest.ticks[g]) > 0
        committed = int(state.committed[g])
        applied = int(state.applied[g])
        term = int(state.term[g])
        leader = int(state.leader[g])
        lag = committed - applied
        prev_lag = int(digest.prev_committed[g]) - int(digest.prev_applied[g])
        inbox_occ = sum(1 for v in inbox_from[g] if int(v) != 0)
        pend = int(state.last[g]) > committed

        leaderless = occ and leader == P.NO_LEADER
        lt = int(digest.leaderless_ticks[g]) + 1 if leaderless else 0
        stalled = (occ and valid and pend
                   and committed == int(digest.prev_committed[g]))
        st = int(digest.stall_ticks[g]) + 1 if stalled else 0
        diverging = occ and valid and lag > prev_lag and lag > 0
        gt = int(digest.lag_ticks[g]) + 1 if diverging else 0
        handoff = (occ and valid and leader != int(digest.prev_leader[g])
                   and leader != P.NO_LEADER
                   and int(digest.prev_leader[g]) != P.NO_LEADER)
        cs = max(int(digest.churn_score[g]) - 1, 0) \
            + (CHURN_INC if handoff else 0)
        rising = occ and valid and term > int(digest.prev_term[g])
        rt = int(digest.runaway_ticks[g]) + 1 if rising else 0

        tripped = (lt >= thresholds.leaderless_ticks,
                   st >= thresholds.stall_ticks,
                   gt >= thresholds.lag_ticks,
                   cs >= thresholds.churn_trip,
                   rt >= thresholds.runaway_ticks)
        flags = sum(1 << c for c in range(NUM_CLASSES) if tripped[c])
        for c in range(NUM_CLASSES):
            counts[c] += int(tripped[c])
        score = (lt * _W_LEADERLESS + st * _W_STALL + gt * _W_LAG
                 + cs * _W_CHURN + rt * _W_RUNAWAY) if flags else 0
        if flags:
            anomalous += 1
        if leaderless:
            leaderless_now += 1

        row = dict(zip(ROW_FIELDS, (flags, score, term, leader, committed,
                                    applied, lag, inbox_occ, lt, st, gt,
                                    cs, rt)))
        per_group.append((score, g, row))
        new = dict(prev_committed=committed, prev_applied=applied,
                   prev_term=term, prev_leader=leader, leaderless_ticks=lt,
                   stall_ticks=st, lag_ticks=gt, churn_score=cs,
                   runaway_ticks=rt, ticks=int(digest.ticks[g]) + 1)
        for f, v in new.items():
            out[f][g] = v

    per_group.sort(key=lambda t: (-t[0], t[1]))
    worst = []
    for score, g, row in per_group[:k]:
        if score <= 0:
            continue
        entry = {"lane": g}
        entry.update(row)
        entry["classes"] = [CLASS_NAMES[c] for c in range(NUM_CLASSES)
                            if (row["flags"] >> c) & 1]
        worst.append(entry)
    report = {
        "class_count": dict(zip(CLASS_NAMES, counts)),
        "anomalous": anomalous,
        "leaderless_now": leaderless_now,
        "worst": worst,
    }
    return report, out
