"""Fleet telemetry: the host-side part.

The reference reduces the batched ``ShardState`` on the device into one
small ``FleetStats`` struct every ``fleet_stats_every`` steps.  The port
keeps the host side of it, which ``NodeHost`` and ``KernelEngine`` use at
construction and at scrape time: the struct's layout and contract, the
dict form (``stats_to_dict``, ``empty_dict``, ``merge_into``,
``add_host_shard``) and the callback-gauge registration
(``register_exposition``).  The device reduction (the reference's
``fleet_stats``) is ROADMAP.md Queue 1 item 7; until it lands the port's
``KernelEngine`` refuses a nonzero ``fleet_stats_every`` at construction.
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


NUM_ROLES = 6
# index == the params.py role constant (FOLLOWER=0 .. WITNESS=5)
ROLE_NAMES = ("follower", "candidate", "pre_vote_candidate", "leader",
              "non_voting", "witness")

# cumulative `le` bounds; the +Inf bucket is implicit (== occupied)
LAG_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)
INBOX_BUCKETS = (0, 1, 2, 4, 8)

# Partition contract for the stats struct (grammar: core/kstate.py
# CONTRACTS; checked by analysis/partition.py).  Every field is an
# aggregate over ALL groups: replicated on every device, and produced by
# an intentional cross-G collective — `collective=declared` licenses the
# cross-G reductions inside _fleet_stats_impl that the partition pass
# would otherwise flag as PS001.  Axis names: ROLES == NUM_ROLES,
# LAGB/INBOXB == len(*_BUCKETS)+1 (host-side constants, not kernel
# geometry — the shape side of this table is documentation, the
# part/collective side is machine-checked).
CONTRACTS = {
    "FleetStats": {
        "occupied": "[] i32 part=replicated collective=declared",
        "role_count": "[ROLES] i32 part=replicated collective=declared",
        "leaderless": "[] i32 part=replicated collective=declared",
        "election_active": "[] i32 part=replicated collective=declared",
        "quiesced": "[] i32 part=replicated collective=declared",
        "term_max": "[] i32 part=replicated collective=declared",
        "term_min": "[] i32 part=replicated collective=declared",
        "lag_hist": "[LAGB] i32 part=replicated collective=declared",
        "inbox_hist": "[INBOXB] i32 part=replicated collective=declared",
    },
}


def bucket_labels(bounds) -> tuple:
    return tuple(str(b) for b in bounds) + ("+Inf",)


class FleetStats(NamedTuple):
    """One host transfer's worth of fleet telemetry (all i32)."""

    occupied: torch.Tensor         # [] — lanes with >= 1 configured peer
    role_count: torch.Tensor       # [NUM_ROLES]
    leaderless: torch.Tensor       # [] — occupied lanes with no known leader
    election_active: torch.Tensor  # [] — candidates + pre-vote candidates
    quiesced: torch.Tensor         # [] — occupied lanes masked-quiesced
    term_max: torch.Tensor         # [] (0 when no lane is occupied)
    term_min: torch.Tensor         # [] (0 when no lane is occupied)
    lag_hist: torch.Tensor         # [len(LAG_BUCKETS)+1] cumulative counts
    inbox_hist: torch.Tensor       # [len(INBOX_BUCKETS)+1] cumulative


def stats_to_dict(stats: FleetStats) -> dict:
    """Fetch to host and flatten into plain ints/dicts — the shape the
    callback gauges (and ``engine.last_fleet``) serve."""
    s = _to_host(stats)
    lag_labels = bucket_labels(LAG_BUCKETS)
    inbox_labels = bucket_labels(INBOX_BUCKETS)
    return {
        "occupied": int(s.occupied),
        "role_count": {ROLE_NAMES[i]: int(s.role_count[i])
                       for i in range(NUM_ROLES)},
        "leaderless": int(s.leaderless),
        "election_active": int(s.election_active),
        "quiesced": int(s.quiesced),
        "term_max": int(s.term_max),
        "term_min": int(s.term_min),
        "lag_hist": {lab: int(s.lag_hist[i])
                     for i, lab in enumerate(lag_labels)},
        "inbox_hist": {lab: int(s.inbox_hist[i])
                       for i, lab in enumerate(inbox_labels)},
    }


def empty_dict() -> dict:
    """All-zero fleet dict (merge identity for hosts with no engine)."""
    return {
        "occupied": 0,
        "role_count": {r: 0 for r in ROLE_NAMES},
        "leaderless": 0,
        "election_active": 0,
        "quiesced": 0,
        "term_max": 0,
        "term_min": 0,
        "lag_hist": {lab: 0 for lab in bucket_labels(LAG_BUCKETS)},
        "inbox_hist": {lab: 0 for lab in bucket_labels(INBOX_BUCKETS)},
    }


def merge_into(base: dict, other: dict) -> None:
    """Accumulate ``other`` (same shape as ``empty_dict``) into
    ``base``: counts add, term_max maxes, term_min mins over nonzero."""
    base["occupied"] += other["occupied"]
    base["leaderless"] += other["leaderless"]
    base["election_active"] += other["election_active"]
    base["quiesced"] += other.get("quiesced", 0)
    base["term_max"] = max(base["term_max"], other["term_max"])
    mins = [m for m in (base["term_min"], other["term_min"]) if m > 0]
    base["term_min"] = min(mins) if mins else 0
    for k in base["role_count"]:
        base["role_count"][k] += other["role_count"].get(k, 0)
    for k in base["lag_hist"]:
        base["lag_hist"][k] += other["lag_hist"].get(k, 0)
    for k in base["inbox_hist"]:
        base["inbox_hist"][k] += other["inbox_hist"].get(k, 0)


def add_host_shard(base: dict, role: str, leaderless: bool, term: int,
                   lag: int, quiesced: bool = False) -> None:
    """Fold one HOST-resident (non-kernel) replica into a fleet dict —
    host clusters have no device state to reduce, but the /metrics
    surface must still answer role/leaderless/lag questions."""
    base["occupied"] += 1
    if role in base["role_count"]:
        base["role_count"][role] += 1
    if leaderless:
        base["leaderless"] += 1
    if role in ("candidate", "pre_vote_candidate"):
        base["election_active"] += 1
    if quiesced:
        base["quiesced"] += 1
    if term > 0:
        base["term_max"] = max(base["term_max"], term)
        base["term_min"] = (term if base["term_min"] == 0
                            else min(base["term_min"], term))
    for bound in LAG_BUCKETS:
        if lag <= bound:
            base["lag_hist"][str(bound)] += 1
    base["lag_hist"]["+Inf"] += 1
    # a host replica's inbox is the Python queue, drained every step:
    # occupancy 0 lands in every cumulative bucket
    for bound in INBOX_BUCKETS:
        base["inbox_hist"][str(bound)] += 1
    base["inbox_hist"]["+Inf"] += 1


def register_exposition(registry, source, replace: bool = False) -> None:
    """Register the fleet callback-gauge families on ``registry``,
    backed by ``source()`` -> fleet dict (or None for "no data yet").

    Idempotent when ``replace`` is False: an already-registered family
    set (e.g. the owning NodeHost's merged view) is left alone, so a
    standalone engine can offer its device-only view without fighting a
    host that registered first.  ``replace=True`` re-points the
    callbacks (host restart)."""
    if not replace and registry.kind_of("fleet_role_count") is not None:
        return

    def _get() -> dict:
        d = source()
        return d if d is not None else empty_dict()

    registry.gauge_fn(
        "fleet_role_count",
        lambda: {(r,): _get()["role_count"][r] for r in ROLE_NAMES},
        help="occupied shards per raft role", labelnames=("role",))
    registry.gauge_fn("fleet.occupied_shards",
                      lambda: _get()["occupied"],
                      help="lanes with at least one configured peer")
    registry.gauge_fn("fleet.leaderless_shards",
                      lambda: _get()["leaderless"],
                      help="occupied shards with no known leader")
    registry.gauge_fn("fleet.election_active",
                      lambda: _get()["election_active"],
                      help="shards currently campaigning")
    registry.gauge_fn("fleet.quiesced_shards",
                      lambda: _get().get("quiesced", 0),
                      help="occupied shards in masked quiesce")
    registry.gauge_fn("fleet.term_max", lambda: _get()["term_max"],
                      help="max raft term over occupied shards")
    registry.gauge_fn("fleet.term_min", lambda: _get()["term_min"],
                      help="min raft term over occupied shards")
    registry.gauge_fn(
        "fleet_commit_lag_bucket",
        lambda: {(lab,): _get()["lag_hist"][lab]
                 for lab in bucket_labels(LAG_BUCKETS)},
        help="cumulative commit-applied lag distribution",
        labelnames=("le",))
    registry.gauge_fn(
        "fleet_inbox_occupancy_bucket",
        lambda: {(lab,): _get()["inbox_hist"][lab]
                 for lab in bucket_labels(INBOX_BUCKETS)},
        help="cumulative inbox slot occupancy distribution",
        labelnames=("le",))
