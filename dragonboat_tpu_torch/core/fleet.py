"""Device-side fleet telemetry reduction over the batched ShardState.

The port of the reference's ``core/fleet.py``.  At 10^4–10^5 lanes, "how
many shards are leaderless right now" must not be answered by iterating
shards on host — one vectorized reduction over the resident ``ShardState``
(plain PyTorch tensor ops on the state's device; the reference's XLA ops)
produces a single small ``FleetStats`` struct, and a decimation knob on
the engines (``fleet_stats_every``) bounds the host transfer to one struct
every N steps, fetched in one crossing (``stats_to_dict``).

The host-side helpers below turn a fetched struct into plain dicts and
register callback gauges on a ``telemetry.Registry`` so the /metrics
endpoint exposes ``fleet_role_count{role=...}`` and the cumulative lag /
inbox-occupancy bucket families.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dragonboat_tpu_torch.core import params as P
from dragonboat_tpu_torch.devices import fetch_struct

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


def fleet_stats(state, inbox_from: torch.Tensor) -> FleetStats:
    """One reduction over the resident state (the reference's
    ``_fleet_stats_impl``): ``inbox_from [G, K]`` i32 on the state's
    device.  Every leaf is i32 (torch sums of bool and i32 widen to i64,
    so each sum names its dtype).  The bucket bounds are compared as
    Python ints, so the pass copies nothing from the host."""
    i32 = torch.int32
    dev = state.role.device
    occ = (state.kind != P.K_ABSENT).any(dim=1)               # [G] bool
    occ_i = occ.to(i32)
    occupied = occ_i.sum(dtype=i32)
    roles = torch.arange(NUM_ROLES, dtype=state.role.dtype, device=dev)
    role_count = (occ_i[:, None]
                  * (state.role[:, None] == roles[None, :]).to(i32)
                  ).sum(dim=0, dtype=i32)
    leaderless = (occ & (state.leader == P.NO_LEADER)).sum(dtype=i32)
    election_active = (occ & ((state.role == P.CANDIDATE)
                              | (state.role == P.PRE_VOTE_CANDIDATE))
                       ).sum(dtype=i32)
    quiesced = (occ & state.quiesced).sum(dtype=i32)
    big = torch.iinfo(i32).max
    term_max = torch.where(occ, state.term, 0).max()
    term_min = torch.where(occupied > 0,
                           torch.where(occ, state.term, big).min(), 0)
    lag = state.committed - state.applied                     # [G] i32
    lag_le = (torch.stack([lag <= b for b in LAG_BUCKETS], dim=1)
              & occ[:, None]).sum(dim=0, dtype=i32)
    lag_hist = torch.cat([lag_le, occupied[None]])
    inbox_occ = (inbox_from != 0).sum(dim=1, dtype=i32)      # [G]
    inbox_le = (torch.stack([inbox_occ <= b for b in INBOX_BUCKETS], dim=1)
                & occ[:, None]).sum(dim=0, dtype=i32)
    inbox_hist = torch.cat([inbox_le, occupied[None]])
    return FleetStats(
        occupied=occupied, role_count=role_count, leaderless=leaderless,
        election_active=election_active, quiesced=quiesced,
        term_max=term_max,
        term_min=term_min, lag_hist=lag_hist, inbox_hist=inbox_hist)


def stats_to_dict(stats: FleetStats) -> dict:
    """Fetch to host (one crossing) and flatten into plain ints/dicts — the
    shape the callback gauges (and ``engine.last_fleet``) serve."""
    s = fetch_struct(stats)
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
