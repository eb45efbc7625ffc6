"""Protocol-invariant probe: the host-side part.

The reference evaluates the protocol invariants its ``core/kstate.py``
declares on every group of the live fleet, on the device, every
``fleet_stats_every`` steps, and fetches one ``InvariantReport``.  The
port keeps the host side of it: the invariant names (in declaration
order, the bit order of ``first_mask``), the struct layouts and
contracts, the dict forms (``report_to_dict``, ``empty_dict``,
``merge_into``), the callback-gauge registration and the validator.  The
device probe (the reference's ``check_invariants``) and its pure-python
oracle (``eval_row`` / ``recount``, which need the invariant grammar) are
ROADMAP.md Queue 1 item 7; until they land the port's ``KernelEngine``
refuses ``invariant_probe=True`` at construction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: the invariants the reference's core/kstate.py declares (INVARIANTS), in
#: declaration order — the bit order of ``InvariantReport.first_mask``
INVARIANT_NAMES = (
    "commit_within_log", "processed_within_commit",
    "applied_within_processed", "term_monotone", "commit_monotone",
    "vote_once_per_term", "leader_commit_quorum", "quiesced_no_campaign",
    "quiesced_no_vote",
)


def _to_host(struct):
    """A struct of tensors with every leaf fetched to a numpy array."""
    return type(struct)(*(np.asarray(v.detach().cpu())
                          if isinstance(v, torch.Tensor) else v
                          for v in struct))


NUM_INVARIANTS = len(INVARIANT_NAMES)

INT32_MAX = 2**31 - 1

#: ShardState columns carried as ``prev_*`` digest fields — must cover
#: every ``prev.`` term any declared invariant references (the reference
#: checks it at import against the parsed invariants; the port's check
#: comes with the probe, item 7)
_PREV_FIELDS = ("term", "vote", "committed", "role", "quiesced",
                "quiesce_epoch")

# Partition contract (grammar: core/kstate.py CONTRACTS; checked by
# analysis/partition.py and the contracts pass).  The digest is per-group
# device state sharded along G; the report is an aggregate over ALL
# groups — replicated, produced by an intentional cross-G collective
# (``collective=declared`` licenses the reductions inside
# _check_invariants_impl that PS001 would otherwise flag).  Axis NI is a
# host-side constant (NUM_INVARIANTS), not kernel geometry.
CONTRACTS = {
    "InvariantDigest": {
        "prev_term": "[G] i32 part=G",
        "prev_vote": "[G] i32 part=G",
        "prev_committed": "[G] i32 part=G",
        "prev_role": "[G] i32 part=G",
        "prev_quiesced": "[G] i32 part=G",
        "prev_quiesce_epoch": "[G] i32 part=G",
        "ticks": "[G] i32 part=G",
    },
    "InvariantReport": {
        "total": "[] i32 part=replicated collective=declared",
        "checked": "[] i32 part=replicated collective=declared",
        "per_invariant": "[NI] i32 part=replicated collective=declared",
        "first_lane": "[] i32 part=replicated collective=declared",
        "first_mask": "[] i32 part=replicated collective=declared",
    },
}


class InvariantDigest(NamedTuple):
    """Fixed-width per-group carry between decimated probe ticks."""

    prev_term: torch.Tensor       # [G]
    prev_vote: torch.Tensor       # [G]
    prev_committed: torch.Tensor  # [G]
    prev_role: torch.Tensor       # [G]
    prev_quiesced: torch.Tensor   # [G] (bool state column widened to i32)
    prev_quiesce_epoch: torch.Tensor  # [G]
    ticks: torch.Tensor           # [G] digest age (0 = no valid prev)


class InvariantReport(NamedTuple):
    """One O(1) host transfer's worth of verdicts (all i32)."""

    total: torch.Tensor           # [] groups violating >= 1 invariant
    checked: torch.Tensor         # [] occupied groups evaluated
    per_invariant: torch.Tensor   # [NUM_INVARIANTS] violating groups
    first_lane: torch.Tensor      # [] lowest violating lane (-1 = none)
    first_mask: torch.Tensor      # [] that lane's violation bitmask


# ---------------------------------------------------------------------------
# host-side converters + exposition
# ---------------------------------------------------------------------------


def _decode_mask(mask: int) -> list[str]:
    return [INVARIANT_NAMES[i] for i in range(NUM_INVARIANTS)
            if (mask >> i) & 1]


def report_to_dict(report: InvariantReport) -> dict:
    """Fetch to host and flatten into plain ints/dicts — the shape the
    callback gauges (and ``engine.last_invariants``) serve."""
    r = _to_host(report)
    d = {
        "total": int(r.total),
        "checked": int(r.checked),
        "per_invariant": {INVARIANT_NAMES[i]: int(r.per_invariant[i])
                          for i in range(NUM_INVARIANTS)},
        "first": None,
    }
    if d["total"] > 0:
        d["first"] = {"lane": int(r.first_lane),
                      "invariants": _decode_mask(int(r.first_mask))}
    return d


def empty_dict() -> dict:
    """All-zero invariants dict (merge identity for hosts w/o engine)."""
    return {
        "total": 0,
        "checked": 0,
        "per_invariant": {n: 0 for n in INVARIANT_NAMES},
        "first": None,
    }


def merge_into(base: dict, other: dict, engine: str | None = None) -> None:
    """Accumulate ``other`` (same shape as ``empty_dict``) into ``base``:
    counts add; the first-offender slot keeps base's unless empty, and
    ``engine`` tags an adopted offender so a merged multi-engine view
    stays attributable."""
    base["total"] += other["total"]
    base["checked"] += other["checked"]
    for n in base["per_invariant"]:
        base["per_invariant"][n] += other["per_invariant"].get(n, 0)
    if base["first"] is None and other["first"] is not None:
        first = dict(other["first"])
        if engine is not None:
            first.setdefault("engine", engine)
        base["first"] = first


def register_exposition(registry, source, replace: bool = False) -> None:
    """Register the invariant callback-gauge families on ``registry``,
    backed by ``source()`` -> invariants dict (or None for "no data
    yet").  Idempotent when ``replace`` is False (same protocol as
    ``health.register_exposition``)."""
    if not replace \
            and registry.kind_of("invariant_violations") is not None:
        return

    def _get() -> dict:
        d = source()
        return d if d is not None else empty_dict()

    registry.gauge_fn(
        "invariant_violations",
        lambda: {(n,): _get()["per_invariant"][n]
                 for n in INVARIANT_NAMES},
        help="groups currently violating each protocol invariant",
        labelnames=("invariant",))
    registry.gauge_fn("invariants.violating_shards",
                      lambda: _get()["total"],
                      help="groups violating at least one invariant")
    registry.gauge_fn("invariants.checked_shards",
                      lambda: _get()["checked"],
                      help="occupied groups the probe evaluated")


def validate_invariants(d: dict, where: str = "invariants") -> None:
    """Strictly check an ``empty_dict``-shaped invariants snapshot (the
    ``/healthz`` 503 ``invariants`` section and chaos oracle rows)."""
    for key in ("total", "checked"):
        v = d.get(key)
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise ValueError(f"{where}.{key}: bad count {v!r}")
    per = d.get("per_invariant")
    if not isinstance(per, dict) or set(per) != set(INVARIANT_NAMES):
        raise ValueError(f"{where}.per_invariant: invariants "
                         f"{sorted(per) if isinstance(per, dict) else per!r}"
                         f" != {sorted(INVARIANT_NAMES)}")
    for n, v in per.items():
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise ValueError(f"{where}.per_invariant[{n!r}]: {v!r}")
    first = d.get("first", 0)
    if first is not None:
        if not isinstance(first, dict):
            raise ValueError(f"{where}.first: expected dict|None, "
                             f"got {first!r}")
        lane = first.get("lane")
        if isinstance(lane, bool) or not isinstance(lane, int):
            raise ValueError(f"{where}.first.lane: {lane!r}")
        for n in first.get("invariants", ()):
            if n not in INVARIANT_NAMES:
                raise ValueError(f"{where}.first: unknown invariant {n!r}")
