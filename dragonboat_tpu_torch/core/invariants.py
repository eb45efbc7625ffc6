"""Runtime protocol-invariant probe: the third leg of the safety verifier.

The port of the reference's ``core/invariants.py``: the probe below is plain
PyTorch tensor ops on the state's device (the reference's are XLA ops under
``jax.jit``), and its ``quorum(match)`` term launches K1
(``parallel/fabric_kernels.quorum_match``) on the card.

``core/kstate.py`` declares the protocol invariants (INVARIANTS, grammar
in ``analysis/common.py``); this module evaluates them on the LIVE fleet.
One pass over the batched ``ShardState`` checks every declared
invariant on every group, carrying a compact per-group
``InvariantDigest`` (the ``prev.``-referenced columns plus an age
counter) between decimated probe ticks so STEP-scoped invariants
(term/commit monotonicity, vote-at-most-once, quorum-backed commit
advance) are checked over the transition between two observations —
sound for the monotone/guarded forms kstate.py declares, at any
decimation.  The ``InvariantReport`` is the single O(1) host transfer:
a violation total, per-invariant counts, and the first-offender lane +
its violation bitmask, fetched in one crossing (``report_to_dict``).

A nonzero total is ALWAYS a bug — either in the kernel or in the
declared invariant — never an operational condition: the engines raise
an ``invariant_violation`` flight event and ``/healthz`` degrades to
503.  The reference's other two legs consume the same declarations
statically (its ``analysis/safety.py`` and ``scripts/model_check.py``).

``eval_row`` / ``recount`` are the pure-python oracle the tests
cross-check against; ``recount`` takes numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dragonboat_tpu_torch.analysis.common import Invariant, parse_invariants
from dragonboat_tpu_torch.core import params as P
from dragonboat_tpu_torch.core.kstate import INVARIANTS as _SPECS
from dragonboat_tpu_torch.devices import fetch_struct
from dragonboat_tpu_torch.parallel.fabric_kernels import quorum_match

#: parsed invariants, declaration order (the bit order of first_mask)
PARSED: dict[str, Invariant] = parse_invariants(
    _SPECS, "core/kstate.py:INVARIANTS")
INVARIANT_NAMES = tuple(PARSED)
NUM_INVARIANTS = len(INVARIANT_NAMES)

INT32_MAX = 2**31 - 1

#: ShardState columns carried as ``prev_*`` digest fields — must cover
#: every ``prev.`` term any declared invariant references (checked below
#: at import, so adding an invariant with a new prev. field fails loudly
#: until the digest + CONTRACTS grow the column)
_PREV_FIELDS = ("term", "vote", "committed", "role", "quiesced",
                "quiesce_epoch")

_needed = {t.name
           for inv in PARSED.values()
           for c in (*inv.guards, inv.conclusion)
           for t in (c.lhs, c.rhs) if t.kind == "prev"}
if _needed - set(_PREV_FIELDS):
    raise ValueError(
        f"core/invariants.py: INVARIANTS reference prev. fields "
        f"{sorted(_needed - set(_PREV_FIELDS))} not carried by "
        "InvariantDigest — add them to _PREV_FIELDS and CONTRACTS")

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


def empty_digest(num_lanes: int, device=None) -> InvariantDigest:
    """All-zero digest for ``num_lanes`` groups on ``device`` (ticks=0
    marks every step-scoped invariant vacuous until the first carry).
    Each field is its own tensor."""
    return InvariantDigest(*(torch.zeros((num_lanes,), dtype=torch.int32,
                                         device=device)
                             for _ in InvariantDigest._fields))


#: comparison semantics shared by the probe (tensors), the
#: pure-python oracle (ints) and the model checker
OPS = {
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
}


def _quorum_arr(state, col):
    """Vectorized [G] ``quorum(col)``: the q-th largest value among
    voting members, q = nv // 2 + 1 — exactly core/kernel.py's commit
    rule with the leading G axis kept, and so one K1 launch on the card.
    K1's contract is the reference's sort-and-clip form, rows with no
    voter included (INT32_MAX)."""
    i32 = torch.int32
    voting = (state.kind == P.K_VOTER) | (state.kind == P.K_WITNESS)
    nv = voting.sum(dim=1, dtype=i32)
    return quorum_match(col.to(i32).contiguous(), voting.contiguous(),
                        nv // 2 + 1)


def _term_arr(t, state, inv_digest):
    """One operand: an i32 [G] tensor, or a Python int for a constant
    (compared against a tensor it broadcasts with no device copy)."""
    if t.kind == "const":
        return int(t.value)
    if t.kind == "param":
        return int(getattr(P, t.name))
    if t.kind == "field":
        return getattr(state, t.name).to(torch.int32)
    if t.kind == "prev":
        return getattr(inv_digest, "prev_" + t.name)
    if t.kind == "quorum":
        return _quorum_arr(state, getattr(state, t.name))
    raise ValueError(f"unknown invariant term kind {t.kind!r}")


def _compare(c, state, inv_digest, like):
    """[G] bool of one comparison (a constant-only one broadcast over
    ``like``'s rows)."""
    got = OPS[c.op](_term_arr(c.lhs, state, inv_digest),
                    _term_arr(c.rhs, state, inv_digest))
    if isinstance(got, bool):
        return torch.full_like(like, got)
    return got


def _violations(inv: Invariant, state, inv_digest, occ, valid):
    """[G] bool: rows where ``inv``'s guards all hold but the conclusion
    does not.  Step-scoped invariants are vacuous without a valid prev."""
    live = occ & valid if inv.scope == "step" else occ
    for g in inv.guards:
        live = live & _compare(g, state, inv_digest, occ)
    holds = _compare(inv.conclusion, state, inv_digest, occ)
    return live & ~holds


def check_invariants(state, inv_digest: InvariantDigest
                     ) -> tuple[InvariantReport, InvariantDigest]:
    """One probe pass (the reference's ``_check_invariants_impl``); every
    report and digest leaf is i32."""
    i32 = torch.int32
    occ = (state.kind != P.K_ABSENT).any(dim=1)               # [G] bool
    valid = inv_digest.ticks > 0                              # [G] bool
    viol_mat = torch.stack(
        [_violations(inv, state, inv_digest, occ, valid)
         for inv in PARSED.values()], dim=1).to(i32)          # [G, NI]
    per_invariant = viol_mat.sum(dim=0, dtype=i32)            # [NI]
    bits = 1 << torch.arange(NUM_INVARIANTS, dtype=i32, device=occ.device)
    mask = (viol_mat * bits[None, :]).sum(dim=1, dtype=i32)   # [G]
    bad = mask > 0
    total = bad.sum(dtype=i32)
    G = mask.shape[0]
    lanes = torch.arange(G, dtype=i32, device=occ.device)
    first = torch.where(bad, lanes, INT32_MAX).min()
    first_lane = torch.where(total > 0, first, -1)
    at_first = torch.clamp(first, 0, G - 1).long().reshape(1)
    first_mask = torch.where(
        total > 0, mask.gather(0, at_first).reshape(()), 0)
    report = InvariantReport(
        total=total, checked=occ.sum(dtype=i32),
        per_invariant=per_invariant, first_lane=first_lane,
        first_mask=first_mask)
    # the prev columns are copies, independent of any later host write
    # into the state
    new_digest = InvariantDigest(
        prev_term=state.term.clone(), prev_vote=state.vote.clone(),
        prev_committed=state.committed.clone(),
        prev_role=state.role.clone(),
        prev_quiesced=state.quiesced.to(i32),
        prev_quiesce_epoch=state.quiesce_epoch.clone(),
        ticks=inv_digest.ticks + 1)
    return report, new_digest


# ---------------------------------------------------------------------------
# host-side converters + exposition
# ---------------------------------------------------------------------------


def _decode_mask(mask: int) -> list[str]:
    return [INVARIANT_NAMES[i] for i in range(NUM_INVARIANTS)
            if (mask >> i) & 1]


def report_to_dict(report: InvariantReport) -> dict:
    """Fetch to host (one crossing) and flatten into plain ints/dicts —
    the shape the callback gauges (and ``engine.last_invariants``) serve."""
    r = fetch_struct(report)
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


# ---------------------------------------------------------------------------
# pure-python oracle (tests)
# ---------------------------------------------------------------------------


def quorum_py(match, kind) -> int:
    """Python mirror of _quorum_arr for one group's [P] rows."""
    voting = [int(k) in (P.K_VOTER, P.K_WITNESS) for k in kind]
    mv = sorted(int(m) if v else INT32_MAX for m, v in zip(match, voting))
    nv = sum(voting)
    pos = min(max(nv - (nv // 2 + 1), 0), len(mv) - 1)
    return mv[pos]


def _term_row(t, cur: dict, prev: dict | None):
    if t.kind == "const":
        return t.value
    if t.kind == "param":
        return int(getattr(P, t.name))
    if t.kind == "field":
        return int(cur[t.name])
    if t.kind == "prev":
        return int(prev[t.name])
    if t.kind == "quorum":
        return quorum_py(cur[t.name], cur["kind"])
    raise ValueError(f"unknown invariant term kind {t.kind!r}")


def eval_row(inv: Invariant, cur: dict, prev: dict | None) -> bool:
    """True iff ``inv`` is VIOLATED on one group's row.  ``cur`` maps
    ShardState field -> int ([G] columns) or [P] sequence (``match`` /
    ``kind``); ``prev`` maps prev-field -> int, or None for "no prior
    observation" (step-scoped invariants pass vacuously)."""
    if inv.scope == "step" and prev is None:
        return False
    for g in inv.guards:
        if not OPS[g.op](_term_row(g.lhs, cur, prev),
                         _term_row(g.rhs, cur, prev)):
            return False
    c = inv.conclusion
    return not OPS[c.op](_term_row(c.lhs, cur, prev),
                         _term_row(c.rhs, cur, prev))


def recount(state, inv_digest) -> tuple[dict, dict]:
    """Recompute ``check_invariants`` with per-group host loops over
    numpy arrays (fetch the inputs to the host first).  Returns
    ``(report_dict, digest_dict)`` where report_dict matches
    ``report_to_dict`` and digest_dict maps InvariantDigest field ->
    list — the oracle the probe's differential tests cite."""
    G = len(inv_digest.ticks)
    counts = {n: 0 for n in INVARIANT_NAMES}
    total = checked = 0
    first = None
    out = {f: [0] * G for f in InvariantDigest._fields}
    for g in range(G):
        occ = any(int(k) != P.K_ABSENT for k in state.kind[g])
        valid = int(inv_digest.ticks[g]) > 0
        cur = {"kind": [int(v) for v in state.kind[g]]}
        for f in sorted({f for inv in PARSED.values() for f in inv.fields}):
            col = getattr(state, f)[g]
            cur[f] = ([int(v) for v in col] if getattr(col, "ndim", 0)
                      else int(col))
        prev = ({f: int(getattr(inv_digest, "prev_" + f)[g])
                 for f in _PREV_FIELDS} if valid else None)
        if occ:
            checked += 1
        mask = 0
        for i, inv in enumerate(PARSED.values()):
            if occ and eval_row(inv, cur, prev):
                counts[inv.name] += 1
                mask |= 1 << i
        if mask:
            total += 1
            if first is None:
                first = {"lane": g, "invariants": _decode_mask(mask)}
        new = {"prev_" + f: int(getattr(state, f)[g])
               for f in _PREV_FIELDS}
        new["ticks"] = int(inv_digest.ticks[g]) + 1
        for f, v in new.items():
            out[f][g] = v
    report = {"total": total, "checked": checked,
              "per_invariant": counts, "first": first}
    return report, out
