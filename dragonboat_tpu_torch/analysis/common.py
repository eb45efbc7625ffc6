"""The CONTRACTS grammar parser the capacity model sizes groups with.

The parts of the reference's ``analysis/common.py`` that the port runs:
the field-contract grammar (``"[G, P] i32 part=G"``) and its parser, which
``capacity`` sizes groups with, and the protocol-invariant grammar and its
parser, which ``core/invariants`` evaluates.  The lint passes and waivers
are not part of the port.
"""

from __future__ import annotations

from dataclasses import dataclass


#: canonical dtype names used throughout the contracts pass
DTYPES = ("i32", "u32", "f32", "bool")


class ContractError(ValueError):
    pass


#: legal values of the ``part=`` tag: data that lives per-group and must be
#: sharded along the mesh G axis, vs data that is identical on every device
PARTS = ("G", "replicated")

#: legal values of the ``collective=`` tag: ``declared`` marks a struct whose
#: fields are PRODUCED by an intentional cross-G collective (fleet stats);
#: ``none`` (the default) means cross-G data flow into the field is a bug
COLLECTIVES = ("none", "declared")


@dataclass(frozen=True)
class FieldContract:
    """One parsed ``"[G, P] i32 domain=A..B ring optional part=G"`` string."""

    axes: tuple[str, ...]          # symbolic axis names, () = scalar
    dtype: str                     # one of DTYPES
    ring: bool = False             # power-of-two ring: indexing must mask
    optional: bool = False         # field may be None under some configs
    domain: tuple[str, str] | None = None  # (lo_name, hi_name) in params.py
    part: str | None = None        # one of PARTS, None = undeclared
    collective: str | None = None  # one of COLLECTIVES, None = undeclared


def parse_contract(spec: str, where: str = "<contract>") -> FieldContract:
    """Parse one contract string; raises ContractError on bad grammar."""
    s = spec.strip()
    if not s.startswith("["):
        raise ContractError(f"{where}: contract must start with [axes]: "
                            f"{spec!r}")
    end = s.find("]")
    if end < 0:
        raise ContractError(f"{where}: unterminated axis list: {spec!r}")
    axes_src = s[1:end].strip()
    axes = tuple(a.strip() for a in axes_src.split(",") if a.strip())
    rest = s[end + 1:].split()
    if not rest:
        raise ContractError(f"{where}: missing dtype: {spec!r}")
    dtype, tags = rest[0], rest[1:]
    if dtype not in DTYPES:
        raise ContractError(f"{where}: unknown dtype {dtype!r} "
                            f"(want one of {DTYPES}): {spec!r}")
    ring = optional = False
    domain = None
    part = collective = None
    for t in tags:
        if t == "ring":
            ring = True
        elif t == "optional":
            optional = True
        elif t.startswith("domain="):
            lo, sep, hi = t[len("domain="):].partition("..")
            if not sep or not lo or not hi:
                raise ContractError(f"{where}: bad domain tag {t!r} "
                                    "(want domain=LO..HI)")
            domain = (lo, hi)
        elif t.startswith("part="):
            part = t[len("part="):]
            if part not in PARTS:
                raise ContractError(f"{where}: bad part tag {t!r} "
                                    f"(want part={'|'.join(PARTS)})")
        elif t.startswith("collective="):
            collective = t[len("collective="):]
            if collective not in COLLECTIVES:
                raise ContractError(
                    f"{where}: bad collective tag {t!r} "
                    f"(want collective={'|'.join(COLLECTIVES)})")
        else:
            raise ContractError(f"{where}: unknown tag {t!r}: {spec!r}")
    return FieldContract(axes=axes, dtype=dtype, ring=ring,
                         optional=optional, domain=domain,
                         part=part, collective=collective)


def parse_contracts(table: dict, where: str = "<contracts>"
                    ) -> dict[str, dict[str, FieldContract]]:
    """Parse a ``{"Class": {"field": "spec", ...}, ...}`` literal."""
    out: dict[str, dict[str, FieldContract]] = {}
    for cls, fields in table.items():
        out[cls] = {
            name: parse_contract(spec, f"{where}:{cls}.{name}")
            for name, spec in fields.items()
        }
    return out


# ---------------------------------------------------------------------------
# Protocol-invariant grammar (core/kstate.py INVARIANTS) — machine-readable
# cross-field per-group invariants over ShardState, consumed by three legs:
# the static safety pass (analysis/safety.py), the small-scope model checker
# (scripts/model_check.py) and the runtime probe (core/invariants.py).
#
# Grammar, one string per invariant:
#
#   invariant  := [ guard ( "&" guard )* "=>" ] comparison
#   guard      := comparison
#   comparison := term OP term
#   OP         := "<=" | ">=" | "==" | "!=" | "<" | ">"
#   term       := FIELD | "prev." FIELD | "quorum(" FIELD ")" | INT | CONST
#
# FIELD is a ShardState field name (per-group [G] column, or [G, P] for
# quorum()); ``prev.`` reads the field at the previous observation (making
# the invariant STEP-scoped — checked over a transition — instead of
# STATE-scoped); ``quorum(f)`` is the sorted-quorum reduction over the
# [G, P] peer column f, exactly core/kernel.py _sorted_match_quorum_index;
# CONST is an UPPERCASE constant resolved in core/params.py (e.g. LEADER).
# ---------------------------------------------------------------------------

#: comparison operators, longest-match-first for the scanner
INVARIANT_OPS = ("<=", ">=", "==", "!=", "<", ">")


class InvariantError(ValueError):
    pass


@dataclass(frozen=True)
class InvTerm:
    """One operand: kind ∈ field | prev | quorum | const | param."""

    kind: str
    name: str | None = None    # field name (field/prev/quorum) or param name
    value: int | None = None   # const only


@dataclass(frozen=True)
class InvCompare:
    lhs: InvTerm
    op: str                    # one of INVARIANT_OPS
    rhs: InvTerm


@dataclass(frozen=True)
class Invariant:
    """One parsed invariant: ``all(guards) => conclusion`` per group row."""

    name: str
    guards: tuple[InvCompare, ...]
    conclusion: InvCompare
    scope: str                 # "state" | "step" (any prev. term => step)
    fields: tuple[str, ...]    # every ShardState field referenced (sorted)


def _parse_inv_term(src: str, where: str) -> InvTerm:
    s = src.strip()
    if not s:
        raise InvariantError(f"{where}: empty term")
    if s.lstrip("-").isdigit():
        return InvTerm(kind="const", value=int(s))
    if s.startswith("prev."):
        name = s[len("prev."):]
        if not name.isidentifier():
            raise InvariantError(f"{where}: bad prev. field {s!r}")
        return InvTerm(kind="prev", name=name)
    if s.startswith("quorum(") and s.endswith(")"):
        name = s[len("quorum("):-1].strip()
        if not name.isidentifier():
            raise InvariantError(f"{where}: bad quorum() field {s!r}")
        return InvTerm(kind="quorum", name=name)
    if not s.isidentifier():
        raise InvariantError(f"{where}: unparsable term {s!r}")
    if s.isupper():
        return InvTerm(kind="param", name=s)
    return InvTerm(kind="field", name=s)


def _parse_inv_compare(src: str, where: str) -> InvCompare:
    s = src.strip()
    for op in INVARIANT_OPS:
        # scan for the operator outside any quorum(...) parens; ops never
        # appear inside a term, so a plain find is enough — but prefer the
        # longest operator (<= before <) via the INVARIANT_OPS ordering
        idx = s.find(op)
        if idx > 0:
            lhs, rhs = s[:idx], s[idx + len(op):]
            return InvCompare(lhs=_parse_inv_term(lhs, where), op=op,
                              rhs=_parse_inv_term(rhs, where))
    raise InvariantError(f"{where}: no comparison operator in {src!r} "
                         f"(want one of {INVARIANT_OPS})")


def parse_invariant(name: str, spec: str,
                    where: str = "<invariant>") -> Invariant:
    """Parse one ``[guard & ... =>] lhs OP rhs`` string."""
    w = f"{where}:{name}"
    s = spec.strip()
    if "=>" in s:
        guard_src, _, concl_src = s.partition("=>")
        guards = tuple(_parse_inv_compare(g, w)
                       for g in guard_src.split("&") if g.strip())
        if not guards:
            raise InvariantError(f"{w}: '=>' with no guards: {spec!r}")
    else:
        guards, concl_src = (), s
    concl = _parse_inv_compare(concl_src, w)
    terms = [t for c in (*guards, concl) for t in (c.lhs, c.rhs)]
    scope = ("step" if any(t.kind == "prev" for t in terms) else "state")
    fields = tuple(sorted({t.name for t in terms
                           if t.kind in ("field", "prev", "quorum")}))
    if not fields:
        raise InvariantError(f"{w}: invariant references no field: {spec!r}")
    return Invariant(name=name, guards=guards, conclusion=concl,
                     scope=scope, fields=fields)


def parse_invariants(table: dict, where: str = "<invariants>"
                     ) -> dict[str, Invariant]:
    """Parse an ``{"name": "spec", ...}`` literal (kstate.py INVARIANTS)."""
    return {name: parse_invariant(name, spec, where)
            for name, spec in table.items()}
