"""Shared lint plumbing: findings, waivers, reporting.

Waivers live in ``analysis/waivers.toml``.  The container pins Python
3.10 (no ``tomllib``) and the repo takes no third-party deps, so the
loader reads the narrow TOML subset the file actually uses:
``[[waiver]]`` array-of-tables with quoted-string values and ``#``
comments.  The format stays real TOML so a 3.11 toolchain can parse the
same file.
"""

from __future__ import annotations

import fnmatch
import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    """One lint hit, addressed by repo-relative path."""

    pass_name: str   # "tracer-safety" | "hlo-budget" | "concurrency" | ...
    path: str        # repo-relative, forward slashes
    line: int
    rule: str        # short id, e.g. "TS001"
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Waiver:
    pass_name: str
    path: str                      # fnmatch pattern on the relative path
    reason: str
    rule: str | None = None
    contains: str | None = None    # substring of the finding message
    hits: int = field(default=0, compare=False)
    line: int = field(default=0, compare=False)  # [[waiver]] line in the toml

    def matches(self, f: Finding) -> bool:
        if self.pass_name != f.pass_name:
            return False
        if not fnmatch.fnmatch(f.path, self.path):
            return False
        if self.rule is not None and self.rule != f.rule:
            return False
        if self.contains is not None and self.contains not in f.message:
            return False
        return True


class WaiverError(ValueError):
    pass


def _parse_toml_subset(text: str, where: str) -> list[dict]:
    """``[[waiver]]`` tables of ``key = "string"`` pairs; nothing else."""
    tables: list[dict] = []
    cur: dict | None = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[waiver]]":
            cur = {"__line__": n}
            tables.append(cur)
            continue
        if "=" in line and cur is not None:
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            # strip a trailing comment outside the quotes
            if len(val) >= 2 and val[0] in "\"'":
                q = val[0]
                end = val.find(q, 1)
                if end < 0:
                    raise WaiverError(f"{where}:{n}: unterminated string")
                cur[key] = val[1:end]
                continue
        raise WaiverError(f"{where}:{n}: unsupported syntax {line!r} "
                          "(only [[waiver]] tables of quoted strings)")
    return tables


def load_waivers(path: str) -> list[Waiver]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        tables = _parse_toml_subset(f.read(), os.path.basename(path))
    waivers = []
    for i, t in enumerate(tables):
        missing = {"pass_name", "path", "reason"} - set(t)
        if missing:
            raise WaiverError(
                f"waiver #{i + 1} missing keys: {sorted(missing)}")
        if not t["reason"].strip():
            raise WaiverError(f"waiver #{i + 1}: empty reason")
        waivers.append(Waiver(pass_name=t["pass_name"], path=t["path"],
                              reason=t["reason"], rule=t.get("rule"),
                              contains=t.get("contains"),
                              line=t.get("__line__", 0)))
    return waivers


def apply_waivers(findings: list[Finding], waivers: list[Waiver]
                  ) -> tuple[list[Finding], list[tuple[Finding, Waiver]]]:
    """-> (unwaived, [(waived finding, its waiver)]).  First match wins."""
    unwaived: list[Finding] = []
    waived: list[tuple[Finding, Waiver]] = []
    for f in findings:
        for w in waivers:
            if w.matches(f):
                w.hits += 1
                waived.append((f, w))
                break
        else:
            unwaived.append(f)
    return unwaived, waived


def rel(root: str, path: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


# ---------------------------------------------------------------------------
# Field-contract grammar (core/kstate.py CONTRACTS) + the tiny shape/dtype
# lattice the contracts pass interprets over.  Kept here so tests and any
# future pass share one parser.
# ---------------------------------------------------------------------------

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


def broadcast_axes(a: tuple[str, ...] | None, b: tuple[str, ...] | None
                   ) -> tuple[tuple[str, ...] | None, str | None]:
    """NumPy trailing-aligned broadcast over NAMED axes.

    Axis entries are axis names, ``'1'`` (unit, broadcasts into anything)
    or ``'?'`` (unknown extent, unifies with anything).  ``None`` means a
    fully unknown rank/shape.  Returns ``(result_axes, conflict)`` where
    ``conflict`` is a human-readable description of the first pair of
    distinct named axes forced into alignment, or ``None`` if the
    broadcast is clean.
    """
    if a is None and b is None:
        return None, None
    if a is None or b is None:
        # unknown rank/shape unifies with the known side (optimistic:
        # the lattice never flags what it cannot see)
        return (b if a is None else a), None
    out: list[str] = []
    conflict = None
    for i in range(1, max(len(a), len(b)) + 1):
        x = a[-i] if i <= len(a) else "1"
        y = b[-i] if i <= len(b) else "1"
        if x == y:
            out.append(x)
        elif x == "1":
            out.append(y)
        elif y == "1":
            out.append(x)
        elif x == "?" or y == "?":
            out.append(y if x == "?" else x)
        else:
            # two distinct NAMED axes aligned — the broadcast "works"
            # numerically whenever the extents happen to agree (K == E
            # == B == RI == 8 in the default geometry), which is exactly
            # the silent cross-axis bug this lattice exists to catch.
            conflict = f"axis {x!r} vs {y!r} at dim -{i}"
            out.append("?")
    return tuple(reversed(out)), conflict


def join_dtypes(a: str | None, b: str | None) -> str | None:
    """Lattice join for ``jnp.where``-style merges: agree or unknown."""
    if a is None or b is None:
        return None
    return a if a == b else None


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
