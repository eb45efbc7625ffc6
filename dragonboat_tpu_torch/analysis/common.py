"""The CONTRACTS grammar parser the capacity model sizes groups with.

The part of the reference's ``analysis/common.py`` that ``capacity`` needs:
the field-contract grammar (``"[G, P] i32 part=G"``) and its parser.  The
lint passes, waivers and invariant grammar are not part of the port.
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
