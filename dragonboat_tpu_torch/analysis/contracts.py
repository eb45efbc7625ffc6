"""Kernel contract analyzer: shape/dtype/domain/ring-mask checking.

The port's form of the reference's pass.  The batched Raft kernel's
whole correctness story is that per-shard state is fixed-width i32/bool
lanes advanced in lockstep — and PyTorch will happily run a silent int64
promotion, a trailing ``[K]``/``[E]`` broadcast, or an unmasked ring
index, corrupting every shard at once.  This pass promotes the field
comments of ``core/kstate.py`` into machine-checked contracts (the
``CONTRACTS`` literals there, in ``core/kernel.py``, ``core/health.py``
and ``core/invariants.py``; grammar documented at the kstate
declaration) and verifies them three ways:

**Statically** — an abstract interpreter over the AST of
``core/kernel.py`` (reachability reuses the tracer-safety walk: every
function reachable from a compiled entry is analyzed).  Each value
carries an abstract ``(axes, dtype)`` where axes are SYMBOLIC names
(G/P/CAP/K/E/B/RI) resolved from ``kp.<attr>`` uses, ``.shape`` reads
and ``torch.arange`` / ``_arange`` extents — essential because the
default geometry has K = E = B = RI = 8, so a cross-axis mixup is
shape-correct and invisible to any runtime diff.  The port writes the
shard axis G out: a parameter bound by annotation or by the
conventional names (``s``, ``box``, ``inp``, ``out``; ``m``, one inbox
slot, is an ``Inbox`` with its K axis taken out) keeps its declared
``[G, ...]`` axes, and the kernel-local structs whose contracts are per
shard (``PER_SHARD_CLASSES``) gain a leading G.  ``sel`` / ``mrep`` /
``_lift`` align their operands on the LEADING (shard) axis — the
licensed alignment; ``[:, None]`` is the explicit one; everywhere else
torch aligns trailing axes, and two different named axes meeting there
is KC001.  ``torch.where`` / ``sel`` join branches in the lattice;
named-axis conflicts, dtype drift and un-ring-masked dynamic indices are
findings:

- KC001  implicit broadcast aligning two DIFFERENT named axes
- KC002  silent dtype conversion, in torch spelling: an int32 or bool
         ``sum`` / ``cumsum`` / ``prod`` with no ``dtype=`` (int64
         result), ``torch.arange`` with no dtype (int64) mixed with i32,
         ``/`` on integer tensors, a Python float with an int tensor,
         arithmetic on ``torch.uint32``, arithmetic on bool (but
         ``bool * int``, the masking idiom), f32/i32 and i64/i32 mixes
- KC003  comparison mixing bool and i32 operands
- KC004  dynamic index into a ring-tagged array (``_get1`` / ``_set1`` /
         ``_get_row`` / ``_clear_row`` / ``torch.gather`` / advanced
         indexing) without the ``& (cap - 1)`` mask (or an equivalent
         in-range proof: ``_slot``, ``_argmax`` / ``_arange`` /
         ``argmax`` / ``arange`` over that axis, ``minimum`` / ``clamp``
         against ``cap - 1``)
- KC005  store of a known constant outside a field's declared domain
- KC006  store whose shape/dtype contradicts the field's contract
         (``_replace`` / ``mrep`` / struct constructors / ``_set1``)

**At runtime** — every declared field against the tensor the port
actually builds (``init_state`` / ``empty_inbox`` / ``empty_input``, the
``ShardState`` and ``StepOutput`` after one real ``kernel.step``, and the
health and invariant reductions' reports and digests after one pass), on
the device the caller names (KC007, ``dynamic``); the reference's
``jax.eval_shape`` becomes a real step on small tensors.

**Donation** — KC008 holds the ``DONATION`` declaration of
``core/kstate.py`` against the ``donate_argnums`` of the module-level
``graphs.compiled(...)`` assignments in ``DONATION_MODULES``, both
directions; KC007's static half checks that every ``CONTRACTS`` table is
a pure literal and every field contract parses.

Analyzing a custom file set (``run(root, files=[...])``, used by the
fixture tests) reads ``CONTRACTS`` and domain constants from those files
and skips the runtime diff and the donation cross-check.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, replace

from dragonboat_tpu_torch.analysis import tracer_safety as ts
from dragonboat_tpu_torch.analysis.common import (
    FieldContract,
    Finding,
    broadcast_axes,
    parse_contract,
    rel,
)

PASS = "contracts"

KERNEL_FILE = "dragonboat_tpu_torch/core/kernel.py"
CONTRACT_FILES = (
    "dragonboat_tpu_torch/core/kstate.py",
    "dragonboat_tpu_torch/core/kernel.py",
    "dragonboat_tpu_torch/core/health.py",
    "dragonboat_tpu_torch/core/invariants.py",
)
PARAMS_FILE = "dragonboat_tpu_torch/core/params.py"

# modules whose ``graphs.compiled(..., donate_argnums=...)`` assignments
# the KC008 cross-check scans: kernel.py (the default module of a DONATION
# entry) plus every module a DONATION ``module`` key may name
DONATION_MODULES = (
    "dragonboat_tpu_torch/core/kernel.py",
    "dragonboat_tpu_torch/parallel/ici.py",
    "dragonboat_tpu_torch/core/router.py",
)

#: every file this pass reads
SCOPE = CONTRACT_FILES + (PARAMS_FILE,) + DONATION_MODULES[1:]

# KernelParams attribute -> the symbolic axis it sizes
KP_AXIS_ATTRS = {
    "num_peers": "P",
    "log_cap": "CAP",
    "inbox_cap": "K",
    "msg_entries": "E",
    "proposal_cap": "B",
    "readindex_cap": "RI",
}

# Conventional parameter names -> (contract class, axes taken out of its
# fields: ``m`` is one inbox slot, ``box.f[:, k]``).  Annotations take
# precedence when present.
NAME_BINDINGS = {
    "s": ("ShardState", ()),
    "state": ("ShardState", ()),
    "box": ("Inbox", ()),
    "inbox": ("Inbox", ()),
    "m": ("Inbox", ("K",)),
    "inp": ("StepInput", ()),
    "eff": ("Effects", ()),
    "pre": ("_Pre", ()),
    "r": ("_Resp", ()),
    "out": ("StepOutput", ()),
}

#: the kernel-local structs whose CONTRACTS are written per shard, as in
#: the reference (``core/kernel.py``): the port's tensors carry a leading
#: [G] the declaration does not
PER_SHARD_CLASSES = frozenset({"Effects", "_Pre", "_Resp"})

_INT_DTYPES = ("i32", "u32", "i64", "u8")
_DTYPE_NAMES = {
    "int32": "i32", "int": "i32", "uint32": "u32", "float32": "f32",
    "float": "f32", "bool": "bool", "bool_": "bool", "int64": "i64",
    "long": "i64", "float64": "f64", "double": "f64", "uint8": "u8",
}
# dtype-cast methods: x.long() and friends
_CAST_METHODS = {"int": "i32", "long": "i64", "bool": "bool",
                 "float": "f32", "double": "f64", "byte": "u8"}


@dataclass(frozen=True)
class AVal:
    """Abstract value: symbolic shape + dtype + provenance facts."""

    axes: tuple[str, ...] | None = None  # None = unknown shape
    dtype: str | None = None             # 'i32'|'i64'|'u32'|'f32'|'bool'
    weak: bool = False                   # python-scalar weak type
    const: int | None = None             # known int value (domain checks)
    bound: str | None = None             # values proven in-range of axis
    size_axis: str | None = None         # python int == size of this axis
    maskconst: str | None = None         # python int == size(axis) - 1
    ring: str | None = None              # ring-tagged array: masked axis
    cls: str | None = None               # contract struct this value is
    strip: tuple[str, ...] = ()          # axes taken out of cls's fields
    tup: tuple | None = None             # tuple value (AVal elements)
    dt_marker: str | None = None         # value IS a dtype (I32, torch.bool)
    part: str | None = None              # partition: 'G' | 'rep' | None
    bcast: bool = False                  # replicated value explicitly
    #                                      broadcast to a G-shaped operand


UNKNOWN = AVal()
_KP = AVal(cls="<kp>")


def _scalar(dtype, weak=False, const=None, bound=None):
    return AVal(axes=(), dtype=dtype, weak=weak, const=const, bound=bound)


def _is_intlike(v: AVal) -> bool:
    return v.dtype in _INT_DTYPES


def _strip(axes: tuple[str, ...], strip: tuple[str, ...]) -> tuple[str, ...]:
    out = list(axes)
    for ax in strip:
        if ax in out:
            out.remove(ax)
    return tuple(out)


def _lead_pad(axes: tuple[str, ...] | None, n: int
              ) -> tuple[str, ...] | None:
    """``axes`` left-aligned against an ``n``-axis operand (``_lift``)."""
    if axes is None or len(axes) >= n:
        return axes
    return tuple(axes) + ("1",) * (n - len(axes))


def _join(a: AVal, b: AVal) -> AVal:
    """Lattice join for where/sel branches.  Optimistic on unknowns."""
    if a.tup is not None and b.tup is not None and len(a.tup) == len(b.tup):
        return AVal(tup=tuple(_join(x, y) for x, y in zip(a.tup, b.tup)))
    if a.cls is not None and a.cls == b.cls:
        return a
    axes, _ = broadcast_axes(a.axes, b.axes)
    if a.dtype is None or b.dtype is None:
        dtype = a.dtype or b.dtype
    elif a.dtype == b.dtype:
        dtype = a.dtype
    elif a.weak and not b.weak:
        dtype = b.dtype
    elif b.weak and not a.weak:
        dtype = a.dtype
    else:
        dtype = None
    const = a.const if a.const == b.const else None
    bound = a.bound if a.bound == b.bound else None
    ring = a.ring if a.ring == b.ring else None
    return AVal(axes=axes, dtype=dtype, weak=a.weak and b.weak,
                const=const, bound=bound, ring=ring)


def _attr_chain(node: ast.AST) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    parts.reverse()
    return parts


def _ann_name(node: ast.AST | None) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(".")[-1]
    return None


class _Ctx:
    """Shared analysis context: contracts, constants, functions."""

    def __init__(self) -> None:
        self.contracts: dict[str, dict[str, FieldContract]] = {}
        self.contract_lines: dict[tuple[str, str], tuple[str, int]] = {}
        self.consts: dict[str, int] = {}
        self.funcs: dict[str, tuple[ts._Module, ast.FunctionDef]] = {}
        self.summaries: dict[str, AVal] = {}
        self.findings: list[Finding] = []

    def field(self, cls: str | None, name: str) -> FieldContract | None:
        if cls is None:
            return None
        return self.contracts.get(cls, {}).get(name)

    def domain_range(self, fc: FieldContract) -> tuple[int, int] | None:
        if fc.domain is None:
            return None
        lo, hi = self.consts.get(fc.domain[0]), self.consts.get(fc.domain[1])
        if lo is None or hi is None:
            return None
        return lo, hi


def _field_axes(cls: str | None, fc: FieldContract,
                strip: tuple[str, ...]) -> tuple[str, ...]:
    axes = fc.axes
    if cls in PER_SHARD_CLASSES:
        axes = ("G",) + tuple(axes)
    return _strip(axes, strip)


def _field_aval(ctx: _Ctx, fc: FieldContract, strip: tuple[str, ...],
                cls: str | None = None) -> AVal:
    axes = _field_axes(cls, fc, strip)
    # the ring axis is the first one after the shard axis
    ring_axes = [a for a in axes if a != "G"]
    ring = ring_axes[0] if (fc.ring and ring_axes) else None
    return AVal(axes=axes, dtype=fc.dtype, ring=ring)


def _struct_aval(cls: str, strip: tuple[str, ...]) -> AVal:
    return AVal(cls=cls, strip=strip)


def _collect_contracts(ctx: _Ctx, tree: ast.Module, relpath: str) -> None:
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "CONTRACTS"):
            continue
        try:
            table = ast.literal_eval(node.value)
        except (ValueError, SyntaxError):
            ctx.findings.append(Finding(
                PASS, relpath, node.lineno, "KC007",
                "CONTRACTS must be a pure literal dict"))
            continue
        # remember source lines of each field key for finding anchors
        if isinstance(node.value, ast.Dict):
            for ck, cv in zip(node.value.keys, node.value.values):
                if not (isinstance(ck, ast.Constant)
                        and isinstance(cv, ast.Dict)):
                    continue
                for fk in cv.keys:
                    if isinstance(fk, ast.Constant):
                        ctx.contract_lines[(ck.value, fk.value)] = (
                            relpath, fk.lineno)
        for cls, fields in table.items():
            parsed = {}
            for fname, spec in fields.items():
                where = f"{relpath}:{cls}.{fname}"
                try:
                    parsed[fname] = parse_contract(spec, where)
                except ValueError as e:
                    path, line = ctx.contract_lines.get(
                        (cls, fname), (relpath, node.lineno))
                    ctx.findings.append(
                        Finding(PASS, path, line, "KC007", str(e)))
            ctx.contracts.setdefault(cls, {}).update(parsed)


def _collect_consts(ctx: _Ctx, tree: ast.Module) -> None:
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                v = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                continue
            if isinstance(v, int) and not isinstance(v, bool):
                ctx.consts[node.targets[0].id] = v


# ---------------------------------------------------------------------------
# the per-function abstract interpreter
# ---------------------------------------------------------------------------

# torch reductions: result drops the reduced axis (or all, without dim=);
# None keeps the operand's dtype
_REDUCTIONS = {"sum": None, "any": "bool", "all": "bool", "min": None,
               "max": None, "amin": None, "amax": None, "prod": None,
               "mean": "f32"}
# reductions whose int32/bool result is int64 unless dtype= is named
_WIDENING = frozenset({"sum", "prod", "cumsum", "cumprod"})
# ops along one axis that keep it (the data still crosses its lanes)
_ALONG = frozenset({"sort", "cumsum", "cumprod", "topk", "kthvalue",
                    "argsort", "flip", "roll", "cummax", "cummin"})

_INDEX_FUNCS = {
    #  name: (array argpos, index argpos, value argpos or None, row)
    "_get1": (1, 2, None, False),
    "_get_row": (1, 2, None, True),
    "_set1": (0, 1, 2, False),
    "_clear_row": (0, 1, None, True),
}


class _Interp:
    def __init__(self, ctx: _Ctx, relpath: str) -> None:
        self.ctx = ctx
        self.relpath = relpath
        self.env: dict[str, AVal] = {}
        self.returns: list[AVal] = []
        self._flagged: set[tuple[int, str]] = set()

    # -- reporting -------------------------------------------------------
    def flag(self, node: ast.AST, rule: str, msg: str) -> None:
        key = (getattr(node, "lineno", 0), rule)
        if key in self._flagged:
            return
        self._flagged.add(key)
        self.ctx.findings.append(
            Finding(PASS, self.relpath, getattr(node, "lineno", 0),
                    rule, msg))

    # -- parameter binding ----------------------------------------------
    def bind_params(self, fn: ast.FunctionDef | ast.Lambda) -> None:
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            ann = _ann_name(getattr(a, "annotation", None))
            name = a.arg
            if name == "kp" or ann == "KernelParams":
                self.env[name] = _KP
            elif ann in self.ctx.contracts:
                strip = NAME_BINDINGS.get(name, (None, ()))[1]
                self.env[name] = _struct_aval(ann, strip)
            elif name in NAME_BINDINGS:
                cls, strip = NAME_BINDINGS[name]
                if cls in self.ctx.contracts:
                    self.env[name] = _struct_aval(cls, strip)
                else:
                    self.env[name] = UNKNOWN
            else:
                self.env[name] = UNKNOWN
        for extra in (args.vararg, args.kwarg):
            if extra is not None:
                self.env[extra.arg] = UNKNOWN

    # -- statements ------------------------------------------------------
    def exec_body(self, body: list[ast.stmt]) -> None:
        for st in body:
            self.exec_stmt(st)

    def exec_stmt(self, st: ast.stmt) -> None:
        if isinstance(st, ast.Assign):
            v = self.eval(st.value)
            for tgt in st.targets:
                self.assign(tgt, v)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self.assign(st.target, self.eval(st.value))
        elif isinstance(st, ast.AugAssign):
            v = self.binop(st, self.eval(st.target), self.eval(st.value),
                           st.op)
            self.assign(st.target, v)
        elif isinstance(st, ast.Expr):
            self.eval(st.value)
        elif isinstance(st, ast.Return):
            if st.value is not None:
                self.returns.append(self.eval(st.value))
        elif isinstance(st, ast.If):
            # host-level branch (capture-time static): walk both arms
            # with a shared env — a sound over-approximation for lint
            self.eval(st.test)
            self.exec_body(st.body)
            self.exec_body(st.orelse)
        elif isinstance(st, ast.For):
            it = self.eval(st.iter)
            self.assign(st.target, self._loop_var(st.iter, it))
            self.exec_body(st.body)
            self.exec_body(st.orelse)
        elif isinstance(st, ast.While):
            self.eval(st.test)
            self.exec_body(st.body)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sub = type(self)(self.ctx, self.relpath)
            sub.env.update(self.env)
            sub.bind_params(st)
            sub._flagged = self._flagged
            sub.exec_body(st.body)
        elif isinstance(st, ast.Assert):
            self.eval(st.test)
        elif isinstance(st, ast.With):
            self.exec_body(st.body)
        elif isinstance(st, ast.Try):
            self.exec_body(st.body)
            for h in st.handlers:
                self.exec_body(h.body)
            self.exec_body(st.orelse)
            self.exec_body(st.finalbody)
        # Raise / Pass / Import / Global / Delete: nothing to track

    def _loop_var(self, iter_node: ast.AST, it: AVal) -> AVal:
        # for j in range(RI): j is an in-range index of axis RI
        if isinstance(iter_node, ast.Call) \
                and isinstance(iter_node.func, ast.Name) \
                and iter_node.func.id == "range" \
                and len(iter_node.args) == 1:
            n = self.eval(iter_node.args[0])
            if n.size_axis is not None:
                return _scalar("i32", weak=True, bound=n.size_axis)
            return _scalar("i32", weak=True)
        return UNKNOWN

    def assign(self, tgt: ast.AST, v: AVal) -> None:
        if isinstance(tgt, ast.Name):
            self.env[tgt.id] = v
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            if v.tup is not None and len(v.tup) == len(tgt.elts):
                for el, sub in zip(tgt.elts, v.tup):
                    self.assign(el, sub)
            else:
                for el in tgt.elts:
                    self.assign(el, UNKNOWN)
        elif isinstance(tgt, ast.Starred):
            self.assign(tgt.value, UNKNOWN)
        # attribute/subscript stores: no local binding

    # -- expressions -----------------------------------------------------
    def eval(self, node: ast.AST | None) -> AVal:
        if node is None:
            return UNKNOWN
        meth = getattr(self, "eval_" + type(node).__name__, None)
        if meth is not None:
            return meth(node)
        return UNKNOWN

    def eval_Constant(self, node: ast.Constant) -> AVal:
        v = node.value
        if isinstance(v, bool):
            return _scalar("bool", weak=True, const=int(v))
        if isinstance(v, int):
            return _scalar("i32", weak=True, const=v)
        if isinstance(v, float):
            return _scalar("f32", weak=True)
        return UNKNOWN

    def eval_Name(self, node: ast.Name) -> AVal:
        if node.id in self.env:
            return self.env[node.id]
        if node.id in ("I32", "I64"):
            return AVal(dt_marker="i32" if node.id == "I32" else "i64")
        if node.id == "INT_MAX":
            return _scalar("i32", weak=True)
        if node.id in ("bool", "int"):
            return AVal(dt_marker="bool" if node.id == "bool" else "i32")
        if node.id in self.ctx.consts:
            return _scalar("i32", weak=True, const=self.ctx.consts[node.id])
        return UNKNOWN

    def eval_Tuple(self, node: ast.Tuple) -> AVal:
        return AVal(tup=tuple(self.eval(e) for e in node.elts))

    eval_List = eval_Tuple

    def eval_NamedExpr(self, node: ast.NamedExpr) -> AVal:
        v = self.eval(node.value)
        self.assign(node.target, v)
        return v

    def eval_IfExp(self, node: ast.IfExp) -> AVal:
        self.eval(node.test)
        return _join(self.eval(node.body), self.eval(node.orelse))

    def eval_BoolOp(self, node: ast.BoolOp) -> AVal:
        for v in node.values:
            self.eval(v)
        return UNKNOWN

    def eval_JoinedStr(self, node: ast.JoinedStr) -> AVal:
        for v in node.values:
            self.eval(v)
        return UNKNOWN

    def eval_FormattedValue(self, node: ast.FormattedValue) -> AVal:
        self.eval(node.value)
        return UNKNOWN

    def eval_Lambda(self, node: ast.Lambda) -> AVal:
        return UNKNOWN

    def eval_Starred(self, node: ast.Starred) -> AVal:
        return self.eval(node.value)

    def _comprehension(self, node) -> AVal:
        for gen in node.generators:
            self.eval(gen.iter)
            self.assign(gen.target, UNKNOWN)
            for cond in gen.ifs:
                self.eval(cond)
        if isinstance(node, ast.DictComp):
            self.eval(node.key)
            self.eval(node.value)
        else:
            self.eval(node.elt)
        return UNKNOWN

    eval_ListComp = eval_SetComp = eval_GeneratorExp = eval_DictComp = \
        _comprehension

    def eval_Attribute(self, node: ast.Attribute) -> AVal:
        # torch.iinfo(...).max / .min: a weak scalar bound constant
        if node.attr in ("max", "min") and isinstance(node.value, ast.Call):
            base = _attr_chain(node.value.func)
            if base and base[-1] in ("iinfo", "finfo"):
                return _scalar("f32" if base[-1] == "finfo" else "i32",
                               weak=True)
        # x.min(dim=..).values / .indices: the reduction's result
        if node.attr in ("values", "indices") \
                and isinstance(node.value, ast.Call):
            v = self.eval(node.value)
            return replace(v, dtype="i64") if node.attr == "indices" else v
        v = self.eval(node.value)
        if v is _KP or v.cls == "<kp>":
            if node.attr in KP_AXIS_ATTRS:
                return AVal(axes=(), dtype="i32", weak=True,
                            size_axis=KP_AXIS_ATTRS[node.attr])
            return _scalar("i32", weak=True)  # host config scalar/flag
        if v.cls is not None:
            fc = self.ctx.field(v.cls, node.attr)
            if fc is not None:
                return _field_aval(self.ctx, fc, v.strip, v.cls)
            return UNKNOWN
        if node.attr == "shape" and v.axes is not None:
            return AVal(tup=tuple(
                AVal(axes=(), dtype="i32", weak=True, size_axis=ax)
                if ax not in ("1", "?")
                else _scalar("i32", weak=True, const=1 if ax == "1" else None)
                for ax in v.axes))
        if node.attr == "dtype" and v.dtype is not None:
            return AVal(dt_marker=v.dtype)
        if node.attr in ("T", "mT") and v.axes is not None:
            return replace(v, axes=tuple(reversed(v.axes)), ring=None)
        # torch.int32 / torch.uint32 / torch.bool as dtype markers
        chain = _attr_chain(node)
        if len(chain) >= 2 and chain[0] in ("torch", "np", "numpy") \
                and chain[-1] in _DTYPE_NAMES:
            return AVal(dt_marker=_DTYPE_NAMES[chain[-1]])
        # module constants via an alias (P.LEADER, params.K_VOTER, ...)
        if isinstance(node.value, ast.Name) and node.attr in self.ctx.consts \
                and node.value.id not in self.env:
            return _scalar("i32", weak=True, const=self.ctx.consts[node.attr])
        return UNKNOWN

    # -- operators -------------------------------------------------------
    def _broadcast(self, node: ast.AST, a: AVal, b: AVal,
                   what: str) -> tuple[str, ...] | None:
        axes, conflict = broadcast_axes(a.axes, b.axes)
        if conflict:
            self.flag(node, "KC001",
                      f"implicit broadcast aligns distinct named axes in "
                      f"{what}: {conflict} (shapes {list(a.axes)} vs "
                      f"{list(b.axes)} — equal extents would silently "
                      "cross-wire lanes)")
        return axes

    def _dtype_of_binop(self, node: ast.AST, a: AVal, b: AVal,
                        op: ast.operator) -> str | None:
        da, db = a.dtype, b.dtype
        if da is None or db is None:
            return da or db
        strong = not (a.weak or b.weak)
        kind = type(op).__name__
        if kind in ("BitAnd", "BitOr", "BitXor"):
            if da == "bool" and db == "bool":
                return "bool"
            if "f32" in (da, db):
                self.flag(node, "KC002",
                          f"bitwise {kind} on float operand ({da}/{db})")
                return None
            if strong and ("bool" in (da, db)) and (da != db):
                self.flag(node, "KC002",
                          f"bitwise {kind} mixes bool and "
                          f"{da if db == 'bool' else db} "
                          "(mask and integer cross-wired?)")
                return None
            if strong and da != db:
                self.flag(node, "KC002",
                          f"bitwise {kind} mixes {da} and {db}")
            return da if not a.weak else db
        if kind == "Div":
            if da in _INT_DTYPES and db in _INT_DTYPES:
                self.flag(node, "KC002",
                          "int/int true division silently produces float "
                          "(use // or an explicit .to())")
                return "f32"
            return "f32"
        # Add/Sub/Mult/FloorDiv/Mod/Pow/shifts
        if "u32" in (da, db) and not (a.weak and b.weak):
            self.flag(node, "KC002",
                      f"{kind} arithmetic on torch.uint32 (most uint32 "
                      "arithmetic is missing or promotes; use int64 "
                      "masked to 32 bits)")
            return "u32"
        if kind == "Mult" and "bool" in (da, db) and (
                db in _INT_DTYPES or da in _INT_DTYPES):
            # bool * int is the kernel's masking idiom — deliberate
            return da if da in _INT_DTYPES else db
        if "bool" in (da, db) and not (a.weak and b.weak) and (
                strong or kind != "Mult"):
            self.flag(node, "KC002",
                      f"{kind} arithmetic on bool and "
                      f"{da if db == 'bool' else db} operands (silent "
                      "promotion: a bool tensor with a Python int is "
                      "int64)")
            return None
        if ("f32" in (da, db)) and (da != db) and (
                strong or (a.weak if da == "f32" else b.weak)):
            self.flag(node, "KC002",
                      f"{kind} mixes {da} and {db}: silent float upcast")
            return "f32"
        if strong and da in _INT_DTYPES and db in _INT_DTYPES and da != db:
            self.flag(node, "KC002",
                      f"{kind} mixes {da} and {db} (silent widening: torch "
                      "promotes to the wider integer)")
            return "i64" if "i64" in (da, db) else None
        if a.weak and not b.weak:
            return db
        return da

    def binop(self, node: ast.AST, a: AVal, b: AVal,
              op: ast.operator) -> AVal:
        axes = self._broadcast(node, a, b, "arithmetic")
        dtype = self._dtype_of_binop(node, a, b, op)
        kind = type(op).__name__
        bound = None
        # x & (size - 1): the ring-mask idiom proves in-range
        if kind == "BitAnd":
            bound = a.maskconst or b.maskconst
        # size - 1 yields a mask constant
        maskconst = None
        if kind == "Sub" and a.size_axis is not None and b.const == 1:
            maskconst = a.size_axis
        weak = a.weak and b.weak
        const = None
        if a.const is not None and b.const is not None:
            try:
                const = {
                    "Add": a.const + b.const, "Sub": a.const - b.const,
                    "Mult": a.const * b.const,
                }.get(kind)
            except Exception:
                const = None
        return AVal(axes=axes, dtype=dtype, weak=weak, const=const,
                    bound=bound, maskconst=maskconst)

    def eval_BinOp(self, node: ast.BinOp) -> AVal:
        return self.binop(node, self.eval(node.left), self.eval(node.right),
                          node.op)

    def eval_UnaryOp(self, node: ast.UnaryOp) -> AVal:
        v = self.eval(node.operand)
        if isinstance(node.op, ast.Not):
            return _scalar("bool", weak=True)
        if isinstance(node.op, ast.Invert):
            return replace(v, const=None, bound=None, maskconst=None)
        if isinstance(node.op, ast.USub):
            c = -v.const if v.const is not None else None
            return replace(v, const=c, bound=None, size_axis=None,
                           maskconst=None)
        return v

    def eval_Compare(self, node: ast.Compare) -> AVal:
        vals = [self.eval(node.left)] + [self.eval(c)
                                         for c in node.comparators]
        axes: tuple[str, ...] | None = vals[0].axes
        cur = vals[0]
        for op, nxt in zip(node.ops, vals[1:]):
            if isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)):
                cur = nxt
                continue
            axes = self._broadcast(node, replace(cur, axes=axes), nxt,
                                   "comparison")
            da, db = cur.dtype, nxt.dtype
            if da and db and not (cur.weak or nxt.weak) \
                    and ("bool" in (da, db)) and da != db:
                self.flag(node, "KC003",
                          f"comparison mixes bool and "
                          f"{da if db == 'bool' else db} operands")
            cur = nxt
        return AVal(axes=axes, dtype="bool")

    # -- subscripts ------------------------------------------------------
    def _check_ring_index(self, node: ast.AST, arr: AVal, idx: AVal,
                          via: str) -> None:
        if arr.ring is None:
            return
        if idx.dtype == "bool":
            return  # boolean masking, not positional indexing
        if idx.const is not None:
            return  # static index: in-range by construction/review
        if idx.bound == arr.ring:
            return
        self.flag(node, "KC004",
                  f"dynamic index into ring array (axis {arr.ring}) via "
                  f"{via} without the `& (cap - 1)` ring mask (or an "
                  "_argmax/_arange/min-against-cap-1 in-range proof) — an "
                  "unwrapped log position reads/writes the wrong slot "
                  "once the log exceeds the ring capacity")

    def _subscript_axes(self, node: ast.Subscript, base: AVal,
                        items: list[ast.AST]) -> AVal:
        if base.axes is None:
            # still ring-check a fully dynamic index
            for it in items:
                if not isinstance(it, ast.Slice):
                    self._check_ring_index(node, base, self.eval(it),
                                           "subscript")
            return UNKNOWN
        out: list[str] = []
        dim = 0
        for it in items:
            if isinstance(it, ast.Slice):
                self.eval(it.lower)
                self.eval(it.upper)
                if dim < len(base.axes):
                    out.append(base.axes[dim])
                dim += 1
            elif isinstance(it, ast.Constant) and it.value is None:
                out.append("1")
            elif isinstance(it, ast.Constant) and it.value is Ellipsis:
                # the axes the items after ``...`` do not index
                keep = max(0, len(base.axes) - dim - sum(
                    1 for x in items[items.index(it) + 1:]
                    if not (isinstance(x, ast.Constant) and x.value is None)))
                out.extend(base.axes[dim:dim + keep])
                dim += keep
            else:
                iv = self.eval(it)
                if dim < len(base.axes) and base.axes[dim] == base.ring:
                    self._check_ring_index(node, base, iv, "subscript")
                if iv.axes is not None and iv.axes != ():
                    out.extend(iv.axes)   # array index: its axes splice in
                dim += 1
        out.extend(base.axes[dim:])
        return AVal(axes=tuple(out), dtype=base.dtype,
                    bound=base.bound, part=base.part)

    def eval_Subscript(self, node: ast.Subscript) -> AVal:
        base = self.eval(node.value)
        sl = node.slice
        if base.tup is not None:
            if isinstance(sl, ast.Constant) and isinstance(sl.value, int):
                try:
                    return base.tup[sl.value]
                except IndexError:
                    return UNKNOWN
            return UNKNOWN
        if base.cls is not None or base.dt_marker is not None:
            return UNKNOWN
        items = list(sl.elts) if isinstance(sl, ast.Tuple) else [sl]
        return self._subscript_axes(node, base, items)

    # -- calls -----------------------------------------------------------
    def _dtype_from_arg(self, node: ast.AST | None) -> str | None:
        if node is None:
            return None
        v = self.eval(node)
        if v.dt_marker is not None:
            return v.dt_marker
        name = _ann_name(node)
        return _DTYPE_NAMES.get(name or "", None)

    def _kwdict(self, node: ast.Call) -> dict[str, ast.AST]:
        return {k.arg: k.value for k in node.keywords if k.arg is not None}

    def _check_store(self, node: ast.AST, cls: str, fname: str,
                     v: AVal, strip: tuple[str, ...],
                     leading: bool = False) -> None:
        fc = self.ctx.field(cls, fname)
        if fc is None:
            if fname in ("lv", "ent_val", "prop_val", "s_ent_val"):
                return
            self.flag(node, "KC006",
                      f"store to {cls}.{fname}: field has no declared "
                      "contract (add it to CONTRACTS)")
            return
        declared = _field_aval(self.ctx, fc, strip, cls)
        # shape: the stored value must broadcast INTO the declared shape
        # (left-aligned for sel/mrep, trailing for a plain store)
        if v.axes is not None and declared.axes is not None:
            vax = _lead_pad(v.axes, len(declared.axes)) if leading \
                else v.axes
            axes, conflict = broadcast_axes(declared.axes, vax)
            if conflict or (axes != declared.axes and "?" not in axes):
                self.flag(node, "KC006",
                          f"store to {cls}.{fname}: value shape "
                          f"{list(v.axes)} does not match declared "
                          f"{list(declared.axes)}")
        # dtype: strong mismatches only; weak python scalars adapt
        if v.dtype is not None and not v.weak and v.dtype != fc.dtype:
            self.flag(node, "KC006",
                      f"store to {cls}.{fname}: value dtype {v.dtype} "
                      f"contradicts declared {fc.dtype}")
        dom = self.ctx.domain_range(fc)
        if dom is not None and v.const is not None \
                and not (dom[0] <= v.const <= dom[1]):
            self.flag(node, "KC005",
                      f"store of constant {v.const} to {cls}.{fname}: "
                      f"outside declared domain "
                      f"{fc.domain[0]}..{fc.domain[1]} [{dom[0]}, {dom[1]}]")

    def _call_replace(self, node: ast.Call, target: AVal,
                      kwargs: dict[str, ast.AST],
                      leading: bool = False) -> AVal:
        for fname, vnode in kwargs.items():
            v = self.eval(vnode)
            if target.cls is not None and target.cls in self.ctx.contracts:
                self._check_store(node, target.cls, fname, v, target.strip,
                                  leading)
        return target

    def _call_ctor(self, node: ast.Call, cls: str) -> AVal:
        for a in node.args:
            self.eval(a)
        for fname, vnode in self._kwdict(node).items():
            self._check_store(node, cls, fname, self.eval(vnode), ())
        return _struct_aval(cls, ())

    def _call_index_func(self, node: ast.Call, name: str) -> AVal:
        arr_pos, idx_pos, val_pos, row = _INDEX_FUNCS[name]
        args = node.args
        if len(args) <= max(arr_pos, idx_pos):
            return UNKNOWN
        arr = self.eval(args[arr_pos])
        idx = self.eval(args[idx_pos])
        self._check_ring_index(node, arr, idx, name)
        if val_pos is not None and len(args) > val_pos:
            v = self.eval(args[val_pos])
            # domain/dtype checks when the array is a contract field read
            src = args[arr_pos]
            if isinstance(src, ast.Attribute):
                holder = self.eval(src.value)
                fc = self.ctx.field(holder.cls, src.attr)
                if fc is not None:
                    dom = self.ctx.domain_range(fc)
                    if dom is not None and v.const is not None \
                            and not (dom[0] <= v.const <= dom[1]):
                        self.flag(node, "KC005",
                                  f"{name} stores constant {v.const} into "
                                  f"{holder.cls}.{src.attr}: outside domain "
                                  f"{fc.domain[0]}..{fc.domain[1]} "
                                  f"[{dom[0]}, {dom[1]}]")
                    if v.dtype is not None and not v.weak \
                            and v.dtype != fc.dtype:
                        self.flag(node, "KC006",
                                  f"{name} stores {v.dtype} value into "
                                  f"{holder.cls}.{src.attr} declared "
                                  f"{fc.dtype}")
            for extra in args[val_pos + 1:]:
                self.eval(extra)
            return arr
        for extra in args[max(arr_pos, idx_pos) + 1:]:
            self.eval(extra)
        if name == "_clear_row":
            return arr
        # read form: result takes the index's shape (+ trailing row axes)
        if name == "_get_row":
            tail = arr.axes[:1] + arr.axes[2:] if arr.axes else None
            return AVal(axes=tail, dtype=arr.dtype)
        return AVal(axes=idx.axes, dtype=arr.dtype, bound=arr.bound)

    def _axis_of(self, v: AVal, dim_node: ast.AST | None) -> str | None:
        """The named axis of ``v`` that ``dim`` selects (None: unknown)."""
        if v.axes is None or dim_node is None:
            return None
        d = self.eval(dim_node)
        if d.const is None:
            return None
        pos = d.const if d.const >= 0 else len(v.axes) + d.const
        if 0 <= pos < len(v.axes) and v.axes[pos] not in ("1", "?"):
            return v.axes[pos]
        return None

    def _dim_node(self, node: ast.Call, pos: int) -> ast.AST | None:
        kw = self._kwdict(node)
        if "dim" in kw:
            return kw["dim"]
        return node.args[pos] if len(node.args) > pos else None

    def _widening(self, node: ast.Call, fname: str, v: AVal) -> str | None:
        """The dtype of an int reduction; KC002 when it silently widens."""
        if fname not in _WIDENING:
            return None
        if "dtype" in self._kwdict(node):
            return self._dtype_from_arg(self._kwdict(node)["dtype"])
        if v.dtype in ("i32", "bool", "u8"):
            self.flag(node, "KC002",
                      f"{fname} of a {v.dtype} tensor with no dtype= "
                      "returns int64 (name dtype=torch.int32)")
            return "i64"
        return None

    def _call_torch(self, node: ast.Call, fname: str,
                    recv: AVal | None = None) -> AVal | None:
        """``torch.<fname>(...)``, or the method ``recv.<fname>(...)``
        (``recv`` then stands for the first operand)."""
        args = node.args
        kw = self._kwdict(node)
        off = 0 if recv is None else 1

        def arg(i):
            if recv is not None and i == 0:
                return recv
            return self.eval(args[i - off]) if len(args) > i - off \
                else UNKNOWN

        def nth(i):
            return args[i - off] if len(args) > i - off else None

        if fname == "where" and (recv is None and len(args) == 3):
            c, a, b = arg(0), arg(1), arg(2)
            self._broadcast(node, replace(a, dtype=None),
                            replace(b, dtype=None), "torch.where")
            j = _join(a, b)
            axes = self._broadcast(node, replace(c, dtype=None),
                                   replace(j, dtype=None), "torch.where")
            if a.dtype and b.dtype and not (a.weak or b.weak) \
                    and a.dtype != b.dtype:
                self.flag(node, "KC002",
                          f"torch.where joins {a.dtype} and {b.dtype} "
                          "branches: silent promotion")
            return replace(j, axes=axes, part=c.part or j.part)
        if fname == "arange" and recv is None:
            n = arg(0)
            dt = self._dtype_from_arg(kw.get("dtype")) or "i64"
            if len(args) == 1 and n.size_axis is not None:
                return AVal(axes=(n.size_axis,), dtype=dt,
                            bound=n.size_axis)
            return AVal(axes=("?",), dtype=dt)
        if fname in ("zeros", "ones", "full", "empty") and recv is None:
            shape = args[0] if args else None
            dt_node = kw.get("dtype")
            if fname == "full":
                fill = arg(1)
                dt = self._dtype_from_arg(dt_node) or (
                    "f32" if fill.dtype == "f32" else
                    "i64" if fill.dtype == "i32" else fill.dtype)
                return AVal(axes=self._shape_from(shape), dtype=dt,
                            const=fill.const)
            dt = self._dtype_from_arg(dt_node) or "f32"
            return AVal(axes=self._shape_from(shape), dtype=dt)
        if fname in ("zeros_like", "ones_like", "full_like", "empty_like"):
            base = arg(0)
            dt = self._dtype_from_arg(kw.get("dtype")) or base.dtype
            if fname == "full_like":
                fill = arg(1)
                return AVal(axes=base.axes, dtype=dt, const=fill.const,
                            part=base.part)
            zc = 0 if fname == "zeros_like" else 1
            return AVal(axes=base.axes, dtype=dt,
                        const=zc if fname in ("zeros_like", "ones_like")
                        else None, part=base.part)
        if fname in ("tensor", "as_tensor") and recv is None:
            v = arg(0)
            dt = self._dtype_from_arg(kw.get("dtype"))
            if dt is not None:
                return replace(v, dtype=dt, weak=False) \
                    if v.axes is not None else AVal(axes=None, dtype=dt)
            return v
        if fname in ("broadcast_to", "expand"):
            v = arg(0)
            if recv is not None and fname == "expand":
                shape_nodes = list(args)
                axes = (self._shape_from(shape_nodes[0])
                        if len(shape_nodes) == 1
                        else self._shape_from(ast.Tuple(elts=shape_nodes,
                                                        ctx=ast.Load())))
            else:
                axes = self._shape_from(nth(1))
            if v.axes is not None and axes is not None:
                _, conflict = broadcast_axes(axes, v.axes)
                if conflict:
                    self.flag(node, "KC001",
                              f"{fname} aligns distinct named axes: "
                              f"{conflict}")
            return AVal(axes=axes, dtype=v.dtype)
        if fname == "expand_as" and recv is not None:
            v, like = arg(0), arg(1)
            if v.axes is not None and like.axes is not None:
                _, conflict = broadcast_axes(like.axes, v.axes)
                if conflict:
                    self.flag(node, "KC001",
                              f"expand_as aligns distinct named axes: "
                              f"{conflict}")
            return AVal(axes=like.axes, dtype=v.dtype)
        if fname in ("minimum", "maximum"):
            a, b = arg(0), arg(1)
            axes = self._broadcast(node, a, b, f"torch.{fname}")
            dt = self._dtype_of_binop(node, a, b, ast.Add())
            bound = None
            if fname == "minimum":
                # min against (size - 1), or against an already-bounded
                # value, keeps the result in range of that axis
                bound = a.maskconst or b.maskconst or a.bound or b.bound
            return AVal(axes=axes, dtype=dt, bound=bound)
        if fname in ("clamp", "clip"):
            v = arg(0)
            for extra in args[1 - off:]:
                self.eval(extra)
            hi = self.eval(kw["max"]) if "max" in kw else arg(2)
            bound = hi.maskconst
            return replace(v, bound=bound or v.bound, const=None,
                           size_axis=None, maskconst=None, ring=None)
        if fname in _REDUCTIONS or fname in ("cumsum", "cumprod"):
            v = arg(0)
            for extra in args[1 - off:]:
                self.eval(extra)
            dt = self._widening(node, fname, v) or (
                _REDUCTIONS.get(fname) or v.dtype)
            dim_node = self._dim_node(node, 1 - off)
            if fname in ("cumsum", "cumprod"):
                return self._reduce(v, dim_node, dt, keep=True)
            return self._reduce(v, dim_node, dt)
        if fname in ("argmax", "argmin"):
            v = arg(0)
            dim_node = self._dim_node(node, 1 - off)
            ax = self._axis_of(v, dim_node)
            if v.axes is not None and len(v.axes) == 1 \
                    and v.axes[0] not in ("1", "?"):
                ax = v.axes[0]
            out = self._reduce(v, dim_node, "i64")
            return replace(out, bound=ax)
        if fname in _ALONG:
            v = arg(0)
            for extra in args[1 - off:]:
                self.eval(extra)
            dim_node = self._dim_node(node, 1 - off)
            if dim_node is None and fname in ("sort", "argsort", "topk",
                                              "kthvalue", "cummax",
                                              "cummin"):
                dim_node = ast.Constant(value=-1)
            out = self._reduce(v, dim_node, v.dtype, keep=True)
            if fname == "kthvalue":
                out = self._reduce(v, dim_node, v.dtype)
            return replace(out, bound=None, const=None, maskconst=None,
                           ring=None)
        if fname in ("abs", "sign", "square", "neg", "contiguous", "clone",
                     "detach"):
            v = arg(0)
            return replace(v, bound=None if fname != "contiguous"
                           else v.bound, const=None, maskconst=None)
        if fname == "unsqueeze":
            v, ax = arg(0), self.eval(nth(1))
            if v.axes is not None and ax.const is not None:
                lst = list(v.axes)
                pos = ax.const if ax.const >= 0 else len(lst) + 1 + ax.const
                if 0 <= pos <= len(lst):
                    lst.insert(pos, "1")
                    return replace(v, axes=tuple(lst), const=None,
                                   ring=None)
            return AVal(axes=None, dtype=v.dtype)
        if fname in ("cat", "stack", "hstack", "vstack", "concatenate"):
            for a in args:
                self.eval(a)
            return UNKNOWN
        if fname in ("logical_and", "logical_or", "logical_xor"):
            a, b = arg(0), arg(1)
            axes = self._broadcast(node, a, b, f"torch.{fname}")
            return AVal(axes=axes, dtype="bool")
        if fname == "logical_not":
            v = arg(0)
            return AVal(axes=v.axes, dtype="bool")
        if fname == "gather":
            v = arg(0)
            dim_node = nth(1) if nth(1) is not None else kw.get("dim")
            idx = self.eval(nth(2) if nth(2) is not None
                            else kw.get("index"))
            ax = self._axis_of(v, dim_node)
            if ax is not None and ax == v.ring:
                self._check_ring_index(node, v, idx, "torch.gather")
            return AVal(axes=idx.axes, dtype=v.dtype)
        return None

    def _shape_from(self, node: ast.AST | None) -> tuple[str, ...] | None:
        if node is None:
            return None
        v = self.eval(node)
        if v.tup is not None:
            if any(e.tup is not None for e in v.tup):
                return None   # a starred/unpacked shape: unknown rank
            out = []
            for e in v.tup:
                if e.size_axis is not None:
                    out.append(e.size_axis)
                elif e.const == 1:
                    out.append("1")
                else:
                    out.append("?")
            return tuple(out)
        if v.size_axis is not None:      # scalar int shape
            return (v.size_axis,)
        if v.axes is not None and v.axes == () and v.dtype in _INT_DTYPES:
            return ("?",)
        return None

    def _reduce(self, v: AVal, axis_node: ast.AST | None,
                dt: str | None, keep: bool = False) -> AVal:
        """The result of reducing ``v`` over ``axis_node`` (every axis
        when None); ``keep``: an op along the axis that keeps it (sort,
        cumsum)."""
        if axis_node is None:
            if keep:
                return AVal(axes=v.axes, dtype=dt)
            return AVal(axes=(), dtype=dt)
        ax = self.eval(axis_node)
        if v.axes is not None and ax.const is not None:
            lst = list(v.axes)
            pos = ax.const if ax.const >= 0 else len(lst) + ax.const
            if 0 <= pos < len(lst):
                if not keep:
                    lst.pop(pos)
                return AVal(axes=tuple(lst), dtype=dt)
        return AVal(axes=None, dtype=dt)

    def _lead_sel(self, node: ast.Call) -> AVal:
        """``sel(c, a, b)``: ``torch.where`` with the operands aligned on
        the leading (shard) axis (``_lift``)."""
        c, a, b = (self.eval(x) for x in node.args[:3])
        n = max(len(x.axes) for x in (c, a, b) if x.axes is not None) \
            if any(x.axes is not None for x in (c, a, b)) else 0
        c, a, b = (replace(x, axes=_lead_pad(x.axes, n)) for x in (c, a, b))
        self._broadcast(node, replace(a, dtype=None), replace(b, dtype=None),
                        "sel")
        j = _join(a, b)
        axes = self._broadcast(node, replace(c, dtype=None),
                               replace(j, dtype=None), "sel")
        if a.dtype and b.dtype and not (a.weak or b.weak) \
                and a.dtype != b.dtype:
            self.flag(node, "KC002",
                      f"sel joins {a.dtype} and {b.dtype} branches: "
                      "silent promotion")
        if a.weak and b.weak and j.dtype == "i32":
            j = replace(j, weak=False)   # sel makes int32 of two scalars
        return replace(j, axes=axes, part=c.part or j.part)

    def eval_Call(self, node: ast.Call) -> AVal:
        func = node.func

        # ----- method calls -------------------------------------------
        if isinstance(func, ast.Attribute):
            recv = func.value
            attr = func.attr
            chain = _attr_chain(func)
            root = chain[0] if chain else None
            if attr == "_replace":
                target = self.eval(recv)
                return self._call_replace(node, target, self._kwdict(node))
            if attr == "to":
                v = self.eval(recv)
                dt = None
                for a in list(node.args) + [self._kwdict(node).get("dtype")]:
                    dt = dt or self._dtype_from_arg(a)
                return replace(v, dtype=dt or v.dtype, weak=False,
                               const=None) if dt else v
            if attr in _CAST_METHODS and not node.args:
                v = self.eval(recv)
                return replace(v, dtype=_CAST_METHODS[attr], weak=False)
            if root in ("torch",) and len(chain) == 2:
                res = self._call_torch(node, attr)
                if res is not None:
                    return res
                for a in node.args:
                    self.eval(a)
                for k in node.keywords:
                    self.eval(k.value)
                return UNKNOWN
            if attr in ("reshape", "view", "flatten", "unbind", "split",
                        "chunk", "tolist", "item", "numpy", "cpu"):
                self.eval(recv)
                for a in node.args:
                    self.eval(a)
                return UNKNOWN
            v = self.eval(recv)
            if v.cls is None and v.tup is None and v.dt_marker is None \
                    and (v.axes is not None or v.dtype is not None):
                res = self._call_torch(node, attr, recv=v)
                if res is not None:
                    return res
            # unknown method: evaluate args for side-findings
            for a in node.args:
                self.eval(a)
            for k in node.keywords:
                self.eval(k.value)
            return UNKNOWN

        # ----- plain-name calls ---------------------------------------
        if isinstance(func, ast.Name):
            name = func.id
            if name == "sel" and len(node.args) >= 3:
                return self._lead_sel(node)
            if name == "mrep":
                target = self.eval(node.args[0]) if node.args else UNKNOWN
                if len(node.args) > 1:
                    self.eval(node.args[1])
                return self._call_replace(node, target, self._kwdict(node),
                                          leading=True)
            if name == "_tree_sel" and len(node.args) >= 3:
                self.eval(node.args[0])
                return _join(self.eval(node.args[1]),
                             self.eval(node.args[2]))
            if name == "_slot" and len(node.args) == 2:
                idx = self.eval(node.args[1])
                return AVal(axes=idx.axes, dtype="i32", bound="CAP")
            if name == "_argmax" and node.args:
                v = self.eval(node.args[0])
                dim_node = self._dim_node(node, 1) or ast.Constant(value=-1)
                ax = self._axis_of(v, dim_node)
                return replace(self._reduce(v, dim_node, "i32"), bound=ax)
            if name == "_arange" and node.args:
                n = self.eval(node.args[0])
                for a in node.args[1:]:
                    self.eval(a)
                if n.size_axis is not None:
                    return AVal(axes=(n.size_axis,), dtype="i32",
                                bound=n.size_axis)
                return AVal(axes=("?",), dtype="i32")
            if name in _INDEX_FUNCS:
                return self._call_index_func(node, name)
            if name == "onehot_select" and len(node.args) >= 3:
                self.eval(node.args[0])
                arr = self.eval(node.args[1])
                return self._reduce(arr, node.args[2], arr.dtype)
            if name in self.ctx.contracts:
                return self._call_ctor(node, name)
            if name in ("range", "len", "sorted", "list", "tuple", "dict",
                        "set", "enumerate", "zip", "print", "isinstance",
                        "getattr", "hasattr", "repr", "str", "min", "max"):
                for a in node.args:
                    self.eval(a)
                return UNKNOWN
            if name in ("int", "float", "bool"):
                v = self.eval(node.args[0]) if node.args else UNKNOWN
                return _scalar({"int": "i32", "float": "f32",
                                "bool": "bool"}[name], weak=True,
                               const=v.const)
            if name in self.ctx.funcs:
                for a in node.args:
                    self.eval(a)
                for k in node.keywords:
                    self.eval(k.value)
                return self.ctx.summaries.get(name, UNKNOWN)
            for a in node.args:
                self.eval(a)
            for k in node.keywords:
                self.eval(k.value)
            return UNKNOWN

        # calling the result of a call
        self.eval(func)
        for a in node.args:
            self.eval(a)
        for k in node.keywords:
            self.eval(k.value)
        return UNKNOWN


# ---------------------------------------------------------------------------
# driving the interpreter over the capture-reachable function set
# ---------------------------------------------------------------------------


def _topo_order(names: set, calls: dict) -> list:
    """Callees before callers (cycles broken arbitrarily): summaries of
    helpers exist by the time their call sites are interpreted."""
    order: list = []
    state: dict = {}

    def visit(n) -> None:
        if state.get(n):            # 1 = in progress, 2 = done
            return
        state[n] = 1
        for c in sorted(calls.get(n, ())):
            if c in names and state.get(c) != 1:
                visit(c)
        state[n] = 2
        order.append(n)

    for n in sorted(names):
        visit(n)
    return order


def _summary_join(avals: list[AVal]) -> AVal:
    if not avals:
        return UNKNOWN
    out = avals[0]
    for v in avals[1:]:
        out = _join(out, v)
    return out


def _analyze(ctx: _Ctx, mods: list[ts._Module], root: str) -> None:
    traced, graph = ts.traced_functions(mods)
    ctx.funcs = {name: (mod, fn) for (_p, name), (mod, fn, _s)
                 in traced.items()}
    for key in _topo_order(set(traced), graph):
        mod, fn, _static = traced[key]
        interp = _Interp(ctx, rel(root, mod.path))
        interp.bind_params(fn)
        interp.exec_body(fn.body)
        ctx.summaries[key[1]] = _summary_join(interp.returns)


# ---------------------------------------------------------------------------
# runtime declared-vs-actual diff (KC007)
# ---------------------------------------------------------------------------

# all-distinct axis sizes: shape equality then implies axis-name equality
_CHECK_GEOMETRY = dict(num_peers=3, log_cap=32, inbox_cap=4, msg_entries=5,
                       proposal_cap=6, readindex_cap=16)
_CHECK_SHARDS = 7


def _dtype_name(dt) -> str:
    name = str(dt).removeprefix("torch.")
    return _DTYPE_NAMES.get(name, name)


def runtime_check(kp=None, num_shards: int = _CHECK_SHARDS,
                  root: str | None = None,
                  eval_step: bool = True, device=None) -> list[Finding]:
    """Diff the declared CONTRACTS against the structures the port
    actually builds on ``device`` (the CUDA card unless the caller names
    another): init_state / empty_inbox / empty_input, the state and
    output of one real step, and one pass of the health and invariant
    reductions."""
    import torch

    from dragonboat_tpu_torch.core import health as _health
    from dragonboat_tpu_torch.core import invariants as _invariants
    from dragonboat_tpu_torch.core import kernel, kstate
    from dragonboat_tpu_torch.core import params as kparams
    from dragonboat_tpu_torch.devices import resolve_device

    device = resolve_device(device)
    if root is None:
        root = os.getcwd()
    if kp is None:
        kp = kparams.KernelParams(**_CHECK_GEOMETRY)
    G = num_shards
    axis_env = {
        "G": G, "P": kp.num_peers, "CAP": kp.log_cap, "K": kp.inbox_cap,
        "E": kp.msg_entries, "B": kp.proposal_cap, "RI": kp.readindex_cap,
    }
    ctx = _Ctx()
    kpath = os.path.join(root, CONTRACT_FILES[0])
    for cf in CONTRACT_FILES:
        p = os.path.join(root, cf)
        if not os.path.exists(p):
            continue
        with open(p, encoding="utf-8") as f:
            _collect_contracts(ctx, ast.parse(f.read(), filename=p),
                               rel(root, p))
    findings = list(ctx.findings)

    def anchor(cls: str, fname: str) -> tuple[str, int]:
        return ctx.contract_lines.get((cls, fname), (rel(root, kpath), 1))

    def diff(cls: str, struct) -> None:
        decl = ctx.contracts.get(cls)
        if decl is None:
            findings.append(Finding(
                PASS, rel(root, kpath), 1, "KC007",
                f"no CONTRACTS entry for {cls}"))
            return
        actual_fields = set(getattr(struct, "_fields", ()))
        for fname in sorted(actual_fields - set(decl)):
            path, line = anchor(cls, next(iter(decl), fname))
            findings.append(Finding(
                PASS, path, line, "KC007",
                f"{cls}.{fname} exists on the struct but has no declared "
                "contract"))
        for fname, fc in decl.items():
            path, line = anchor(cls, fname)
            if fname not in actual_fields:
                findings.append(Finding(
                    PASS, path, line, "KC007",
                    f"{cls}.{fname} declared but absent from the struct"))
                continue
            val = getattr(struct, fname)
            if val is None:
                if not fc.optional:
                    findings.append(Finding(
                        PASS, path, line, "KC007",
                        f"{cls}.{fname} is None but not declared optional"))
                continue
            want = tuple(axis_env.get(a, -1) for a in fc.axes)
            got = tuple(val.shape)
            if got != want:
                findings.append(Finding(
                    PASS, path, line, "KC007",
                    f"{cls}.{fname}: declared {list(fc.axes)} -> {want} "
                    f"but actual shape is {got}"))
            actual_dt = _dtype_name(val.dtype)
            if actual_dt != fc.dtype:
                findings.append(Finding(
                    PASS, path, line, "KC007",
                    f"{cls}.{fname}: declared dtype {fc.dtype} but actual "
                    f"is {actual_dt}"))
            if val.device.type != device.type:
                findings.append(Finding(
                    PASS, path, line, "KC007",
                    f"{cls}.{fname} lives on {val.device.type}, not on "
                    f"the {device.type} device the structures were "
                    "built for"))

    peer_ids = list(range(1, kp.num_peers + 1))
    state = kstate.init_state(kp, G, 1, peer_ids, device=device)
    box = kstate.empty_inbox(kp, G, device=device)
    inp = kstate.empty_input(kp, G, device=device)
    diff("ShardState", state)
    diff("Inbox", box)
    diff("StepInput", inp)
    if eval_step:
        new_state, out = kernel.step(kp, state, box, inp)
        diff("StepOutput", out)
        diff("ShardState", new_state)

    # health structures: C/TOPK/RW are host-side constants, and k clamps
    # to G on small fleets (core/health.py) — the env mirrors that
    hk = min(_health.DEFAULT_TOP_K, G)
    axis_env.update({"C": _health.NUM_CLASSES, "TOPK": hk,
                     "RW": _health.ROW_WIDTH})
    digest = _health.empty_digest(G, device=device)
    report, new_digest = _health.fleet_health(
        state, box.from_, digest, k=_health.DEFAULT_TOP_K)
    diff("HealthReport", report)
    diff("HealthDigest", new_digest)
    row = _health.shard_row(state, box.from_, digest, 0)
    diff("ShardRow", row)

    # invariant-probe structures: NI is the declared invariant count
    axis_env["NI"] = _invariants.NUM_INVARIANTS
    inv_digest = _invariants.empty_digest(G, device=device)
    inv_report, new_inv_digest = _invariants.check_invariants(
        state, inv_digest)
    diff("InvariantReport", inv_report)
    diff("InvariantDigest", new_inv_digest)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return findings


# ---------------------------------------------------------------------------
# donation contract (KC008): kstate.DONATION vs the graphs' donate_argnums
# ---------------------------------------------------------------------------


def _donation_decl(tree: ast.Module) -> tuple[dict | None, int]:
    """The DONATION literal from a kstate-shaped module (+ its line)."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "DONATION":
            try:
                return ast.literal_eval(node.value), node.lineno
            except (ValueError, SyntaxError):
                return None, node.lineno
    return None, 1


def _donated_entries(tree: ast.Module) -> dict[str, tuple[tuple, list, int]]:
    """Module-level ``name = graphs.compiled(fn, ..., donate_argnums=...)``
    assignments: name -> (argnums, positional param names of ``fn`` as
    defined in the same module, lineno)."""
    defs = {node.name: node for node in tree.body
            if isinstance(node, ast.FunctionDef)}
    out: dict[str, tuple[tuple, list, int]] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            continue
        call = node.value
        fname = (call.func.attr if isinstance(call.func, ast.Attribute)
                 else getattr(call.func, "id", None))
        if fname != "compiled":
            continue
        for k in call.keywords:
            if k.arg != "donate_argnums":
                continue
            try:
                nums = ast.literal_eval(k.value)
            except (ValueError, SyntaxError):
                nums = None
            if isinstance(nums, int):
                nums = (nums,)
            fn = defs.get(getattr(call.args[0], "id", None)) \
                if call.args else None
            params = ([a.arg for a in (fn.args.posonlyargs + fn.args.args)]
                      if fn is not None else [])
            out[node.targets[0].id] = (tuple(nums) if nums else (),
                                       params, node.lineno)
    return out


def donation_check(root: str, kstate_tree: ast.Module,
                   kernel_tree: ast.Module,
                   extra_trees: dict[str, ast.Module] | None = None,
                   ) -> list[Finding]:
    """Cross-check the declared donation contract against the actual
    ``donate_argnums`` of the compiled entries (both directions).

    Entries default to ``KERNEL_FILE``; an entry carrying a ``module``
    key is checked against that module instead (``extra_trees`` maps
    repo-relative module path -> parsed tree; every DONATION_MODULES
    member beyond kernel.py should be present).  An entry's ``function``
    key names the compiled entry when it differs from the entry name."""
    findings: list[Finding] = []
    srel = rel(root, os.path.join(root, CONTRACT_FILES[0]))
    decl, decl_line = _donation_decl(kstate_tree)
    mod_trees = {KERNEL_FILE: kernel_tree}
    mod_trees.update(extra_trees or {})
    mod_entries = {m: _donated_entries(t) for m, t in mod_trees.items()}
    if decl is None:
        if any(mod_entries.values()):
            findings.append(Finding(
                PASS, srel, decl_line, "KC008",
                "compiled entries donate buffers but kstate.py has no "
                "(or a non-literal) DONATION declaration"))
        return findings
    declared_fns: dict[str, set[str]] = {m: set() for m in mod_trees}
    for name, spec in decl.items():
        module = spec.get("module", KERNEL_FILE)
        fn_name = spec.get("function", name)
        mrel = rel(root, os.path.join(root, module))
        entries = mod_entries.get(module)
        if entries is None:
            findings.append(Finding(
                PASS, srel, decl_line, "KC008",
                f"DONATION entry {name} names module {module} which is "
                "not in DONATION_MODULES — the cross-check cannot see "
                "its compiled entries"))
            continue
        declared_fns.setdefault(module, set()).add(fn_name)
        if fn_name not in entries:
            findings.append(Finding(
                PASS, srel, decl_line, "KC008",
                f"DONATION declares {name} but {module} has no "
                f"donating compiled entry {fn_name}"))
            continue
        nums, params, line = entries[fn_name]
        want_nums = tuple(spec.get("argnums", ()))
        if nums != want_nums:
            findings.append(Finding(
                PASS, mrel, line, "KC008",
                f"{name}: donate_argnums {nums} != declared "
                f"DONATION argnums {want_nums}"))
            continue
        bound = tuple(params[i] for i in nums if i < len(params))
        want_params = tuple(spec.get("params", ()))
        if bound != want_params:
            findings.append(Finding(
                PASS, mrel, line, "KC008",
                f"{name}: donated parameters {bound} != declared "
                f"DONATION params {want_params}"))
    for module, entries in mod_entries.items():
        mrel = rel(root, os.path.join(root, module))
        for name, (_, _, line) in entries.items():
            if name not in declared_fns.get(module, set()):
                findings.append(Finding(
                    PASS, mrel, line, "KC008",
                    f"{name} donates buffers but is not declared in "
                    "kstate.DONATION — the host no-touch contract is "
                    "undocumented/unchecked"))
    return findings


# ---------------------------------------------------------------------------
# pass entry point
# ---------------------------------------------------------------------------


def run(root: str, files: list[str] | None = None,
        dynamic: bool = False, device=None) -> list[Finding]:
    """The interpreter (KC001-KC006) and static KC007/KC008;
    ``dynamic`` adds the runtime KC007 diff on ``device`` (default mode
    only)."""
    default_mode = files is None
    if default_mode:
        paths = [os.path.join(root, KERNEL_FILE)]
        contract_paths = [os.path.join(root, cf) for cf in CONTRACT_FILES]
        const_paths = [os.path.join(root, PARAMS_FILE)]
    else:
        paths = list(files)
        contract_paths = list(files)
        const_paths = list(files)

    ctx = _Ctx()
    trees: dict[str, ast.Module] = {}

    def tree_of(p: str) -> ast.Module | None:
        if p not in trees:
            if not os.path.exists(p):
                return None
            with open(p, encoding="utf-8") as f:
                trees[p] = ast.parse(f.read(), filename=p)
        return trees[p]

    for p in contract_paths:
        t = tree_of(p)
        if t is not None:
            _collect_contracts(ctx, t, rel(root, p))
    for p in const_paths + paths:
        t = tree_of(p)
        if t is not None:
            _collect_consts(ctx, t)

    mods = [ts._Module(p, trees[p]) for p in paths if tree_of(p) is not None]
    _analyze(ctx, mods, root)
    findings = ctx.findings

    if default_mode:
        if dynamic:
            findings = findings + runtime_check(root=root, device=device)
        ktree = tree_of(os.path.join(root, CONTRACT_FILES[0]))
        ntree = tree_of(os.path.join(root, KERNEL_FILE))
        if ktree is not None and ntree is not None:
            extra: dict[str, ast.Module] = {}
            for m in DONATION_MODULES:
                if m == KERNEL_FILE:
                    continue
                mt = tree_of(os.path.join(root, m))
                if mt is not None:
                    extra[m] = mt
            findings = findings + donation_check(root, ktree, ntree, extra)
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))
