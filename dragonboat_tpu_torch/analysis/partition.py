"""SPMD partition-safety analyzer: the G axis as a checked contract.

The port's form of the reference's pass.  The mesh layout
(``parallel/ici.py``) holds every kernel struct's leading G axis split
over the ``(g, r)`` positions; the whole scaling story rests on groups
never talking to each other except through the two declared seams (the
in-mesh router exchange and the fleet-stats reduction).  Nothing in
PyTorch enforces that: a stray ``.sum()`` over the shard axis, a
replicated value broadcast into split rows by accident, or an ``int()``
on a device value in a hot host path all run fine and only show up as
wrong answers or a serving regression.  This pass promotes the layout to
a machine-checked discipline, driven by the ``part=``/``collective=``
tags on the ``CONTRACTS`` literals (``core/kstate.py`` grammar block):

- PS001  cross-G data flow outside a declared collective: a reduction
         (``sum`` / ``any`` / ``all`` / ``max`` / ``min`` / ``amax`` /
         ``amin`` / ``prod`` / ``mean``) whose reduced axes include G —
         ``dim=0`` on a ``[G, ...]`` value, or no ``dim`` at all — or an
         op along G (``sort`` / ``topk`` / ``kthvalue`` / ``cumsum``
         with ``dim=0``), not inside a collective's operands and not in
         a function producing a ``collective=declared`` struct (fleet
         stats).  In the port G is written out, so the kernel
         (``core/kernel.py``) and the device state machine
         (``rsm/device_kv.py``) are in scope too: a reduction over dim 0
         there leaks data across shards (the reference leaves
         ``kernel.py`` out only because vmap strips G there).  The
         router's picks (``core/router.py``) are the declared exchange
         and are not in scope.
- PS002  [dynamic] the placement check (``placement_check``): after one
         serve step of a split mesh every ``part=G`` leaf of position
         ``(ig, ir)`` lies on that position's device with ``n_local``
         rows, and the pieces are one per position
- PS003  a replicated operand (a collective's result, or a
         ``part=replicated`` field) combined with split data without an
         explicit broadcast (``expand`` / ``expand_as`` /
         ``broadcast_to`` / ``unsqueeze`` / ``[None]`` on the replicated
         side is the annotation)
- PS006  implicit device->host syncs in hot host paths: ``int()`` /
         ``bool()`` / ``float()`` / ``.item()`` / ``.tolist()`` /
         ``np.asarray`` / ``.cpu()`` / ``.numpy()`` on device values,
         ``torch.cuda.synchronize()``, in every host-side function of
         ``parallel/`` (the functions no compiled entry captures, e.g.
         ``ici.write_rows``, which runs for every lane write of a mesh
         step; tensor parameters and producers' results are the device
         values).  The reference's hot-path list (``step_all``,
         ``_kernel_call``, ``_stage_lane``, ...) names engine methods,
         and over the engine files (``transfer.ENGINE_FILES``) PS006
         DEFERS to the transfer pass's TB005: TB005 scans every
         engine-layer function outside the declared ``SYNC_POINTS``
         (the reference's exempt sync points among them) with the same
         sync forms, a superset of that list, so a line is never
         reported twice under two ids.

Static scope: the abstract interpreter (subclassing the contracts
pass's ``_Interp``) runs over ``DEFAULT_ANALYSIS_FILES`` — the files
that live at mesh level or, in the port, carry G written out.

What has no torch form, and is not invented here: PS002's static
``shard_map`` in/out spec check (the split mesh has no ``shard_map``;
its pieces are checked as they are, dynamically), PS004 (the donor and
result shardings of a donated buffer are the pieces' own devices) and
PS005 (host callbacks in ``shard_map`` bodies: a per-position body is a
captured entry, where a host round-trip is the tracer-safety pass's
TS002/TS003).
"""

from __future__ import annotations

import ast
import os
from dataclasses import replace

from dragonboat_tpu_torch.analysis import contracts as ct
from dragonboat_tpu_torch.analysis import tracer_safety as ts
from dragonboat_tpu_torch.analysis.common import (
    Finding,
    parse_contracts,
    rel,
)

PASS = "partition"

KSTATE_FILE = "dragonboat_tpu_torch/core/kstate.py"

DEFAULT_CONTRACT_FILES = (
    "dragonboat_tpu_torch/core/kstate.py",
    "dragonboat_tpu_torch/core/kernel.py",
    "dragonboat_tpu_torch/core/fleet.py",
    "dragonboat_tpu_torch/core/health.py",
    "dragonboat_tpu_torch/core/invariants.py",
)
#: files interpreted at mesh level (G axis real) — see module docstring
DEFAULT_ANALYSIS_FILES = (
    "dragonboat_tpu_torch/core/fleet.py",
    "dragonboat_tpu_torch/core/health.py",
    "dragonboat_tpu_torch/core/invariants.py",
    "dragonboat_tpu_torch/parallel/ici.py",
    # the elastic controller consumes the fleet-health digest at host
    # level: any reduction appearing here is a cross-G flow outside the
    # two declared seams
    "dragonboat_tpu_torch/control.py",
    # G written out in the port (module docstring)
    "dragonboat_tpu_torch/core/kernel.py",
    "dragonboat_tpu_torch/rsm/device_kv.py",
)
DEFAULT_CONST_FILES = ("dragonboat_tpu_torch/core/params.py",)
#: PS006: every host-side function of these files
DEFAULT_PARALLEL_FILES = (
    "dragonboat_tpu_torch/parallel/ici.py",
    "dragonboat_tpu_torch/parallel/fabric_kernels.py",
)

#: every file any sub-check reads
SCOPE = tuple(dict.fromkeys(
    DEFAULT_CONTRACT_FILES + DEFAULT_ANALYSIS_FILES + DEFAULT_CONST_FILES
    + DEFAULT_PARALLEL_FILES + ts.DEFAULT_MODULES))

# Conventional parameter names at MESH level: no axes are stripped (the
# G axis is present).  The kernel's names (``m``, ``eff``, ``pre``,
# ``r``) bind as in the contracts pass.
PART_BINDINGS = {
    "s": "ShardState",
    "st": "ShardState",
    "state": "ShardState",
    "box": "Inbox",
    "bx": "Inbox",
    "inbox": "Inbox",
    "inp": "StepInput",
    "out": "StepOutput",
    "digest": "HealthDigest",
    "inv_digest": "InvariantDigest",
}

#: ``rsm/device_kv.py``'s tensors, which carry no CONTRACTS: its state
#: dict's entries (``sm_state["keys"]``) and the apply's parameters,
#: each with its leading shard axis
DEVICE_KV_FILE = "dragonboat_tpu_torch/rsm/device_kv.py"
DEVICE_KV_BINDINGS = {
    "keys": (("G", "T"), "i32"), "vals": (("G", "T"), "i32"),
    "count": (("G",), "i32"), "key": (("G",), "i32"),
    "val": (("G",), "i32"), "valid": (("G",), "bool"),
    "first_key": (("G",), "i32"), "cmd_lanes": (("G", "AB", "2"), "i32"),
    "valid_mask": (("G", "AB"), "bool"),
}

#: torch collectives (``torch.distributed`` and its functional form) —
#: using one IS declaring cross-device flow
_NAMED_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_tensor",
    "all_gather_into_tensor", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "broadcast", "reduce",
})
#: collectives whose result is identical on every participating rank
_REPLICATING = frozenset({"all_reduce", "broadcast"})

# --- PS006 scope (hot host paths) -----------------------------------------
#: self.<attr> values that live on device in both engines
_DEVICE_SELF_ATTRS = frozenset({"state", "box", "_pending_dev", "_cut_dev"})
#: calls whose results are device values
_DEVICE_PRODUCERS = frozenset({
    "kernel_step", "kernel_step_donated", "step", "step_donated",
    "ici_serve_step", "ici_cluster_step", "fleet_stats",
    "fleet_health", "shard_row", "serve_step", "serve_step_donated",
    "cluster_step", "cluster_step_donated", "dispatch", "route",
    "output_row_flags", "to_device", "shard", "place", "join",
    "_kernel_call", "upload", "put_rows",
})
#: parameters of a parallel/ host function that hold device values
_DEVICE_PARAMS = frozenset(PART_BINDINGS) | {"lanes", "senders", "slots"}


def class_partition(ctx: ct._Ctx, cls: str | None) -> str | None:
    """The uniform declared partition of a struct, or None if mixed or
    undeclared ('G' | 'replicated')."""
    fields = ctx.contracts.get(cls or "")
    if not fields:
        return None
    parts = {fc.part for fc in fields.values() if fc.part is not None}
    return next(iter(parts)) if len(parts) == 1 else None


def _declares_collective(ctx: ct._Ctx, fn: ast.AST) -> bool:
    """Does ``fn`` construct a struct whose fields are declared
    ``collective=declared``?  Such a producer's cross-G reductions are
    the licensed seam (fleet stats)."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            fields = ctx.contracts.get(n.func.id)
            if fields and any(fc.collective == "declared"
                              for fc in fields.values()):
                return True
    return False


def _relabel_collect_findings(ctx: ct._Ctx) -> None:
    """Contract-table parse errors surface from the shared collector as
    contracts/KC007; re-own them as partition/PS000 here."""
    ctx.findings = [
        f if f.pass_name == PASS
        else Finding(PASS, f.path, f.line, "PS000", f.message)
        for f in ctx.findings
    ]


# ---------------------------------------------------------------------------
# the partition-aware abstract interpreter (PS001 / PS003)
# ---------------------------------------------------------------------------


class _PartInterp(ct._Interp):
    """Contracts interpreter with partition tracking layered on.

    Only PS* rules are emitted — the KC* checks the parent runs on the
    way through are the contracts pass's job and are dropped here."""

    def __init__(self, ctx: ct._Ctx, relpath: str) -> None:
        super().__init__(ctx, relpath)
        self._collective_depth = 0   # >0: inside a collective's operands
        self._declared = False       # fn produces a collective=declared struct
        self._call_stack: list[ast.Call] = []

    # -- reporting: PS-only --------------------------------------------
    def flag(self, node: ast.AST, rule: str, msg: str) -> None:
        if not rule.startswith("PS"):
            return
        key = (getattr(node, "lineno", 0), rule)
        if key in self._flagged:
            return
        self._flagged.add(key)
        self.ctx.findings.append(
            Finding(PASS, self.relpath, getattr(node, "lineno", 0),
                    rule, msg))

    # -- parameter binding: mesh level, nothing stripped ----------------
    def bind_params(self, fn: ast.FunctionDef | ast.Lambda) -> None:
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            ann = ct._ann_name(getattr(a, "annotation", None))
            name = a.arg
            kernel_cls, strip = ct.NAME_BINDINGS.get(name, (None, ()))
            if name == "kp" or ann == "KernelParams":
                self.env[name] = ct._KP
            elif ann in self.ctx.contracts:
                self.env[name] = ct._struct_aval(ann, strip)
            elif name in PART_BINDINGS \
                    and PART_BINDINGS[name] in self.ctx.contracts:
                self.env[name] = ct._struct_aval(PART_BINDINGS[name], ())
            elif kernel_cls in self.ctx.contracts:
                self.env[name] = ct._struct_aval(kernel_cls, strip)
            elif self.relpath == DEVICE_KV_FILE \
                    and name in DEVICE_KV_BINDINGS:
                self.env[name] = self._kv_aval(name)
            else:
                self.env[name] = ct.UNKNOWN
        for extra in (args.vararg, args.kwarg):
            if extra is not None:
                self.env[extra.arg] = ct.UNKNOWN

    # nested defs spawn THIS interpreter class with the partition state
    def exec_stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sub = _PartInterp(self.ctx, self.relpath)
            sub.env.update(self.env)
            sub.bind_params(st)
            sub._flagged = self._flagged
            sub._call_stack = self._call_stack
            sub._declared = self._declared \
                or _declares_collective(self.ctx, st)
            sub.exec_body(st.body)
        else:
            super().exec_stmt(st)

    # -- collectives -----------------------------------------------------
    def eval_Call(self, node: ast.Call) -> ct.AVal:
        func = node.func
        cname = None
        chain = ct._attr_chain(func)
        if isinstance(func, ast.Attribute):
            if chain and chain[-1] in _NAMED_COLLECTIVES and (
                    "distributed" in chain or chain[0] in ("dist",
                                                           "funcol")):
                cname = chain[-1]
        elif isinstance(func, ast.Name) and func.id in _NAMED_COLLECTIVES:
            cname = func.id
        # a collective licenses cross-G reductions in its operands (a
        # process group names no mesh axis: optimistic, as the reference
        # is on unresolvable axes)
        self._call_stack.append(node)
        if cname is not None:
            self._collective_depth += 1
        try:
            res = super().eval_Call(node)
            if cname in _REPLICATING and node.args:
                v0 = self.eval(node.args[0])
                base = v0 if v0.axes is not None else res
                res = replace(base, part="rep", bcast=False, cls=None,
                              tup=None, const=None, size_axis=None,
                              maskconst=None)
            return res
        finally:
            if cname is not None:
                self._collective_depth -= 1
            self._call_stack.pop()

    # -- PS001: reductions over the G axis -------------------------------
    def _reduce(self, v: ct.AVal, axis_node: ast.AST | None,
                dt: str | None, keep: bool = False) -> ct.AVal:
        out = super()._reduce(v, axis_node, dt, keep)
        if axis_node is None:
            along = set(v.axes or ())
        else:
            along = {self._axis_of(v, axis_node)}
        if "G" in along and not self._declared \
                and self._collective_depth == 0 and self._call_stack:
            self.flag(
                self._call_stack[-1], "PS001",
                "reduction over the G (group/shard) axis outside a "
                "declared collective — at mesh level this mixes data "
                "across independent raft groups (reduce over a trailing "
                "dim, or produce a collective=declared struct like "
                "FleetStats)")
        if v.part == "G" and out.axes and "G" in out.axes:
            out = replace(out, part="G")
        return out

    # -- PS003: unannotated replicated x split combination ---------------
    def _broadcast(self, node: ast.AST, a: ct.AVal, b: ct.AVal,
                   what: str) -> tuple[str, ...] | None:
        for r_, g_ in ((a, b), (b, a)):
            if (r_.part == "rep" and not r_.bcast
                    and r_.axes not in (None, ())
                    and (g_.part == "G"
                         or (g_.axes is not None and "G" in g_.axes))):
                self.flag(
                    node, "PS003",
                    f"replicated value combined with G-split data in "
                    f"{what} without an explicit broadcast annotation "
                    "(expand / broadcast_to / unsqueeze / [None] on the "
                    "replicated operand makes the fan-out intentional)")
        return super()._broadcast(node, a, b, what)

    # -- partition propagation -------------------------------------------
    def binop(self, node: ast.AST, a: ct.AVal, b: ct.AVal,
              op: ast.operator) -> ct.AVal:
        r = super().binop(node, a, b, op)
        if a.part == "G" or b.part == "G":
            r = replace(r, part="G")
        elif a.part == "rep" and b.part == "rep":
            r = replace(r, part="rep")
        return r

    def eval_Attribute(self, node: ast.Attribute) -> ct.AVal:
        v = super().eval_Attribute(node)
        recv = self.eval(node.value)
        if recv.cls is not None:
            fc = self.ctx.field(recv.cls, node.attr)
            if fc is not None and fc.part is not None:
                v = replace(v, part="G" if fc.part == "G" else "rep")
        return v

    @staticmethod
    def _kv_aval(name: str) -> ct.AVal:
        axes, dtype = DEVICE_KV_BINDINGS[name]
        return ct.AVal(axes=axes, dtype=dtype, part="G")

    def eval_Subscript(self, node: ast.Subscript) -> ct.AVal:
        if self.relpath == DEVICE_KV_FILE \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "sm_state" \
                and isinstance(node.slice, ast.Constant) \
                and node.slice.value in DEVICE_KV_BINDINGS:
            return self._kv_aval(node.slice.value)
        r = super().eval_Subscript(node)
        base = self.eval(node.value)
        if base.cls is None and base.tup is None:
            items = (node.slice.elts if isinstance(node.slice, ast.Tuple)
                     else [node.slice])
            newaxis = any(isinstance(i, ast.Constant) and i.value is None
                          for i in items)
            if base.part == "rep":
                # x[None] IS the PS003 annotation
                r = replace(r, part="rep", bcast=base.bcast or newaxis)
            elif base.part == "G" and r.axes is not None and "G" in r.axes:
                r = replace(r, part="G")
        return r

    def _call_torch(self, node: ast.Call, fname: str,
                    recv: ct.AVal | None = None) -> ct.AVal | None:
        res = super()._call_torch(node, fname, recv)
        # expand/broadcast_to/unsqueeze IS the PS003 annotation
        if fname in ("broadcast_to", "expand", "expand_as", "unsqueeze") \
                and res is not None:
            v = recv if recv is not None else (
                self.eval(node.args[0]) if node.args else ct.UNKNOWN)
            if v.part is not None:
                res = replace(res, part=v.part, bcast=(v.part == "rep"))
        return res


def _interpret(ctx: ct._Ctx, mods: list[ts._Module], root: str) -> None:
    """Interpret EVERY function of the analysis modules (host helpers
    included — a stray cross-G reduce in a utility is just as wrong)."""
    _, graph = ts.traced_functions(mods)
    funcs = {(m.path, name): (m, fn) for m in mods
             for name, fn in m.funcs.items()}
    ctx.funcs = {name: v for (_p, name), v in funcs.items()}
    for key in ct._topo_order(set(funcs), graph):
        mod, fn = funcs[key]
        interp = _PartInterp(ctx, rel(root, mod.path))
        interp._declared = _declares_collective(ctx, fn)
        interp.bind_params(fn)
        interp.exec_body(fn.body)
        ctx.summaries[key[1]] = ct._summary_join(interp.returns)


# ---------------------------------------------------------------------------
# PS006: implicit device->host syncs in hot host paths
# ---------------------------------------------------------------------------


def _host_sync_check(mods: list[ts._Module],
                         capture_mods: list[ts._Module],
                         root: str) -> list[Finding]:
    """PS006 over every host-side function of ``mods`` (those no
    compiled entry of ``capture_mods`` captures), their tensor
    parameters device values."""
    traced, _ = ts.traced_functions(capture_mods)
    findings: list[Finding] = []
    for m in mods:
        relpath = rel(root, m.path)
        for node in m.tree.body:
            defs = [node] if isinstance(node, ast.FunctionDef) else (
                [s for s in node.body if isinstance(s, ast.FunctionDef)]
                if isinstance(node, ast.ClassDef) else [])
            for fn in defs:
                if (m.path, fn.name) in traced:
                    continue
                params = {a.arg for a in fn.args.posonlyargs + fn.args.args
                          + fn.args.kwonlyargs} & _DEVICE_PARAMS
                findings.extend(_scan_hot_fn(fn, relpath, params))
    return findings


def _scan_hot_fn(fn: ast.FunctionDef, relpath: str,
                 device_params: set[str] = frozenset()) -> list[Finding]:
    findings: list[Finding] = []
    tainted: set[str] = set(device_params)
    seen: set[tuple[int, str]] = set()

    def is_device(node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in tainted
        if isinstance(node, ast.Attribute):
            if node.attr in ts.META_ATTRS:
                return False
            chain = ct._attr_chain(node)
            if len(chain) >= 2 and chain[0] == "self" \
                    and chain[1] in _DEVICE_SELF_ATTRS:
                return True
            return is_device(node.value)
        if isinstance(node, ast.Subscript):
            return is_device(node.value)
        if isinstance(node, ast.Call):
            c = ct._attr_chain(node.func)
            return bool(c) and c[-1] in _DEVICE_PRODUCERS
        return False

    def emit(node: ast.AST, msg: str) -> None:
        key = (getattr(node, "lineno", 0), msg[:40])
        if key not in seen:
            seen.add(key)
            findings.append(Finding(
                PASS, relpath, getattr(node, "lineno", 0), "PS006",
                msg + f" in hot host path {fn.name}() — this blocks "
                "on the device and stalls every lane (move it to a "
                "designated sync point like _process_outputs)"))

    def check_call(call: ast.Call) -> None:
        func = call.func
        if isinstance(func, ast.Name) \
                and func.id in ("int", "bool", "float") \
                and call.args and is_device(call.args[0]):
            emit(call, f"{func.id}() on a device value")
            return
        if not isinstance(func, ast.Attribute):
            return
        chain = ct._attr_chain(func)
        attr = func.attr
        if attr in ("item", "tolist", "cpu", "numpy") \
                and is_device(func.value):
            emit(call, f".{attr}() on a device value")
        elif attr in ("asarray", "array") and chain \
                and chain[0] in ("np", "numpy") \
                and call.args and is_device(call.args[0]):
            emit(call, f"np.{attr}() on a device value")
        elif attr == "synchronize":
            emit(call, f"{'.'.join(chain)}()")

    def check_exprs(st: ast.AST) -> None:
        for node in ast.walk(st):
            if isinstance(node, ast.Call):
                check_call(node)

    def taint(tgt: ast.AST) -> None:
        if isinstance(tgt, ast.Name):
            tainted.add(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                taint(el)
        elif isinstance(tgt, ast.Starred):
            taint(tgt.value)

    def visit(body: list[ast.stmt]) -> None:
        for st in body:
            if isinstance(st, (ast.If, ast.While)):
                check_exprs(st.test)
                if isinstance(st.test,
                              (ast.Name, ast.Attribute, ast.Subscript)) \
                        and is_device(st.test):
                    emit(st.test, "implicit bool() of a device value "
                                  "in a branch condition")
                visit(st.body)
                visit(st.orelse)
            elif isinstance(st, ast.For):
                check_exprs(st.iter)
                visit(st.body)
                visit(st.orelse)
            elif isinstance(st, ast.With):
                for it in st.items:
                    check_exprs(it.context_expr)
                visit(st.body)
            elif isinstance(st, ast.Try):
                visit(st.body)
                for h in st.handlers:
                    visit(h.body)
                visit(st.orelse)
                visit(st.finalbody)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            else:
                check_exprs(st)
                if isinstance(st, ast.Assign) and is_device(st.value):
                    for t in st.targets:
                        taint(t)
                elif isinstance(st, ast.AnnAssign) and st.value is not None \
                        and is_device(st.value):
                    taint(st.target)

    visit(fn.body)
    return findings


# ---------------------------------------------------------------------------
# PS002 [dynamic]: every split piece on its position's device
# ---------------------------------------------------------------------------

#: the structs a serve step leaves split, as in the reference's check
CHECKED = ("ShardState", "Inbox", "StepOutput")


def placement_check(cluster, **trees) -> list[Finding]:
    """PS002 findings for the split trees ``trees`` (class name ->
    ``graphs.Split`` of that struct, e.g. ``ShardState=state``) of
    ``cluster``; [] when every ``part=G`` leaf of every position lies on
    the position's device with ``n_local`` rows."""
    from dragonboat_tpu_torch import graphs
    from dragonboat_tpu_torch.core import kstate

    contracts = parse_contracts(kstate.CONTRACTS, KSTATE_FILE)
    findings: list[Finding] = []

    def bad(msg: str) -> None:
        findings.append(Finding(PASS, KSTATE_FILE, 1, "PS002",
                                f"[dynamic] {msg}"))

    devices = cluster.devices
    if devices is None:
        bad("the cluster is not split: its positions share one [G] "
            "layout, there is no per-position placement to check")
        return findings
    for cls, tree in trees.items():
        if not isinstance(tree, graphs.Split) \
                or len(tree) != cluster.positions:
            bad(f"{cls} is not split into {cluster.positions} per-position "
                f"pieces ({type(tree).__name__})")
            continue
        for p, (piece, dev) in enumerate(zip(tree, devices)):
            ig, ir = divmod(p, cluster.replicas)
            for fname, fc in contracts.get(cls, {}).items():
                val = getattr(piece, fname, None)
                if val is None or fc.part != "G":
                    continue
                if val.device != dev:
                    bad(f"{cls}.{fname} of position ({ig}, {ir}) is on "
                        f"{val.device}, its position's device is {dev}")
                if val.ndim == 0 or val.shape[0] != cluster.n_local:
                    bad(f"{cls}.{fname} of position ({ig}, {ir}) has "
                        f"shape {tuple(val.shape)}, want {cluster.n_local} "
                        "leading rows")
    return findings


def dynamic_check(device=None, devices=None) -> list[Finding]:
    """One serve step of a small split mesh, then ``placement_check``:
    the reference's 2-position ``(1, 2)`` geometry, its positions on
    ``devices`` (default: both on ``device``, the CUDA card unless the
    caller names another)."""
    import numpy as np

    from dragonboat_tpu_torch.core.params import KernelParams
    from dragonboat_tpu_torch.devices import resolve_device
    from dragonboat_tpu_torch.parallel import ici

    dev = resolve_device(device)
    # small but legal: router.route needs inbox_cap >= 5 * (R - 1)
    kp = KernelParams(num_peers=2, log_cap=8, inbox_cap=8, msg_entries=2,
                      proposal_cap=2, readindex_cap=4)
    cluster, state, box = ici.make_ici_cluster(
        kp, 1, 2, num_groups=2, devices=devices or [dev, dev])
    cut = np.zeros((cluster.total_rows, kp.num_peers), np.bool_)
    state, box, out = ici.ici_serve_step(
        cluster, state, box, ici.self_driving_input(kp, state),
        cluster.shard(cut))
    return placement_check(cluster, ShardState=state, Inbox=box,
                           StepOutput=out)


# ---------------------------------------------------------------------------
# pass entry point
# ---------------------------------------------------------------------------


def run(root: str, files: list[str] | None = None, dynamic: bool = True,
        device=None) -> list[Finding]:
    """The static walk (PS001, PS003, PS006); ``dynamic`` adds the
    placement check on ``device`` (default mode only)."""
    default_mode = files is None
    if default_mode:
        def paths(fs):
            return [os.path.join(root, f) for f in fs]
        contract_paths = paths(DEFAULT_CONTRACT_FILES)
        const_paths = paths(DEFAULT_CONST_FILES)
        analysis_paths = paths(DEFAULT_ANALYSIS_FILES)
        parallel_paths = paths(DEFAULT_PARALLEL_FILES)
        capture_paths = paths(ts.DEFAULT_MODULES)
    else:
        contract_paths = const_paths = analysis_paths = parallel_paths = \
            capture_paths = list(files)

    ctx = ct._Ctx()
    trees: dict[str, ast.Module] = {}

    def tree_of(p: str) -> ast.Module | None:
        if p not in trees:
            if not os.path.exists(p):
                return None
            with open(p, encoding="utf-8") as f:
                trees[p] = ast.parse(f.read(), filename=p)
        return trees.get(p)

    for p in contract_paths:
        t = tree_of(p)
        if t is not None:
            ct._collect_contracts(ctx, t, rel(root, p))
    _relabel_collect_findings(ctx)
    for p in const_paths + analysis_paths:
        t = tree_of(p)
        if t is not None:
            ct._collect_consts(ctx, t)

    analysis_mods = [ts._Module(p, trees[p]) for p in analysis_paths
                     if tree_of(p) is not None]
    _interpret(ctx, analysis_mods, root)
    findings = list(ctx.findings)

    # host-side = captured by no compiled entry of the capture module set
    capture_mods = [ts._Module(p, trees[p]) for p in capture_paths
                    if tree_of(p) is not None]
    findings += _host_sync_check(
        [m for m in capture_mods if m.path in parallel_paths], capture_mods,
        root)
    if default_mode and dynamic:
        findings += dynamic_check(device)
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))
