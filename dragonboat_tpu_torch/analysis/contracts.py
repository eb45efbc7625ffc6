"""Kernel contract analyzer: declared vs actual shape and dtype, donation.

The port's form of the reference's pass.  The batched Raft kernel's whole
correctness story is that per-shard state is fixed-width i32/bool lanes
advanced in lockstep.  This pass holds the field comments of
``core/kstate.py`` (the ``CONTRACTS`` literals there, in
``core/kernel.py``, ``core/health.py`` and ``core/invariants.py``; grammar
documented at the kstate declaration) to the tensors the port builds:

- KC007  a ``CONTRACTS`` table that is not a pure literal or a field
         contract that does not parse; and, at runtime, every declared
         field against the tensor the port actually builds
         (``init_state`` / ``empty_inbox`` / ``empty_input``, the
         ``ShardState`` and ``StepOutput`` after one real ``kernel.step``,
         and the health and invariant reductions' reports and digests
         after one pass): a missing or undeclared field, a shape that
         differs from the declared axes, a dtype that differs from the
         declared one (an int64 where i32 is declared is a finding: the
         port has no x64 switch to blame), on the device the caller names
- KC008  the ``DONATION`` declaration of the port's ``core/kstate.py``
         against the ``donate_argnums`` of the module-level
         ``graphs.compiled(...)`` assignments in ``DONATION_MODULES``,
         both directions

What has no torch form, and is left out: the reference's abstract
interpreter over ``core/kernel.py`` (KC001 named-axis broadcasts, KC002
silent dtype conversions, KC003 bool/i32 comparisons, KC004 unmasked ring
indices, KC005 out-of-domain constant stores, KC006 store shapes) reads
``jnp`` idioms in every function reachable from a ``jit``/``vmap``/``scan``
seed through the ``tracer_safety`` walk, and the port's kernel has neither
JAX tracers nor those seeds; the runtime leg's ``jax.eval_shape`` becomes a
real step on small tensors.

Analyzing a custom file set (``run(root, files=[...])``, used by the
fixture tests) reads ``CONTRACTS`` from those files and skips the runtime
diff and the donation cross-check.
"""

from __future__ import annotations

import ast
import os

from dragonboat_tpu_torch.analysis.common import (
    FieldContract,
    Finding,
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

# modules whose ``graphs.compiled(..., donate_argnums=...)`` assignments
# the KC008 cross-check scans: kernel.py (the default module of a DONATION
# entry) plus every module a DONATION ``module`` key may name
DONATION_MODULES = (
    "dragonboat_tpu_torch/core/kernel.py",
    "dragonboat_tpu_torch/parallel/ici.py",
    "dragonboat_tpu_torch/core/router.py",
)

#: every file this pass reads
SCOPE = CONTRACT_FILES + DONATION_MODULES[1:]

_DTYPE_NAMES = {
    "int32": "i32", "uint32": "u32", "float32": "f32", "bool": "bool",
}


class _Ctx:
    """Shared analysis context: contracts and their source lines."""

    def __init__(self) -> None:
        self.contracts: dict[str, dict[str, FieldContract]] = {}
        self.contract_lines: dict[tuple[str, str], tuple[str, int]] = {}
        self.findings: list[Finding] = []


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
    """Static KC007/KC008; ``dynamic`` adds the runtime KC007 diff on
    ``device`` (default mode only)."""
    default_mode = files is None
    if default_mode:
        contract_paths = [os.path.join(root, cf) for cf in CONTRACT_FILES]
    else:
        contract_paths = list(files)

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
