"""Transfer-boundary analyzer: the device<->host seam as a checked
contract.

The port's form of the reference's pass, over the port's engine layer
and its ``engine/dispatch.py`` literals (kept as the reference's).  What
reads a JAX idiom in the reference reads the port's counterpart here:

- TB004's uploads are the port's staging calls: ``_upload`` /
  ``_upload_into`` (``torch.from_numpy`` then ``.to(device)`` /
  ``copy_``) and ``torch.tensor`` / ``torch.as_tensor`` /
  ``torch.from_numpy`` given a ``device=``, outside every declared
  ledger site, every ``*.to_device`` builder and those helpers' own
  bodies;
- TB005's syncs add the torch forms: ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()`` and ``.synchronize()``;
- the entries' parameters are read off the function each
  ``graphs.compiled`` assignment compiles, and the telemetry reductions
  are the port's ``fleet_stats`` / ``fleet_health`` /
  ``check_invariants``;
- the dynamic leg steps the real seams at serial depth 0, serial depth 1
  (donated), the one-device mesh (every mesh position on the host's
  one device) and the split mesh (the reference's two-position mesh,
  each position's pieces on its own card, or both on the one device
  when the process sees one card), under
  ``capacity.METER.guard()``: on the card that is
  ``torch.cuda.set_sync_debug_mode("error")`` with the declared
  sanctioned scopes lifted to 0 for their extent, so an undeclared sync
  raises; on the CPU the guard counts.  The cache is keyed on
  ``torch.__version__``, the device type and the seam sources.

ROADMAP item 2 ("device-resident message fabric: zero host hops in the
commit path") needs an inventory before it can drive anything to zero:
which values cross the jit seam per step, in which direction, and how
many bytes they carry.  The partition pass's PS006 catches *implicit*
syncs in a handful of hot methods; nothing classifies the *sanctioned*
crossings, sizes them, or stops them from regrowing — the same gap
hlo-budget closed for op counts, closed here for transfers.

Source of truth is ``engine/dispatch.py``'s two machine-read literals:

- ``TRANSFER_LEDGER`` — per jit entry (``DISPATCH_ENTRIES`` plus the
  telemetry reductions), the device-resident operand classes, every
  host->device upload row and every device->host download row, each
  with the host qualname performing the crossing and the
  ``capacity.METER`` tag it counts under;
- ``SYNC_POINTS`` — the only engine-layer qualnames whose bodies may
  force a device value (``int()`` / ``.item()`` / ``np.asarray`` /
  ``block_until_ready``).

Every row is sized in closed form from the CONTRACTS grammar
(``capacity.bytes_for_contract`` — class names resolve through the
merged kstate/fleet/health/invariants tables, inline ``"[G, K] i32"``
strings directly), and the per-step up/down totals are gated against
``analysis/transfer_budget.json`` exactly like the hlo-budget gate.

Rules:

- TB001  undeclared crossing: a dispatch entry with no ledger section,
         an entry array parameter no resident/upload row covers, a
         ledger row whose site qualname does not exist in the engine
         layer, an unsizable row, or (dynamic) a METER tag observed
         live that no declaration carries
- TB002  per-step upload/download bytes exceed the seeded budget
- TB003  wide-field download outside the ``_LazyOut`` masked-fetch
         path: an unmasked download row carrying a [G, axis] field, or
         an eager ``np.asarray`` of a wide StepOutput field in engine
         code (the 42-field sweep the masked fetch deleted)
- TB004  upload not built through a staging builder: an ``_upload`` /
         ``_upload_into`` call, or a ``torch.tensor`` / ``as_tensor`` /
         ``from_numpy`` given a ``device=``, in the engine layer
         outside every declared ledger site and every ``*.to_device``
         builder
- TB005  device->host sync outside a declared ``SYNC_POINTS`` qualname
         (the engine-scope sharpening of PS006: the scan covers EVERY
         engine-layer function, not just the hot-path list)
- TB006  per-step transfer count growth: more per-step crossings than
         the ledger declares (static vs budget, and dynamic — the live
         METER counts diffed against the ledger after a guarded step
         loop at four geometries: serial depth-0, serial depth-1
         donated, the one-device mesh, the split mesh)

The dynamic leg drives the REAL seam objects (``SerialDispatch`` /
``MeshDispatch`` + the staging builders) under
``capacity.METER.guard()`` — on the card an undeclared sync raises, the
declared crossings' sanctioned scopes lifting the guard — while the tag
counters prove the declared crossings happen EXACTLY as often as the
ledger says.  Results are cached in ``.transfer_cache.json``.

The pass's artifact — ``build/transfer_ledger.json``, every crossing
with bytes and provenance — is literally ROADMAP item 2's work-list:
the rows it enumerates are the host hops the device-resident fabric
must delete, and this gate is what keeps them deleted.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os

from dragonboat_tpu_torch.analysis.common import (
    ContractError,
    Finding,
    parse_contract,
    rel,
)

PASS = "transfer"

DISPATCH_FILE = "dragonboat_tpu_torch/engine/dispatch.py"
BUDGET_FILE = "dragonboat_tpu_torch/analysis/transfer_budget.json"
CACHE_FILE = "dragonboat_tpu_torch/analysis/.transfer_cache.json"
LEDGER_ARTIFACT = "build/transfer_ledger.json"

#: the engine layer: every file whose code may touch the boundary
ENGINE_FILES = (
    "dragonboat_tpu_torch/engine/kernel_engine.py",
    "dragonboat_tpu_torch/engine/mesh_engine.py",
    "dragonboat_tpu_torch/engine/dispatch.py",
)
#: contract tables the sizing model merges
CONTRACT_FILES = (
    "dragonboat_tpu_torch/core/kstate.py",
    "dragonboat_tpu_torch/core/fleet.py",
    "dragonboat_tpu_torch/core/health.py",
    "dragonboat_tpu_torch/core/invariants.py",
)

#: every file any leg reads
SCOPE = ENGINE_FILES + CONTRACT_FILES + (
    "dragonboat_tpu_torch/core/kernel.py",
    "dragonboat_tpu_torch/core/params.py",
    "dragonboat_tpu_torch/parallel/ici.py",
    "dragonboat_tpu_torch/capacity.py",
    BUDGET_FILE,
)

#: sources hashed into the dynamic-leg cache key (an edit to any seam
#: source, or a torch upgrade, invalidates the cached live diff)
CACHE_SOURCES = SCOPE[:-1] + (
    "dragonboat_tpu_torch/bench_loop.py",
    "dragonboat_tpu_torch/analysis/transfer.py",
)

#: telemetry reductions classified alongside DISPATCH_ENTRIES: the
#: reductions whose signatures the TB001 parameter check reads
TELEMETRY_ENTRIES = {
    "fleet_stats": ("dragonboat_tpu_torch/core/fleet.py", "fleet_stats"),
    "fleet_health": ("dragonboat_tpu_torch/core/health.py", "fleet_health"),
    "check_invariants": ("dragonboat_tpu_torch/core/invariants.py",
                         "check_invariants"),
}

#: entry parameters that are static/jit-metadata, never array crossings
STATIC_PARAMS = frozenset({
    "kp", "cluster", "cl", "replicas", "thresholds", "k",
})

#: conventional parameter name -> contract class (the reference's
#: partition pass's mesh-level bindings; that pass has no torch form)
PARAM_CLASSES = {
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
#: engine attributes holding device trees
_DEVICE_SELF_ATTRS = frozenset({"state", "box", "_pending_dev", "_cut_dev"})
#: calls whose results are device values
_DEVICE_PRODUCERS = frozenset({
    "kernel_step", "kernel_step_donated", "step", "step_donated",
    "ici_serve_step", "ici_cluster_step", "fleet_stats",
    "fleet_health", "shard_row", "serve_step", "serve_step_donated",
    "cluster_step", "cluster_step_donated", "dispatch",
    "output_row_flags", "to_device", "shard", "_upload", "_kernel_call",
})

#: the port's upload helpers: a call of one is an upload; their own
#: bodies are the staging primitive
_UPLOAD_HELPERS = frozenset({"_upload", "_upload_into"})

#: engine-held device trees beyond the partition pass's set (the lazy
#: output view and the telemetry digest carries)
_SELF_ATTRS = frozenset(_DEVICE_SELF_ATTRS) | {
    "_out", "_health_digest", "_inv_digest",
}

#: geometry the budget/ledger sizes at when no budget file declares one
#: (the bench sweet spot, bench_loop.bench_params(3) + 1024 groups)
DEFAULT_CONFIG = {
    "num_groups": 1024,
    "num_peers": 3,
    "log_cap": 128,
    "inbox_cap": 10,
    "msg_entries": 32,
    "proposal_cap": 32,
    "readindex_cap": 4,
    "inline_payloads": False,
    "top_k": 8,
}

#: host-side axis extents (histogram widths, report rows) — resolved
#: live from fleet/health/invariants when importable, else this frozen
#: snapshot keeps fixture runs sizable
_AXIS_ENV_FALLBACK = {
    "ROLES": 6, "LAGB": 9, "INBOXB": 6,
    "C": 5, "TOPK": 8, "RW": 13, "NI": 7,
}

#: dynamic-leg step count per geometry
_LIVE_STEPS = 5


class _Geom:
    """Attribute view of a config dict (stands in for KernelParams so
    fixture geometries never trip its power-of-two asserts)."""

    def __init__(self, cfg: dict) -> None:
        for k, v in cfg.items():
            setattr(self, k, v)


# ---------------------------------------------------------------------------
# declaration + source loading
# ---------------------------------------------------------------------------

_DECL_NAMES = ("SYNC_POINTS", "TRANSFER_LEDGER", "DISPATCH_ENTRIES")


def _load_decl(root: str) -> tuple[dict, dict[str, int], list[Finding]]:
    """The dispatch transfer literals (+ line numbers + load findings)."""
    decl: dict = {"SYNC_POINTS": {}, "TRANSFER_LEDGER": {},
                  "DISPATCH_ENTRIES": {}}
    lines = {name: 1 for name in _DECL_NAMES}
    findings: list[Finding] = []
    path = os.path.join(root, DISPATCH_FILE)
    if not os.path.exists(path):
        findings.append(Finding(
            PASS, DISPATCH_FILE, 1, "TB001",
            "engine/dispatch.py is missing — the transfer contract "
            "(SYNC_POINTS / TRANSFER_LEDGER) has no home"))
        return decl, lines, findings
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    seen = set()
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if name not in _DECL_NAMES:
            continue
        lines[name] = node.lineno
        seen.add(name)
        try:
            decl[name] = ast.literal_eval(node.value)
        except (ValueError, SyntaxError):
            findings.append(Finding(
                PASS, DISPATCH_FILE, node.lineno, "TB001",
                f"{name} is not a pure literal — the transfer contract "
                "must be ast.literal_eval-parseable (no names, calls or "
                "comprehensions)"))
    for name in ("SYNC_POINTS", "TRANSFER_LEDGER"):
        if name not in seen:
            findings.append(Finding(
                PASS, DISPATCH_FILE, 1, "TB001",
                f"{name} literal missing from engine/dispatch.py — "
                "every boundary crossing must be declared there"))
    return decl, lines, findings


def _engine_paths(root: str, files: list[str] | None) -> list[str]:
    if files is None:
        return [os.path.join(root, f) for f in ENGINE_FILES]
    return [p if os.path.isabs(p) else os.path.join(root, p)
            for p in files if p.endswith(".py")]


def _parse(path: str) -> ast.Module | None:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), filename=path)


def _qual_funcs(tree: ast.Module) -> list[tuple[str, ast.FunctionDef]]:
    """(qualname, def) for every module-level function and every method;
    nested defs belong to their enclosing method's qualname."""
    out: list[tuple[str, ast.FunctionDef]] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, node))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((f"{node.name}.{sub.name}", sub))
    return out


def _attr_chain(node: ast.AST) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return list(reversed(parts))


# ---------------------------------------------------------------------------
# sizing: contract tables + closed-form bytes per row
# ---------------------------------------------------------------------------


def _collect_contracts(trees: dict[str, ast.Module],
                       findings: list[Finding]) -> dict:
    """Merged ``{cls: {field: FieldContract}}`` from every CONTRACTS
    literal in the given trees (kstate + the telemetry modules)."""
    table: dict = {}
    for relpath, tree in trees.items():
        for node in tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "CONTRACTS"):
                continue
            try:
                raw = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                continue  # the contracts pass owns that diagnosis
            for cls, fields in raw.items():
                parsed = {}
                for fname, spec in fields.items():
                    try:
                        parsed[fname] = parse_contract(
                            spec, f"{relpath}:{cls}.{fname}")
                    except ContractError as e:
                        findings.append(Finding(
                            PASS, relpath, node.lineno, "TB001",
                            f"unsizable contract {cls}.{fname}: {e}"))
                table.setdefault(cls, {}).update(parsed)
    return table


def _axis_env(cfg: dict) -> dict:
    """Host-side axis extents for the report/histogram classes."""
    try:
        from dragonboat_tpu_torch.core import fleet, health, invariants
        env = {
            "ROLES": len(fleet.ROLE_NAMES),
            "LAGB": len(fleet.bucket_labels(fleet.LAG_BUCKETS)),
            "INBOXB": len(fleet.bucket_labels(fleet.INBOX_BUCKETS)),
            "C": health.NUM_CLASSES,
            "TOPK": health.DEFAULT_TOP_K,
            "RW": health.ROW_WIDTH,
            "NI": invariants.NUM_INVARIANTS,
        }
    except ImportError:  # pragma: no cover - fixture environments
        env = dict(_AXIS_ENV_FALLBACK)
    env["TOPK"] = int(cfg.get("top_k", env["TOPK"]))
    return env


def _field_bytes(fc, kp, num_groups: int, env: dict) -> int:
    from dragonboat_tpu_torch import capacity as _capacity

    n = _capacity.DTYPE_BYTES[fc.dtype]
    for ax in fc.axes:
        if ax == "G":
            n *= int(num_groups)
        elif ax.isdigit():
            n *= int(ax)
        elif ax in _capacity.AXIS_PARAMS:
            n *= int(getattr(kp, _capacity.AXIS_PARAMS[ax]))
        elif ax in env:
            n *= int(env[ax])
        else:
            raise ValueError(f"axis {ax!r} has no extent")
    return n


def _value_bytes(value: str, contracts: dict, kp, num_groups: int,
                 env: dict) -> int | None:
    """Closed-form bytes of one ledger row value: a contract class name
    (sum of its materialized fields) or an inline contract string."""
    from dragonboat_tpu_torch import capacity as _capacity

    fields = contracts.get(value)
    if fields is not None:
        total = 0
        for fname, fc in fields.items():
            if fc.optional and not _capacity._optional_materialized(
                    value, fname, kp):
                continue
            try:
                total += _field_bytes(fc, kp, num_groups, env)
            except ValueError:
                return None
        return total
    try:
        return _capacity.bytes_for_contract(value, kp, num_groups,
                                            axis_extra=env)
    except (ValueError, ContractError):
        return None


def _ledger_rows(ledger: dict):
    """Every (entry, direction, row) in the ledger, ``_control``
    included (its rows carry an explicit ``dir``)."""
    for entry, section in ledger.items():
        if entry == "_control":
            for row in section:
                yield entry, row.get("dir", "up"), row
            continue
        for dirn in ("up", "down"):
            for row in section.get(dirn, ()):
                yield entry, dirn, row


def build_ledger(root: str, decl: dict | None = None,
                 cfg: dict | None = None,
                 contracts: dict | None = None) -> dict:
    """The sized transfer ledger: every declared crossing with closed-
    form bytes at ``cfg``'s geometry, plus the per-step profile totals
    the budget gates.  This is ROADMAP item 2's work-list artifact."""
    if decl is None:
        decl, _, _ = _load_decl(root)
    if cfg is None:
        cfg = _budget_config(root)
    kp, num_groups = _Geom(cfg), int(cfg["num_groups"])
    if contracts is None:
        trees = {}
        for f in CONTRACT_FILES:
            t = _parse(os.path.join(root, f))
            if t is not None:
                trees[f] = t
        contracts = _collect_contracts(trees, [])
    env = _axis_env(cfg)
    ledger = decl.get("TRANSFER_LEDGER", {})

    def size_row(row: dict) -> dict:
        out = dict(row)
        out["bytes"] = _value_bytes(row.get("value", ""), contracts, kp,
                                    num_groups, env)
        return out

    entries: dict = {}
    control: list = []
    for name, section in ledger.items():
        if name == "_control":
            control = [size_row(r) for r in section]
            continue
        entries[name] = {
            "resident": list(section.get("resident", ())),
            "up": [size_row(r) for r in section.get("up", ())],
            "down": [size_row(r) for r in section.get("down", ())],
        }
    return {
        "config": dict(cfg),
        "entries": entries,
        "control": control,
        "per_step": {
            "serial": _profile(entries.get("step_donated", {})),
            "mesh": _profile(entries.get("serve_step_donated", {})),
        },
        "provenance": {
            "dispatch_file": DISPATCH_FILE,
            "sized_by": "dragonboat_tpu_torch/analysis/transfer.py "
                        "(capacity.bytes_for_contract)",
        },
    }


def _profile(section: dict) -> dict:
    """Per-step totals of one entry's sized rows (per_step rows only —
    masked/cached rows are off the every-step critical path)."""
    prof = {"up_bytes": 0, "down_bytes": 0,
            "up_crossings": 0, "down_crossings": 0}
    for dirn in ("up", "down"):
        for row in section.get(dirn, ()):
            if not row.get("per_step"):
                continue
            prof[f"{dirn}_crossings"] += 1
            prof[f"{dirn}_bytes"] += int(row.get("bytes") or 0)
    return prof


def emit_ledger(root: str, out_path: str | None = None) -> str:
    """Write ``build/transfer_ledger.json``; returns the path."""
    path = out_path or os.path.join(root, LEDGER_ARTIFACT)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(build_ledger(root), f, indent=2, sort_keys=True)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# TB001: every crossing declared, every declaration real
# ---------------------------------------------------------------------------


def _entry_params(root: str, module: str, func: str
                  ) -> list[str] | None:
    """The parameters of ``func``, or of the function a module-level
    ``func = graphs.compiled(fn, ...)`` assignment compiles."""
    tree = _parse(os.path.join(root, module))
    if tree is None:
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == func \
                and isinstance(node.value, ast.Call) and node.value.args \
                and isinstance(node.value.args[0], ast.Name):
            func = node.value.args[0].id
            break
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func:
            a = node.args
            return [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    return None


def _check_entries(findings: list[Finding], root: str, decl: dict,
                   lines: dict, qualnames: set[str]) -> None:
    ledger = decl.get("TRANSFER_LEDGER", {})
    entries = dict(decl.get("DISPATCH_ENTRIES", {}))
    line = lines.get("TRANSFER_LEDGER", 1)

    known = {
        name: (spec.get("module", ""), spec.get("function", ""))
        for name, spec in entries.items()
    }
    known.update(TELEMETRY_ENTRIES)

    for name, (module, _func) in known.items():
        if name in ledger:
            continue
        if name not in entries \
                and not os.path.exists(os.path.join(root, module)):
            continue  # fixture tree without this telemetry module
        findings.append(Finding(
            PASS, DISPATCH_FILE, line, "TB001",
            f"jit entry {name!r} has no TRANSFER_LEDGER section — "
            "its boundary crossings are undeclared"))
    for name in ledger:
        if name != "_control" and name not in known:
            findings.append(Finding(
                PASS, DISPATCH_FILE, line, "TB001",
                f"TRANSFER_LEDGER section {name!r} matches no dispatch "
                "or telemetry entry — stale declaration"))

    # array parameters must be covered: device-resident, an upload row,
    # or static jit metadata
    for name, (module, func) in known.items():
        section = ledger.get(name)
        if section is None:
            continue
        params = _entry_params(root, module, func)
        if params is None:
            continue  # module absent (fixture tree) — nothing to check
        resident = set(section.get("resident", ()))
        up_params = {row.get("param") for row in section.get("up", ())}
        # the ledger names the reference's parameters (``inbox``); a port
        # function may name the same class otherwise (``_step``'s ``box``)
        up_classes = {PARAM_CLASSES.get(b, b) for b in up_params}
        param_classes = {PARAM_CLASSES.get(p, p) for p in params}
        for p in params:
            if p in STATIC_PARAMS or p in up_params \
                    or PARAM_CLASSES.get(p, p) in up_classes:
                continue
            if PARAM_CLASSES.get(p) in resident:
                continue
            findings.append(Finding(
                PASS, DISPATCH_FILE, line, "TB001",
                f"entry {name!r} parameter {p!r} ({module}:{func}) is "
                "neither declared device-resident nor covered by an "
                "upload row — an undeclared host->device crossing"))
        for row in section.get("up", ()):
            bound = row.get("param")
            if bound is not None and bound not in params \
                    and PARAM_CLASSES.get(bound, bound) not in param_classes:
                findings.append(Finding(
                    PASS, DISPATCH_FILE, line, "TB001",
                    f"entry {name!r} upload row binds parameter "
                    f"{bound!r} which {module}:{func} does not take"))

    # every row site (and sync point) must be a real engine qualname
    for entry, _dirn, row in _ledger_rows(ledger):
        site = row.get("site", "")
        if site not in qualnames:
            findings.append(Finding(
                PASS, DISPATCH_FILE, line, "TB001",
                f"ledger row for {entry!r} names site {site!r} which "
                "matches no engine-layer function — stale declaration"))
    sp_line = lines.get("SYNC_POINTS", 1)
    ledger_tags = {row.get("tag") for _e, _d, row in _ledger_rows(ledger)}
    for qual, spec in decl.get("SYNC_POINTS", {}).items():
        if qual not in qualnames:
            findings.append(Finding(
                PASS, DISPATCH_FILE, sp_line, "TB001",
                f"SYNC_POINTS entry {qual!r} matches no engine-layer "
                "function — stale declaration"))
        if spec.get("tag") not in ledger_tags:
            findings.append(Finding(
                PASS, DISPATCH_FILE, sp_line, "TB001",
                f"SYNC_POINTS entry {qual!r} tag {spec.get('tag')!r} "
                "appears on no TRANSFER_LEDGER row — the sync's "
                "crossing is unsized"))


def _check_sizing(findings: list[Finding], lines: dict,
                  sized: dict) -> None:
    line = lines.get("TRANSFER_LEDGER", 1)
    rows = [(e, r) for e, s in sized["entries"].items()
            for d in ("up", "down") for r in s[d]]
    rows += [("_control", r) for r in sized["control"]]
    for entry, row in rows:
        if row.get("bytes") is None:
            findings.append(Finding(
                PASS, DISPATCH_FILE, line, "TB001",
                f"ledger row for {entry!r} value {row.get('value')!r} "
                "cannot be sized — not a contract class or a parseable "
                "contract string with known axes"))


# ---------------------------------------------------------------------------
# TB003: wide downloads stay masked
# ---------------------------------------------------------------------------


def _is_wide(value: str, contracts: dict) -> bool:
    """A value is wide when any field pairs the G axis with a symbolic
    kernel axis (numeric literals like the [G, 8] flag matrix are the
    deliberate narrow fetches)."""
    from dragonboat_tpu_torch import capacity as _capacity

    def wide_axes(axes) -> bool:
        return ("G" in axes
                and any(ax in _capacity.AXIS_PARAMS for ax in axes))

    fields = contracts.get(value)
    if fields is not None:
        return any(wide_axes(fc.axes) for fc in fields.values())
    try:
        return wide_axes(parse_contract(value, "transfer").axes)
    except ContractError:
        return False


def _wide_out_fields(contracts: dict) -> frozenset:
    from dragonboat_tpu_torch import capacity as _capacity

    return frozenset(
        fname for fname, fc in contracts.get("StepOutput", {}).items()
        if "G" in fc.axes
        and any(ax in _capacity.AXIS_PARAMS for ax in fc.axes))


def _check_masked(findings: list[Finding], decl: dict, lines: dict,
                  contracts: dict) -> None:
    line = lines.get("TRANSFER_LEDGER", 1)
    for entry, dirn, row in _ledger_rows(decl.get("TRANSFER_LEDGER", {})):
        if dirn != "down" or row.get("masked"):
            continue
        if _is_wide(row.get("value", ""), contracts):
            findings.append(Finding(
                PASS, DISPATCH_FILE, line, "TB003",
                f"ledger row for {entry!r} downloads wide value "
                f"{row.get('value')!r} unmasked — [G, axis] fetches "
                "must ride the _LazyOut masked path (declare "
                "masked=True and gate on the activity flags)"))


def _tb003_ast(findings: list[Finding], engine_trees: dict,
               sync_points: dict, contracts: dict) -> None:
    wide = _wide_out_fields(contracts)
    if not wide:
        return
    allowed = set(sync_points) | {"_LazyOut.__getitem__"}
    for relpath, tree in engine_trees.items():
        for qual, fn in _qual_funcs(tree):
            if qual in allowed:
                continue
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("asarray", "array")
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in ("np", "numpy")
                        and node.args
                        and isinstance(node.args[0], ast.Attribute)
                        and node.args[0].attr in wide):
                    continue
                findings.append(Finding(
                    PASS, relpath, node.lineno, "TB003",
                    f"eager np.{node.func.attr} of wide StepOutput "
                    f"field .{node.args[0].attr} in {qual}() — the "
                    "whole [G, axis] column crosses the boundary; "
                    "fetch it through the _LazyOut masked path"))


# ---------------------------------------------------------------------------
# TB004: uploads go through staging builders
# ---------------------------------------------------------------------------


def _check_staging(findings: list[Finding], engine_trees: dict,
                   ledger_sites: set[str]) -> None:
    for relpath, tree in engine_trees.items():
        for qual, fn in _qual_funcs(tree):
            if qual in ledger_sites or qual in _UPLOAD_HELPERS \
                    or qual.rsplit(".", 1)[-1] == "to_device":
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func)
                if not chain:
                    continue
                staging = (
                    chain == [chain[-1]] and chain[-1] in _UPLOAD_HELPERS
                    or (chain[0] == "torch"
                        and chain[-1] in ("tensor", "as_tensor",
                                          "from_numpy")
                        and any(k.arg == "device" for k in node.keywords))
                )
                if staging:
                    findings.append(Finding(
                        PASS, relpath, node.lineno, "TB004",
                        f"host->device upload ({'.'.join(chain)}) in "
                        f"{qual}() which is neither a *.to_device "
                        "staging builder nor a declared "
                        "TRANSFER_LEDGER site — undeclared uploads "
                        "regrow the host hop the ledger exists to "
                        "delete"))


# ---------------------------------------------------------------------------
# TB005: syncs only at declared SYNC_POINTS (PS006, engine-wide)
# ---------------------------------------------------------------------------


def _scan_syncs(qual: str, fn: ast.FunctionDef, relpath: str
                ) -> list[Finding]:
    """The partition pass's taint walk, widened to the engine-held
    device trees and run over EVERY engine function."""
    findings: list[Finding] = []
    tainted: set[str] = set()
    seen: set[tuple[int, str]] = set()

    def is_device(node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in tainted
        if isinstance(node, ast.Attribute):
            chain = _attr_chain(node)
            if len(chain) >= 2 and chain[0] == "self" \
                    and chain[1] in _SELF_ATTRS:
                return True
            return is_device(node.value)
        if isinstance(node, ast.Subscript):
            return is_device(node.value)
        if isinstance(node, ast.Call):
            c = _attr_chain(node.func)
            return bool(c) and c[-1] in _DEVICE_PRODUCERS
        return False

    def emit(node: ast.AST, msg: str) -> None:
        key = (getattr(node, "lineno", 0), msg[:40])
        if key in seen:
            return
        seen.add(key)
        findings.append(Finding(
            PASS, relpath, getattr(node, "lineno", 0), "TB005",
            msg + f" in {qual}() which is not a declared SYNC_POINTS "
            "qualname — an implicit device->host sync outside the "
            "reviewed seam (declare it in engine/dispatch.py "
            "SYNC_POINTS with a METER tag, or move the read to one)"))

    def check_call(call: ast.Call) -> None:
        func = call.func
        if isinstance(func, ast.Name) \
                and func.id in ("int", "bool", "float") \
                and call.args and is_device(call.args[0]):
            emit(call, f"{func.id}() on a device value")
            return
        if not isinstance(func, ast.Attribute):
            return
        chain = _attr_chain(func)
        attr = func.attr
        if attr in ("item", "tolist") and is_device(func.value):
            emit(call, f".{attr}() on a device value")
        elif attr in ("asarray", "array") and chain \
                and chain[0] in ("np", "numpy") \
                and call.args and is_device(call.args[0]):
            emit(call, f"np.{attr}() on a device value")
        elif attr in ("cpu", "numpy") and is_device(func.value):
            emit(call, f".{attr}() on a device value")
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
                visit(st.body)
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


def _check_syncs(findings: list[Finding], engine_trees: dict,
                 sync_points: dict) -> None:
    for relpath, tree in engine_trees.items():
        for qual, fn in _qual_funcs(tree):
            if qual in sync_points:
                continue
            findings.extend(_scan_syncs(qual, fn, relpath))


# ---------------------------------------------------------------------------
# TB002 / TB006: the per-step budget gate
# ---------------------------------------------------------------------------


def _budget_config(root: str) -> dict:
    path = os.path.join(root, BUDGET_FILE)
    cfg = dict(DEFAULT_CONFIG)
    if os.path.exists(path):
        try:
            with open(path, encoding="utf-8") as f:
                cfg.update(json.load(f).get("config", {}))
        except (OSError, ValueError):
            pass  # the gate below reports the unreadable file
    return cfg


def _check_budget(findings: list[Finding], root: str, sized: dict,
                  default_mode: bool) -> None:
    path = os.path.join(root, BUDGET_FILE)
    relpath = BUDGET_FILE
    if not os.path.exists(path):
        if default_mode:
            findings.append(Finding(
                PASS, relpath, 1, "TB002",
                "transfer budget file missing — run transfer.reseed(root) "
                "to seed it at the measured "
                "crossings"))
        return
    try:
        with open(path, encoding="utf-8") as f:
            budget = json.load(f).get("budget", {})
    except (OSError, ValueError):
        findings.append(Finding(
            PASS, relpath, 1, "TB002",
            "transfer budget file is unreadable JSON — re-seed it"))
        return
    for profile in ("serial", "mesh"):
        got = sized["per_step"].get(profile, {})
        lim = budget.get(profile, {})
        for key in ("up_bytes", "down_bytes"):
            limit = lim.get(f"{key}_per_step")
            if limit is not None and got.get(key, 0) > limit:
                findings.append(Finding(
                    PASS, relpath, 1, "TB002",
                    f"{profile} per-step {key.replace('_', ' ')} "
                    f"{got.get(key, 0)} exceeds budget {limit} — a "
                    "crossing grew or a new per-step row appeared; if "
                    "intended, transfer.reseed(root) and justify in "
                    "PERF.md"))
        for key in ("up_crossings", "down_crossings"):
            limit = lim.get(f"{key}_per_step")
            if limit is not None and got.get(key, 0) > limit:
                findings.append(Finding(
                    PASS, relpath, 1, "TB006",
                    f"{profile} declares {got.get(key, 0)} per-step "
                    f"{key.replace('_', ' ')} but the budget allows "
                    f"{limit} — per-step transfer count grew; every "
                    "added crossing is a host hop on the commit path"))


# ---------------------------------------------------------------------------
# dynamic leg: METER counts vs the ledger at four geometries
# ---------------------------------------------------------------------------


def _source_key(root: str, device) -> str:
    import torch

    h = hashlib.sha256()
    h.update(f"torch:{torch.__version__}:{device.type}".encode())
    for f in CACHE_SOURCES:
        p = os.path.join(root, f)
        h.update(f.encode())
        if os.path.exists(p):
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def _cache_load(path: str, key: str) -> list[Finding] | None:
    try:
        with open(path, encoding="utf-8") as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return None
    if cache.get("source_hash") != key:
        return None
    try:
        return [Finding(*entry) for entry in cache.get("findings", [])]
    except TypeError:
        return None


def _cache_save(path: str, key: str, findings: list[Finding]) -> None:
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({
                "source_hash": key,
                "findings": [[g.pass_name, g.path, g.line, g.rule,
                              g.message] for g in findings],
            }, f, indent=1)
    except OSError:
        pass  # cache is best-effort


def _declared_tags(decl: dict) -> set[str]:
    tags = {row.get("tag")
            for _e, _d, row in _ledger_rows(decl.get("TRANSFER_LEDGER", {}))}
    tags |= {spec.get("tag")
             for spec in decl.get("SYNC_POINTS", {}).values()}
    tags.discard(None)
    return tags


def _per_step_tag_counts(decl: dict, entry: str) -> dict:
    counts: dict = {}
    section = decl.get("TRANSFER_LEDGER", {}).get(entry, {})
    for dirn in ("up", "down"):
        for row in section.get(dirn, ()):
            if row.get("per_step"):
                tag = row.get("tag")
                counts[tag] = counts.get(tag, 0) + 1
    return counts


def _diff_counts(findings: list[Finding], geometry: str, entry: str,
                 decl: dict, counts: dict, steps: int,
                 extra_expected: dict | None = None) -> None:
    """Observed METER tags vs the ledger: exact equality for per-step
    tags, declared-tag membership for everything else."""
    declared = _declared_tags(decl)
    expected = {tag: n * steps
                for tag, n in _per_step_tag_counts(decl, entry).items()}
    expected.update(extra_expected or {})
    for tag, n in sorted(counts.items()):
        if tag not in declared:
            findings.append(Finding(
                PASS, DISPATCH_FILE, 1, "TB001",
                f"[dynamic/{geometry}] METER tag {tag!r} observed live "
                f"({n}x over {steps} steps) but declared on no "
                "TRANSFER_LEDGER row or SYNC_POINTS entry"))
    # symmetric diff: an observed-but-unexpected declared tag is a
    # count mismatch too (the ledger says 0 crossings for this entry)
    for tag in sorted(set(expected)
                      | (set(counts) & declared)):
        got, want = counts.get(tag, 0), expected.get(tag, 0)
        if got != want:
            findings.append(Finding(
                PASS, DISPATCH_FILE, 1, "TB006",
                f"[dynamic/{geometry}] tag {tag!r} crossed {got}x over "
                f"{steps} steps of entry {entry!r}; the ledger declares "
                f"exactly {want} — the static ledger and the live seam "
                "disagree"))


def live_transfer_check(root: str, decl: dict | None = None,
                        use_cache: bool = True,
                        device=None) -> list[Finding]:
    """Run the real dispatch seams under ``capacity.METER.guard()`` at
    four geometries (serial depth-0, serial depth-1 donated, the
    one-device mesh, the split mesh) on ``device`` (the CUDA card unless the caller names
    another) and diff the live METER counts against the declared ledger.
    On the card an undeclared sync raises inside the guard; the counters
    prove the sanctioned crossings happen exactly as declared."""
    from dragonboat_tpu_torch.devices import resolve_device

    device = resolve_device(device)
    if decl is None:
        decl, _, _ = _load_decl(root)
    cache_path = os.path.join(root, CACHE_FILE)
    key = _source_key(root, device)
    if use_cache:
        cached = _cache_load(cache_path, key)
        if cached is not None:
            return cached
    findings = _live_impl(root, decl, device)
    if use_cache:
        _cache_save(cache_path, key, findings)
    return findings


def _live_impl(root: str, decl: dict, device) -> list[Finding]:
    from dragonboat_tpu_torch import capacity as _capacity
    from dragonboat_tpu_torch.bench_loop import bench_params, make_cluster
    from dragonboat_tpu_torch.core.kernel import output_row_flags
    from dragonboat_tpu_torch.core.params import KernelParams
    from dragonboat_tpu_torch.engine import kernel_engine as _ke
    from dragonboat_tpu_torch.engine.dispatch import MeshDispatch, SerialDispatch
    from dragonboat_tpu_torch.parallel import ici

    findings: list[Finding] = []
    meter = _capacity.METER
    N = _LIVE_STEPS

    def drain(out) -> None:
        """Mirror the engine's per-step retire: the flags fetch (one
        sanctioned download) plus one masked _LazyOut field."""
        with meter.sanctioned("output_flags"):
            output_row_flags(out).cpu().numpy()
        _ = _ke._LazyOut(out)["s_commit"]

    # --- serial, depth 0 (non-donated oracle entry) --------------------
    kp = bench_params(3, device=device)
    state = make_cluster(kp, 2, 3, device=device)
    G = int(state.term.shape[0])
    disp = SerialDispatch(kp)
    inbox = _ke._InboxBuilder(G, kp.inbox_cap, kp.msg_entries, device=device)
    inp = _ke._InputBuilder(G, kp.proposal_cap, device=device)
    state, out = disp.dispatch(state, inbox, inp, donate=False)  # warm
    output_row_flags(out).cpu().numpy()
    meter.reset()
    with meter.guard():
        for _ in range(N):
            state, out = disp.dispatch(state, inbox, inp, donate=False)
            drain(out)
    _diff_counts(findings, "serial-depth0", "step", decl,
                 meter.counts(), N, {"lazy_out": N})

    # --- serial, depth 1 (donated entry, retire-before-dispatch) -------
    state = make_cluster(kp, 2, 3, device=device)
    state, out = disp.dispatch(state, inbox, inp, donate=True)  # warm
    output_row_flags(out).cpu().numpy()
    meter.reset()
    with meter.guard():
        for _ in range(N):
            drain(out)  # retire the previous step's outputs first
            state, out = disp.dispatch(state, inbox, inp, donate=True)
    # the drain above ran on the WARM step's output too: still N drains
    _diff_counts(findings, "serial-depth1", "step_donated", decl,
                 meter.counts(), N, {"lazy_out": N})

    # --- one-device mesh (device-resident inbox, cached cut mask) ------
    mkp = KernelParams(num_peers=2, log_cap=8, inbox_cap=8,
                       msg_entries=2, proposal_cap=2, readindex_cap=4)
    cluster, mstate, _box = ici.make_ici_cluster(mkp, 1, 2, num_groups=2,
                                                 device=device)
    mdisp = MeshDispatch(cluster)
    minp = _ke._InputBuilder(cluster.total_rows, mkp.proposal_cap,
                             device=device)
    mstate, mout = mdisp.dispatch(mstate, None, minp, donate=False)  # warm
    mdisp.pending()
    output_row_flags(mout).cpu().numpy()
    mdisp.set_cut(0, False)  # invalidate so cut_up restages under guard
    meter.reset()
    with meter.guard():
        for _ in range(N):
            mstate, mout = mdisp.dispatch(mstate, None, minp,
                                          donate=False)
            mdisp.pending()
            drain(mout)
    _diff_counts(findings, "mesh-1dev", "serve_step", decl,
                 meter.counts(), N, {"lazy_out": N, "cut_up": 1})

    # --- split mesh (each position's pieces on its own device: separate
    # cards when the process sees two, else both on the device) --------
    grid = ici.mesh_grid(2, device) or [device, device]
    scluster, sstate, _box = ici.make_ici_cluster(mkp, 1, 2, num_groups=2,
                                                  devices=grid)
    sdisp = MeshDispatch(scluster)
    sinp = _ke._InputBuilder(scluster.total_rows, mkp.proposal_cap,
                             device=scluster.device)

    def drain_split(out) -> None:
        """The engine's retire on a split step: the flags of every
        position in one sanctioned download, one masked field."""
        with meter.sanctioned("output_flags"):
            for o in out:
                output_row_flags(o).cpu().numpy()
        _ = _ke._LazyOut(out)["s_commit"]

    sstate, sout = sdisp.dispatch(sstate, None, sinp, donate=False)  # warm
    sdisp.pending()
    for o in sout:
        output_row_flags(o).cpu().numpy()
    sdisp.set_cut(0, False)
    meter.reset()
    with meter.guard():
        for _ in range(N):
            sstate, sout = sdisp.dispatch(sstate, None, sinp, donate=False)
            sdisp.pending()
            drain_split(sout)
    _diff_counts(findings, "mesh-split", "serve_step", decl,
                 meter.counts(), N, {"lazy_out": N, "cut_up": 1})
    return findings


# ---------------------------------------------------------------------------
# budget seeding
# ---------------------------------------------------------------------------


def reseed(root: str, budget_path: str | None = None,
           cfg: dict | None = None) -> dict:
    """Size the declared ledger at ``cfg`` and (re)write the budget at
    exactly the measured values; returns the new spec."""
    path = budget_path or os.path.join(root, BUDGET_FILE)
    cfg = dict(cfg or _budget_config(root))
    sized = build_ledger(root, cfg=cfg)
    spec = {
        "config": cfg,
        "budget": {
            profile: {f"{k}_per_step": v for k, v in prof.items()}
            for profile, prof in sized["per_step"].items()
        },
        "note": ("Per-step device<->host transfer budget, sized in "
                 "closed form from engine/dispatch.py TRANSFER_LEDGER "
                 "via the CONTRACTS grammar at the config geometry.  "
                 "serial = the step_donated profile, mesh = "
                 "serve_step_donated.  Update via "
                 "dragonboat_tpu_torch.analysis.transfer.reseed(root) "
                 "+ a PERF.md note justifying "
                 "the new crossings."),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=2, sort_keys=True)
        f.write("\n")
    return spec


# ---------------------------------------------------------------------------
# pass entry point
# ---------------------------------------------------------------------------


def run(root: str, files: list[str] | None = None,
        dynamic: bool = True, device=None,
        use_cache: bool = True) -> list[Finding]:
    default_mode = files is None
    decl, lines, findings = _load_decl(root)

    engine_trees: dict[str, ast.Module] = {}
    for p in _engine_paths(root, files):
        t = _parse(p)
        if t is not None:
            engine_trees[rel(root, p)] = t
    qualnames = {qual for tree in engine_trees.values()
                 for qual, _fn in _qual_funcs(tree)}

    contract_trees: dict[str, ast.Module] = {}
    for f in CONTRACT_FILES:
        t = _parse(os.path.join(root, f))
        if t is not None:
            contract_trees[f] = t
    if not default_mode:
        contract_trees.update(engine_trees)
    contracts = _collect_contracts(contract_trees, findings)

    _check_entries(findings, root, decl, lines, qualnames)
    _check_masked(findings, decl, lines, contracts)
    _tb003_ast(findings, engine_trees, decl.get("SYNC_POINTS", {}),
               contracts)
    ledger_sites = {row.get("site")
                    for _e, _d, row in
                    _ledger_rows(decl.get("TRANSFER_LEDGER", {}))}
    ledger_sites.discard(None)
    _check_staging(findings, engine_trees, ledger_sites)
    _check_syncs(findings, engine_trees, decl.get("SYNC_POINTS", {}))

    cfg = _budget_config(root)
    sized = build_ledger(root, decl=decl, cfg=cfg, contracts=contracts)
    _check_sizing(findings, lines, sized)
    _check_budget(findings, root, sized, default_mode)

    if default_mode and dynamic:
        findings += live_transfer_check(root, decl=decl,
                                        use_cache=use_cache, device=device)
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))


if __name__ == "__main__":  # pragma: no cover - CI artifact hook
    import sys

    target = emit_ledger(sys.argv[1] if len(sys.argv) > 1 else ".")
    print(f"transfer ledger written to {target}")
