"""Engine-unity pass: one step loop, one dispatch abstraction (EU001-6).

The port's form of the reference's pass, over the port's ``engine/``.
The port's engine keeps the reference's dispatch contract literals
(``engine/dispatch.py``) as they stand; three rules read JAX idioms the
port replaced, and read their counterparts here:

- EU003's donation parity reads a ``DONATION`` literal the port's
  ``core/kstate.py`` declares, mirroring the reference's and the graphs'
  donated positions (``donate_argnums`` on ``graphs.compiled``
  assignments: 1-3 on ``step_donated``, 2-4 on ``cluster_step_donated``
  and ``serve_step_donated``), rather than reading the graphs alone, so
  that the contracts pass's KC008 checks the same table;
- EU005's "through ``capacity.TRACKER.wrap``" reads the port's compiled
  entries: a ``graphs.compiled`` entry or a CUDA graph capture built in
  the engine layer outside the wrap is the blind spot (an engine binds
  forks of ``graphs.py``'s entries and registers each with the
  ``CompileTracker`` through the wrap);
- EU006's private-import rule names ``dragonboat_tpu_torch.core.*`` and
  ``dragonboat_tpu_torch.parallel.*``.

round 6 taught the single-device engine donation + depth-1 software
pipelining; the mesh engine's bespoke ``_kernel_call`` then drifted for
three rounds (no donation, no pipelined entry, its own telemetry
wiring) before the unified ``engine/dispatch.py`` seam deleted it.
This pass is the ratchet that keeps the repo there: the engine layer
declares its dispatch contract as pure literals in
``dragonboat_tpu_torch/engine/dispatch.py`` (``STEP_LOOP_OWNER``,
``STEP_LOOP_METHODS``, ``DISPATCH_SEAMS``, ``ENGINE_FEATURE_KNOBS``,
``ENGINE_FEATURE_CALLS``, ``DISPATCH_ENTRIES`` — parsed here with
``ast.literal_eval``, the kstate CONTRACTS idiom), and the rules hold
every engine path to it:

  EU001  second step-loop implementation: a subclass of the step-loop
         owner defines one of STEP_LOOP_METHODS (step_all,
         _stage_props, _process_outputs, ... even _kernel_call).
         Backends contribute a dispatch object via the _make_dispatch
         seam; they do not re-implement the loop.
  EU002  dispatch-feature drift: an ENGINE_FEATURE_KNOBS config
         attribute (pipeline_depth, fleet_stats_every, ...) or an
         ENGINE_FEATURE_CALLS call (the masked-output-fetch gate) is
         reachable from step_all on one concrete engine path but not
         another — or on none (dead knob).  Reachability is the
         self-call graph from step_all resolved per concrete class.
  EU003  donation parity: every DISPATCH_ENTRIES entry marked donated
         must carry donate_argnums in its defining module (the
         ``graphs.compiled`` assignment in the port) AND a
         kstate.DONATION declaration (composing with KC008/PS004);
         a non-donated entry must declare a waiver naming why; a
         backend may only name entries the table declares.
  EU004  pipelining parity: the owner's step_all must retire the
         carried step context BEFORE dispatching (the donation
         contract), every engine path must reach _kernel_call, and
         every dispatch backend must wire a donated entry — a backend
         without one silently degrades depth-1 to blocking dispatch.
  EU005  telemetry parity: compiled-entry construction or a direct call
         of a dispatch entry function inside engine/ that does not
         flow through capacity.TRACKER.wrap is a retrace blind spot
         (CompileTracker never sees it); every declared entry must be
         wrapped somewhere in the engine layer.
  EU006  layering: engine/ importing an underscore-private name from
         dragonboat_tpu_torch.core.* / dragonboat_tpu_torch.parallel.* (or
         touching one through a module alias) bypasses the
         CONTRACTS-tagged public types the other passes check.

Pure AST — no torch import, safe in the lint fork pool.
"""

from __future__ import annotations

import ast
import glob
import os

from dragonboat_tpu_torch.analysis.common import Finding, rel
from dragonboat_tpu_torch.analysis.contracts import (
    _donated_entries,
    _donation_decl,
)

PASS = "engine-unity"

#: the declaration module (machine-read contract) and the engine layer
DISPATCH_FILE = "dragonboat_tpu_torch/engine/dispatch.py"
KSTATE_FILE = "dragonboat_tpu_torch/core/kstate.py"
ENGINE_GLOB = "dragonboat_tpu_torch/engine/*.py"

#: --changed-only inputs: the engine layer plus every module the
#: dispatch table or the donation cross-check reads
SCOPE = (
    ENGINE_GLOB,
    "dragonboat_tpu_torch/core/kernel.py",
    "dragonboat_tpu_torch/core/kstate.py",
    "dragonboat_tpu_torch/core/router.py",
    "dragonboat_tpu_torch/parallel/ici.py",
)

#: module-level literals read from DISPATCH_FILE
_DECL_NAMES = (
    "STEP_LOOP_OWNER",
    "STEP_LOOP_METHODS",
    "DISPATCH_SEAMS",
    "ENGINE_FEATURE_KNOBS",
    "ENGINE_FEATURE_CALLS",
    "DISPATCH_ENTRIES",
)

#: conservative fallbacks when the declaration module is absent (a
#: fixture tree, or a catastrophically pruned checkout) — EU checks
#: still run against the owner-only core of the contract
_DECL_DEFAULTS = {
    "STEP_LOOP_OWNER": "KernelEngine",
    "STEP_LOOP_METHODS": ("step_all", "_kernel_call"),
    "DISPATCH_SEAMS": (),
    "ENGINE_FEATURE_KNOBS": (),
    "ENGINE_FEATURE_CALLS": (),
    "DISPATCH_ENTRIES": {},
}

#: extra jit entry spellings engine code must not call directly even
#: though the dispatch table does not list them (legacy serving paths)
_LEGACY_ENTRY_FNS = ("ici_serve_step", "ici_cluster_step")


def _load_decl(root: str) -> tuple[dict, dict[str, int]]:
    """The dispatch contract literals (+ their line numbers)."""
    decl = dict(_DECL_DEFAULTS)
    lines = {name: 1 for name in _DECL_NAMES}
    path = os.path.join(root, DISPATCH_FILE)
    if not os.path.exists(path):
        return decl, lines
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if name not in _DECL_NAMES:
            continue
        lines[name] = node.lineno
        try:
            decl[name] = ast.literal_eval(node.value)
        except (ValueError, SyntaxError):
            pass  # non-literal declaration: keep the fallback
    return decl, lines


class _Cls:
    """One class definition: name, defining file, AST node, base names."""

    def __init__(self, name: str, relpath: str, node: ast.ClassDef):
        self.name = name
        self.relpath = relpath
        self.node = node
        self.bases = []
        for b in node.bases:
            if isinstance(b, ast.Name):
                self.bases.append(b.id)
            elif isinstance(b, ast.Attribute):
                self.bases.append(b.attr)


def _classes(trees: dict[str, ast.Module]) -> dict[str, _Cls]:
    out: dict[str, _Cls] = {}
    for relpath, tree in trees.items():
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                out[node.name] = _Cls(node.name, relpath, node)
    return out


def _inherits(cls: _Cls, owner: str, classes: dict[str, _Cls]) -> bool:
    seen: set[str] = set()
    stack = list(cls.bases)
    while stack:
        b = stack.pop()
        if b == owner:
            return True
        if b in seen:
            continue
        seen.add(b)
        if b in classes:
            stack.extend(classes[b].bases)
    return False


def _mro(cls: _Cls, classes: dict[str, _Cls]) -> list[_Cls]:
    """Linearized name-based MRO over the scanned classes (left-to-right
    depth-first; good enough for the engine's single-inheritance tree)."""
    out, seen = [], set()

    def visit(c: _Cls) -> None:
        if c.name in seen:
            return
        seen.add(c.name)
        out.append(c)
        for b in c.bases:
            if b in classes:
                visit(classes[b])

    visit(cls)
    return out


def _method_table(cls: _Cls, classes: dict[str, _Cls],
                  ) -> dict[str, tuple[ast.FunctionDef, str]]:
    """Method name -> (def node, defining file), first definition wins."""
    table: dict[str, tuple[ast.FunctionDef, str]] = {}
    for c in _mro(cls, classes):
        for node in c.node.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name not in table:
                table[node.name] = (node, c.relpath)
    return table


def _self_calls(fn: ast.FunctionDef) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self":
            out.add(node.func.attr)
    return out


def _reachable(cls: _Cls, classes: dict[str, _Cls],
               entry: str = "step_all",
               ) -> dict[str, tuple[ast.FunctionDef, str]]:
    """Methods reachable from ``entry`` via self-calls, resolved against
    THIS class's method table (the per-path view EU002/EU004 need)."""
    table = _method_table(cls, classes)
    if entry not in table:
        return {}
    seen: dict[str, tuple[ast.FunctionDef, str]] = {}
    stack = [entry]
    while stack:
        name = stack.pop()
        if name in seen or name not in table:
            continue
        seen[name] = table[name]
        stack.extend(_self_calls(table[name][0]))
    return seen


def _attr_chain(node: ast.AST) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return list(reversed(parts))


def _is_tracker_wrap(call: ast.Call) -> bool:
    chain = _attr_chain(call.func)
    return len(chain) >= 2 and chain[-1] == "wrap" and "TRACKER" in chain


def _module_of(relpath_py: str) -> str:
    return relpath_py[:-3].replace("/", ".") if relpath_py.endswith(".py") \
        else relpath_py.replace("/", ".")


def _eu001(findings: list[Finding], classes: dict[str, _Cls],
           owner: str, loop_methods: tuple) -> None:
    for cls in classes.values():
        if cls.name == owner or not _inherits(cls, owner, classes):
            continue
        for node in cls.node.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in loop_methods:
                findings.append(Finding(
                    PASS, cls.relpath, node.lineno, "EU001",
                    f"second step-loop implementation: {cls.name}."
                    f"{node.name} overrides a {owner} step-loop internal "
                    "— backends contribute a dispatch object through the "
                    "_make_dispatch seam, they do not re-implement the "
                    "loop"))


def _eu002(findings: list[Finding], engines: list[_Cls],
           classes: dict[str, _Cls], knobs: tuple, calls: tuple,
           decl_lines: dict[str, int]) -> None:
    knob_readers: dict[str, set[str]] = {k: set() for k in knobs}
    call_reachers: dict[str, set[str]] = {c: set() for c in calls}
    reach = {cls.name: _reachable(cls, classes) for cls in engines}
    for cls in engines:
        for fn, _src in reach[cls.name].values():
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "self" \
                        and node.attr in knob_readers:
                    knob_readers[node.attr].add(cls.name)
                if isinstance(node, ast.Call):
                    chain = _attr_chain(node.func)
                    if chain and chain[-1] in call_reachers:
                        call_reachers[chain[-1]].add(cls.name)
    analyzed = [cls for cls in engines if reach[cls.name]]
    for feature, readers in list(knob_readers.items()) \
            + list(call_reachers.items()):
        kind = "config knob" if feature in knob_readers \
            else "feature call"
        if not readers and analyzed:
            findings.append(Finding(
                PASS, DISPATCH_FILE,
                decl_lines.get("ENGINE_FEATURE_KNOBS", 1), "EU002",
                f"dead dispatch feature: {kind} {feature!r} is declared "
                "but unreachable from step_all on every engine path — "
                "delete the feature or its declaration"))
            continue
        for cls in engines:
            if cls.name in readers or not reach[cls.name]:
                continue
            findings.append(Finding(
                PASS, cls.relpath, cls.node.lineno, "EU002",
                f"dispatch-feature drift: {kind} {feature!r} gates "
                f"dispatch on {', '.join(sorted(readers))} but is "
                f"unreachable from step_all on {cls.name} — the paths "
                "have diverged"))


def _backend_classes(classes: dict[str, _Cls]) -> list[_Cls]:
    """Dispatch backends: classes defining dispatch() + self.entries."""
    out = []
    for cls in classes.values():
        has_dispatch = any(
            isinstance(n, ast.FunctionDef) and n.name == "dispatch"
            for n in cls.node.body)
        assigns_entries = any(
            isinstance(t, ast.Attribute) and t.attr == "entries"
            and isinstance(t.value, ast.Name) and t.value.id == "self"
            for n in ast.walk(cls.node) if isinstance(n, ast.Assign)
            for t in n.targets)
        if has_dispatch and assigns_entries:
            out.append(cls)
    return out


def _eu003(findings: list[Finding], root: str, entries: dict,
           backends: list[_Cls], decl_lines: dict[str, int]) -> None:
    # forward: declared entries vs their defining modules + kstate
    donation_fns: set[tuple[str, str]] | None = None
    kpath = os.path.join(root, KSTATE_FILE)
    if os.path.exists(kpath):
        with open(kpath, encoding="utf-8") as f:
            decl, _ln = _donation_decl(ast.parse(f.read(), filename=kpath))
        if decl is not None:
            donation_fns = set()
            for name, spec in decl.items():
                mod = spec.get("module", "dragonboat_tpu_torch/core/kernel.py")
                donation_fns.add((mod, spec.get("function", name)))
    mod_donated: dict[str, dict] = {}
    for name, spec in sorted(entries.items()):
        mod = spec.get("module", "")
        fn = spec.get("function", name)
        mpath = os.path.join(root, mod)
        if mod not in mod_donated:
            if not os.path.exists(mpath):
                mod_donated[mod] = {}
            else:
                with open(mpath, encoding="utf-8") as f:
                    mod_donated[mod] = _donated_entries(
                        ast.parse(f.read(), filename=mpath))
        donated_here = mod_donated[mod]
        if spec.get("donated"):
            if os.path.exists(mpath) and fn not in donated_here:
                findings.append(Finding(
                    PASS, mod, 1, "EU003",
                    f"dispatch entry {name!r} is declared donated but "
                    f"{fn} carries no donate_argnums in {mod} — the "
                    "pipelined path would silently copy instead of "
                    "donate"))
            if donation_fns is not None and (mod, fn) not in donation_fns:
                findings.append(Finding(
                    PASS, DISPATCH_FILE,
                    decl_lines.get("DISPATCH_ENTRIES", 1), "EU003",
                    f"donated dispatch entry {name!r} ({mod}:{fn}) has "
                    "no kstate.DONATION declaration — KC008/PS004 "
                    "cannot cross-check its buffer classes"))
        else:
            if not str(spec.get("waiver", "")).strip():
                findings.append(Finding(
                    PASS, DISPATCH_FILE,
                    decl_lines.get("DISPATCH_ENTRIES", 1), "EU003",
                    f"non-donated dispatch entry {name!r} declares no "
                    "waiver — name why donation is out or donate it"))
            if fn in mod_donated[mod]:
                findings.append(Finding(
                    PASS, mod, 1, "EU003",
                    f"dispatch entry {name!r} is declared non-donated "
                    f"but {fn} carries donate_argnums in {mod} — the "
                    "table and the jit entry disagree"))
    # reverse: a backend may only name entries the table declares
    for cls in backends:
        for node in ast.walk(cls.node):
            key = None
            if isinstance(node, ast.Subscript):
                chain = _attr_chain(node.value)
                if chain and chain[-1] == "entries" \
                        and isinstance(node.slice, ast.Constant) \
                        and isinstance(node.slice.value, str):
                    key = (node.slice.value, node.lineno)
            elif isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Attribute) and t.attr == "entries"
                    for t in node.targets) \
                    and isinstance(node.value, ast.Dict):
                for k in node.value.keys:
                    if isinstance(k, ast.Constant) \
                            and isinstance(k.value, str) \
                            and k.value not in entries:
                        findings.append(Finding(
                            PASS, cls.relpath, k.lineno, "EU003",
                            f"backend {cls.name} registers undeclared "
                            f"dispatch entry {k.value!r} — add it to "
                            "DISPATCH_ENTRIES (donated flag + waiver) "
                            "or drop it"))
                continue
            if key is not None and key[0] not in entries:
                findings.append(Finding(
                    PASS, cls.relpath, key[1], "EU003",
                    f"backend {cls.name} selects undeclared dispatch "
                    f"entry {key[0]!r} — add it to DISPATCH_ENTRIES "
                    "(donated flag + waiver) or drop it"))


def _eu004(findings: list[Finding], engines: list[_Cls],
           classes: dict[str, _Cls], owner: str, entries: dict,
           backends: list[_Cls]) -> None:
    donated_names = sorted(n for n, s in entries.items()
                           if s.get("donated"))
    # (a) the owner's step_all must retire before it dispatches
    owner_cls = classes.get(owner)
    step_all = None
    if owner_cls is not None:
        table = _method_table(owner_cls, classes)
        if "step_all" in table:
            step_all, src = table["step_all"]
    if step_all is not None:
        dispatch_lines, retire_lines, carries_ctx = [], [], False
        for node in ast.walk(step_all):
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if chain[:1] == ["self"] and chain[-1] == "_kernel_call":
                    dispatch_lines.append(node.lineno)
                if chain[:1] == ["self"] \
                        and chain[-1] == "_process_outputs":
                    retire_lines.append(node.lineno)
            for t in (node.targets if isinstance(node, ast.Assign)
                      else []):
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Attribute) \
                            and leaf.attr == "_pending_ctx":
                        carries_ctx = True
        if dispatch_lines:
            if not carries_ctx:
                findings.append(Finding(
                    PASS, src, step_all.lineno, "EU004",
                    "step_all never carries a _pending_ctx across "
                    "steps — the depth-1 retire-before-dispatch "
                    "protocol is gone"))
            elif not retire_lines \
                    or min(retire_lines) > min(dispatch_lines):
                findings.append(Finding(
                    PASS, src, step_all.lineno, "EU004",
                    "retire-before-dispatch order broken: step_all "
                    "dispatches (_kernel_call, line "
                    f"{min(dispatch_lines)}) before retiring the "
                    "pipelined outputs (_process_outputs"
                    + (f", line {min(retire_lines)}" if retire_lines
                       else " never called")
                    + ") — donated buffers would be read after the graph "
                    "reuses them"))
    # (b) every engine path must reach the dispatch point
    for cls in engines:
        reach = _reachable(cls, classes)
        if reach and "_kernel_call" not in reach:
            findings.append(Finding(
                PASS, cls.relpath, cls.node.lineno, "EU004",
                f"engine path {cls.name} never reaches _kernel_call "
                "from step_all — the unified dispatch (and its "
                "pipelined donated entry) is unreachable on this "
                "path"))
    # (c) every backend must wire a donated entry
    for cls in backends:
        named = {node.value for node in ast.walk(cls.node)
                 if isinstance(node, ast.Constant)
                 and isinstance(node.value, str)}
        if donated_names and not named.intersection(donated_names):
            findings.append(Finding(
                PASS, cls.relpath, cls.node.lineno, "EU004",
                f"pipelining parity: backend {cls.name} references no "
                f"donated dispatch entry ({', '.join(donated_names)}) "
                "— depth-1 pipelining silently degrades to blocking "
                "non-donated dispatch on this path"))


def _eu005(findings: list[Finding], trees: dict[str, ast.Module],
           entries: dict, decl_lines: dict[str, int],
           default_mode: bool) -> None:
    entry_fns = {s.get("function", n) for n, s in entries.items()}
    entry_fns.update(_LEGACY_ENTRY_FNS)
    entry_mods = {_module_of(s.get("module", "")) for s in entries.values()}
    wrapped: set[str] = set()
    for relpath, tree in trees.items():
        # aliases of entry functions imported from the entry modules
        aliases: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and (node.module in entry_mods
                         or node.module.startswith("dragonboat_tpu_torch.core")
                         or node.module.startswith(
                             "dragonboat_tpu_torch.parallel")):
                for a in node.names:
                    if a.name in entry_fns:
                        aliases[a.asname or a.name] = a.name

        wrap_spans: list[tuple[int, int]] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _is_tracker_wrap(node):
                end = getattr(node, "end_lineno", node.lineno)
                wrap_spans.append((node.lineno, end))
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    wrapped.add(node.args[0].value)

        def in_wrap(node: ast.AST) -> bool:
            return any(lo <= node.lineno <= hi for lo, hi in wrap_spans)

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain and (chain[-1] in ("compiled", "CUDAGraph")
                          or chain[-2:] == ["cuda", "graph"]) \
                    and not in_wrap(node):
                findings.append(Finding(
                    PASS, relpath, node.lineno, "EU005",
                    f"{'.'.join(chain)} constructed in the engine "
                    "layer outside capacity.TRACKER.wrap — an entry "
                    "CompileTracker never sees is a retrace blind "
                    "spot; define compiled entries in core/ or "
                    "parallel/ "
                    "and register them in DISPATCH_ENTRIES"))
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in aliases and not in_wrap(node):
                findings.append(Finding(
                    PASS, relpath, node.lineno, "EU005",
                    f"direct call of dispatch entry "
                    f"{aliases[node.func.id]!r} bypasses its "
                    "CompileTracker wrapper — compiles/retraces of "
                    "this call are invisible to the capacity model"))
    if default_mode:
        for name in sorted(entries):
            if name not in wrapped:
                findings.append(Finding(
                    PASS, DISPATCH_FILE,
                    decl_lines.get("DISPATCH_ENTRIES", 1), "EU005",
                    f"declared dispatch entry {name!r} is never "
                    "registered with capacity.TRACKER.wrap in the "
                    "engine layer — its compiles/retraces would be "
                    "invisible"))


def _eu006(findings: list[Finding],
           trees: dict[str, ast.Module]) -> None:
    private_mods = ("dragonboat_tpu_torch.core", "dragonboat_tpu_torch.parallel")
    for relpath, tree in trees.items():
        mod_aliases: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.startswith(private_mods):
                for a in node.names:
                    if a.name.startswith("_"):
                        findings.append(Finding(
                            PASS, relpath, node.lineno, "EU006",
                            f"engine layer imports kernel internal "
                            f"{a.name!r} from {node.module} — private "
                            "names bypass the CONTRACTS-tagged types "
                            "the contracts/partition passes check; "
                            "export a public seam instead"))
                    else:
                        full = f"{node.module}.{a.name}"
                        if full.startswith(private_mods):
                            mod_aliases[a.asname or a.name] = full
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.startswith(private_mods):
                        mod_aliases[a.asname
                                    or a.name.split(".")[0]] = a.name
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in mod_aliases \
                    and node.attr.startswith("_") \
                    and not node.attr.startswith("__"):
                findings.append(Finding(
                    PASS, relpath, node.lineno, "EU006",
                    f"engine layer reaches into kernel internal "
                    f"{mod_aliases[node.value.id]}.{node.attr} — "
                    "private attributes bypass the CONTRACTS-tagged "
                    "public surface; export a public seam instead"))


def run(root: str, files: list[str] | None = None) -> list[Finding]:
    """All EU findings for the engine layer under ``root``."""
    default_mode = files is None
    if files is None:
        files = sorted(glob.glob(os.path.join(root, ENGINE_GLOB)))
    engine_prefix = os.path.join(root, "dragonboat_tpu_torch",
                                 "engine") + os.sep
    engine_files = [p for p in files
                    if os.path.abspath(p).startswith(engine_prefix)
                    and os.path.exists(p)]

    trees: dict[str, ast.Module] = {}
    for p in engine_files:
        with open(p, encoding="utf-8") as f:
            trees[rel(root, p)] = ast.parse(f.read(), filename=p)

    decl, decl_lines = _load_decl(root)
    owner = decl["STEP_LOOP_OWNER"]
    entries = decl["DISPATCH_ENTRIES"]

    classes = _classes(trees)
    engines = [cls for cls in classes.values()
               if cls.name == owner or _inherits(cls, owner, classes)]
    backends = _backend_classes(classes)

    findings: list[Finding] = []
    _eu001(findings, classes, owner, tuple(decl["STEP_LOOP_METHODS"]))
    _eu002(findings, engines, classes,
           tuple(decl["ENGINE_FEATURE_KNOBS"]),
           tuple(decl["ENGINE_FEATURE_CALLS"]), decl_lines)
    _eu003(findings, root, entries, backends, decl_lines)
    _eu004(findings, engines, classes, owner, entries, backends)
    _eu005(findings, trees, entries, decl_lines, default_mode)
    _eu006(findings, trees)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
