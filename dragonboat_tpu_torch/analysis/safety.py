"""Raft safety verifier: invariant contracts checked against the kernel.

The port's form of the reference's pass, over the port's
``core/kstate.py`` and ``core/kernel.py``: the port keeps the reference's
store idiom (``mrep`` / ``_replace`` keywords), its follower commit form
(``torch.maximum(s.committed, ...)``) and its quorum source
(``_sorted_match_quorum_index``, which wraps K1's ``commit_quorum``), so
the declaration lint and the store obligations read it unchanged.  The
model-check gate runs the port's ``model_check.py`` on the device it is
given, and its cache is keyed on ``torch.__version__``, that device type
and the participating sources.

The seventh analysis pass closes the loop the other six leave open: the
contracts pass proves SHAPE discipline, the partition pass proves
PLACEMENT discipline — neither says anything about whether a
shape-correct, well-placed store is allowed by the Raft *protocol*.
This pass consumes the machine-readable ``core/kstate.py INVARIANTS``
declarations (grammar: ``analysis/common.parse_invariant``) three ways:

**Declaration lint** — every invariant must parse, and every field it
references (``field`` / ``prev.field`` / ``quorum(field)`` terms) must
be a declared ``ShardState`` contract field (RS001); a missing or empty
``INVARIANTS`` table is itself a finding (RS006) — the runtime probe
and the model checker silently become vacuous without it.

**Store obligations** — an AST provenance analysis over
``core/kernel.py``: for each store (``mrep`` / ``_replace`` keyword) to
an invariant-participating field, the store's value and mask
expressions are resolved transitively through local definitions, and
the store must *provably preserve* the invariant or be flagged:

- RS002  a store to ``committed`` that is neither monotone in
         ``s.committed`` (the ``torch.maximum(s.committed, ...)``
         follower form) nor derived from ``_sorted_match_quorum_index``
         under a leader-role + current-term mask — the
         ``leader_commit_quorum`` / ``commit_monotone`` obligations
- RS003  the RequestVote handler grants without persisting the
         candidate id into ``vote`` — the ``vote_once_per_term``
         obligation (a granted-but-unrecorded vote lets a second
         same-term candidate win a disjoint quorum)
- RS004  a store that can LOWER ``last`` (truncation) whose mask does
         not derive from a comparison against ``s.committed`` — the
         ``commit_within_log`` obligation (a replicate must never
         truncate the committed prefix)

**Model-check gate** — the fast small-scope exhaustive run of
``dragonboat_tpu_torch/model_check.py`` (the real kernel step as
transition relation) must report zero violations (RS005).  The result
is cached in ``analysis/.safety_cache.json`` (git-ignored) keyed by a
hash of the participating sources + the torch version and the device
type, so the exploration only re-runs when the kernel (or the checker
itself) actually changed, or on another device.

Custom file sets (``run(root, files=[...])``, fixture tests) run the
declaration lint + store obligations over those files and skip the
model-check gate; ``run(root, dynamic=False)`` skips only the gate.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os

from dragonboat_tpu_torch.analysis.common import (
    Finding,
    InvariantError,
    parse_contracts,
    parse_invariant,
    rel,
)

PASS = "safety"

KSTATE_FILE = "dragonboat_tpu_torch/core/kstate.py"
KERNEL_FILE = "dragonboat_tpu_torch/core/kernel.py"

CACHE_FILE = "dragonboat_tpu_torch/analysis/.safety_cache.json"
#: sources whose content keys the cached model-check verdict
CACHE_SOURCES = (
    "dragonboat_tpu_torch/core/kstate.py",
    "dragonboat_tpu_torch/core/kernel.py",
    "dragonboat_tpu_torch/core/params.py",
    "dragonboat_tpu_torch/core/invariants.py",
    "dragonboat_tpu_torch/parallel/fabric_kernels.py",
    "dragonboat_tpu_torch/csrc/quorum_match.cu",
    "dragonboat_tpu_torch/model_check.py",
    "dragonboat_tpu_torch/analysis/safety.py",
)

#: every file this pass reads
SCOPE = tuple(dict.fromkeys((KSTATE_FILE, KERNEL_FILE) + CACHE_SOURCES))

#: state params whose attribute reads count as ShardState field refs
_STATE_NAMES = ("s", "state", "st")
_MSG_NAMES = ("m",)

#: the quorum source: commit advances on the leader path must derive
#: from it (mirrors raft.go sortMatchValues; in the port it wraps K1's
#: commit_quorum)
_QUORUM_FN = "_sorted_match_quorum_index"


# ---------------------------------------------------------------------------
# declaration lint (RS001 / RS006)
# ---------------------------------------------------------------------------


def _literal_assign(tree: ast.Module, name: str):
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            try:
                return ast.literal_eval(node.value), node
            except (ValueError, SyntaxError):
                return None, node
    return None, None


def _entry_lines(node: ast.Assign | None) -> dict[str, int]:
    out: dict[str, int] = {}
    if node is not None and isinstance(node.value, ast.Dict):
        for k in node.value.keys:
            if isinstance(k, ast.Constant):
                out[k.value] = k.lineno
    return out


def check_declarations(root: str, kstate_path: str) -> tuple[list, dict]:
    """RS001/RS006 over one kstate-shaped file; returns
    ``(findings, parsed_invariants)``."""
    findings: list[Finding] = []
    relpath = rel(root, kstate_path)
    with open(kstate_path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=kstate_path)
    table, node = _literal_assign(tree, "INVARIANTS")
    if not isinstance(table, dict) or not table:
        line = node.lineno if node is not None else 1
        if node is None:
            what = "is missing"
        elif not isinstance(table, dict):
            what = "is not a pure-literal dict"
        else:
            what = "is empty"
        findings.append(Finding(
            PASS, relpath, line, "RS006",
            f"kstate INVARIANTS {what} — the runtime probe and the "
            "model checker have nothing to verify"))
        return findings, {}
    lines = _entry_lines(node)
    contracts_table, _ = _literal_assign(tree, "CONTRACTS")
    state_fields: set[str] = set()
    if isinstance(contracts_table, dict):
        try:
            parsed_c = parse_contracts(contracts_table, relpath)
            state_fields = set(parsed_c.get("ShardState", {}))
        except ValueError:
            state_fields = set(contracts_table.get("ShardState", {}))
    parsed: dict = {}
    for name, spec in table.items():
        line = lines.get(name, node.lineno)
        try:
            inv = parse_invariant(name, spec, f"{relpath}:INVARIANTS")
        except InvariantError as e:
            findings.append(Finding(PASS, relpath, line, "RS001", str(e)))
            continue
        unknown = [f for f in inv.fields if f not in state_fields]
        if state_fields and unknown:
            findings.append(Finding(
                PASS, relpath, line, "RS001",
                f"invariant {name!r} references field(s) "
                f"{sorted(unknown)} with no ShardState contract — the "
                "probe and checker would KeyError or silently skip"))
            continue
        parsed[name] = inv
    return findings, parsed


# ---------------------------------------------------------------------------
# store-obligation provenance analysis (RS002-RS004)
# ---------------------------------------------------------------------------


def _collect_defs(fn: ast.FunctionDef) -> dict[str, list[ast.AST]]:
    """name -> every expression assigned to it anywhere in the function
    (all defs are unioned during resolution — a sound over-approx)."""
    defs: dict[str, list[ast.AST]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            defs.setdefault(node.targets[0].id, []).append(node.value)
        elif isinstance(node, ast.NamedExpr) \
                and isinstance(node.target, ast.Name):
            defs.setdefault(node.target.id, []).append(node.value)
    return defs


class _Prov:
    """Transitive refs of an expression through local definitions."""

    def __init__(self, defs: dict[str, list[ast.AST]]):
        self.defs = defs
        self._memo: dict[int, tuple[frozenset, frozenset]] = {}

    def refs(self, expr: ast.AST | None,
             _visiting: frozenset = frozenset()) -> tuple[set, set]:
        """``(attrs, calls)``: attrs are ``(base, field)`` pairs for
        reads like ``s.committed`` / ``m.log_index``; calls are the
        names of every function invoked in the expression's def chain."""
        attrs: set = set()
        calls: set = set()
        if expr is None:
            return attrs, calls
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in _STATE_NAMES + _MSG_NAMES:
                base = "s" if node.value.id in _STATE_NAMES else "m"
                attrs.add((base, node.attr))
            elif isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name):
                    calls.add(node.func.id)
                elif isinstance(node.func, ast.Attribute):
                    calls.add(node.func.attr)
            elif isinstance(node, ast.Name) and node.id in self.defs \
                    and node.id not in _visiting \
                    and node.id not in _STATE_NAMES + _MSG_NAMES:
                # the state/message SoA names are terminal: they are
                # rebound by every mrep, and chasing those rebindings
                # would conflate all stores in the function
                for d in self.defs[node.id]:
                    a, c = self.refs(d, _visiting | {node.id})
                    attrs |= a
                    calls |= c
        return attrs, calls


def _store_sites(fn: ast.FunctionDef):
    """Every ``mrep(s, mask, **kw)`` / ``x._replace(**kw)`` call in the
    function: ``(lineno, mask_expr_or_None, {field: value_expr})``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        if not kw:
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "mrep":
            mask = node.args[1] if len(node.args) > 1 else None
            yield node.lineno, mask, kw
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr == "_replace":
            yield node.lineno, None, kw


def _handles_request_vote(fn: ast.FunctionDef) -> bool:
    """Whether the function dispatches on ``m.mtype == MT.REQUEST_VOTE``
    (the authoritative vote-grant handler marker)."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        has_mtype = any(
            isinstance(x, ast.Attribute) and x.attr == "mtype"
            for x in sides)
        has_rv = any(
            isinstance(x, ast.Attribute) and x.attr == "REQUEST_VOTE"
            for x in sides)
        if has_mtype and has_rv:
            return True
    return False


def check_stores(root: str, kernel_path: str,
                 invariants: dict) -> list[Finding]:
    """RS002-RS004 over one kernel-shaped file."""
    findings: list[Finding] = []
    relpath = rel(root, kernel_path)
    with open(kernel_path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=kernel_path)

    # obligations only exist for fields the declarations actually bind
    inv_fields = {f for inv in invariants.values() for f in inv.fields}
    want_commit = "committed" in inv_fields
    want_vote = "vote" in inv_fields
    want_last = "last" in inv_fields

    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
        prov = _Prov(_collect_defs(fn))
        grants_vote = _handles_request_vote(fn)
        persisted_vote = False
        for lineno, mask, kw in _store_sites(fn):
            mask_attrs, mask_calls = prov.refs(mask)
            if want_commit and "committed" in kw:
                vattrs, vcalls = prov.refs(kw["committed"])
                monotone = ("s", "committed") in vattrs
                quorum = _QUORUM_FN in vcalls
                if quorum and ("s", "role") not in mask_attrs:
                    findings.append(Finding(
                        PASS, relpath, lineno, "RS002",
                        f"{fn.name}: quorum-derived commit advance whose "
                        "mask never checks s.role — a non-leader could "
                        "move the commit index"))
                elif not monotone and not quorum:
                    findings.append(Finding(
                        PASS, relpath, lineno, "RS002",
                        f"{fn.name}: store to ShardState.committed is "
                        "neither monotone in s.committed (the "
                        "torch.maximum follower form) nor derived from "
                        f"{_QUORUM_FN} — commit_monotone / "
                        "leader_commit_quorum cannot be preserved"))
            if want_vote and "vote" in kw:
                vattrs, _ = prov.refs(kw["vote"])
                if ("m", "from_") in vattrs:
                    persisted_vote = True
            if want_last and "last" in kw:
                vattrs, _ = prov.refs(kw["last"])
                if ("s", "last") in vattrs:
                    continue        # append path: monotone from s.last
                if ("s", "committed") not in mask_attrs:
                    findings.append(Finding(
                        PASS, relpath, lineno, "RS004",
                        f"{fn.name}: store can LOWER ShardState.last "
                        "(value independent of s.last) but its mask "
                        "never compares against s.committed — a "
                        "replicate could truncate the committed prefix "
                        "(commit_within_log)"))
        if want_vote and grants_vote and not persisted_vote:
            findings.append(Finding(
                PASS, relpath, fn.lineno, "RS003",
                f"{fn.name}: handles RequestVote but never persists the "
                "candidate id into ShardState.vote — a granted-but-"
                "unrecorded vote breaks vote_once_per_term (two "
                "same-term candidates can each win a quorum)"))
    return findings


# ---------------------------------------------------------------------------
# cached model-check gate (RS005)
# ---------------------------------------------------------------------------


def _source_key(root: str, device) -> str:
    import torch

    h = hashlib.sha256()
    for src in CACHE_SOURCES:
        p = os.path.join(root, src)
        if os.path.exists(p):
            with open(p, "rb") as f:
                h.update(f.read())
        h.update(b"\0")
    h.update(f"torch:{torch.__version__}:{device.type}".encode())
    return h.hexdigest()


def model_check_gate(root: str, use_cache: bool = True,
                     device=None) -> list[Finding]:
    """RS005: the fast exhaustive scope must be clean on ``device`` (the
    CUDA card unless the caller names another).  Cached by source hash,
    torch version and device type."""
    from dragonboat_tpu_torch import model_check as mc
    from dragonboat_tpu_torch.devices import resolve_device

    device = resolve_device(device)
    relpath = KERNEL_FILE
    cache_path = os.path.join(root, CACHE_FILE)
    key = _source_key(root, device)
    if use_cache and os.path.exists(cache_path):
        try:
            with open(cache_path, encoding="utf-8") as f:
                cached = json.load(f)
            if cached.get("key") == key:
                return [Finding(PASS, relpath, 1, "RS005", m)
                        for m in cached.get("messages", [])]
        except (OSError, ValueError):
            pass
    res = mc.run_scope("fast", root=root, device=device)
    messages = [
        f"model check ({res['scope']} scope, {res['states_explored']} "
        f"states): {v['property']} violated — {v['detail']} "
        f"[trail: {' / '.join(v['trail'])}]"
        for v in res["violations"]]
    if not res["scope_complete"]:
        messages.append(
            "model check: fast scope did not complete "
            f"({res['states_explored']} states explored) — exploration "
            "budget misconfigured")
    try:
        with open(cache_path, "w", encoding="utf-8") as f:
            json.dump({"key": key, "messages": messages,
                       "states_explored": res["states_explored"],
                       "transitions": res["transitions"],
                       "frontier_exhausted": res["frontier_exhausted"]},
                      f, indent=2, sort_keys=True)
            f.write("\n")
    except OSError:
        pass
    return [Finding(PASS, relpath, 1, "RS005", m) for m in messages]


# ---------------------------------------------------------------------------
# pass entry point
# ---------------------------------------------------------------------------


def run(root: str, files: list[str] | None = None,
        dynamic: bool = True, device=None,
        use_cache: bool = True) -> list[Finding]:
    if files is None:
        kstate_paths = [os.path.join(root, KSTATE_FILE)]
        kernel_paths = [os.path.join(root, KERNEL_FILE)]
    else:
        kstate_paths = [p for p in files
                        if os.path.basename(p) == "kstate.py"] or files
        kernel_paths = [p for p in files
                        if os.path.basename(p) == "kernel.py"] or files
        dynamic = False

    findings: list[Finding] = []
    invariants: dict = {}
    for p in kstate_paths:
        if not os.path.exists(p):
            continue
        f, parsed = check_declarations(root, p)
        findings += f
        invariants.update(parsed)
    for p in kernel_paths:
        if not os.path.exists(p):
            continue
        findings += check_stores(root, p, invariants)
    if dynamic:
        findings += model_check_gate(root, use_cache=use_cache,
                                     device=device)
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))
