"""Concurrency lint: ``# guarded-by: <lock>`` discipline.

Scope: classes that own a ``threading.Lock`` / ``RLock`` / ``Condition``
attribute (assigned in ``__init__``) in the modules shared across
threads.  Two rules:

- CC001  a mutable container attribute (dict/list/set/deque display or
         constructor) of a lock-owning class carries no trailing
         ``# guarded-by: <name>`` annotation on its ``__init__``
         assignment.  ``# guarded-by: <init-only>`` declares an
         attribute immutable after construction.
- CC002  a guarded attribute is mutated (assignment, augmented
         assignment, subscript store/delete, or a mutating method call
         such as ``.append`` / ``.pop`` / ``.clear``) outside a ``with
         self.<lock>:`` block in a method other than ``__init__``.
         ``with self._locks[i]:`` counts as holding ``_locks`` — the
         key-sharded book pattern (request.py PendingProposal).
         ``init-only`` attributes admit no post-``__init__`` mutation
         at all.
- CC003  static deadlock detection: a lock-order graph is built per
         class with an edge A -> B whenever ``self.B`` is acquired
         (directly, or transitively through a same-class method call)
         while ``self.A`` is held.  A cycle in that graph — including
         the length-1 cycle of re-acquiring a non-reentrant
         Lock/Semaphore — means two threads interleaving those paths
         can deadlock, and is flagged at one acquisition site per
         cycle edge.

Known limitations (documented, on purpose): mutations through a local
alias (``q = self.queues[a]; q.append(...)``) are not tracked — the
lint enforces the annotation discipline at the ``self.<attr>`` access
level, which is where review happens.  The lock-order graph is
likewise per-class and ``self.``-scoped: an inversion spanning two
objects' locks (hub holding its mu while calling into a pool that
grabs its own) needs runtime lock profiling, not this lint.
"""

from __future__ import annotations

import ast
import os
import re

from dragonboat_tpu_torch.analysis.common import Finding, rel

PASS = "concurrency"

DEFAULT_MODULES = (
    "dragonboat_tpu_torch/transport/hub.py",
    "dragonboat_tpu_torch/engine/apply_pool.py",
    "dragonboat_tpu_torch/request.py",
    "dragonboat_tpu_torch/events.py",
    "dragonboat_tpu_torch/chaos/crashfs.py",
    "dragonboat_tpu_torch/telemetry.py",
    "dragonboat_tpu_torch/flight.py",
    "dragonboat_tpu_torch/lifecycle.py",
    "dragonboat_tpu_torch/core/health.py",
    "dragonboat_tpu_torch/capacity.py",
    "dragonboat_tpu_torch/fabric.py",
    "dragonboat_tpu_torch/transport/chan.py",
    "dragonboat_tpu_torch/transport/tcp.py",
    # the fleet controller: lockless BY CONTRACT (all state advances
    # under the NodeHost tick, never from transport threads) — listed so
    # the day it grows a lock, its streak/cooldown dicts must declare
    # their guard like every other shared book
    "dragonboat_tpu_torch/control.py",
    # the port's own thread-shared modules: the compiled entries (graph
    # caches and the capture lock, replayed from every engine thread)
    # and the engine layer (the class-wide step lock by which engines in
    # one process take turns, the kernel engine's books, the mesh
    # engine's attach registry)
    "dragonboat_tpu_torch/graphs.py",
    "dragonboat_tpu_torch/engine/dispatch.py",
    "dragonboat_tpu_torch/engine/kernel_engine.py",
    "dragonboat_tpu_torch/engine/mesh_engine.py",
)

LOCK_CTORS = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                        "BoundedSemaphore"})
MUTABLE_CTORS = frozenset({"dict", "list", "set", "deque", "defaultdict",
                           "OrderedDict", "Counter", "bytearray"})
MUTATING_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "remove", "discard", "clear", "update", "add",
    "setdefault", "sort", "reverse", "rotate",
})

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_<][A-Za-z0-9_\->]*)")

INIT_ONLY = "<init-only>"

# acquiring one of these twice on the same thread is safe
REENTRANT_CTORS = frozenset({"RLock", "Condition"})


def _ctor_name(node: ast.AST) -> str | None:
    """`threading.Lock()` -> "Lock"; `deque()` -> "deque"."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _lock_kind(node: ast.AST) -> str | None:
    """The lock ctor name when ``node`` builds a lock (or lock array)."""
    name = _ctor_name(node)
    if name in LOCK_CTORS:
        return name
    # [threading.Lock() for _ in range(n)] — a lock *array*
    if isinstance(node, ast.ListComp):
        name = _ctor_name(node.elt)
        if name in LOCK_CTORS:
            return name
    if isinstance(node, (ast.List, ast.Tuple)) and node.elts and all(
            _ctor_name(e) in LOCK_CTORS for e in node.elts):
        return _ctor_name(node.elts[0])
    return None


def _is_lock_value(node: ast.AST) -> bool:
    return _lock_kind(node) is not None


def _is_mutable_value(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    return _ctor_name(node) in MUTABLE_CTORS


def _self_attr(node: ast.AST) -> str | None:
    """The attribute name when ``node`` is exactly ``self.<attr>``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _self_attr_base(node: ast.AST) -> str | None:
    """`self.x`, `self.x[i]`, `self.x[i][j]` -> "x"."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return _self_attr(node)


class _ClassInfo:
    def __init__(self, cls: ast.ClassDef, src_lines: list[str]) -> None:
        self.cls = cls
        self.locks: set[str] = set()
        self.lock_kinds: dict[str, str] = {}  # attr -> ctor name
        self.guards: dict[str, str] = {}   # attr -> lock name / INIT_ONLY
        self.mutable_unannotated: list[tuple[str, int]] = []
        init = next((n for n in cls.body
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "__init__"), None)
        if init is None:
            return
        for node in ast.walk(init):
            targets: list[ast.AST] = []
            value: ast.AST | None = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                kind = _lock_kind(value)
                if kind is not None:
                    self.locks.add(attr)
                    self.lock_kinds[attr] = kind
                    continue
                m = _GUARD_RE.search(src_lines[node.lineno - 1])
                if m:
                    self.guards[attr] = m.group(1)
                elif _is_mutable_value(value):
                    self.mutable_unannotated.append((attr, node.lineno))


class _MethodChecker(ast.NodeVisitor):
    """Flag guarded-attr mutations outside their lock's with-block."""

    def __init__(self, info: _ClassInfo, relpath: str,
                 findings: list[Finding]) -> None:
        self.info = info
        self.relpath = relpath
        self.findings = findings
        self.held: list[str] = []       # lock-attr names currently held

    def _flag(self, node: ast.AST, attr: str) -> None:
        guard = self.info.guards[attr]
        if guard == INIT_ONLY:
            msg = (f"`self.{attr}` is declared init-only but mutated "
                   f"after __init__")
        else:
            msg = (f"mutation of `self.{attr}` outside `with "
                   f"self.{guard}:` (declared guarded-by: {guard})")
        self.findings.append(Finding(PASS, self.relpath, node.lineno,
                                     "CC002", msg))

    def _check_target(self, node: ast.AST, stmt: ast.AST) -> None:
        attr = _self_attr_base(node)
        if attr is None or attr not in self.info.guards:
            return
        guard = self.info.guards[attr]
        if guard == INIT_ONLY or guard not in self.held:
            self._flag(stmt, attr)

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            attr = _self_attr_base(item.context_expr)
            if attr is not None and attr in self.info.locks:
                acquired.append(attr)
                self.held.append(attr)
        self.generic_visit(node)
        for a in acquired:
            self.held.remove(a)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            for el in (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                       else [tgt]):
                self._check_target(el, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._check_target(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._check_target(tgt, node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATING_METHODS:
            self._check_target(f.value, node)
        self.generic_visit(node)


class _LockOrderVisitor(ast.NodeVisitor):
    """Per-method acquisition structure for the CC003 lock-order graph.

    Collects (a) direct lock acquisitions with the held-stack at that
    point, and (b) same-class method calls with the held-stack at the
    call site; ``_lock_order_edges`` closes (b) over each callee's
    transitive acquisition set.
    """

    def __init__(self, locks: set[str]) -> None:
        self.locks = locks
        self.held: list[str] = []
        # lock acquired -> (held locks at acquisition, lineno)
        self.acquisitions: list[tuple[str, tuple[str, ...], int]] = []
        # same-class method called -> (held locks at call, lineno)
        self.calls: list[tuple[str, tuple[str, ...], int]] = []

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            attr = _self_attr_base(item.context_expr)
            if attr is not None and attr in self.locks:
                self.acquisitions.append(
                    (attr, tuple(self.held), item.context_expr.lineno))
                acquired.append(attr)
                self.held.append(attr)
        self.generic_visit(node)
        for a in acquired:
            self.held.remove(a)

    def visit_Call(self, node: ast.Call) -> None:
        meth = _self_attr(node.func)
        if meth is not None:
            self.calls.append((meth, tuple(self.held), node.lineno))
        self.generic_visit(node)


def _lock_order_edges(info: _ClassInfo
                      ) -> dict[tuple[str, str], tuple[int, str]]:
    """Edges ``(held, acquired) -> (lineno, via)`` for one class."""
    methods = {n.name: n for n in info.cls.body
               if isinstance(n, ast.FunctionDef)}
    visits = {}
    for name, fn in methods.items():
        v = _LockOrderVisitor(info.locks)
        for st in fn.body:
            v.visit(st)
        visits[name] = v
    # transitive closure: every lock a method can acquire, including
    # through same-class calls (cycle-tolerant fixpoint)
    acquires = {name: {a for a, _, _ in v.acquisitions}
                for name, v in visits.items()}
    changed = True
    while changed:
        changed = False
        for name, v in visits.items():
            for callee, _, _ in v.calls:
                if callee in acquires and not (
                        acquires[callee] <= acquires[name]):
                    acquires[name] |= acquires[callee]
                    changed = True
    edges: dict[tuple[str, str], tuple[int, str]] = {}
    for name, v in visits.items():
        for lock, held, line in v.acquisitions:
            for h in held:
                edges.setdefault((h, lock), (line, name))
        for callee, held, line in v.calls:
            if not held or callee not in acquires:
                continue
            for lock in acquires[callee]:
                for h in held:
                    edges.setdefault(
                        (h, lock), (line, f"{name} -> self.{callee}()"))
    return edges


def _find_cycle(nodes: set[str], edges: set[tuple[str, str]]
                ) -> list[str] | None:
    """One directed cycle as [a, b, ..., a], or None."""
    succ: dict[str, list[str]] = {n: [] for n in nodes}
    for a, b in edges:
        succ.setdefault(a, []).append(b)
    state: dict[str, int] = {}
    stack: list[str] = []

    def dfs(n: str) -> list[str] | None:
        state[n] = 1
        stack.append(n)
        for m in sorted(succ.get(n, ())):
            if state.get(m, 0) == 1:
                return stack[stack.index(m):] + [m]
            if state.get(m, 0) == 0:
                cyc = dfs(m)
                if cyc is not None:
                    return cyc
        stack.pop()
        state[n] = 2
        return None

    for n in sorted(nodes):
        if state.get(n, 0) == 0:
            cyc = dfs(n)
            if cyc is not None:
                return cyc
    return None


def _check_lock_order(cls: ast.ClassDef, info: _ClassInfo, relpath: str,
                      findings: list[Finding]) -> None:
    edges = _lock_order_edges(info)
    # self-edge on a non-reentrant lock: one thread deadlocks itself
    for (a, b), (line, via) in sorted(edges.items()):
        if a == b and info.lock_kinds.get(a) not in REENTRANT_CTORS:
            findings.append(Finding(
                PASS, relpath, line, "CC003",
                f"{cls.name}: `self.{a}` "
                f"({info.lock_kinds.get(a, 'Lock')}) re-acquired while "
                f"already held (via {via}) — non-reentrant, deadlocks "
                "the acquiring thread"))
    proper = {(a, b) for (a, b) in edges if a != b}
    cyc = _find_cycle({n for e in proper for n in e}, proper)
    if cyc is not None:
        sites = "; ".join(
            f"{a}->{b} at line {edges[(a, b)][0]} ({edges[(a, b)][1]})"
            for a, b in zip(cyc, cyc[1:]))
        findings.append(Finding(
            PASS, relpath, edges[(cyc[0], cyc[1])][0], "CC003",
            f"{cls.name}: lock-order cycle "
            f"{' -> '.join('self.' + n for n in cyc)} — two threads "
            f"interleaving these paths deadlock ({sites})"))


def _check_class(cls: ast.ClassDef, info: _ClassInfo, relpath: str,
                 findings: list[Finding]) -> None:
    if not info.locks:
        return                          # not a lock-owning class
    for attr, line in info.mutable_unannotated:
        findings.append(Finding(
            PASS, relpath, line, "CC001",
            f"mutable attribute `self.{attr}` of lock-owning class "
            f"{cls.name} has no `# guarded-by:` annotation"))
    for node in cls.body:
        if not isinstance(node, ast.FunctionDef) or node.name == "__init__":
            continue
        _MethodChecker(info, relpath, findings).visit(node)
    _check_lock_order(cls, info, relpath, findings)


def run(root: str, files: list[str] | None = None) -> list[Finding]:
    paths = files if files is not None else [
        os.path.join(root, m) for m in DEFAULT_MODULES]
    findings: list[Finding] = []
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p, encoding="utf-8") as f:
            src = f.read()
        tree = ast.parse(src, filename=p)
        lines = src.splitlines()
        classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
        infos = {c.name: _ClassInfo(c, lines) for c in classes}
        # single-module inheritance: a book subclassing _ClockedBook owns
        # its base's lock and inherits its guard declarations
        for c in classes:
            seen, stack = {c.name}, [b.id for b in c.bases
                                     if isinstance(b, ast.Name)]
            while stack:
                base = stack.pop()
                if base in seen or base not in infos:
                    continue
                seen.add(base)
                infos[c.name].locks |= infos[base].locks
                for attr, k in infos[base].lock_kinds.items():
                    infos[c.name].lock_kinds.setdefault(attr, k)
                for attr, g in infos[base].guards.items():
                    infos[c.name].guards.setdefault(attr, g)
                stack.extend(b.id for b in infos[base].cls.bases
                             if isinstance(b, ast.Name))
        for c in classes:
            _check_class(c, infos[c.name], rel(root, p), findings)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
