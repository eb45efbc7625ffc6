"""Determinism lint for the replay paths (``core/`` and ``rsm/``).

A raft log replayed on two replicas must produce bit-identical state;
so must the kernel↔pycore differential harness.  Anything that can make
two replays diverge is banned from these modules:

- DT001  wall clock: ``time.time`` / ``monotonic`` / ``perf_counter`` /
         ``*_ns`` / ``datetime.now`` / ``utcnow`` / ``today`` — replay
         must be a pure function of the log, never of the wall;
- DT002  unseeded RNG: module-level ``random.*`` and global
         ``np.random.*`` draws (``jax.random`` is keyed and explicit,
         and the kernel's splitmix32 timeout draw is seeded state —
         both fine);
- DT003  set-iteration-order dependence: iterating a ``set`` (display,
         ``set(...)`` constructor, or a local assigned from one)
         without ``sorted()`` — CPython set order varies with insertion
         history and PYTHONHASHSEED for str keys.  Dict iteration is
         insertion-ordered and allowed.
"""

from __future__ import annotations

import ast
import glob
import os

from dragonboat_tpu_torch.analysis.common import Finding, rel

PASS = "determinism"

DEFAULT_GLOBS = (
    "dragonboat_tpu_torch/core/*.py",
    "dragonboat_tpu_torch/rsm/*.py",
    # the replay-contract side of the chaos harness: plan generation,
    # fault cartridge, oracle.  runner.py is deliberately NOT listed —
    # it waits on real elections/recovery, so wall-clock use is its job;
    # the deterministic trace contract lives in these three.
    "dragonboat_tpu_torch/chaos/faultplan.py",
    "dragonboat_tpu_torch/chaos/crashfs.py",
    "dragonboat_tpu_torch/chaos/oracle.py",
    # telemetry must never perturb a replay: no clocks, no randomness —
    # instruments observe caller-supplied values, the flight recorder
    # stamps records with a caller-side monotonic sequence
    "dragonboat_tpu_torch/telemetry.py",
    "dragonboat_tpu_torch/flight.py",
    # the lifecycle tracer follows the same contract: its microsecond
    # clock is INJECTED (tracing.monotonic_us lives outside this scope),
    # so the module itself names no wall clock
    "dragonboat_tpu_torch/lifecycle.py",
    # the capacity rail too: the compile tracker's clock is injected,
    # flight records are stamped with call counts, never wall time
    "dragonboat_tpu_torch/capacity.py",
    # the fabric meter: same injected-clock contract as the lifecycle
    # tracer (delivery latencies and remote-span stamps come off the
    # injected microsecond clock), and distinct-host sets are
    # insertion-ordered dicts so snapshots carry no set-order noise
    "dragonboat_tpu_torch/fabric.py",
    # the elastic controller: decisions must be a pure function of the
    # observation sequence (digest + seeded splitmix32 tie-break) so a
    # replayed flight record reproduces every transfer — no wall clock,
    # no unseeded RNG, no set-order dependence
    "dragonboat_tpu_torch/control.py",
)

WALL_CLOCK = {
    ("time", "time"), ("time", "time_ns"),
    ("time", "monotonic"), ("time", "monotonic_ns"),
    ("time", "perf_counter"), ("time", "perf_counter_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
}

RNG_ROOTS = {"random", "np.random", "numpy.random"}


def _dotted(node: ast.AST) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_set_expr(node: ast.AST, set_names: set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
        # s.union(...), s.intersection(...) etc. on a known set
        if isinstance(f, ast.Attribute) and _is_set_expr(f.value, set_names):
            return True
    if isinstance(node, ast.Name):
        return node.id in set_names
    if isinstance(node, ast.BinOp):   # s1 | s2 on known sets
        return (_is_set_expr(node.left, set_names)
                and _is_set_expr(node.right, set_names))
    return False


class _Checker(ast.NodeVisitor):
    def __init__(self, relpath: str, findings: list[Finding]) -> None:
        self.relpath = relpath
        self.findings = findings
        self.set_names: set[str] = set()

    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(PASS, self.relpath, node.lineno,
                                     rule, msg))

    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        if d is not None:
            parts = d.split(".")
            root, leaf = ".".join(parts[:-1]), parts[-1]
            if (root, leaf) in WALL_CLOCK or (
                    root.endswith(".datetime")
                    and leaf in ("now", "utcnow", "today")):
                self._flag(node, "DT001",
                           f"wall clock `{d}()` in a replay path — replay "
                           "must be a pure function of the log")
            elif root in RNG_ROOTS:
                self._flag(node, "DT002",
                           f"unseeded global RNG `{d}()` in a replay path "
                           "(thread a seeded generator instead)")
        self.generic_visit(node)

    def _note_assign(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            if _is_set_expr(value, self.set_names):
                self.set_names.add(target.id)
            else:
                self.set_names.discard(target.id)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._note_assign(t, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._note_assign(node.target, node.value)
        self.generic_visit(node)

    def _check_iter(self, it: ast.AST) -> None:
        if _is_set_expr(it, self.set_names):
            self._flag(it, "DT003",
                       "iteration over a set in a replay path — order "
                       "varies across processes; wrap in sorted()")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)


def run(root: str, files: list[str] | None = None) -> list[Finding]:
    if files is None:
        files = []
        for g in DEFAULT_GLOBS:
            files.extend(sorted(glob.glob(os.path.join(root, g))))
    findings: list[Finding] = []
    for p in files:
        if not os.path.exists(p):
            continue
        with open(p, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=p)
        _Checker(rel(root, p), findings).visit(tree)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
