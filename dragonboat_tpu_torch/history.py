"""Client-history recording + linearizability checking.

The reference's nightly chaos harness records client histories and checks
them with Jepsen Knossos / porcupine (docs/test.md; published runs at
github.com/lni/knossos-data).  This module is the equivalent seam:

- :class:`HistoryRecorder` — wraps client ops with invoke/complete
  timestamps; thread-safe; one record per operation attempt.  Timed-out
  ops stay OPEN (outcome unknown — they may have applied), which is
  exactly what a linearizability checker must assume.
- :meth:`HistoryRecorder.export_jsonl` — porcupine-style JSONL (one op
  per line: process, op, key, value, call, return, ok) for offline
  checking with external tools.
- :func:`check_linearizable_kv` — built-in Wing&Gong-style checker for
  per-key register histories (reads/writes), usable directly in chaos
  tests.  Exponential in the worst case — meant for test-sized
  histories (hundreds of ops per key).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass


@dataclass
class Op:
    process: int
    op: str                  # "write" | "read"
    key: str
    value: object            # written value, or value observed by a read
    call: float              # invoke timestamp (monotonic)
    ret: float | None = None  # completion timestamp; None = open (unknown)
    ok: bool | None = None   # False = known-failed (never applied)
    idx: int = 0


class HistoryRecorder:
    """Thread-safe operation history (docs/test.md history recording)."""

    def __init__(self) -> None:
        self.mu = threading.Lock()
        self.ops: list[Op] = []

    def invoke(self, process: int, op: str, key: str, value=None) -> Op:
        rec = Op(process=process, op=op, key=key, value=value,
                 call=time.monotonic())
        with self.mu:
            rec.idx = len(self.ops)
            self.ops.append(rec)
        return rec

    def complete(self, rec: Op, value=None, ok: bool = True) -> None:
        rec.ret = time.monotonic()
        if rec.op == "read":
            rec.value = value
        rec.ok = ok

    def fail(self, rec: Op) -> None:
        """The op is KNOWN to have not applied (e.g. rejected)."""
        rec.ret = time.monotonic()
        rec.ok = False

    # a timed-out op is simply never completed: ret stays None and the
    # checker must consider both it-applied and it-never-applied

    def export_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for o in self.ops:
                f.write(json.dumps({
                    "process": o.process, "op": o.op, "key": o.key,
                    "value": o.value, "call": o.call, "return": o.ret,
                    "ok": o.ok,
                }) + "\n")


def check_linearizable_kv(ops: list[Op], initial=None) -> bool:
    """Check a register history per key (writes + reads).

    Open ops (ret is None) may linearize at any point after their call —
    or never (their effect may or may not exist).  Known-failed ops are
    excluded.  Returns True iff every key's history is linearizable."""
    by_key: dict[str, list[Op]] = {}
    for o in ops:
        if o.ok is False:
            continue
        by_key.setdefault(o.key, []).append(o)
    return all(_check_register(v, initial) for v in by_key.values())


def _check_register(ops: list[Op], initial) -> bool:
    """Wing & Gong search with memoization over (done-set, value)."""
    n = len(ops)
    if n == 0:
        return True
    INF = float("inf")

    def precedes(a: Op, b: Op) -> bool:
        ra = a.ret if a.ret is not None else INF
        return ra < b.call

    ops = sorted(ops, key=lambda o: o.call)
    seen: set[tuple[frozenset, object]] = set()

    def memo_key(value):
        # values may be unhashable (dicts/lists from user SMs); the memo
        # key only needs equality-consistency, so canonicalize via repr
        try:
            hash(value)
            return value
        except TypeError:
            return repr(value)

    def minimal(done: frozenset) -> list[int]:
        """Ops not done whose every predecessor is done."""
        out = []
        for i, o in enumerate(ops):
            if i in done:
                continue
            if all((j in done) or not precedes(ops[j], o)
                   for j in range(n) if j != i):
                out.append(i)
        return out

    def choices(done: frozenset, value):
        """(next_done, next_value) successors from this state."""
        for i in minimal(done):
            o = ops[i]
            if o.op == "write":
                yield done | {i}, o.value
                if o.ret is None:
                    # an OPEN write may also never take effect
                    yield done | {i}, value
            else:  # read
                if o.ret is None or o.value == value:
                    yield done | {i}, value

    # iterative DFS (histories can be thousands of ops; recursion depth
    # would equal the op count)
    stack = [choices(frozenset(), initial)]
    if n == 0:
        return True
    seen.add((frozenset(), memo_key(initial)))
    while stack:
        it = stack[-1]
        advanced = False
        for done, value in it:
            if len(done) == n:
                return True
            key = (done, memo_key(value))
            if key in seen:
                continue
            seen.add(key)
            stack.append(choices(done, value))
            advanced = True
            break
        if not advanced:
            stack.pop()
    return False
