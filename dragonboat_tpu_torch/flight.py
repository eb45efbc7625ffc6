"""Flight recorder: a bounded ring buffer of fleet transition records.

When a chaos schedule diverges or an operator asks "what happened just
before this", per-shard state is already gone — the kernel overwrote
it.  The flight recorder keeps the last N *transitions* (leader
changes, term bumps, snapshot send/recv, breaker trips, quarantine
truncations, chaos fault injections) as small structured dicts,
dumpable to JSON on demand and automatically appended to a chaos-oracle
failure report.

Determinism: this module is in the determinism lint scope.  Records are
stamped with a process-monotonic sequence number plus whatever tick the
*caller* supplies (engine step counters, chaos event indices) — never
the wall clock — so a replayed schedule produces an identical tail.
"""

from __future__ import annotations

import json
import threading
from collections import deque

# transition kinds recorded by the built-in hooks (callers may add more)
LEADER_CHANGE = "leader_change"
SNAPSHOT = "snapshot"
BREAKER_TRIP = "breaker_trip"
QUARANTINE = "quarantine"
CHAOS_FAULT = "chaos_fault"
EVICTION = "eviction"
SLOW_COMMIT = "slow_commit"
ANOMALY_RAISED = "anomaly_raised"
ANOMALY_CLEARED = "anomaly_cleared"
RETRACE_STORM = "retrace_storm"
MEMORY_PRESSURE = "memory_pressure"
INVARIANT_VIOLATION = "invariant_violation"
CONTROL_TRANSFER = "control_transfer"
ADMISSION_REFUSED = "admission_refused"


class FlightRecorder:
    """Thread-safe bounded ring of structured transition records."""

    def __init__(self, capacity: int = 512) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.mu = threading.Lock()
        self._cond = threading.Condition(self.mu)
        self._records: deque = deque(maxlen=capacity)     # guarded-by: mu
        self._seq = 0                                     # guarded-by: mu

    def record(self, kind: str, **fields) -> int:
        """Append one record; returns its monotonic sequence number.
        ``fields`` must be JSON-serializable (enforced at dump time)."""
        with self.mu:
            seq = self._seq
            self._seq += 1
            rec = {"seq": seq, "kind": kind}
            rec.update(fields)
            self._records.append(rec)
            self._cond.notify_all()
        return seq

    def wait_beyond(self, seq: int, timeout: float | None = None) -> bool:
        """Block until a record with sequence >= ``seq`` exists (i.e. at
        least one record landed after the caller sampled ``next_seq``).
        Event-driven convergence waits poll THIS instead of sleeping:
        the chaos runner re-checks its oracle each time any transition
        (anomaly_cleared, leader_change, ...) is recorded.  Returns
        False on timeout."""
        with self.mu:
            return self._cond.wait_for(lambda: self._seq > seq, timeout)

    def __len__(self) -> int:
        with self.mu:
            return len(self._records)

    @property
    def next_seq(self) -> int:
        with self.mu:
            return self._seq

    def tail(self, k: int | None = None) -> list:
        """The most recent ``k`` records (all retained when ``k`` is
        None), oldest first, as fresh dicts."""
        with self.mu:
            recs = [dict(r) for r in self._records]
        if k is not None and k >= 0:
            recs = recs[len(recs) - min(k, len(recs)):]
        return recs

    def clear(self) -> None:
        """Drop retained records; the sequence counter keeps running so
        pre/post-clear records remain ordered."""
        with self.mu:
            self._records.clear()

    def dump_json(self, k: int | None = None, indent: int | None = None
                  ) -> str:
        """Canonical JSON of ``tail(k)`` (sorted keys, stable across
        processes for identical record streams)."""
        return json.dumps(self.tail(k), sort_keys=True, indent=indent)

    def dump(self, path: str, k: int | None = None) -> str:
        """Write ``dump_json`` to ``path``; returns the path."""
        data = self.dump_json(k, indent=2)
        with open(path, "w", encoding="utf-8") as f:
            f.write(data + "\n")
        return path


# process-wide recorder: producers (events hub, transport hub, logdb,
# chaos runner) record here so one dump shows the interleaved fleet
# history across every host in the process
RECORDER = FlightRecorder()


def record(kind: str, **fields) -> int:
    return RECORDER.record(kind, **fields)
