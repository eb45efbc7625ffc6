"""FaultPlan — seeded, deterministic composed fault schedules.

A plan is a sequence of :class:`FaultEvent` records over three seams:

========= =============================================================
storage   ``crash_write`` (CrashPointFS trips at the Nth durability op,
          optionally tearing the final write) healed by
          ``restart_inplace`` (NodeHost.restart from the data dir)
transport ``drop`` / ``delay`` / ``duplicate`` / ``reorder`` (chan
          hooks), ``partition`` (monkey.go PartitionNode), and
          ``breaker_trip`` (forced hub CircuitBreaker failures), healed
          by ``heal_transport`` / ``restore_partition``
process   ``kill`` (simulate_kill + MemFS power loss) healed by
          ``restart_process`` (a fresh NodeHost over the same data dir)
========= =============================================================

Generation is a pure function of the seed (``from random import
Random`` — no global RNG, no wall clock), and serialization is
canonical JSON (sorted keys, tight separators), so the SAME seed always
yields the SAME bytes and a recorded trace replays as a plan
(:meth:`FaultPlan.from_json`).

Invariants the generator maintains so every schedule is recoverable:

- at most ONE replica is faulted-down (crashed, killed, or partitioned)
  at any time — a 3-replica shard keeps its quorum;
- every down event is followed by its matching restart/heal event;
- the final step heals everything, so the convergence oracle always
  runs against a fully-connected cluster.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from random import Random

# kinds that take a replica out (at most one outstanding at a time)
DOWN_KINDS = ("crash_write", "kill", "partition")
# benign transport faults that may overlap freely
SOFT_KINDS = ("drop", "delay", "duplicate", "reorder", "breaker_trip")
HEAL_FOR = {
    "crash_write": "restart_inplace",
    "kill": "restart_process",
    "partition": "restore_partition",
    "drop": "heal_transport",
    "delay": "heal_transport",
    "duplicate": "heal_transport",
    "reorder": "heal_transport",
    "breaker_trip": "heal_breaker",
}
SEAM_FOR = {
    "crash_write": "storage",
    "restart_inplace": "storage",
    "kill": "process",
    "restart_process": "process",
    "partition": "transport",
    "restore_partition": "transport",
    "drop": "transport",
    "delay": "transport",
    "duplicate": "transport",
    "reorder": "transport",
    "breaker_trip": "transport",
    "heal_transport": "transport",
    "heal_breaker": "transport",
}


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault (or heal) at a workload step."""

    step: int
    seam: str
    kind: str
    target: int            # replica id
    params: tuple          # sorted (key, value) pairs — hashable, canonical

    def as_dict(self) -> dict:
        return {"step": self.step, "seam": self.seam, "kind": self.kind,
                "target": self.target, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(step=int(d["step"]), seam=str(d["seam"]),
                   kind=str(d["kind"]), target=int(d["target"]),
                   params=tuple(sorted(d.get("params", {}).items())))


def canonical_json(obj) -> str:
    """THE trace encoding: identical structures -> identical bytes."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@dataclass(frozen=True)
class FaultPlan:
    seed: int
    n_replicas: int
    steps: int
    events: tuple

    def events_at(self, step: int) -> list:
        return [e for e in self.events if e.step == step]

    def to_json(self) -> str:
        return canonical_json({
            "seed": self.seed, "n_replicas": self.n_replicas,
            "steps": self.steps,
            "events": [e.as_dict() for e in self.events]})

    @classmethod
    def from_json(cls, blob: str) -> "FaultPlan":
        d = json.loads(blob)
        return cls(seed=int(d["seed"]), n_replicas=int(d["n_replicas"]),
                   steps=int(d["steps"]),
                   events=tuple(FaultEvent.from_dict(e)
                                for e in d["events"]))

    @classmethod
    def generate(cls, seed: int, n_replicas: int = 3,
                 steps: int = 6) -> "FaultPlan":
        """Pure function of (seed, n_replicas, steps)."""
        rng = Random(seed)
        events: list = []
        down: tuple | None = None       # (rid, kind) awaiting its heal
        soft: list = []                 # [(rid, kind)] awaiting heal

        def add(step: int, kind: str, rid: int, **params) -> None:
            events.append(FaultEvent(
                step=step, seam=SEAM_FOR[kind], kind=kind, target=rid,
                params=tuple(sorted(params.items()))))

        for step in range(steps):
            # recover an outstanding down replica before anything else
            # this step (rng-gated so outages span 1..k steps)
            if down is not None and (step == steps - 1
                                     or rng.random() < 0.6):
                rid, kind = down
                add(step, HEAL_FOR[kind], rid)
                down = None
            # heal a lingering soft fault now and then
            if soft and rng.random() < 0.4:
                rid, kind = soft.pop(rng.randrange(len(soft)))
                add(step, HEAL_FOR[kind], rid)
            # inject something new (not on the last step: it must heal)
            if step < steps - 1 and rng.random() < 0.85:
                hard_ok = down is None and step < steps - 2
                kind = rng.choice(DOWN_KINDS + SOFT_KINDS) if hard_ok \
                    else rng.choice(SOFT_KINDS)
                rid = rng.randrange(1, n_replicas + 1)
                if kind in DOWN_KINDS:
                    # never take down a replica already soft-faulted in a
                    # way that would stall its recovery IO
                    if any(r == rid for r, _ in soft):
                        kind = rng.choice(SOFT_KINDS)
                if kind in DOWN_KINDS:
                    if kind == "crash_write":
                        add(step, kind, rid,
                            after_ops=rng.randrange(2, 30),
                            torn=rng.random() < 0.5)
                    else:
                        add(step, kind, rid)
                    down = (rid, kind)
                elif any(r == rid and k == kind for r, k in soft):
                    pass        # already active on this replica
                elif kind == "drop":
                    add(step, kind, rid, every=rng.randrange(3, 7))
                    soft.append((rid, kind))
                elif kind == "delay":
                    add(step, kind, rid,
                        seconds=rng.choice((0.002, 0.005, 0.01)))
                    soft.append((rid, kind))
                elif kind == "duplicate":
                    add(step, kind, rid, every=rng.randrange(2, 5))
                    soft.append((rid, kind))
                elif kind == "reorder":
                    add(step, kind, rid, seed=rng.getrandbits(32))
                    soft.append((rid, kind))
                else:           # breaker_trip: self-heals after cooldown
                    add(step, kind, rid, count=1)
        # final barrier: everything heals at step == steps
        if down is not None:
            add(steps, HEAL_FOR[down[1]], down[0])
        for rid, kind in soft:
            add(steps, HEAL_FOR[kind], rid)
        return cls(seed=seed, n_replicas=n_replicas, steps=steps,
                   events=tuple(events))
