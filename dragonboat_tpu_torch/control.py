"""Elastic fleet control plane: the observe→act loop's decision core.

The health subsystem (core/health.py) *observes* — a device-side top-K
offender digest plus step-latency telemetry.  This module *decides*:
given one decimated observation, which leaderships should move off this
host (``transfer``) and whether a new device-resident replica may be
admitted under the capacity budget (``refuse``).  The NodeHost applies
the decisions (``request_leader_transfer`` / rejecting
``start_replica``) and flight-records each one with its evidence row;
``fleet_doctor --plan`` runs the same planner read-only over a scraped
``info()`` payload.

Determinism doctrine: a decision is a pure function of the observation
sequence fed in — digest contents, shard rows, the host-hot flag — plus
the policy's fixed seed.  No wall clock, no ambient RNG: the transfer
target tie-break is a splitmix32 hash over (seed, shard_id, term), so
two replays of the same observations plan the same actions, and the
flight recorder's evidence rows are comparable across runs.

Concurrency doctrine: a ``FleetController`` is single-owner state — the
NodeHost calls ``observe`` from its engine tick round only, the doctor
builds a throwaway instance per plan.  It therefore owns no lock; do
not share one instance across threads.

Rate limiting is structural, not temporal: at most
``max_transfers`` per observation, ``hysteresis`` consecutive hot
observations before a shard is acted on, and a per-shard
``cooldown_obs`` observation cooldown after an issued transfer — all
counted in decimated observations (``fleet_stats_every`` engine steps
each), never in seconds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# decision kinds (Decision.kind / flight-record payloads)
TRANSFER = "transfer"
REFUSE = "refuse"

# admission policy modes (ExpertConfig.admission_policy)
ADMISSION_ENFORCE = "enforce"
ADMISSION_WARN = "warn"
ADMISSION_OFF = "off"
ADMISSION_MODES = (ADMISSION_ENFORCE, ADMISSION_WARN, ADMISSION_OFF)

_MASK32 = 0xFFFFFFFF


def splitmix32(x: int) -> int:
    """One round of the splitmix32 mixer — the same construction the
    kernel uses for randomized election timeouts (core/kernel.py), kept
    host-side here so transfer-target selection is seeded state, not
    ambient RNG (determinism lint DT002 doctrine)."""
    x = (x + 0x9E3779B9) & _MASK32
    z = x
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _MASK32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _MASK32
    return (z ^ (z >> 16)) & _MASK32


@dataclass(frozen=True)
class ControlPolicy:
    """Planner knobs.  Defaults mirror ExpertConfig (config.py) — the
    NodeHost builds one of these from its expert block."""

    enabled: bool = False
    #: offender severity (health.py weighted class score) at or above
    #: which a led shard counts as hot
    hot_score: int = 8
    #: commit-applied lag at or above which a led shard counts as hot
    #: even when its class score is below hot_score
    lag_hot: int = 64
    #: consecutive hot observations before a transfer is issued
    hysteresis: int = 2
    #: observations a shard is exempt after a transfer was issued for it
    cooldown_obs: int = 8
    #: max transfers issued per observation (per decimated tick)
    max_transfers: int = 2
    #: tie-break seed for target selection
    seed: int = 0
    #: observations during which the host_hot latency input is IGNORED:
    #: the first engine steps after process start carry the jit-compile
    #: cost, so the step EWMA opens orders of magnitude above any sane
    #: threshold and would drain a perfectly healthy host.  Digest
    #: inputs (score/lag) are not suppressed — they are per-lane
    #: detector verdicts, not wall-clock measurements
    warmup_obs: int = 8


@dataclass(frozen=True)
class Decision:
    """One planned action, with the observation slice that justified it
    (the flight-record payload and the doctor's evidence row)."""

    kind: str          # TRANSFER | REFUSE
    shard_id: int
    target: int        # transferee replica id (0 for REFUSE)
    evidence: dict = field(default_factory=dict)


def pick_target(seed: int, shard_id: int, term: int, voters,
                exclude: int) -> int:
    """Deterministic transfer target: a voter != ``exclude`` chosen by
    splitmix32 over (seed, shard_id, term).  Term is in the key so a
    repeat decision after a failed transfer (term moved) can land on a
    different peer.  Returns 0 when no other voter exists."""
    others = sorted(int(v) for v in voters if int(v) != exclude)
    if not others:
        return 0
    h = splitmix32((seed & _MASK32)
                   ^ splitmix32(shard_id & _MASK32)
                   ^ splitmix32(term & _MASK32))
    return others[h % len(others)]


def shard_voters(shard: dict) -> tuple:
    """Voter replica ids from an ``info()`` shard row's membership."""
    mb = shard.get("membership") or {}
    return tuple(sorted(int(r) for r in (mb.get("addresses") or {})))


class FleetController:
    """Hysteresis-guarded, rate-limited leadership rebalancer.

    Feed it one observation per decimated tick via ``observe``; it
    returns the transfers to issue *this* observation.  All internal
    state (hot streaks, cooldowns, observation index) advances only on
    ``observe`` calls, so the decision sequence is a pure function of
    the observation sequence.
    """

    def __init__(self, policy: ControlPolicy | None = None) -> None:
        self.policy = policy or ControlPolicy()
        self._obs = 0               # observation index (decimated ticks)
        self._streak: dict = {}     # shard_id -> consecutive hot count
        self._cool: dict = {}       # shard_id -> obs index cooldown ends
        self.planned = 0            # cumulative transfers planned

    # -- observation -----------------------------------------------------

    def observe(self, worst, shards, host_hot: bool = False) -> list:
        """Plan transfers for one observation.

        ``worst``: offender rows (health.report_to_dict shape — dicts
        with lane/score/lag/classes/term).  ``shards``: this host's
        shard rows ({shard_id, lane, is_leader, replica_id, term,
        membership}).  ``host_hot``: step-latency telemetry says this
        host's engine is slow (EWMA over threshold) — EVERY led shard
        becomes a drain candidate, digest row or not, because host-level
        overload (e.g. apply backpressure throttling the whole engine
        round) is not attributable to any one anomalous lane.
        """
        self._obs += 1
        pol = self.policy
        by_lane = {int(r.get("lane", -1)): r for r in (worst or [])}

        candidates = []
        hot_ids: dict = {}     # shard_id -> True (insertion-ordered set)
        for sh in shards or []:
            if not sh.get("is_leader"):
                continue
            sid = int(sh["shard_id"])
            row = by_lane.get(int(sh.get("lane", -2)))
            score = int(row["score"]) if row else 0
            lag = int(row["lag"]) if row else 0
            hot = (score >= pol.hot_score
                   or lag >= pol.lag_hot
                   or (host_hot and self._obs > pol.warmup_obs))
            if not hot:
                continue
            hot_ids[sid] = True
            streak = self._streak.get(sid, 0) + 1
            self._streak[sid] = streak
            if streak < pol.hysteresis:
                continue
            if self._obs < self._cool.get(sid, 0):
                continue
            candidates.append((score, lag, sid, sh, row, streak))
        # hysteresis means CONSECUTIVE hot observations: any shard not
        # hot this round (including ones the caller no longer reports)
        # restarts from zero
        for sid in [s for s in self._streak if s not in hot_ids]:
            del self._streak[sid]

        # severity-ordered, shard id as the stable tie-break
        candidates.sort(key=lambda c: (-c[0], -c[1], c[2]))

        out = []
        for score, lag, sid, sh, row, streak in candidates:
            if not pol.enabled or len(out) >= pol.max_transfers:
                break
            term = int(sh.get("term", 0))
            target = pick_target(pol.seed, sid, term, shard_voters(sh),
                                 int(sh.get("replica_id", 0)))
            if target == 0:
                continue  # singleton: nowhere to move leadership
            self._cool[sid] = self._obs + pol.cooldown_obs
            self._streak.pop(sid, None)
            self.planned += 1
            out.append(Decision(
                kind=TRANSFER, shard_id=sid, target=target,
                evidence={
                    "obs": self._obs, "lane": int(sh.get("lane", -1)),
                    "score": score, "lag": lag, "streak": streak,
                    "term": term, "host_hot": bool(host_hot),
                    "classes": list((row or {}).get("classes", ())),
                }))
        return out


# -- capacity-driven admission ------------------------------------------


def admission_limit(kp, budget_bytes: int, watermark_pct: float,
                    max_g_for_budget) -> int:
    """Device-resident shard ceiling: the modeled capacity for the
    budget, derated by the headroom watermark.  Returns 0 when no
    budget is resolvable (admission then never refuses — capacity
    unknown is not capacity exhausted)."""
    if budget_bytes <= 0:
        return 0
    g = max_g_for_budget(kp, budget_bytes)
    keep = max(0.0, 1.0 - float(watermark_pct) / 100.0)
    return max(1, int(g * keep)) if g > 0 else 0


def plan_to_dict(decisions, quiesced: int = 0) -> dict:
    """JSON-able dry-run plan (``fleet_doctor --plan``): the decision
    list as evidence-bearing rows plus summary counts.  ``quiesced`` is
    the host's masked-quiesced lane count (fleet stats), reported so an
    operator sees the third control-plane verb alongside the two the
    planner can still take."""
    transfers = [
        {"shard_id": int(d.shard_id), "target": int(d.target),
         "evidence": dict(d.evidence)}
        for d in decisions if d.kind == TRANSFER]
    refusals = [
        {"shard_id": int(d.shard_id), "evidence": dict(d.evidence)}
        for d in decisions if d.kind == REFUSE]
    return {
        "transfers": transfers,
        "refusals": refusals,
        "counts": {"transfer": len(transfers), "refuse": len(refusals),
                   "quiesced": int(quiesced)},
    }


def _plan_req(d: dict, key: str, typ, where: str):
    if key not in d:
        raise ValueError(f"{where}: missing key {key!r}")
    v = d[key]
    if isinstance(v, bool) and typ is int or not isinstance(v, typ):
        raise ValueError(f"{where}.{key}: expected {typ.__name__}, "
                         f"got {type(v).__name__}")
    return v


def validate_plan(plan: dict, where: str = "plan") -> None:
    """Strictly check a ``plan_to_dict`` payload; raises ValueError
    naming the offending path (the same doctrine as
    core/health.validate_info — the doctor's output is a schema other
    tools may scrape, not prose)."""
    if set(plan) != {"transfers", "refusals", "counts"}:
        raise ValueError(f"{where}: keys {sorted(plan)} != "
                         f"['counts', 'refusals', 'transfers']")
    for i, t in enumerate(_plan_req(plan, "transfers", list, where)):
        w = f"{where}.transfers[{i}]"
        _plan_req(t, "shard_id", int, w)
        if _plan_req(t, "target", int, w) <= 0:
            raise ValueError(f"{w}.target: must be a replica id")
        ev = _plan_req(t, "evidence", dict, w)
        for key in ("obs", "lane", "score", "lag", "streak", "term"):
            _plan_req(ev, key, int, f"{w}.evidence")
        _plan_req(ev, "host_hot", bool, f"{w}.evidence")
        _plan_req(ev, "classes", list, f"{w}.evidence")
    for i, r in enumerate(_plan_req(plan, "refusals", list, where)):
        w = f"{where}.refusals[{i}]"
        _plan_req(r, "shard_id", int, w)
        ev = _plan_req(r, "evidence", dict, w)
        for key in ("occupied", "limit"):
            _plan_req(ev, key, int, f"{w}.evidence")
        if _plan_req(ev, "mode", str, f"{w}.evidence") not in ADMISSION_MODES:
            raise ValueError(f"{w}.evidence.mode: {ev['mode']!r}")
    counts = _plan_req(plan, "counts", dict, where)
    if set(counts) != {"transfer", "refuse", "quiesced"}:
        raise ValueError(f"{where}.counts: keys {sorted(counts)}")
    for key in ("transfer", "refuse", "quiesced"):
        if _plan_req(counts, key, int, f"{where}.counts") < 0:
            raise ValueError(f"{where}.counts.{key}: negative")
    if counts["transfer"] != len(plan["transfers"]) \
            or counts["refuse"] != len(plan["refusals"]):
        raise ValueError(f"{where}.counts: do not match the rows")


def check_admission(shard_id: int, occupied: int, limit: int,
                    mode: str = ADMISSION_ENFORCE) -> Decision | None:
    """Admission gate for one StartReplica: a REFUSE decision when the
    host is at/over its derated capacity, else None.  ``mode`` "off"
    never refuses; "warn" returns the decision with evidence noting it
    is advisory (the caller records but does not reject)."""
    if mode == ADMISSION_OFF or limit <= 0 or occupied < limit:
        return None
    return Decision(
        kind=REFUSE, shard_id=int(shard_id), target=0,
        evidence={"occupied": int(occupied), "limit": int(limit),
                  "mode": mode})
