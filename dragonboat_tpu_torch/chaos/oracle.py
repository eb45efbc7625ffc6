"""Convergence oracle — pure checks over replica observations.

The runner samples each replica's applied journal (the exact sequence
of committed user commands its SM applied), applied index, and the
monkey.go hash oracles; these functions turn the samples into a
verdict.  Everything here is pure data -> data so the determinism lint
covers it and tests can feed synthetic histories.

The three safety properties (round 3 tentpole):

- **zero committed-entry loss** — every command the workload saw an ack
  for is present in every replica's journal;
- **identical committed prefixes** — any two replicas' journals are
  prefix-ordered at all times, and equal at convergence;
- **monotone applied indices** — a replica's applied index never moves
  backwards between samples (restart resets the baseline: recovery
  legitimately replays from a snapshot/zero up to the durable commit).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class OracleReport:
    ok: bool = True
    failures: list = field(default_factory=list)
    # last flight-recorder records at failure time, attached by the
    # RUNNER (this module stays pure — no clocks, no global recorder
    # reads — so the determinism lint keeps covering it)
    flight_tail: list = field(default_factory=list)
    # runtime invariant-probe counters harvested from every live host
    # after the final heal (attached by the runner; see
    # check_invariant_probe for the verdict over them)
    invariant_probe: dict = field(default_factory=dict)

    def fail(self, msg: str) -> None:
        self.ok = False
        self.failures.append(msg)

    def merge(self, other: "OracleReport") -> None:
        if not other.ok:
            self.ok = False
            self.failures.extend(other.failures)


def check_prefix_consistent(journals: dict) -> OracleReport:
    """Any two replicas' journals must be prefix-ordered — a divergent
    suffix means two replicas committed different entries at the same
    index, the one thing raft may never do."""
    rep = OracleReport()
    rids = sorted(journals)
    for i, a in enumerate(rids):
        for b in rids[i + 1:]:
            ja, jb = journals[a], journals[b]
            n = min(len(ja), len(jb))
            if ja[:n] != jb[:n]:
                k = next(x for x in range(n) if ja[x] != jb[x])
                rep.fail(f"replicas {a} and {b} diverge at journal "
                         f"position {k}: {ja[k]!r} != {jb[k]!r}")
    return rep


def check_no_acked_loss(acked: list, journals: dict) -> OracleReport:
    """Every acked command must appear in every replica's journal."""
    rep = OracleReport()
    for rid in sorted(journals):
        have = set(journals[rid])
        missing = [c for c in acked if c not in have]
        if missing:
            rep.fail(f"replica {rid} lost {len(missing)} acked "
                     f"command(s), first: {missing[0]!r}")
    return rep


def check_journals_equal(journals: dict) -> OracleReport:
    rep = OracleReport()
    rids = sorted(journals)
    first = journals[rids[0]]
    for rid in rids[1:]:
        if journals[rid] != first:
            rep.fail(f"replica {rid} journal length {len(journals[rid])}"
                     f" != replica {rids[0]} length {len(first)} "
                     "(or content differs) after convergence")
    return rep


def check_monotone_applied(samples: dict) -> OracleReport:
    """``samples[rid]`` is the time-ordered list of (epoch, applied)
    observations for one replica; ``epoch`` increments on each restart
    of that replica.  Within an epoch applied may never decrease."""
    rep = OracleReport()
    for rid in sorted(samples):
        prev_epoch, prev_applied = -1, -1
        for epoch, applied in samples[rid]:
            if epoch == prev_epoch and applied < prev_applied:
                rep.fail(f"replica {rid} applied index moved backwards "
                         f"within epoch {epoch}: {prev_applied} -> "
                         f"{applied}")
            prev_epoch, prev_applied = epoch, applied
    return rep


def check_hashes_equal(name: str, hashes: dict) -> OracleReport:
    rep = OracleReport()
    if len(set(hashes.values())) > 1:
        rep.fail(f"{name} hashes diverge: " + ", ".join(
            f"r{rid}={hashes[rid]:#x}" for rid in sorted(hashes)))
    return rep


def check_hot_drained(initial_leader: int, final_leader: int,
                      transfers: list) -> OracleReport:
    """Controller drain verdict (hotspot differential): at least one
    ``control_transfer`` decision was flight-recorded for the hot
    shard, every decision carries its full evidence row (the
    observe→act loop must be auditable, not just effective), and
    leadership actually left the initially hot replica."""
    rep = OracleReport()
    if not transfers:
        rep.fail("controller planned no transfer off the hot shard")
        return rep
    for rec in transfers:
        ev = rec.get("evidence") or {}
        missing = [k for k in ("obs", "lane", "score", "lag", "streak",
                               "term") if k not in ev]
        if missing:
            rep.fail(f"transfer record seq {rec.get('seq')} missing "
                     f"evidence field(s): {', '.join(missing)}")
    if final_leader == 0:
        rep.fail("hot shard leaderless after the transfer window")
    elif final_leader == initial_leader:
        rep.fail(f"leadership never left replica {initial_leader} "
                 "despite planned transfers")
    return rep


def check_invariant_probe(counters: dict) -> OracleReport:
    """The device-side invariant probe must stay silent through a whole
    chaos schedule — faults may delay commits, but no interleaving of
    crashes/partitions/delays is allowed to produce a protocol-invariant
    violation (``violations_seen`` is sticky per engine lifetime, so a
    one-tick trip during the fault window still fails here)."""
    rep = OracleReport()
    seen = int(counters.get("violations_seen", 0))
    live = int(counters.get("total", 0))
    if seen or live:
        first = counters.get("first")
        rep.fail(f"invariant probe tripped during the schedule: "
                 f"violations_seen={seen} live_total={live}"
                 + (f", first offender: {first}" if first else ""))
    return rep


def check_convergence(acked: list, journals: dict, applied_samples: dict,
                      sm_hashes: dict, session_hashes: dict,
                      membership_hashes: dict) -> OracleReport:
    """The full oracle, run once after the final heal + settle."""
    rep = OracleReport()
    rep.merge(check_prefix_consistent(journals))
    rep.merge(check_journals_equal(journals))
    rep.merge(check_no_acked_loss(acked, journals))
    rep.merge(check_monotone_applied(applied_samples))
    rep.merge(check_hashes_equal("sm", sm_hashes))
    rep.merge(check_hashes_equal("session", session_hashes))
    rep.merge(check_hashes_equal("membership", membership_hashes))
    return rep
