"""The pycore replay on the port's batched step.

``KernelCluster`` here is the port's form of ``tests/kernel_harness.py``:
a loopback router that plays transport over
``dragonboat_tpu_torch.core.kernel.step`` on a named device.  The scenario
families of ``tests/test_kernel_differential.py`` and the three tests of
``tests/test_kernel_chaos.py`` run on it: both files are loaded as private
module copies (as the reference tests load ``scripts/model_check.py``)
whose ``KernelCluster`` name is this one and whose random schedules run
``TRACE_STEPS`` (``SHORTEN`` lists the edits), so every family asserts the
reference test's own pycore agreement (or per-engine safety) against the
port's step.

The eager step costs about the same at 6 rows as at a few hundred, so the
scenarios run together: each in its own thread, their clusters' steps
gathered by ``StepBatcher`` into one batched ``step`` call per round (the
step is independent per row, so each cluster's rows come out as they
would alone).  One randomized trace also drives the port's cluster and
the reference's ``KernelCluster`` side by side, every state and output
leaf equal after every step (``convert.diff_leaves``).  Last, the
``onehot_reads`` and ``unroll_scans`` lockstep families drive the port's
``bench_loop`` with the flag off and on, every state leaf equal to the
JAX package's ``bench_loop`` on the same inputs at each phase end.

Budget: one case per family (the reference's other seeds are listed in
``LEFT_OUT``), the random schedules at TRACE_STEPS, a tenth of the
reference's, and the flag lockstep families at 12, 10 and 6 steps a
phase against one reference arm, so the file stays within its share of
the tier-1 time.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch import bench_loop as bl
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.core.kernel import step
from dragonboat_tpu_torch.core.kstate import (
    Inbox,
    ShardState,
    StepInput,
    StepOutput,
    empty_input,
    init_state,
)

MT = pb.MessageType
TESTS = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cpu"

#: the reference's seeds and configs not run here (one case per family)
LEFT_OUT = {
    "test_diff_randomized_trace": [23, 106, 109, 172, 1009, 2024],
    "test_diff_randomized_trace_configs": [
        (11, "pre_vote"), (11, "check_quorum"), (15, "pre_vote"),
        (15, "check_quorum"), (15, "pre_vote+check_quorum")],
    "test_chaos_randomized_safety": [172, 307, 2024, 9090],
    "test_diff_witness_randomized_trace": [77],
    "test_diff_onehot_reads_lockstep": [42],
    "test_diff_unroll_scans_lockstep": [9],
}


class Msg:
    __slots__ = ("mtype", "frm", "to", "term", "log_term", "log_index",
                 "commit", "reject", "hint", "hint_high", "ents")

    def __init__(self, mtype, frm, to, term, log_term=0, log_index=0, commit=0,
                 reject=False, hint=0, hint_high=0, ents=()):
        self.mtype = int(mtype)
        self.frm = int(frm)
        self.to = int(to)
        self.term = int(term)
        self.log_term = int(log_term)
        self.log_index = int(log_index)
        self.commit = int(commit)
        self.reject = bool(reject)
        self.hint = int(hint)
        self.hint_high = int(hint_high)
        self.ents = ents  # list[(term, is_cc)]


# ---------------------------------------------------------------------------
# batching the steps of clusters driven by separate threads
# ---------------------------------------------------------------------------


def _cat(parts: list, cls):
    return cls(*(None if vs[0] is None else torch.cat(vs)
                 for vs in zip(*parts)))


def _split(x, sizes: list, cls) -> list:
    cols = [[None] * len(sizes) if v is None else torch.split(v, sizes)
            for v in x]
    return [cls(*(c[i] for c in cols)) for i in range(len(sizes))]


class StepBatcher:
    """Rounds of one batched step: every registered thread submits one
    step (``step``) or leaves (``leave``); when every live thread has
    submitted, the last one runs the round, one ``step`` call per
    distinct ``KernelParams`` over the submitters' rows side by side."""

    def __init__(self, threads: int):
        self.cv = threading.Condition()
        self.live = threads
        self.queue: list = []
        self.rounds = 0

    def step(self, kp, state, box, inp):
        req = {"args": (kp, state, box, inp)}
        with self.cv:
            self.queue.append(req)
            if len(self.queue) == self.live:
                self._run()
            while "out" not in req:
                self.cv.wait()
        if isinstance(req["out"], BaseException):
            raise req["out"]
        return req["out"]

    def leave(self):
        with self.cv:
            self.live -= 1
            if self.queue and len(self.queue) == self.live:
                self._run()

    def _run(self):
        reqs, self.queue = self.queue, []
        self.rounds += 1
        by_kp: dict = {}
        for r in reqs:
            by_kp.setdefault(r["args"][0], []).append(r)
        for kp, group in by_kp.items():
            try:
                sizes = [r["args"][1].term.shape[0] for r in group]
                st, out = step(kp, *(_cat([r["args"][i] for r in group], cls)
                                     for i, cls in ((1, ShardState), (2, Inbox),
                                                    (3, StepInput))))
                for r, s, o in zip(group, _split(st, sizes, ShardState),
                                   _split(out, sizes, StepOutput)):
                    r["out"] = (s, o)
            except BaseException as e:  # every submitter sees the failure
                for r in group:
                    r["out"] = e
        self.cv.notify_all()


_LOCAL = threading.local()


def _kernel_step(kp, state, box, inp):
    batcher = getattr(_LOCAL, "batcher", None)
    if batcher is None:
        return step(kp, state, box, inp)
    return batcher.step(kp, state, box, inp)


def run_together(scenarios: dict) -> tuple[dict, int]:
    """Run every scenario (name -> callable) in its own thread with their
    steps batched; returns name -> exception (None when it passed) and
    the number of rounds."""
    batcher = StepBatcher(len(scenarios))
    results: dict = {}

    def worker(name, fn):
        _LOCAL.batcher = batcher
        try:
            fn()
            results[name] = None
        except BaseException as e:  # reported by the test of that scenario
            results[name] = e
        finally:
            batcher.leave()

    threads = [threading.Thread(target=worker, args=item, daemon=True)
               for item in scenarios.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, batcher.rounds


# ---------------------------------------------------------------------------
# the port's KernelCluster (tests/kernel_harness.py over the port's step)
# ---------------------------------------------------------------------------


class KernelCluster:
    """num_groups raft groups × replicas-per-group rows in one kernel state
    of the port, on ``device``."""

    def __init__(self, num_groups: int, replicas: int = 3,
                 kp: KP.KernelParams | None = None,
                 election: int = 10, heartbeat: int = 1,
                 check_quorum: bool = False, pre_vote: bool = False,
                 witnesses: frozenset[int] | set[int] = frozenset(),
                 device=DEVICE):
        self.kp = kp or KP.KernelParams(
            num_peers=max(3, replicas), log_cap=256, inbox_cap=4,
            msg_entries=4, proposal_cap=4, readindex_cap=4,
        )
        self.device = torch.device(device)
        self.n = num_groups
        self.p = replicas
        self.witnesses = frozenset(witnesses)
        G = num_groups * replicas
        self.G = G
        rids = np.tile(np.arange(1, replicas + 1, dtype=np.int32), num_groups)
        peer_ids = np.zeros((G, self.kp.num_peers), np.int32)
        peer_ids[:, :replicas] = np.arange(1, replicas + 1, dtype=np.int32)
        peer_kinds = np.where(peer_ids != 0, KP.K_VOTER,
                              KP.K_ABSENT).astype(np.int32)
        for rid_w in self.witnesses:
            peer_kinds[:, rid_w - 1] = KP.K_WITNESS
        self.state: ShardState = init_state(
            self.kp, G, rids, peer_ids, peer_kinds=peer_kinds,
            election_timeout=election, heartbeat_timeout=heartbeat,
            check_quorum=check_quorum, pre_vote=pre_vote, device=self.device,
        )
        self.pending: list[list[Msg]] = [[] for _ in range(G)]  # inbox queues
        self.dropped_pairs: set[tuple[int, int]] = set()  # (row_from, row_to)
        self.isolated: set[int] = set()
        self.last_out = None
        self._input0 = convert.to_numpy(empty_input(self.kp, G, "cpu"))

    def row(self, group: int, rid: int) -> int:
        return group * self.p + (rid - 1)

    def _route(self, out) -> None:
        """Scatter one step's outbound lanes into pending queues."""
        o = {k: (convert.tensor_to_numpy(v) if v is not None else None)
             for k, v in out._asdict().items()}
        K, P_ = self.kp.inbox_cap, self.kp.num_peers
        for g in range(self.G):
            group = g // self.p
            my_rid = g % self.p + 1
            if g in self.isolated:
                continue

            def deliver(to_rid, msg):
                if to_rid < 1 or to_rid > self.p:
                    return
                row = self.row(group, to_rid)
                if row in self.isolated or (g, row) in self.dropped_pairs:
                    return
                self.pending[row].append(msg)

            for k in range(K):
                t = int(o["r_type"][g, k])
                if t != 0:
                    deliver(int(o["r_to"][g, k]), Msg(
                        t, my_rid, int(o["r_to"][g, k]), int(o["r_term"][g, k]),
                        log_index=int(o["r_log_index"][g, k]),
                        reject=bool(o["r_reject"][g, k]),
                        hint=int(o["r_hint"][g, k]),
                        hint_high=int(o["r_hint_high"][g, k]),
                    ))
            for p_ in range(P_):
                to_rid = p_ + 1
                if bool(o["s_rep"][g, p_]):
                    n = int(o["s_n_ent"][g, p_])
                    ents = [
                        (int(o["s_ent_term"][g, p_, e]), bool(o["s_ent_cc"][g, p_, e]))
                        for e in range(n)
                    ]
                    deliver(to_rid, Msg(
                        MT.REPLICATE, my_rid, to_rid, int(o["term"][g]),
                        log_term=int(o["s_prev_term"][g, p_]),
                        log_index=int(o["s_prev_index"][g, p_]),
                        commit=int(o["s_commit"][g, p_]), ents=ents,
                    ))
                if bool(o["s_hb"][g, p_]):
                    deliver(to_rid, Msg(
                        MT.HEARTBEAT, my_rid, to_rid, int(o["term"][g]),
                        commit=int(o["s_hb_commit"][g, p_]),
                        hint=int(o["s_hb_low"][g, p_]),
                        hint_high=int(o["s_hb_high"][g, p_]),
                    ))
                v = int(o["s_vote"][g, p_])
                if v:
                    deliver(to_rid, Msg(
                        MT.REQUEST_VOTE if v == 1 else MT.REQUEST_PREVOTE,
                        my_rid, to_rid, int(o["s_vote_term"][g, p_]),
                        log_term=int(o["s_vote_lterm"][g, p_]),
                        log_index=int(o["s_vote_lindex"][g, p_]),
                        hint=int(o["s_vote_hint"][g, p_]),
                    ))
                if bool(o["s_timeout_now"][g, p_]):
                    deliver(to_rid, Msg(MT.TIMEOUT_NOW, my_rid, to_rid,
                                        int(o["term"][g])))

    def _inbox_arrays(self) -> dict:
        K, E = self.kp.inbox_cap, self.kp.msg_entries
        z = lambda *s: np.zeros((self.G, *s), np.int32)  # noqa: E731
        box = dict(mtype=z(K), from_=z(K), term=z(K), log_term=z(K),
                   log_index=z(K), commit=z(K),
                   reject=np.zeros((self.G, K), bool), hint=z(K),
                   hint_high=z(K), n_ent=z(K), ent_term=z(K, E),
                   ent_cc=np.zeros((self.G, K, E), bool), ent_val=None)
        for g in range(self.G):
            q = self.pending[g][:K]
            self.pending[g] = self.pending[g][K:]
            for k, m in enumerate(q):
                box["mtype"][g, k] = m.mtype
                box["from_"][g, k] = m.frm
                box["term"][g, k] = m.term
                box["log_term"][g, k] = m.log_term
                box["log_index"][g, k] = m.log_index
                box["commit"][g, k] = m.commit
                box["reject"][g, k] = m.reject
                box["hint"][g, k] = m.hint
                box["hint_high"][g, k] = m.hint_high
                ents = m.ents[:E]
                box["n_ent"][g, k] = len(ents)
                for e, (t, cc) in enumerate(ents):
                    box["ent_term"][g, k, e] = t
                    box["ent_cc"][g, k, e] = cc
        return box

    def step(self, tick=False, proposals=None, reads=None, transfers=None,
             applied_sync=True):
        """One kernel step. proposals: {row: n_entries or [(is_cc)...]},
        reads: {row: (low, high)}, transfers: {row: target_rid}."""
        d = {k: (v.copy() if v is not None else None)
             for k, v in self._input0.items()}
        if tick:
            d["tick"][:] = True
        if proposals:
            for row, spec in proposals.items():
                if isinstance(spec, int):
                    spec = [False] * spec
                for b, is_cc in enumerate(spec[: self.kp.proposal_cap]):
                    d["prop_valid"][row, b] = True
                    d["prop_cc"][row, b] = is_cc
        if reads:
            for row, (lo, hi) in reads.items():
                d["ri_valid"][row] = True
                d["ri_low"][row] = lo
                d["ri_high"][row] = hi
        if transfers:
            for row, target in transfers.items():
                d["transfer_to"][row] = target
        if applied_sync:
            d["applied"] = self.field("processed")
        box = self._inbox_arrays()
        self.state, out = _kernel_step(
            self.kp, self.state, convert.from_numpy(Inbox, box, self.device),
            convert.from_numpy(StepInput, d, self.device))
        self.last_out = out
        self._route(out)
        return out

    def run_until_leader(self, group: int = 0, max_steps: int = 200):
        for i in range(max_steps):
            self.step(tick=True)
            if self.leader_row(group) is not None:
                # drain in-flight messages without ticking
                for _ in range(6):
                    self.step()
                return i
        raise AssertionError("no leader elected")

    def leader_row(self, group: int):
        role = self.field("role")
        for r in range(group * self.p, (group + 1) * self.p):
            if role[r] == KP.LEADER:
                return r
        return None

    def drain(self, steps: int = 10):
        for _ in range(steps):
            self.step()

    def field(self, name: str):
        return convert.tensor_to_numpy(getattr(self.state, name))


# ---------------------------------------------------------------------------
# the reference's test files as private copies over this KernelCluster
# ---------------------------------------------------------------------------


#: the randomized schedules' length here: the reference's 300 steps
#: (400 and 300 in test_kernel_chaos) cut to a tenth for the test time
TRACE_STEPS = 30
#: (literal in the reference file, its count there, what it reads here)
SHORTEN = {
    "test_kernel_differential": [("range(300)", 4, "range(TRACE_STEPS)")],
    "test_kernel_chaos": [("steps: int = 400", 1, "steps: int = 4 * TRACE_STEPS // 3"),
                          ("steps=300", 1, "steps=TRACE_STEPS")],
}


def _load_private(name: str):
    """A private copy of ``tests/<name>.py`` whose ``KernelCluster`` is the
    port's and whose random schedules run TRACE_STEPS (the reference's
    module stays as it is)."""
    path = os.path.join(TESTS, f"{name}.py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    for find, count, replace in SHORTEN[name]:
        assert src.count(find) == count, (name, find)
        src = src.replace(find, replace)
    mod = type(sys)(f"_port_{name}")
    mod.__file__ = path
    mod.TRACE_STEPS = TRACE_STEPS
    exec(compile(src, path, "exec"), mod.__dict__)
    mod.KernelCluster = KernelCluster
    return mod


if TESTS not in sys.path:      # test_kernel_chaos imports kernel_harness
    sys.path.insert(0, TESTS)
DIFF = _load_private("test_kernel_differential")
CHAOS = _load_private("test_kernel_chaos")


class LockstepCluster:
    """The port's cluster and the reference's ``KernelCluster`` driven on
    one schedule; every state and output leaf equal after every step."""

    def __init__(self, groups: int = 2, replicas: int = 3, **opts):
        from tests.kernel_harness import KernelCluster as RefCluster

        self.kc = KernelCluster(groups, replicas, **opts)
        self.ref = RefCluster(groups, replicas, **opts)
        self.groups = groups
        self.steps = 0

    def step(self, **kw):
        # the port's inputs are read off its own queues; the reference
        # drains its own (equal) queues
        self.kc.step(**kw)
        self.ref.step(**kw)
        self.steps += 1
        for what, got, ref in (("state", self.kc.state, self.ref.state),
                               ("out", self.kc.last_out, self.ref.last_out)):
            bad = convert.diff_leaves(
                {k: None if v is None else np.asarray(v)
                 for k, v in ref._asdict().items()},
                convert.to_numpy(got))
            assert bad == [], f"step {self.steps}: {what} leaves differ: {bad}"

    def isolate(self, row: int) -> None:
        self.kc.isolated.add(row)
        self.ref.isolated.add(row)

    def heal(self) -> None:
        for c in (self.kc, self.ref):
            c.isolated.clear()
            c.dropped_pairs.clear()


def _lockstep_trace(seed: int) -> None:
    """A randomized schedule WITH partitions (the reference's
    ``_random_schedule``) on both clusters; equal after every step."""
    rng = np.random.default_rng(seed)
    d = LockstepCluster(2, 3, check_quorum=True, pre_vote=True)
    for _ in range(300):
        d.step(tick=True)
        if all(d.kc.leader_row(g) is not None for g in range(d.groups)):
            break
    for step_no in range(TRACE_STEPS):
        DIFF._random_schedule(d, rng, step_no, partitions=True)
    d.heal()
    for _ in range(30):
        d.step(tick=True)
    assert d.steps > TRACE_STEPS


#: case -> the reference test body it runs on the port's step
SCENARIOS = {
    "election_convergence": DIFF.test_diff_election_convergence,
    "election_5_replicas": DIFF.test_diff_election_5_replicas,
    "prevote_election": DIFF.test_diff_prevote_election,
    "replication": DIFF.test_diff_replication,
    "heartbeat_maintenance": DIFF.test_diff_heartbeat_maintenance,
    "leader_isolation_reelection": DIFF.test_diff_leader_isolation_reelection,
    "leader_transfer": DIFF.test_diff_leader_transfer,
    "readindex": DIFF.test_diff_readindex,
    "check_quorum_step_down": DIFF.test_diff_check_quorum_step_down,
    "randomized_trace[7]": lambda: DIFF.test_diff_randomized_trace(7),
    "randomized_trace_configs[11-pre_vote+check_quorum]":
        lambda: DIFF.test_diff_randomized_trace_configs(
            11, {"pre_vote": True, "check_quorum": True}),
    "chaos_randomized_safety[106]":
        lambda: DIFF.test_chaos_randomized_safety(106),
    "witness_election_and_replication":
        DIFF.test_diff_witness_election_and_replication,
    "witness_sustains_quorum_with_voter_down":
        DIFF.test_diff_witness_sustains_quorum_with_voter_down,
    "witness_randomized_trace[13]":
        lambda: DIFF.test_diff_witness_randomized_trace(13),
    "kernel_chaos_safety": CHAOS.test_kernel_chaos_safety,
    "kernel_chaos_second_seed": CHAOS.test_kernel_chaos_second_seed,
    "kernel_determinism": CHAOS.test_kernel_determinism,
    "lockstep_with_reference_cluster[5]": lambda: _lockstep_trace(5),
}


@pytest.fixture(scope="module")
def replay():
    torch.set_num_threads(1)
    return run_together(SCENARIOS)


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_scenario_on_port_step(replay, case):
    results, rounds = replay
    assert rounds > 0
    if results[case] is not None:
        raise results[case]


def test_batched_rounds_equal_solo_steps():
    """The batcher's contract: two clusters stepped in one batched call
    come out as each stepped alone."""
    solo = [KernelCluster(1, 3), KernelCluster(2, 3), KernelCluster(1, 5)]
    both = [KernelCluster(1, 3), KernelCluster(2, 3), KernelCluster(1, 5)]

    def drive(c):
        for _ in range(8):
            c.step(tick=True)
        c.step(proposals={0: 2})
        c.drain(2)

    for c in solo:
        drive(c)

    results, rounds = run_together({str(i): (lambda c=c: drive(c))
                                    for i, c in enumerate(both)})
    assert all(e is None for e in results.values()) and rounds == 11
    for a, b in zip(solo, both):
        assert convert.diff_leaves(convert.to_numpy(a.state),
                                   convert.to_numpy(b.state)) == []


# ---------------------------------------------------------------------------
# the read-lowering and scan-unroll flags through the port's bench_loop
# ---------------------------------------------------------------------------


def _ref_keep_masks(kp_ref, rows: int, iters: int, drop_p: float, seed: int):
    """The reference storm's drop masks: its ``_drop_box`` on an all-ones
    inbox (True = keep)."""
    import jax
    import jax.numpy as jnp

    from dragonboat_tpu import bench_loop as ref_bl
    from dragonboat_tpu.core import kstate as ref_ks

    box = ref_ks.empty_inbox(kp_ref, rows)
    ones = type(box)(*[None if f is None else jnp.ones_like(f) for f in box])
    key0 = jax.random.PRNGKey(seed)
    p = jnp.asarray(drop_p, jnp.float32)
    return torch.as_tensor(np.stack([
        np.asarray(ref_bl._drop_box(ones, jax.random.fold_in(key0, i), p).mtype) != 0
        for i in range(iters)]))


def _drive_ref(kp_ref, groups: int, plan: tuple, seed: int) -> list:
    """The reference test's phases on the JAX package's ``bench_loop``:
    elect_all, the storm, run_steps, run_steps_mixed, every state leaf as
    numpy at each phase end."""
    from dragonboat_tpu import bench_loop as ref_bl

    def snap(st):
        return {k: None if v is None else np.asarray(v)
                for k, v in zip(st._fields, st)}

    storm, writes, mixed = plan
    state, box = ref_bl.elect_all(kp_ref, 3, ref_bl.make_cluster(kp_ref, groups, 3))
    snaps = [snap(state)]
    state, box = ref_bl.run_steps_storm(kp_ref, 3, storm, 0.25, seed, state, box)
    snaps.append(snap(state))
    state, box = ref_bl.run_steps(kp_ref, 3, writes, True, True, state, box)
    snaps.append(snap(state))
    state, box, _ = ref_bl.run_steps_mixed(
        kp_ref, 3, mixed, max(1, kp_ref.proposal_cap // 8), np.int32(7),
        state, box, np.int32(0))
    snaps.append(snap(state))
    return snaps


def _drive_loops(kp, groups: int, plan: tuple, keep_masks) -> list:
    """The same phases on the port's ``bench_loop``, the storm under the
    reference's drop masks."""
    storm, writes, mixed = plan
    state, box = bl.elect_all(kp, 3, bl.make_cluster(kp, groups, 3,
                                                     device=DEVICE))
    snaps = [convert.to_numpy(state)]
    state, box = bl.run_steps_storm(kp, 3, storm, 0.25, 0, state, box,
                                    keep_masks=keep_masks)
    snaps.append(convert.to_numpy(state))
    state, box = bl.run_steps(kp, 3, writes, True, True, state, box)
    snaps.append(convert.to_numpy(state))
    zero = torch.zeros((), dtype=torch.int32)
    state, box, _ = bl.run_steps_mixed(
        kp, 3, mixed, max(1, kp.proposal_cap // 8), 7, state, box, zero)
    snaps.append(convert.to_numpy(state))
    return snaps


#: the reference arm both flag families are held against: the reference
#: unroll test's geometry with ``onehot_reads`` on, 8 groups (the onehot
#: test's 64, the unroll test's 16) and 12, 10 and 6 steps a phase (its 40, 30 and 20; 10
#: shares ``elect_all``'s compiled ``run_steps``), at the onehot test's
#: first seed; one compiled set and one run for both families
REF_GROUPS, REF_PLAN, REF_SEED = 8, (12, 10, 6), 5
_RUNS: dict = {}


def _ref_kp():
    from dragonboat_tpu.core import params as ref_kp

    return ref_kp.KernelParams(
        num_peers=3, log_cap=32, inbox_cap=10, msg_entries=4,
        proposal_cap=4, readindex_cap=4, apply_batch=8,
        compaction_overhead=4, onehot_reads=True,
    )


def _flag_lockstep(flag: str) -> None:
    """The port with ``flag`` off and on against the reference arm on the
    same inputs: every state leaf equal at each phase end.  The runs are
    kept per parameter set, so an arm the other family already ran is
    not run again."""
    torch.set_num_threads(1)
    kp_ref = _ref_kp()
    if "ref" not in _RUNS:
        _RUNS["ref"] = (
            _drive_ref(kp_ref, REF_GROUPS, REF_PLAN, REF_SEED),
            _ref_keep_masks(kp_ref, REF_GROUPS * 3, REF_PLAN[0], 0.25,
                            REF_SEED))
    ref, masks = _RUNS["ref"]
    for on in (False, True):
        kp = dataclasses.replace(
            convert.kernel_params_from(dataclasses.asdict(kp_ref)),
            **{flag: on})
        if kp not in _RUNS:
            _RUNS[kp] = _drive_loops(kp, REF_GROUPS, REF_PLAN, masks)
        for phase, (sr, sp) in enumerate(zip(ref, _RUNS[kp])):
            bad = convert.diff_leaves(sr, sp)
            assert bad == [], (f"{flag}={on}: phase {phase} fields {bad} "
                               f"diverged from the reference (seed {REF_SEED})")


def test_diff_onehot_reads_lockstep():
    """``KernelParams.onehot_reads`` (one-hot selects against gathers in
    the step's ring reads and the router's picks; the card's default)
    leaves every state leaf equal to the JAX package's ``bench_loop`` at
    each phase end, with the flag off and on (``REF_PLAN``)."""
    _flag_lockstep("onehot_reads")


def test_diff_unroll_scans_lockstep():
    """``KernelParams.unroll_scans`` (the reference's ``lax.scan``
    unroll) leaves every state leaf equal to the JAX package's rolled
    ``bench_loop`` (its unrolled XLA:CPU compile is too slow to run here;
    the reference holds the two bitwise equal) with the flag off and on
    (``REF_PLAN``).  The port's step runs its slot scans as Python loops
    either way: no code of the port reads the flag."""
    pkg = os.path.join(os.path.dirname(TESTS), "dragonboat_tpu_torch")
    readers = sorted(
        os.path.relpath(os.path.join(d, f), pkg)
        for d, _, files in os.walk(pkg) for f in files
        if f.endswith(".py") and "unroll_scans" in open(os.path.join(d, f)).read())
    assert readers == [os.path.join("core", "params.py")], readers
    _flag_lockstep("unroll_scans")
