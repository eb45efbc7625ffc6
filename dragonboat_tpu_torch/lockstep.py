"""Two sets of NodeHosts of one shard driven in lockstep through the
membership and log-lifecycle operations, compared after every round.

A *side* is a set of NodeHost classes and the means to read their device
state (``Side``): the reference's and the port's in the CPU tests, the
port on the CPU and on the card in ``chip_smoke.py``.  ``Lockstep`` opens
three voter hosts per side (``auto_run=False``, one device- or
mesh-resident shard, its ``node_host_dir`` under ``root``) and runs
rounds: an action of a seeded script (a proposal on the leader's host, a
ReadIndex read on a host, or ticks only), writes and operations put in
on both sides before the round's ticks, then every host's bounded
``run_once`` (``run``).  After every round every device engine's state
must be equal leaf for leaf between the sides, and so must its
reductions (the caller's ``reductions_equal``), every replica's applied
index and KV contents, and the witness's durable log (``witness_log``:
METADATA entries without payload but for config changes).

``kernel_ops`` and ``mesh_ops`` are the two scripts of operations: a
witness added after the leader lane's device ring compacted (so it
catches up through the stripped file-less witness snapshot), a voter
closed (the witness's acks carry the quorum), a leader transfer, a
snapshot request beside the automatic snapshots, a restart of every host
from its directory; on the mesh, a follower read, a transfer, a snapshot
and a restart, then a witness member, which takes the group to the host
engines, and a restart that mesh admission refuses.

End to end (``auto_run``), ``majority_leader``, ``writes``,
``add_witness_sync``, ``metadata_only`` and ``monkey`` (the reference's
partition monkey, its history checked linearizable) serve the witness
and monkey cells.

What would make the sides differ for reasons of the drive and not of the
code is held still: host-resident nodes draw their election timeouts
from the process's ``random``, seeded with the round before each side's
round; the host's apply pool and the transports' snapshot streams run on
threads of their own, so each pass waits for them; a send to a host that
is not up trips the transport's circuit breaker, whose cooldown runs on
the wall clock, so the witness host opens before it is added.
"""

from __future__ import annotations

import contextlib
import itertools
import random
import threading
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np

from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.history import HistoryRecorder, check_linearizable_kv
from dragonboat_tpu_torch.logger import get_logger
from dragonboat_tpu_torch.request import (
    RequestDroppedError,
    RequestResultCode,
    RequestTimeoutError,
)

_LOG = get_logger("lockstep")

VOTERS = (1, 2, 3)
WITNESS = 4
#: the reference engine tests' kernel geometry
GEOMETRY = dict(kernel_log_cap=256, kernel_capacity=8, kernel_apply_batch=16,
                kernel_compaction_overhead=16)
#: a snapshot every SNAPSHOT_ENTRIES applied entries, so the leader lane's
#: device ring compacts on its own
SNAPSHOT_ENTRIES, COMPACTION_OVERHEAD = 8, 2
#: election timeout in ticks (two tick rounds a round, a heartbeat every
#: round)
ELECTION_RTT, HEARTBEAT_RTT = 6, 2
#: the mesh's geometry: witness id 4 inside mesh addressing
MESH = dict(g_size=2, replicas=4, n_local=2)
#: passes of a round's bounded run_once: a round's work settles in two
#: passes and a third that finds none
RUN_PASSES = 4


class Side(NamedTuple):
    """One side's NodeHost, config and state machine classes, the keyword
    arguments of its NodeHost (``device=``), ``leaves(engine, tree)``, a
    device tree of the engine's as a dict of numpy arrays, and the
    side's ``request`` module, whose process-wide proposal and ReadIndex
    counters each side runs on its own (a ReadIndex ctx lands in the
    device state; two sides of one package share the module)."""
    NodeHost: Any
    NodeHostConfig: Any
    ExpertConfig: Any
    EngineConfig: Any
    Config: Any
    MeshSpec: Any
    StateMachine: Any
    kw: dict
    leaves: Callable
    request: Any


def kv(nh) -> tuple:
    """The replica's applied index and KV contents."""
    n = nh.nodes[1]
    return n.sm.get_last_applied(), dict(n.sm.sm.kv)


def script(seed: int, rounds: int) -> list:
    """Per round: 0 = ticks only, 1 = a proposal on the leader's host,
    2 = a ReadIndex read on a random host; plus the value and host."""
    rng = np.random.default_rng(seed)
    return [(int(rng.choice(3, p=[0.4, 0.4, 0.2])), int(rng.integers(0, 100)),
             int(rng.choice(VOTERS))) for _ in range(rounds)]


class Lockstep:
    """The sides' NodeHosts of one shard, driven round by round; every
    action goes to every side before the round's ticks."""

    def __init__(self, sides: dict[str, Side], root: Path, tag: str,
                 reductions_equal: Callable, depth: int = 0,
                 mesh: bool = False) -> None:
        self.sides, self.tag, self.depth, self.mesh = sides, tag, depth, mesh
        self.reductions_equal = reductions_equal
        self.first = next(iter(sides))
        self.dirs = {s: Path(root) / s for s in sides}
        self.addrs = {s: {r: f"{s}{tag}-{r}" for r in (*VOTERS, WITNESS)}
                      for s in sides}
        self.hosts: dict[str, dict] = {s: {} for s in sides}
        self.engines: dict[str, list] = {s: [] for s in sides}
        self.round_no = 0
        self._counters = {s: (itertools.count(1), itertools.count(1))
                          for s in sides}
        for r in VOTERS:
            self.start(r)

    @contextlib.contextmanager
    def _as(self, side: str):
        """The side's own request counters in place."""
        req = self.sides[side].request
        saved = req.PendingProposal._seq, req.PendingReadIndex._ctx
        req.PendingProposal._seq, req.PendingReadIndex._ctx = \
            self._counters[side]
        try:
            yield
        finally:
            req.PendingProposal._seq, req.PendingReadIndex._ctx = saved

    # -- hosts ---------------------------------------------------------

    def _open(self, side: str, rid: int):
        S = self.sides[side]
        ex = dict(kernel_pipeline_depth=self.depth,
                  engine=S.EngineConfig(exec_shards=1, apply_shards=1),
                  **GEOMETRY)
        if self.mesh:
            ex.pop("kernel_capacity")
            ex["mesh"] = S.MeshSpec(name=f"{side}{self.tag}", **MESH)
        return S.NodeHost(S.NodeHostConfig(
            raft_address=self.addrs[side][rid], rtt_millisecond=5,
            node_host_dir=str(self.dirs[side] / f"nh{rid}"),
            expert=S.ExpertConfig(**ex)), auto_run=False, **S.kw)

    def start(self, rid: int) -> None:
        """Open host ``rid`` on every side and start its replica (the
        witness host joins; the voters start with the initial members)."""
        wit = rid == WITNESS
        for side, S in self.sides.items():
            random.seed(f"{self.tag}/{self.round_no}/open{rid}")
            voters = {r: self.addrs[side][r] for r in VOTERS}
            cfg = S.Config(
                shard_id=1, replica_id=rid, election_rtt=ELECTION_RTT,
                heartbeat_rtt=HEARTBEAT_RTT,
                snapshot_entries=0 if wit else SNAPSHOT_ENTRIES,
                compaction_overhead=COMPACTION_OVERHEAD, is_witness=wit,
                device_resident=not wit and not self.mesh,
                mesh_resident=not wit and self.mesh)
            with self._as(side):
                nh = self._open(side, rid)
                nh.start_replica({} if wit else voters, wit, S.StateMachine,
                                 cfg)
            self.hosts[side][rid] = nh

    def close(self, rid: int) -> None:
        for side, hosts in self.hosts.items():
            self._close(side, hosts.pop(rid))

    def close_all(self) -> None:
        for side, hosts in self.hosts.items():
            for nh in hosts.values():
                self._close(side, nh)
            hosts.clear()

    def _close(self, side: str, nh) -> None:
        """Close a host; its device engine joins ``engines[side]`` (an
        engine's step timer outlives its host)."""
        for eng in (nh.kernel_engine, nh.mesh_engine):
            if eng is not None and all(e is not eng
                                       for e in self.engines[side]):
                self.engines[side].append(eng)
        nh.close()

    def restart(self) -> None:
        """Close every open host and reopen each on its directory."""
        rids = sorted(self.hosts[self.first])
        self.close_all()
        for r in rids:
            self.start(r)

    # -- views -----------------------------------------------------------

    def leader(self, side: str | None = None) -> int:
        """The leader every open voter host agrees on, else 0."""
        hosts = self.hosts[side or self.first]
        ids = {hosts[r].get_leader_id(1) for r in VOTERS if r in hosts}
        if len(ids) == 1:
            lid, ok = ids.pop()
            return lid if ok and lid in hosts else 0
        return 0

    def each(self, fn: Callable) -> dict:
        """``fn(side, hosts)`` on every side; the results by side."""
        out = {}
        for side, hosts in self.hosts.items():
            with self._as(side):
                out[side] = fn(side, hosts)
        return out

    def on_mesh(self, side: str) -> list:
        """The shard's rows on the side's shared mesh engine."""
        engines = {id(nh.mesh_engine): nh.mesh_engine
                   for nh in self.hosts[side].values()
                   if nh.mesh_engine is not None}
        return sorted(k for e in engines.values() for k in e.by_shard)

    # -- a round ---------------------------------------------------------

    def round(self, action=(0, 0, 1), writes=()) -> dict:
        """One round on every side: the script's action, ``writes``
        proposed on the leader's host, then 2 tick rounds (3 at pipeline
        depth 1: the retire that re-dirties a lane runs a step later) on
        every host and a bounded ``run_once`` each; then the sides are
        compared.  Returns the writes' request states by side."""
        lead = self.leader()
        for side in self.hosts:
            assert self.leader(side) == lead, (self.round_no, side, lead)
        kind, val, rid = action
        states = {}
        for side, hosts in self.hosts.items():
            random.seed(f"{self.tag}/{self.round_no}")
            states[side] = []
            with self._as(side):
                if lead:
                    nh = hosts[lead]
                    if kind == 1:
                        nh.propose(nh.get_noop_session(1),
                                   f"k{val % 7}={val}".encode(), timeout_s=2)
                    for w in writes:
                        states[side].append(nh.propose(
                            nh.get_noop_session(1), w.encode(), timeout_s=2))
                if kind == 2 and rid in hosts:
                    hosts[rid].read_index(1, timeout_s=2)
                for nh in hosts.values():
                    for _ in range(2 + self.depth):
                        nh.tick_all()
                for nh in hosts.values():
                    run(nh)
        self.compare()
        self.round_no += 1
        return states

    def spin(self, steps, until: Callable, budget: int, what: str) -> None:
        """Rounds of the script ``steps`` until ``until()`` holds."""
        for _ in range(budget):
            if until():
                return
            self.round(next(steps))
        raise AssertionError(f"{what}: not within {budget} rounds "
                             f"(round {self.round_no})")

    # -- the comparison --------------------------------------------------

    def compare(self) -> None:
        where = (self.tag, self.round_no)
        a_side = self.first
        a_hosts = self.hosts[a_side]
        for side, hosts in self.hosts.items():
            if side == a_side:
                continue
            assert sorted(hosts) == sorted(a_hosts), where
            if self.mesh:
                self._compare_mesh(a_side, side, where)
            for r, nh in hosts.items():
                a, b = a_hosts[r].kernel_engine, nh.kernel_engine
                assert (a is None) == (b is None), (where, r)
                if a is not None:
                    bad = convert.diff_leaves(self.sides[a_side].leaves(a, a.state),
                                self.sides[side].leaves(b, b.state))
                    assert not bad, (where, side, r, bad)
                    self.reductions_equal(a, b, (where, side, r))
                assert kv(nh) == kv(a_hosts[r]), (where, side, r)
            if WITNESS in hosts:
                a, b = witness_log(a_hosts[WITNESS]), witness_log(hosts[WITNESS])
                assert a == b, (where, side, a, b)
                assert all(t == int(pb.EntryType.METADATA) and n == 0
                           for _, _, t, n, cc in b if not cc), (where, b)
                assert kv(hosts[WITNESS])[1] == {}, where

    def _compare_mesh(self, a_side: str, b_side: str, where) -> None:
        def engines(side):
            return [nh.mesh_engine for nh in self.hosts[side].values()
                    if nh.mesh_engine is not None]
        ea, eb = engines(a_side), engines(b_side)
        assert len(ea) == len(eb), where
        if not ea:
            return
        a, b = ea[0], eb[0]
        assert all(e is b for e in eb), where
        la, lb = self.sides[a_side].leaves, self.sides[b_side].leaves
        bad = convert.diff_leaves(la(a, a.state), lb(b, b.state))
        assert not bad, (where, b_side, "state", bad)
        bad = convert.diff_leaves(la(a, a._dispatch.box), lb(b, b._dispatch.box))
        assert not bad, (where, b_side, "box", bad)
        assert sorted(a.by_shard) == sorted(b.by_shard), where
        self.reductions_equal(a, b, (where, b_side))


def run(nh, passes: int = RUN_PASSES) -> None:
    """``nh.run_once()`` cut at ``passes`` passes over the host's nodes
    and engines.  ``run_once`` steps until nothing progresses, and a
    leader lane with a transfer lease re-stages every step until the
    leader changes, which needs the other hosts to step: the bounded run
    lets the round go on to them.  A node whose step raises is logged and
    passed over, as ``run_once`` and the host's step workers do.  Each
    pass ends when the host-resident nodes' applies (the host's apply
    pool) and the snapshot streams it started are done."""
    for _ in range(passes):
        progressed = False
        for n in list(nh.nodes.values()):
            try:
                progressed |= bool(n.step())
            except Exception:   # logged and dropped, as run_once does
                _LOG.exception("shard %d step failed", n.shard_id)
        for eng in (nh.kernel_engine, nh.mesh_engine):
            if eng is not None:
                progressed |= bool(eng.step_all())
        for sid in list(nh.nodes):
            nh._apply_pool.flush(sid)
        _snapshot_streams()
        if not progressed:
            return


def _snapshot_streams() -> None:
    """Wait for the snapshot streams the transports started: each is a
    thread of its own, and the message it carries must land in the same
    pass on every side."""
    for t in threading.enumerate():
        if t.name == "snapshot-stream":
            t.join(10)


def witness_log(nh) -> list:
    """(index, term, type, payload length, is a config change) of every
    entry in the witness's durable log past its snapshot."""
    ss = nh.logdb.get_snapshot(1, WITNESS)
    low = 1 if ss is None else ss.index + 1
    return [(e.index, e.term, int(e.type), len(e.cmd), e.is_config_change())
            for e in nh.logdb.iterate_entries(1, WITNESS, low, 1 << 30, 0)]


def _codes(states: dict) -> list:
    """Every side's request states with the same codes; the codes (None
    while pending)."""
    codes = {side: [rs.result.code if rs._event.is_set() else None
                    for rs in sts] for side, sts in states.items()}
    first = next(iter(codes.values()))
    assert all(c == first for c in codes.values()), codes
    return first


def _await(ls: Lockstep, steps, states: dict, budget: int, what: str) -> list:
    """Rounds until every request of ``states`` is resolved; the codes."""
    ls.spin(steps, lambda: None not in _codes(states), budget, what)
    return _codes(states)


def write(ls: Lockstep, steps, keys, budget: int = 40) -> dict:
    """Propose ``key=<key>.<round>`` for every key in one round on the
    leader's host, again after a drop, until each is acknowledged;
    returns key -> value."""
    want, left = {}, list(keys)
    for _ in range(budget):
        if not left:
            return want
        ls.spin(steps, ls.leader, budget, f"a leader for {left}")
        vals = {k: f"{k}.{ls.round_no}" for k in left}
        st = ls.round(writes=[f"{k}={v}" for k, v in vals.items()])
        codes = _await(ls, steps, st, budget, f"writes {left}")
        for k, code in zip(list(left), codes):
            if code == RequestResultCode.COMPLETED:
                want[k] = vals[k]
                left.remove(k)
    raise AssertionError(f"writes {left} never acknowledged")


def read_back(ls: Lockstep, steps, want: dict, budget: int = 40) -> None:
    """Every acknowledged write on every open voter of every side."""
    def applied():
        return all(nh.stale_read(1, k) == v for hosts in ls.hosts.values()
                   for r, nh in hosts.items() if r in VOTERS
                   for k, v in want.items())
    ls.spin(steps, applied, budget, "read back")


def _completed(ls: Lockstep, steps, states: dict, what: str) -> None:
    """Rounds until every request of ``states`` is resolved, each
    COMPLETED (a request code of either package compares as its int)."""
    codes = _await(ls, steps, states, 30, what)
    assert all(c == RequestResultCode.COMPLETED for c in codes), (what, codes)


def _request(ls: Lockstep, steps, fn: Callable, what: str) -> None:
    """``fn(side, hosts)`` -> request states on every side, completed."""
    _completed(ls, steps, ls.each(fn), what)


def add_witness(ls: Lockstep, steps) -> None:
    """Open the witness host (it joins and waits), then add it on the
    leader's host."""
    ls.start(WITNESS)
    lead = ls.leader()
    _request(ls, steps, lambda s, h: [h[lead].request_add_witness(
        1, WITNESS, ls.addrs[s][WITNESS], timeout_s=2)], "add witness")


def transfer(ls: Lockstep, steps) -> int:
    """Leadership to the next voter; returns it."""
    lead = ls.leader()
    target = VOTERS[lead % len(VOTERS)]
    ls.each(lambda s, h: h[lead].request_leader_transfer(1, target))
    ls.spin(steps, lambda: ls.leader() == target, 40, "leader transfer")
    return target


def _lane_snap_index(nh) -> int:
    eng = nh.kernel_engine
    return int(eng.state.snap_index[eng.by_shard[1].lane])


def kernel_ops(ls: Lockstep, steps) -> dict:
    """The KernelEngine's script of operations (see the module's
    docstring); returns what it saw."""
    t0 = time.perf_counter()
    ls.spin(steps, ls.leader, 60, "first election")
    elect = {"elect_rounds": ls.round_no, "elect_s": time.perf_counter() - t0}
    # writes until the leader lane's device ring compacts, with one
    # explicit snapshot request beside the automatic ones
    want = write(ls, steps, [f"a{i}" for i in range(6)])
    lead = ls.leader()
    snap = ls.each(lambda s, h: [h[lead].request_snapshot(1, timeout_s=2)])
    want.update(write(ls, steps, [f"b{i}" for i in range(6)]))
    _completed(ls, steps, snap, "snapshot")
    for i in range(10):
        if all(_lane_snap_index(h[ls.leader()]) > 0
               for h in ls.hosts.values()):
            break
        want.update(write(ls, steps, [f"c{i}.{j}" for j in range(4)]))
    else:
        raise AssertionError("the leader lane's ring never compacted")
    snap_index = _lane_snap_index(ls.hosts[ls.first][ls.leader()])
    assert all(h[ls.leader()].nodes[1].compacted_to > 0
               for h in ls.hosts.values())
    transfer(ls, steps)
    # the witness joins after compaction: the stripped snapshot
    add_witness(ls, steps)

    def caught_up():
        lead = ls.leader()
        return lead and all(
            h[WITNESS].nodes[1].sm.get_last_applied()
            >= h[lead].nodes[1].sm.get_last_applied()
            for h in ls.hosts.values())
    ls.spin(steps, caught_up, 60, "witness catch-up")
    for hosts in ls.hosts.values():
        ss = hosts[WITNESS].logdb.get_snapshot(1, WITNESS)
        assert ss is not None and ss.witness, ss
        assert 1 in hosts[ls.leader()].kernel_engine.by_shard
    want.update(write(ls, steps, [f"d{i}" for i in range(3)]))
    # one voter down: commits need the witness's acks
    down = next(r for r in VOTERS if r != ls.leader())
    ls.close(down)
    want.update(write(ls, steps, [f"e{i}" for i in range(3)]))
    for hosts in ls.hosts.values():
        assert 1 in hosts[ls.leader()].kernel_engine.by_shard
    read_back(ls, steps, want)
    # every open host closed and reopened on its directory
    ls.restart()
    ls.spin(steps, ls.leader, 80, "election after restart")
    want.update(write(ls, steps, ["f0"]))
    read_back(ls, steps, want)
    if ls.depth:
        ls.spin(steps, lambda: all(
            h[r].kernel_engine._pending_ctx is None
            for h in ls.hosts.values() for r in h if r in VOTERS),
            10, "pending step context at idle")
    return {**elect, "rounds": ls.round_no, "writes": len(want),
            "ring_snap_index": snap_index, "down": down}


def mesh_ops(ls: Lockstep, steps) -> dict:
    """The MeshEngine's script of operations (see the module's
    docstring); returns what it saw."""
    on_mesh = [(1, r) for r in VOTERS]
    assert all(ls.on_mesh(s) == on_mesh for s in ls.hosts)
    t0 = time.perf_counter()
    ls.spin(steps, ls.leader, 60, "first election")
    elect = {"elect_rounds": ls.round_no, "elect_s": time.perf_counter() - t0}
    want = write(ls, steps, [f"a{i}" for i in range(6)])
    # a ReadIndex read through a follower host
    lead = ls.leader()
    fol = next(r for r in VOTERS if r != lead)
    _request(ls, steps, lambda s, h: [h[fol].read_index(1, timeout_s=2)],
             "follower read")
    for hosts in ls.hosts.values():
        assert hosts[fol].read_local_node(1, "a5") == want["a5"]
    # a leader transfer, then a snapshot beside the automatic ones
    target = transfer(ls, steps)
    snap = ls.each(lambda s, h: [h[target].request_snapshot(1, timeout_s=2)])
    want.update(write(ls, steps, [f"b{i}" for i in range(6)]))
    _completed(ls, steps, snap, "snapshot")
    assert all(h[target].nodes[1].compacted_to > 0 for h in ls.hosts.values())
    # restart from disk: the rows re-inject from tan state
    ls.restart()
    assert all(ls.on_mesh(s) == on_mesh for s in ls.hosts)
    ls.spin(steps, ls.leader, 60, "election after restart")
    read_back(ls, steps, want)
    # a witness member takes the whole group off the mesh
    add_witness(ls, steps)
    ls.spin(steps, lambda: not ls.on_mesh(ls.first), 10, "escalation")
    for hosts in ls.hosts.values():
        assert all(hosts[r].nodes[1].peer is not None for r in VOTERS)
    assert all(ls.on_mesh(s) == [] for s in ls.hosts)
    want.update(write(ls, steps, [f"c{i}" for i in range(3)]))
    # every voter's snapshot records the witness member: on restart,
    # admission refuses the mesh from the durable membership
    _request(ls, steps, lambda s, h: [h[r].request_snapshot(1, timeout_s=2)
                                      for r in VOTERS], "snapshots")
    ls.restart()
    for side, hosts in ls.hosts.items():
        assert ls.on_mesh(side) == []
        assert all(hosts[r].nodes[1].peer is not None for r in VOTERS)
    want.update(write(ls, steps, ["d0"]))
    read_back(ls, steps, want)
    return {**elect, "rounds": ls.round_no, "writes": len(want)}


# -- end to end (auto_run): the helpers of the witness and monkey cells --


def majority_leader(hosts: dict, timeout_s: float = 60.0) -> int:
    """The leader a majority of the voter hosts agree on (the witness
    host, id WITNESS, has no say)."""
    voters = {r: nh for r, nh in hosts.items() if r != WITNESS}
    end = time.monotonic() + timeout_s
    while True:
        votes: dict = {}
        for nh in voters.values():
            lid, ok = nh.get_leader_id(1)
            if ok:
                votes[lid] = votes.get(lid, 0) + 1
        for lid, n in votes.items():
            if n > len(voters) // 2 and lid in voters:
                return lid
        assert time.monotonic() < end, "no leader elected"
        time.sleep(0.02)


def writes(hosts: dict, cmds, deadline_s: float = 60.0) -> int:
    """Every command in flight at once on the voters' leader, again after
    a drop, until each is acknowledged; returns the leader."""
    end = time.monotonic() + deadline_s
    left = list(cmds)
    while True:
        lid = majority_leader(hosts)
        nh = hosts[lid]
        sent = [(c, nh.propose(nh.get_noop_session(1), c.encode(),
                               timeout_s=10)) for c in left]
        left = [c for c, rs in sent
                if rs.wait(15).code != RequestResultCode.COMPLETED]
        if not left:
            return lid
        assert time.monotonic() < end, f"writes {left[:4]} never acknowledged"


def add_witness_sync(hosts: dict, addr: str, deadline_s: float = 30.0) -> int:
    """``sync_request_add_witness`` on the leader, again after a drop;
    returns the leader.  Open the witness host first (see the module's
    docstring)."""
    end = time.monotonic() + deadline_s
    while True:
        lid = majority_leader(hosts)
        try:
            hosts[lid].sync_request_add_witness(1, WITNESS, addr, 0,
                                                timeout_s=5)
            return lid
        except (RequestDroppedError, RequestTimeoutError):
            assert time.monotonic() < end, "the witness was never added"


def metadata_only(wnh, n: int, timeout_s: float = 30.0) -> int:
    """At least ``n`` METADATA entries in the witness's durable log, none
    with a payload, and the witness's SM empty; returns the count."""
    end = time.monotonic() + timeout_s
    while True:
        ents = wnh.logdb.iterate_entries(1, WITNESS, 1, 1 << 30, 0)
        meta = sum(e.type == pb.EntryType.METADATA for e in ents)
        if meta >= n or time.monotonic() > end:
            break
        time.sleep(0.05)
    assert meta >= n, f"the witness's log holds {meta} METADATA entries"
    assert all(not e.cmd for e in ents if not e.is_config_change()), \
        "a payload reached the witness's log"
    assert wnh.nodes[1].sm.sm.kv == {}, "a payload reached the witness's SM"
    return meta


def monkey(hosts: dict, least_s: float, min_ops: int,
           op_timeout_s: float) -> dict:
    """The reference's partition monkey (``tests/test_monkey.py``) on the
    voter hosts: four clients write and read one register through the
    leader host's partition and its heal.  Each window (before, during,
    after) lasts until ``min_ops`` operations completed in it, the
    partition at least ``least_s`` seconds (the reference's fixed 2, 2
    and 1.5 s see few operations complete where the engine step is
    slow).  The history must hold 10 completed operations, 3 of them
    across the partition, and be linearizable."""
    voters = {r: nh for r, nh in hosts.items() if r != WITNESS}
    h = HistoryRecorder()
    stop = threading.Event()

    def client(pid):
        rng = random.Random(pid)
        seq = 0
        while not stop.is_set():
            lid = None
            rids = list(voters)
            rng.shuffle(rids)
            for rid in rids:
                if voters[rid]._partitioned:
                    continue
                got, ok = voters[rid].get_leader_id(1)
                if ok and got in voters and not voters[got]._partitioned:
                    lid = got
                    break
            if lid is None:
                time.sleep(0.02)
                continue
            nh = voters[lid]
            if pid % 2 == 0:
                val = f"p{pid}s{seq}"
                seq += 1
                rec = h.invoke(pid, "write", "x", val)
                try:
                    nh.sync_propose(nh.get_noop_session(1),
                                    f"x={val}".encode(),
                                    timeout_s=op_timeout_s)
                    h.complete(rec)
                except Exception:
                    pass  # open op: outcome unknown
            else:
                rec = h.invoke(pid, "read", "x")
                try:
                    h.complete(rec, value=nh.sync_read(
                        1, "x", timeout_s=op_timeout_s))
                except Exception:
                    pass
            time.sleep(0.01)

    def window(t_from, least):
        t1, end = time.monotonic() + least, time.monotonic() + 30.0
        while time.monotonic() < end:
            if time.monotonic() >= t1 and sum(
                    1 for o in list(h.ops)
                    if o.ret is not None and o.ret > t_from) >= min_ops:
                return
            time.sleep(0.05)

    threads = [threading.Thread(target=client, args=(p,), daemon=True)
               for p in range(4)]
    try:
        for t in threads:
            t.start()
        window(0.0, 0.0)
        lid = majority_leader(voters, timeout_s=30)
        voters[lid].partition_node()
        partition_at = time.monotonic()
        window(partition_at, least_s)
        heal_at = time.monotonic()
        voters[lid].restore_partitioned_node()
        window(heal_at, 0.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    done = [o for o in h.ops if o.ret is not None]
    chaos = [o for o in done if o.call < heal_at and o.ret > partition_at]
    assert len(done) >= 10, f"{len(done)} operations completed"
    assert len(chaos) >= 3, f"{len(chaos)} operations overlap the partition"
    t0 = time.perf_counter()
    assert check_linearizable_kv(h.ops), "the history is not linearizable"
    return {"monkey_ops": len(h.ops), "monkey_completed": len(done),
            "monkey_in_partition": len(chaos), "linearizable": True,
            "monkey_check_s": time.perf_counter() - t0,
            "monkey_s": heal_at - partition_at}
