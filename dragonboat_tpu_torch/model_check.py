#!/usr/bin/env python3
"""Small-scope exhaustive model checker for the port's batched Raft step.

The port of the reference's ``scripts/model_check.py``.  The transition
relation is the REAL ``dragonboat_tpu_torch/core/kernel.py`` step — not a
re-implementation — driven over an exhaustively enumerated small scope:
one group of 3 replicas, a <= ``MAX_LOG``-entry log, bounded exploration
depth, all interleavings of message delivery / drop / duplication, and at
most one network partition (isolate + heal) per path.  Exploration is a
deterministic BFS with state-hash dedup; every explored state is checked
against

* the five classical Raft safety properties —

  - ``election_safety``     at most one leader per term
  - ``leader_append_only``  a stable leader never rewrites its own log
  - ``log_matching``        same (index, term) => identical prefixes
  - ``leader_completeness`` a leader holds every committed entry
  - ``state_machine_safety``no two replicas disagree below their commits

* every declared ``core/kstate.py INVARIANTS`` row, evaluated through
  the same pure-python oracle (``core/invariants.eval_row``) the runtime
  probe's differential tests cite.

Because cold-start election takes many timer ticks, exploration seeds
from a deterministically scripted happy-path prefix (full delivery, all
messages): the initial state, mid-election, leader-just-elected, and
entries-in-flight/committed states — then turns full nondeterminism
loose from each seed.

The step is eager, so one call costs the same few thousand tensor
operations at 3 rows as at hundreds.  The checker therefore steps the
kernel successors of many frontier nodes in ONE batched call (each node's
3 rows side by side; the step is independent per row), and builds each
successor when BFS reaches its parent, in the reference's order: the
explored state set, ``states_explored``, ``transitions`` (one per kernel
successor of an expanded node) and ``net_overflow`` are the reference
checker's at the same scope.  ``step_calls`` counts the batched calls.

Mutation testing: ``MUTATIONS`` maps seeded protocol bugs (skip vote
persistence, commit without quorum, truncate a committed suffix, grant
double votes, campaign while quiesced) to exact source edits of the
port's ``core/kernel.py``; ``--mutation`` re-runs the scope against the
mutated kernel and must catch each.

CLI:
    python -m dragonboat_tpu_torch.model_check [--scope fast|deep|quiesce]
        [--json] [--mutation NAME | --all-mutations] [--device DEVICE]

``--device`` names the device the step runs on (default: the CUDA card;
with no card it raises — pass ``--device cpu`` on a machine without one).

Exit status: 0 = scope explored, zero violations (or, with a mutation,
the mutation WAS caught); 1 = violations on the unmutated kernel or a
mutation that escaped.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import types
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.convert import from_numpy, tensor_to_numpy, to_numpy
from dragonboat_tpu_torch.core import invariants as inv_mod
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.core.kstate import (
    Inbox,
    ShardState,
    StepInput,
    empty_input,
    init_state,
)
from dragonboat_tpu_torch.devices import resolve_device

MT = pb.MessageType

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: replicas in the model (one raft group; kernel rows 0..2 = rids 1..3)
N_REP = 3
#: log-length bound: proposals stop once the leader's last reaches this
MAX_LOG = 4
#: in-flight network bound; routing past it drops (counted, reported)
NET_CAP = 12
#: most kernel successors stepped in one batched call (3 rows each)
BATCH = 256

#: kernel geometry for the scope (log_cap covers MAX_LOG with headroom
#: and keeps ring wrap out of scope)
KP_SCOPE = dict(num_peers=N_REP, log_cap=8, inbox_cap=4, msg_entries=4,
                proposal_cap=1, readindex_cap=4)
ELECTION_TIMEOUT = 3
HEARTBEAT_TIMEOUT = 1

SCOPES = {
    # depth = BFS radius around each seed; max_states = exploration
    # budget (dedup'd)
    "fast": dict(depth=3, max_states=600),
    "deep": dict(depth=5, max_states=20000),
    # quiesced=True seeds with a banked election clock: the natural
    # entry path needs e_timeout*10 idle ticks — unreachable at these
    # depths — so the scope seeds the mask directly and checks the
    # quiesced_no_campaign / quiesced_no_vote invariants
    "quiesce": dict(depth=3, max_states=600, quiesce=True),
}

KERNEL_FILE = os.path.join("dragonboat_tpu_torch", "core", "kernel.py")

#: seeded protocol bugs: name -> (find, replace) exact source edits.
#: Each must be caught by at least one verifier leg (model checker /
#: runtime probe / static safety pass) — asserted by the test suite.
MUTATIONS = {
    # granting a vote without persisting who it went to: a second
    # candidate of the same term can then also be granted
    "skip_vote_persist": (
        "    s = mrep(s, grant, vote=m.from_, e_tick=0)\n",
        "    s = mrep(s, grant, e_tick=0)\n",
    ),
    # advancing the commit index to the leader's own last entry without
    # consulting the quorum match book
    "commit_without_quorum": (
        "    ok = (q > s.committed) & (t == s.term) & (s.role == P.LEADER)\n"
        "    return mrep(s, ok, committed=q)\n",
        "    ok = (s.last > s.committed) & (s.role == P.LEADER)\n"
        "    return mrep(s, ok, committed=s.last)\n",
    ),
    # accepting a replicate that truncates below the local commit index
    "truncate_committed": (
        "    accept = h_rep & ~below_commit & prev_ok & ~over_cap\n",
        "    accept = h_rep & prev_ok & ~over_cap\n",
    ),
    # vote-once check disabled: any second candidate is also granted
    "double_vote": (
        "    can_grant = (s.vote == 0) | (s.vote == m.from_)\n",
        "    can_grant = (s.vote == 0) | (s.vote != 0)\n",
    ),
    # tick masking ignores the device-resident quiesced mask: a
    # quiesced lane with a banked election clock campaigns while its
    # mask is still raised (caught by quiesced_no_campaign under the
    # quiesce scope's seeded-mask states)
    "quiesce_campaigns": (
        "    q_any = inp.quiesced | s.quiesced\n",
        "    q_any = inp.quiesced\n",
    ),
}


def load_kernel_module(mutation: str, root: str = _ROOT):
    """A throwaway copy of the port's ``core.kernel`` with one seeded bug
    applied (the real module is untouched).  Exposes the full module so
    callers can also reach ``step_donated`` — the chaos mutation test
    drives a live engine through the mutated kernel."""
    find, replace = MUTATIONS[mutation]
    path = os.path.join(root, KERNEL_FILE)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    if find not in src:
        raise RuntimeError(
            f"mutation {mutation!r}: target snippet not found in "
            f"{KERNEL_FILE} — update MUTATIONS to match the kernel source")
    src = src.replace(find, replace)
    mod = types.ModuleType(f"dragonboat_tpu_torch.core.kernel__mut_{mutation}")
    mod.__file__ = path + f"<mutated:{mutation}>"
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def load_kernel_step(mutation: str | None = None, root: str = _ROOT):
    """The port kernel's ``step``, optionally with one seeded bug."""
    if mutation is None:
        from dragonboat_tpu_torch.core.kernel import step

        return step
    return load_kernel_module(mutation, root).step


# ---------------------------------------------------------------------------
# model state: kernel arrays + in-flight network + partition ghost
# ---------------------------------------------------------------------------

# message tuple layout (hashable, canonical):
# (mtype, frm, to, term, log_term, log_index, commit, reject, hint,
#  hint_high, ents) with ents = ((term, is_cc), ...)


@dataclass
class Node:
    """One explored model state (ghost fields ride outside the hash)."""

    arrs: dict                      # ShardState field -> np array [3,...]
    net: tuple                      # sorted tuple of in-flight messages
    isolated: int                   # row cut off by the partition, or -1
    part_used: bool                 # the <=1 partition event is spent
    depth: int
    leaders: dict = field(default_factory=dict)   # ghost: term -> rid
    trail: tuple = ()               # action names from the seed


def _state_arrays(state: ShardState) -> dict:
    """Every present ShardState field as a host numpy array (int32 or
    bool, the reference's dtypes), so ``state_key`` hashes the bytes the
    reference checker hashes."""
    return {f: tensor_to_numpy(v) for f, v in zip(ShardState._fields, state)
            if v is not None}


def state_key(n: Node) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for f in ShardState._fields:
        a = n.arrs.get(f)
        if a is not None:
            h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr((n.net, n.isolated, n.part_used)).encode())
    return h.digest()


def _log_term(arrs: dict, row: int, idx: int, cap: int) -> int:
    return int(arrs["lt"][row, idx & (cap - 1)])


# ---------------------------------------------------------------------------
# routing: StepOutput lanes -> message tuples (harness-parity transport)
# ---------------------------------------------------------------------------


def collect_messages(o: dict, kp) -> list:
    """All outbound messages of one step over the 3-row group, as
    message tuples; ``o`` holds the StepOutput fields of the group's 3
    rows as numpy arrays (the lanes tests/kernel_harness.py routes)."""
    msgs: list = []
    K, Pn = kp.inbox_cap, kp.num_peers
    for g in range(N_REP):
        my = g + 1
        for k in range(K):
            t = int(o["r_type"][g, k])
            if t:
                msgs.append((t, my, int(o["r_to"][g, k]),
                             int(o["r_term"][g, k]), 0,
                             int(o["r_log_index"][g, k]), 0,
                             int(bool(o["r_reject"][g, k])),
                             int(o["r_hint"][g, k]),
                             int(o["r_hint_high"][g, k]), ()))
        for p in range(Pn):
            to = p + 1
            if bool(o["s_rep"][g, p]):
                n = int(o["s_n_ent"][g, p])
                ents = tuple(
                    (int(o["s_ent_term"][g, p, e]),
                     int(bool(o["s_ent_cc"][g, p, e]))) for e in range(n))
                msgs.append((int(MT.REPLICATE), my, to, int(o["term"][g]),
                             int(o["s_prev_term"][g, p]),
                             int(o["s_prev_index"][g, p]),
                             int(o["s_commit"][g, p]), 0, 0, 0, ents))
            if bool(o["s_hb"][g, p]):
                msgs.append((int(MT.HEARTBEAT), my, to, int(o["term"][g]),
                             0, 0, int(o["s_hb_commit"][g, p]), 0,
                             int(o["s_hb_low"][g, p]),
                             int(o["s_hb_high"][g, p]), ()))
            v = int(o["s_vote"][g, p])
            if v:
                mt = MT.REQUEST_VOTE if v == 1 else MT.REQUEST_PREVOTE
                msgs.append((int(mt), my, to, int(o["s_vote_term"][g, p]),
                             int(o["s_vote_lterm"][g, p]),
                             int(o["s_vote_lindex"][g, p]), 0, 0,
                             int(o["s_vote_hint"][g, p]), 0, ()))
            if bool(o["s_timeout_now"][g, p]):
                msgs.append((int(MT.TIMEOUT_NOW), my, to,
                             int(o["term"][g]), 0, 0, 0, 0, 0, 0, ()))
    return [m for m in msgs if 1 <= m[2] <= N_REP and m[2] != m[1]]


def _inbox_arrays(kp, deliveries: dict) -> dict:
    """The inbox fields as numpy arrays with ``deliveries[row] = [msg,
    ...]`` placed in the leading slots (others empty)."""
    K, E = kp.inbox_cap, kp.msg_entries
    z = lambda *s: np.zeros((N_REP, *s), np.int32)  # noqa: E731
    box = dict(mtype=z(K), from_=z(K), term=z(K), log_term=z(K),
               log_index=z(K), commit=z(K),
               reject=np.zeros((N_REP, K), bool), hint=z(K),
               hint_high=z(K), n_ent=z(K), ent_term=z(K, E),
               ent_cc=np.zeros((N_REP, K, E), bool))
    for row, ms in deliveries.items():
        for k, m in enumerate(ms[:K]):
            (box["mtype"][row, k], box["from_"][row, k], _,
             box["term"][row, k], box["log_term"][row, k],
             box["log_index"][row, k], box["commit"][row, k],
             box["reject"][row, k], box["hint"][row, k],
             box["hint_high"][row, k]) = m[:10]
            ents = m[10][:E]
            box["n_ent"][row, k] = len(ents)
            for e, (t, cc) in enumerate(ents):
                box["ent_term"][row, k, e] = t
                box["ent_cc"][row, k, e] = cc
    if "ent_val" in Inbox._fields:
        box["ent_val"] = None
    return box


def _cat(parts: list) -> np.ndarray | None:
    return None if parts[0] is None else np.concatenate(parts)


def build_inbox(kp, deliveries: list, device=None) -> Inbox:
    """Inbox tensors on ``device`` for groups side by side, group i's
    ``deliveries[i][row] = [msg, ...]`` placed in its leading slots
    (others empty)."""
    boxes = [_inbox_arrays(kp, d) for d in deliveries]
    return from_numpy(Inbox, {k: _cat([b[k] for b in boxes])
                              for k in Inbox._fields}, device)


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------


class ModelChecker:
    def __init__(self, mutation: str | None = None, scope: str = "fast",
                 root: str = _ROOT, device=None):
        self.device = resolve_device(device)
        self.kp = KP.KernelParams(**KP_SCOPE)
        self.step_fn = load_kernel_step(mutation, root)
        self.scope = dict(SCOPES[scope])
        self.scope_name = scope
        self.mutation = mutation
        self.violations: list[dict] = []
        self.states_explored = 0
        self.transitions = 0
        self.step_calls = 0
        self.net_overflow = 0
        self.frontier_exhausted = False
        self.scope_complete = False
        self._seen: set[bytes] = set()
        self._input0 = to_numpy(empty_input(self.kp, N_REP, "cpu"))

    # -- kernel driving --------------------------------------------------
    def _step_batch(self, reqs: list) -> list:
        """One batched kernel call over ``reqs`` = [(arrs, deliveries,
        tick_rows, propose_row), ...], each a 3-row group side by side;
        returns [(arrs, msgs), ...] in order."""
        kp, n = self.kp, len(reqs)
        inp = {k: (None if v is None else np.concatenate([v] * n))
               for k, v in self._input0.items()}
        for i, (arrs, _, tick_rows, propose_row) in enumerate(reqs):
            for r in tick_rows:
                inp["tick"][N_REP * i + r] = True
            if propose_row is not None:
                inp["prop_valid"][N_REP * i + propose_row, 0] = True
        inp["applied"] = np.concatenate([r[0]["processed"] for r in reqs])
        state = from_numpy(ShardState, {
            f: _cat([r[0].get(f) for r in reqs]) for f in ShardState._fields},
            self.device)
        box = build_inbox(kp, [r[1] for r in reqs], self.device)
        new_state, out = self.step_fn(kp, state, box,
                                      from_numpy(StepInput, inp, self.device))
        self.step_calls += 1
        st = _state_arrays(new_state)
        o = {k: (tensor_to_numpy(v) if v is not None else None)
             for k, v in out._asdict().items()}
        res = []
        for i in range(n):
            rows = slice(N_REP * i, N_REP * (i + 1))
            res.append(({f: a[rows].copy() for f, a in st.items()},
                        collect_messages({k: (None if v is None else v[rows])
                                          for k, v in o.items()}, kp)))
        return res

    def _step(self, arrs: dict, deliveries: dict, tick_rows=(),
              propose_row: int | None = None):
        self.transitions += 1
        return self._step_batch([(arrs, deliveries, tuple(tick_rows),
                                  propose_row)])[0]

    def _route(self, node: Node, new_msgs: list) -> tuple:
        net = list(node.net)
        for m in new_msgs:
            if node.isolated >= 0 and (m[1] - 1 == node.isolated
                                       or m[2] - 1 == node.isolated):
                continue       # partition eats traffic crossing the cut
            if len(net) >= NET_CAP:
                self.net_overflow += 1
                continue
            net.append(m)
        return tuple(sorted(net))

    # -- safety properties ----------------------------------------------
    def _violate(self, prop: str, node: Node, detail: str) -> None:
        self.violations.append(dict(
            property=prop, detail=detail, depth=node.depth,
            trail=list(node.trail)[-10:], mutation=self.mutation))

    def check_node(self, node: Node, prev: Node | None,
                   action: str) -> None:
        a = node.arrs
        cap = self.kp.log_cap
        roles = [int(a["role"][r]) for r in range(N_REP)]
        terms = [int(a["term"][r]) for r in range(N_REP)]
        lasts = [int(a["last"][r]) for r in range(N_REP)]
        commits = [int(a["committed"][r]) for r in range(N_REP)]
        leaders = [r for r in range(N_REP) if roles[r] == KP.LEADER]

        # election safety: per-state coexistence + per-path history
        for i, r in enumerate(leaders):
            for q in leaders[i + 1:]:
                if terms[r] == terms[q]:
                    self._violate(
                        "election_safety", node,
                        f"rows {r} and {q} both lead term {terms[r]}")
        for r in leaders:
            prior = node.leaders.get(terms[r])
            if prior is not None and prior != r + 1:
                self._violate(
                    "election_safety", node,
                    f"term {terms[r]} led by rid {prior} earlier on this "
                    f"path, now by rid {r + 1}")
            node.leaders[terms[r]] = r + 1

        # leader append-only (edge property over one kernel step)
        if prev is not None:
            pa = prev.arrs
            for r in range(N_REP):
                if (int(pa["role"][r]) == KP.LEADER
                        and roles[r] == KP.LEADER
                        and int(pa["term"][r]) == terms[r]):
                    old_last = int(pa["last"][r])
                    if lasts[r] < old_last:
                        self._violate(
                            "leader_append_only", node,
                            f"leader row {r} shrank last "
                            f"{old_last}->{lasts[r]} ({action})")
                    for i in range(1, old_last + 1):
                        if _log_term(pa, r, i, cap) != _log_term(a, r, i,
                                                                 cap):
                            self._violate(
                                "leader_append_only", node,
                                f"leader row {r} rewrote entry {i} "
                                f"({action})")
                            break

        # log matching: equal terms at an index => equal prefixes
        for r in range(N_REP):
            for q in range(r + 1, N_REP):
                hi = min(lasts[r], lasts[q])
                for i in range(hi, 0, -1):
                    if _log_term(a, r, i, cap) == _log_term(a, q, i, cap):
                        for j in range(1, i):
                            if _log_term(a, r, j, cap) != _log_term(
                                    a, q, j, cap):
                                self._violate(
                                    "log_matching", node,
                                    f"rows {r}/{q} agree at index {i} "
                                    f"(term {_log_term(a, r, i, cap)}) but "
                                    f"diverge at {j}")
                                break
                        break

        # leader completeness: every committed entry is on the leader
        for ldr in leaders:
            for r in range(N_REP):
                if commits[r] > lasts[ldr]:
                    self._violate(
                        "leader_completeness", node,
                        f"row {r} committed through {commits[r]} but "
                        f"leader row {ldr} only has {lasts[ldr]} entries")
                    continue
                for i in range(1, commits[r] + 1):
                    if _log_term(a, r, i, cap) != _log_term(a, ldr, i, cap):
                        self._violate(
                            "leader_completeness", node,
                            f"committed entry {i} of row {r} (term "
                            f"{_log_term(a, r, i, cap)}) missing from "
                            f"leader row {ldr}")
                        break

        # state-machine safety: agreement below both commit indices
        for r in range(N_REP):
            for q in range(r + 1, N_REP):
                for i in range(1, min(commits[r], commits[q]) + 1):
                    if _log_term(a, r, i, cap) != _log_term(a, q, i, cap):
                        self._violate(
                            "state_machine_safety", node,
                            f"rows {r}/{q} disagree on committed entry {i}")
                        break

        # declared INVARIANTS via the runtime probe's python oracle
        inv_fields = sorted({f for iv in inv_mod.PARSED.values()
                             for f in iv.fields})
        for r in range(N_REP):
            cur = {"kind": [int(v) for v in a["kind"][r]]}
            for f in inv_fields:
                col = a[f][r] if f in a else None
                if col is None:
                    continue
                cur[f] = ([int(v) for v in col]
                          if getattr(col, "ndim", 0) else int(col))
            prow = None
            if prev is not None:
                prow = {f: int(prev.arrs[f][r])
                        for f in inv_mod._PREV_FIELDS}
            for iv in inv_mod.PARSED.values():
                if eval_violated(iv, cur, prow):
                    self._violate(
                        "invariant:" + iv.name, node,
                        f"row {r} violates {iv.name} ({action})")

    # -- successor generation --------------------------------------------
    def _plan(self, node: Node) -> list:
        """The reference's successor list for ``node``, deterministically
        ordered, with each kernel successor left as a request:
        ``("kernel", action, (arrs, deliveries, tick_rows, propose),
        net_minus)`` or ``("node", action, Node)``."""
        out: list = []
        a = node.arrs

        def kernel_succ(action, deliveries, tick_rows=(), propose=None,
                        net_minus=None):
            out.append(("kernel", action,
                        (a, deliveries, tuple(tick_rows), propose),
                        net_minus))

        # tick: timers advance on every non-isolated row
        ticks = tuple(r for r in range(N_REP) if r != node.isolated)
        kernel_succ("tick", {}, tick_rows=ticks)

        # propose one entry at any live leader below the log bound
        for r in range(N_REP):
            if (int(a["role"][r]) == KP.LEADER and r != node.isolated
                    and int(a["last"][r]) < MAX_LOG):
                kernel_succ(f"propose@{r}", {}, propose=r)

        # one message delivered / duplicated / dropped
        for m in sorted(set(node.net)):
            to_row = m[2] - 1
            if to_row == node.isolated or m[1] - 1 == node.isolated:
                continue
            label = f"{MT(m[0]).name}:{m[1]}->{m[2]}"
            kernel_succ("deliver " + label, {to_row: [m]}, net_minus=m)
            kernel_succ("dup " + label, {to_row: [m]})
            net = list(node.net)
            net.remove(m)
            out.append(("node", "drop " + label, Node(
                arrs=a, net=tuple(sorted(net)), isolated=node.isolated,
                part_used=node.part_used, depth=node.depth + 1,
                leaders=dict(node.leaders),
                trail=node.trail + ("drop " + label,))))

        # at most one partition event per path, plus its heal
        if not node.part_used:
            for r in range(N_REP):
                out.append(("node", f"isolate@{r}", Node(
                    arrs=a, net=node.net, isolated=r, part_used=True,
                    depth=node.depth + 1, leaders=dict(node.leaders),
                    trail=node.trail + (f"isolate@{r}",))))
        elif node.isolated >= 0:
            out.append(("node", "heal", Node(
                arrs=a, net=node.net, isolated=-1, part_used=True,
                depth=node.depth + 1, leaders=dict(node.leaders),
                trail=node.trail + ("heal",))))
        return out

    def _prefetch(self, nodes: list, cache: dict) -> None:
        """Step the kernel successors of ``nodes`` (up to BATCH of them
        in one call) into ``cache[id(node)]`` as (plan, results)."""
        plans = [(n, self._plan(n)) for n in nodes]
        reqs = [p[2] for _, plan in plans for p in plan if p[0] == "kernel"]
        res = iter([r for i in range(0, len(reqs), BATCH)
                    for r in self._step_batch(reqs[i:i + BATCH])])
        for n, plan in plans:
            cache[id(n)] = (plan, [next(res) for p in plan
                                   if p[0] == "kernel"])

    def successors(self, node: Node, cache: dict | None = None):
        """Deterministically ordered (action, Node) successors; the kernel
        steps come from ``cache`` (filled by ``_prefetch``) when there."""
        if cache is None:
            cache = {}
        if id(node) not in cache:
            self._prefetch([node], cache)
        plan, results = cache.pop(id(node))
        res = iter(results)
        out: list[tuple[str, Node]] = []
        for p in plan:
            if p[0] == "node":
                out.append((p[1], p[2]))
                continue
            _, action, _, net_minus = p
            self.transitions += 1
            arrs, msgs = next(res)
            net = list(node.net)
            if net_minus is not None:
                net.remove(net_minus)
            nxt = Node(arrs=arrs, net=(), isolated=node.isolated,
                       part_used=node.part_used, depth=node.depth + 1,
                       leaders=dict(node.leaders),
                       trail=node.trail + (action,))
            nxt.net = self._route(
                Node(arrs=arrs, net=tuple(net), isolated=node.isolated,
                     part_used=node.part_used, depth=0), msgs)
            out.append((action, nxt))
        return out

    # -- seed construction ----------------------------------------------
    def seeds(self) -> list[Node]:
        """Deterministic happy-path prefix states (full delivery)."""
        arrs = _state_arrays(init_state(
            self.kp, N_REP, np.arange(1, N_REP + 1, dtype=np.int32),
            np.arange(1, N_REP + 1, dtype=np.int32),
            election_timeout=ELECTION_TIMEOUT,
            heartbeat_timeout=HEARTBEAT_TIMEOUT, device=self.device))
        node = Node(arrs=arrs, net=(), isolated=-1, part_used=False,
                    depth=0, trail=("seed:init",))
        seeds = [node]
        cur, net = arrs, []

        def advance(tick, propose=None, label=""):
            nonlocal cur, net
            deliveries: dict = {}
            for m in net:
                deliveries.setdefault(m[2] - 1, []).append(m)
            cur, msgs = self._step(
                cur, deliveries, tick_rows=range(N_REP) if tick else (),
                propose_row=propose)
            net = msgs
            return Node(arrs=cur, net=tuple(sorted(net)), isolated=-1,
                        part_used=False, depth=0, trail=(label,))

        leader = None
        for i in range(60):
            n = advance(tick=True, label=f"seed:tick{i}")
            roles = [int(cur["role"][r]) for r in range(N_REP)]
            if KP.CANDIDATE in roles and len(seeds) < 2:
                seeds.append(n)                       # mid-election
            if KP.LEADER in roles:
                leader = roles.index(KP.LEADER)
                seeds.append(n)                       # leader elected
                break
        if leader is None:
            raise RuntimeError("seed phase failed to elect a leader")
        for _ in range(4):                            # settle vote traffic
            advance(tick=False, label="seed:settle")
        seeds.append(advance(tick=False, propose=leader,
                             label="seed:proposed"))  # entry in flight
        for i in range(6):
            n = advance(tick=False, label=f"seed:drain{i}")
        if int(cur["committed"][leader]) < 1:
            raise RuntimeError("seed phase failed to commit an entry")
        seeds.append(n)                               # entry committed
        seeds.append(advance(tick=False, propose=leader,
                             label="seed:proposed2"))
        if self.scope.get("quiesce"):
            return self._quiesce_seeds(seeds)
        return seeds

    def _quiesce_seeds(self, seeds: list[Node]) -> list[Node]:
        """Quiesced variants of the init and entry-committed seeds: the
        mask is raised directly (the natural e_timeout*10 idle entry is
        outside the depth bound) and the election clock is banked past
        the largest randomized timeout, so any tick-path bug that
        ignores the mask campaigns on its very first step."""
        out: list[Node] = []
        for i, base in enumerate((seeds[0], seeds[-2])):
            arrs = {f: a.copy() for f, a in base.arrs.items()}
            arrs["quiesce_on"][:] = True
            arrs["quiesced"][:] = True
            arrs["idle_tick"][:] = ELECTION_TIMEOUT * 10
            arrs["e_tick"][:] = 2 * ELECTION_TIMEOUT
            out.append(Node(
                arrs=arrs, net=base.net, isolated=-1, part_used=False,
                depth=0, leaders=dict(base.leaders),
                trail=(f"seed:quiesced{i}",)))
        return out

    # -- BFS --------------------------------------------------------------
    def run(self) -> dict:
        frontier: deque[Node] = deque()
        for s in self.seeds():
            k = state_key(s)
            if k not in self._seen:
                self._seen.add(k)
                self.check_node(s, None, s.trail[-1])
                self.states_explored += 1
                frontier.append(s)
        budget = self.scope["max_states"]
        depth_cap = self.scope["depth"]
        cache: dict = {}
        while frontier:
            node = frontier.popleft()
            if node.depth >= depth_cap:
                continue
            if self.states_explored >= budget:
                break
            if id(node) not in cache:
                # this node and the next frontier nodes BFS will expand,
                # about BATCH kernel successors (2 per message, a tick
                # and a proposal or two), in one call
                ahead, n_req = [], 0
                for nx in (node, *frontier):
                    if n_req >= BATCH:
                        break
                    if nx.depth < depth_cap and id(nx) not in cache:
                        ahead.append(nx)
                        n_req += 2 * len(nx.net) + 2
                self._prefetch(ahead, cache)
            for action, nxt in self.successors(node, cache):
                k = state_key(nxt)
                if k in self._seen:
                    continue
                self._seen.add(k)
                self.check_node(nxt, node, action)
                self.states_explored += 1
                frontier.append(nxt)
                if self.states_explored >= budget:
                    break
        self.frontier_exhausted = not frontier
        # the configured scope (depth radius x state budget) was fully
        # explored — either the frontier drained or the budget bound hit
        self.scope_complete = (self.frontier_exhausted
                               or self.states_explored >= budget)
        return self.result()

    def seen_digest(self) -> str:
        """A digest of the explored state set (sorted state keys)."""
        return hashlib.blake2b(b"".join(sorted(self._seen)),
                               digest_size=16).hexdigest()

    def result(self) -> dict:
        return dict(
            scope=self.scope_name, mutation=self.mutation,
            states_explored=self.states_explored,
            transitions=self.transitions,
            step_calls=self.step_calls,
            net_overflow=self.net_overflow,
            frontier_exhausted=self.frontier_exhausted,
            scope_complete=self.scope_complete,
            violations=self.violations,
            properties=["election_safety", "leader_append_only",
                        "log_matching", "leader_completeness",
                        "state_machine_safety"]
            + ["invariant:" + n for n in inv_mod.INVARIANT_NAMES],
        )


def eval_violated(iv, cur, prev) -> bool:
    return inv_mod.eval_row(iv, cur, prev)


def run_scope(scope: str = "fast", mutation: str | None = None,
              root: str = _ROOT, device=None) -> dict:
    return ModelChecker(mutation=mutation, scope=scope, root=root,
                        device=device).run()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scope", choices=sorted(SCOPES), default="fast")
    ap.add_argument("--mutation", choices=sorted(MUTATIONS))
    ap.add_argument("--all-mutations", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device the step runs on (default: the CUDA card)")
    args = ap.parse_args(argv)

    muts = sorted(MUTATIONS) if args.all_mutations else [args.mutation]
    ok = True
    reports = []
    for mut in muts:
        res = run_scope(args.scope, mut, device=args.device)
        reports.append(res)
        caught = bool(res["violations"])
        if mut is None:
            ok &= not caught
            verdict = ("CLEAN" if not caught
                       else f"{len(res['violations'])} VIOLATIONS")
        else:
            ok &= caught
            verdict = "caught" if caught else "ESCAPED"
        if not args.json:
            print(f"[model-check] scope={res['scope']} "
                  f"mutation={mut or '-'} states={res['states_explored']} "
                  f"transitions={res['transitions']} "
                  f"exhausted={res['frontier_exhausted']} -> {verdict}")
            for v in res["violations"][:5]:
                print(f"  {v['property']}: {v['detail']}")
    if args.json:
        print(json.dumps(reports if args.all_mutations else reports[0],
                         indent=2, sort_keys=True))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
