"""The port's device reductions against the JAX package's, on the CPU.

``core/fleet.fleet_stats``, ``core/health.fleet_health`` /
``shard_row`` and ``core/invariants.check_invariants`` of the port take
the same inputs as the reference's jitted functions and must give the same
structs, leaf for leaf and dtype for dtype (tolerance 0: every leaf is
i32), and the same dicts as the port's and the reference's pure-python
``recount`` oracles.

Inputs: a ``tests/kernel_harness.KernelCluster`` run for 30 ticked steps
(real elections), carried across as numpy, then perturbed by one numpy RNG
per tick (any state, violating ones included, not only reachable ones), at
the reference tests' geometries (1, 3), (4, 3) and (8, 5) groups x
replicas; six ticks each, the digests carried on both sides.  The
invariant probe's ``quorum(match)`` term runs K1's plain arm here (CPU
tensors); ``chip_smoke.py`` holds K1 at the probe's call site on the card.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dragonboat_tpu.core import fleet as ref_fleet
from dragonboat_tpu.core import health as ref_health
from dragonboat_tpu.core import invariants as ref_inv
from dragonboat_tpu.core import kstate as ref_kstate
from dragonboat_tpu.core import params as ref_P
from dragonboat_tpu.core.kstate import ShardState as RefShardState
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch.core import fleet, health, kstate
from dragonboat_tpu_torch.core import invariants as inv
from dragonboat_tpu_torch.core import params as P
from dragonboat_tpu_torch.core.kstate import ShardState

GEOMETRIES = [(1, 3, 11), (4, 3, 22), (8, 5, 33)]
TICKS = 6


@functools.lru_cache(maxsize=None)
def _cluster(groups, replicas):
    """(state, inbox_from) of a KernelCluster after 30 ticked steps, as
    numpy (cached per geometry; callers copy before mutating)."""
    from tests.kernel_harness import KernelCluster

    c = KernelCluster(groups, replicas)
    for _ in range(30):
        c.step(tick=True)
    st = {f: None if v is None else np.asarray(v)
          for f, v in zip(c.state._fields, c.state)}
    return st, np.asarray(c._build_inbox().from_)


def _inputs(groups, replicas):
    st, box = _cluster(groups, replicas)
    return ({k: None if v is None else v.copy() for k, v in st.items()},
            box.copy())


def _perturb(st, rng):
    """Random host-side mutation of every column the three reductions
    read, dtypes kept (``quiesced`` stays bool)."""
    G = st["committed"].shape[0]
    for name in ("committed", "applied", "term", "leader", "last",
                 "processed", "vote", "role", "quiesce_epoch"):
        mask = rng.random(G) < 0.4
        st[name][mask] = rng.integers(0, 12, mask.sum()).astype(np.int32)
    st["quiesced"] = st["quiesced"] | (rng.random(G) < 0.3)
    st["quiesced"] &= rng.random(G) < 0.8
    mask = rng.random(st["match"].shape) < 0.3
    st["match"][mask] = rng.integers(0, 12, mask.sum()).astype(np.int32)
    kind = st["kind"]
    for g in rng.integers(0, G, 2):
        if rng.random() < 0.5:
            kind[g, :] = P.K_ABSENT
    mask = rng.random(kind.shape) < 0.1
    kind[mask] = rng.integers(0, 4, mask.sum()).astype(np.int32)
    return st


def _port(st):
    return convert.from_numpy(ShardState, st, device="cpu")


def _ref(st):
    return RefShardState(**st)


def _np_struct(struct):
    """A struct of JAX arrays or tensors as a dict of numpy leaves."""
    out = {}
    for f, v in zip(struct._fields, struct):
        out[f] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _assert_equal(ref_struct, port_struct, what):
    bad = convert.diff_leaves(_np_struct(ref_struct), _np_struct(port_struct))
    assert not bad, (what, bad, _np_struct(ref_struct), _np_struct(port_struct))


def _digest_lists(d):
    return {f: [int(x) for x in np.asarray(getattr(d, f))] for f in d._fields}


def _ref_digest(cls, d):
    """The reference's digest struct from the port's (numpy leaves)."""
    return cls(**{f: getattr(d, f).numpy() for f in d._fields})


@pytest.mark.parametrize("groups,replicas,seed", GEOMETRIES)
def test_fleet_stats_matches_jax(groups, replicas, seed):
    st, box = _inputs(groups, replicas)
    rng = np.random.default_rng(seed)
    for tick in range(TICKS):
        st = _perturb(st, rng)
        want = ref_fleet.fleet_stats(_ref(st), box)
        got = fleet.fleet_stats(_port(st), torch.from_numpy(box))
        _assert_equal(want, got, ("tick", tick))
        assert fleet.stats_to_dict(got) == ref_fleet.stats_to_dict(want)


@pytest.mark.parametrize("k", [4, 99], ids=["k4", "k_over_G"])
@pytest.mark.parametrize("groups,replicas,seed", GEOMETRIES)
def test_fleet_health_matches_jax_and_recount(groups, replicas, seed, k):
    """Report and digest equal the reference's and both recounts every
    tick, the digests carried on both sides; k > G clamps to G."""
    st, box = _inputs(groups, replicas)
    rng = np.random.default_rng(seed)
    G = groups * replicas
    digest = health.empty_digest(G, "cpu")
    ref_digest = ref_health.empty_digest(G)
    for tick in range(TICKS):
        st = _perturb(st, rng)
        want, ref_next = ref_health.fleet_health(_ref(st), box, ref_digest, k=k)
        got, nxt = health.fleet_health(_port(st), torch.from_numpy(box),
                                       digest, k=k)
        _assert_equal(want, got, ("report", tick))
        _assert_equal(ref_next, nxt, ("digest", tick))
        assert got.worst_idx.shape == (min(k, G),)
        rec, rec_digest = health.recount(ShardState(**st), box,
                                         health.HealthDigest(*(
                                             v.numpy() for v in digest)), k=k)
        ref_rec, _ = ref_health.recount(_ref(st), box, ref_digest, k=k)
        assert health.report_to_dict(got) == rec == ref_rec, tick
        assert _digest_lists(nxt) == rec_digest, tick
        digest, ref_digest = nxt, ref_next


@pytest.mark.parametrize("groups,replicas,seed", GEOMETRIES)
def test_shard_row_matches_jax_for_every_lane(groups, replicas, seed):
    st, box = _inputs(groups, replicas)
    rng = np.random.default_rng(seed)
    G = groups * replicas
    digest = health.empty_digest(G, "cpu")
    for tick in range(3):
        st = _perturb(st, rng)
        _, digest = health.fleet_health(_port(st), torch.from_numpy(box),
                                        digest)
        ref_digest = _ref_digest(ref_health.HealthDigest, digest)
        for lane in range(G):
            want = ref_health.shard_row(_ref(st), box, ref_digest,
                                        np.int32(lane))
            got = health.shard_row(_port(st), torch.from_numpy(box), digest,
                                   lane)
            _assert_equal(want, got, ("tick", tick, "lane", lane))
            assert health.row_to_dict(got) == ref_health.row_to_dict(want)


def _synthetic_state(G, leaderless_rows):
    """Every row occupied; ``leaderless_rows`` have no leader (the
    reference test's stand-in, as tensors)."""
    from collections import namedtuple

    S = namedtuple("S", "kind role term vote leader committed applied "
                   "last stable processed snap_index snap_term")
    i32 = torch.int32
    leader = torch.full((G,), 2, dtype=i32)
    leader[list(leaderless_rows)] = P.NO_LEADER
    z = torch.zeros((G,), dtype=i32)
    return S(kind=torch.full((G, 3), P.K_VOTER, dtype=i32), role=z,
             term=torch.ones((G,), dtype=i32), vote=z, leader=leader,
             committed=z, applied=z, last=z, stable=z, processed=z,
             snap_index=z, snap_term=z)


def test_top_k_tie_determinism():
    """Equal severity scores order by ascending lane index (the
    reference's ``lax.top_k`` order; ``torch.topk`` alone does not)."""
    G, k = 16, 8
    tied = [3, 7, 11, 14]
    state = _synthetic_state(G, tied)
    inbox = torch.zeros((G, 4), dtype=torch.int32)
    digest = health.empty_digest(G)
    prev = None
    for _ in range(health.DEFAULT_THRESHOLDS.leaderless_ticks + 1):
        prev = digest
        report, digest = health.fleet_health(state, inbox, digest, k=k)
    idx = report.worst_idx.tolist()
    score = report.worst_score.tolist()
    assert idx[:4] == tied
    assert score[0] == score[3] > 0
    rerun, _ = health.fleet_health(state, inbox, prev, k=k)
    assert health.report_to_dict(rerun) == health.report_to_dict(report)
    np_state = type(state)(*(v.numpy() for v in state))
    want, _ = health.recount(np_state, inbox.numpy(),
                             health.HealthDigest(*(v.numpy() for v in prev)),
                             k=k)
    assert health.report_to_dict(report) == want
    ref_report, _ = ref_health.fleet_health(
        np_state, inbox.numpy(),
        _ref_digest(ref_health.HealthDigest, prev), k=k)
    _assert_equal(ref_report, report, "tie order")


@pytest.mark.parametrize("groups,replicas,seed", GEOMETRIES)
def test_check_invariants_matches_jax_and_recount(groups, replicas, seed):
    st, _ = _inputs(groups, replicas)
    rng = np.random.default_rng(seed)
    G = groups * replicas
    digest = inv.empty_digest(G, "cpu")
    ref_digest = ref_inv.empty_digest(G)
    saw_violation = False
    for tick in range(TICKS):
        st = _perturb(st, rng)
        want, ref_next = ref_inv.check_invariants(_ref(st), ref_digest)
        got, nxt = inv.check_invariants(_port(st), digest)
        _assert_equal(want, got, ("report", tick))
        _assert_equal(ref_next, nxt, ("digest", tick))
        rec, rec_digest = inv.recount(ShardState(**st), inv.InvariantDigest(
            *(v.numpy() for v in digest)))
        ref_rec, _ = ref_inv.recount(_ref(st), ref_digest)
        assert inv.report_to_dict(got) == rec == ref_rec, tick
        assert _digest_lists(nxt) == rec_digest, tick
        saw_violation |= rec["total"] > 0
        digest, ref_digest = nxt, ref_next
    assert saw_violation, "the perturbation never broke an invariant"


def _clean_base():
    """One group x 3 after real elections: (state, leader lane, a
    follower lane); every invariant holds on it."""
    st, _ = _inputs(1, 3)
    leaders = np.flatnonzero(st["role"] == P.LEADER)
    assert len(leaders) == 1, st["role"]
    lead = int(leaders[0])
    follower = (lead + 1) % 3
    assert st["committed"][follower] >= 1 and st["vote"][follower] != 0
    return st, lead, follower


def _break(name, st, lead, follower):
    """(lane, the base state to seed the digest from, the state that
    breaks exactly ``name``)."""
    base = {k: None if v is None else v.copy() for k, v in st.items()}
    lane = lead if name == "leader_commit_quorum" else follower
    if name in ("quiesced_no_campaign", "quiesced_no_vote"):
        base["quiesced"][lane] = True
    if name == "quiesced_no_vote":
        base["vote"][lane] = 0      # keeps vote_once_per_term vacuous
    s = {k: None if v is None else v.copy() for k, v in base.items()}
    if name == "commit_within_log":
        s["last"][lane] = s["committed"][lane] - 1
    elif name == "processed_within_commit":
        s["processed"][lane] = s["committed"][lane] + 1
    elif name == "applied_within_processed":
        s["applied"][lane] = s["processed"][lane] + 1
    elif name == "term_monotone":
        s["term"][lane] -= 1
    elif name == "commit_monotone":
        c = s["committed"][lane] - 1
        s["committed"][lane] = c
        s["processed"][lane] = min(s["processed"][lane], c)
        s["applied"][lane] = min(s["applied"][lane], c)
    elif name == "vote_once_per_term":
        s["vote"][lane] += 1
    elif name == "leader_commit_quorum":
        s["committed"][lane] += 1
        s["last"][lane] = max(s["last"][lane], s["committed"][lane])
        s["match"][lane, :] = 0
    elif name == "quiesced_no_campaign":
        s["term"][lane] += 1
    elif name == "quiesced_no_vote":
        s["vote"][lane] = 2
    else:
        raise AssertionError(name)
    return lane, base, s


@pytest.mark.parametrize("name", list(ref_kstate.INVARIANTS))
def test_handmade_state_breaks_exactly_one_invariant(name):
    st, lead, follower = _clean_base()
    lane, base, broken = _break(name, st, lead, follower)
    bit = inv.INVARIANT_NAMES.index(name)
    rep0, digest = inv.check_invariants(_port(base), inv.empty_digest(3))
    assert inv.report_to_dict(rep0)["total"] == 0
    got, _ = inv.check_invariants(_port(broken), digest)
    want, _ = ref_inv.check_invariants(
        _ref(broken), _ref_digest(ref_inv.InvariantDigest, digest))
    _assert_equal(want, got, name)
    d = inv.report_to_dict(got)
    assert d["per_invariant"] == {n: int(n == name)
                                  for n in inv.INVARIANT_NAMES}, d
    assert (d["total"], int(got.first_lane), int(got.first_mask)) == \
        (1, lane, 1 << bit)
    assert d["first"] == {"lane": lane, "invariants": [name]}
    rec, _ = inv.recount(ShardState(**broken), inv.InvariantDigest(
        *(v.numpy() for v in digest)))
    assert rec == d
    # with no valid prev (ticks == 0) a step-scoped invariant is vacuous
    fresh, _ = inv.check_invariants(_port(broken), inv.empty_digest(3))
    scoped = inv.PARSED[name].scope == "step"
    assert inv.report_to_dict(fresh)["total"] == (0 if scoped else 1)


def test_parsed_declarations_equal_the_reference():
    assert kstate.INVARIANTS == ref_kstate.INVARIANTS
    assert inv.INVARIANT_NAMES == ref_inv.INVARIANT_NAMES
    assert {n: dataclasses.asdict(i) for n, i in inv.PARSED.items()} == \
        {n: dataclasses.asdict(i) for n, i in ref_inv.PARSED.items()}
    assert inv.OPS.keys() == ref_inv.OPS.keys()
    assert inv._PREV_FIELDS == ref_inv._PREV_FIELDS
    assert P.LEADER == ref_P.LEADER and P.K_ABSENT == ref_P.K_ABSENT
