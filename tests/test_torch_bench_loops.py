"""The port's bench loops against the JAX reference's, leaf for leaf.

Each loop of ``dragonboat_tpu_torch.bench_loop`` (the latency loop and
its pipelined form with and without reads, the ReadIndex mix and its
pipelined form, the served mix on direct-mapped and hashed tables and with
``apply_batch=2``, the membership wave's ``cc_step`` and the election
storm and its pipelined form) is fed the same elected state, made by the
reference and carried across as numpy, and must leave every
``ShardState``, ``Inbox``, table and carry leaf equal, dtypes included.
The storms run under the reference's own drop masks, taken by calling the
reference's ``_drop_box`` on an all-ones inbox.  The geometries are those
of ``tests/test_bench_modes.py``, whose checks are repeated here as the
port's own (histogram total = releases, ctxs complete, the storm recovers
with term < 30, served checksum > 0, the read gate suppresses, hashed =
direct), the storm's with the port's own drop draw.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonboat_tpu import bench_loop as ref_bl
from dragonboat_tpu.core import kstate as ref_ks
from dragonboat_tpu.rsm.device_kv import DeviceKV as RefKV
from dragonboat_tpu_torch import bench_loop as bl
from dragonboat_tpu_torch import convert, graphs, scale_100k
from dragonboat_tpu_torch.core import params as P
from dragonboat_tpu_torch.core.kstate import empty_inbox
from dragonboat_tpu_torch.rsm.device_kv import DeviceKV

R = 3
I32_MAX = 2**31 - 1


def _np(x):
    return {k: None if v is None else np.asarray(v) for k, v in zip(x._fields, x)}


def _writable(fields):
    """A copy of a dict of numpy leaves (the cached ones stay untouched)."""
    return {k: None if v is None else v.copy() for k, v in fields.items()}


def _ref_struct(cls, fields):
    return cls(**{k: None if v is None else jnp.asarray(v) for k, v in fields.items()})


def _same(ref, got, what):
    bad = convert.diff_leaves(_np(ref), convert.to_numpy(got))
    assert bad == [], f"{what}: leaves differ: {bad}"


def _same_scalar(ref, got, what):
    a, b = np.asarray(ref), got.numpy()
    assert a.dtype == b.dtype == np.int32 and a.shape == b.shape == (), (what, a.dtype, b.dtype)
    assert int(a) == int(b), (what, int(a), int(b))


def _same_kv(ref, got):
    assert convert.diff_leaves({k: np.asarray(v) for k, v in ref.items()},
                               convert.kv_state_to_numpy(got)) == []


def _kps(sm: bool, **repl):
    ref = ref_bl.sm_params(R) if sm else ref_bl.bench_params(R)
    port = bl.sm_params(R, device="cpu") if sm else bl.bench_params(R, device="cpu")
    ref, port = dataclasses.replace(ref, **repl), dataclasses.replace(port, **repl)
    assert convert.kernel_params_from(dataclasses.asdict(ref)) == port
    return ref, port


_ELECTED = {}


def _elected(groups, sm=False, **repl):
    """(kp_ref, kp, ref (state, box), port (state, box)): one elected state
    made by the reference, on both sides (cached as numpy per geometry)."""
    kp_ref, kp = _kps(sm, **repl)
    key = (groups, sm, tuple(sorted(repl.items())))
    if key not in _ELECTED:
        s, b = ref_bl.elect_all(kp_ref, R, ref_bl.make_cluster(kp_ref, groups, R))
        _ELECTED[key] = (_np(s), _np(b))
    s, b = (_writable(d) for d in _ELECTED[key])
    ref = (_ref_struct(ref_ks.ShardState, s), _ref_struct(ref_ks.Inbox, b))
    port = (convert.from_numpy("ShardState", s, "cpu"), convert.from_numpy("Inbox", b, "cpu"))
    return kp_ref, kp, ref, port


def _zero():
    return torch.zeros((), dtype=torch.int32)


# -- latency loops -------------------------------------------------------------


def test_run_steps_lat_equals_reference_and_histogram_counts_releases():
    kp_ref, kp, (rs, rb), (ts, tb) = _elected(8)
    G = ts.term.shape[0]
    B = kp.proposal_cap
    rstamp, rhist, rreads = ref_bl.lat_init(kp_ref, G)
    stamp, hist, reads = bl.lat_init(kp, G, device="cpu")
    lead = ts.role.numpy() == P.LEADER
    for iters, now0 in ((10, 0), (25, 10)):
        if now0:
            h0 = hist.numpy().astype(np.int64)
            a0 = ts.processed.numpy()[lead].astype(np.int64).sum()
        rs, rb, rstamp, rhist, rreads = ref_bl.run_steps_lat(
            kp_ref, R, iters, B, False, True, True, jnp.asarray(now0, jnp.int32),
            rs, rb, rstamp, rhist, rreads)
        ts, tb, stamp, hist, reads = bl.run_steps_lat(
            kp, R, iters, B, False, True, True, now0, ts, tb, stamp, hist, reads)
        _same(rs, ts, "state")
        _same(rb, tb, "inbox")
        for name, r, t in (("stamp", rstamp, stamp), ("hist", rhist, hist)):
            assert convert.diff_leaves({name: np.asarray(r)}, {name: t.numpy()}) == [], name
        _same_scalar(rreads, reads, "reads")
    # every leader-side released write lands in exactly one bucket, and the
    # steady state releases within a few steps of proposing
    dh = hist.numpy().astype(np.int64) - h0
    released = ts.processed.numpy()[lead].astype(np.int64).sum() - a0
    assert dh.sum() == released > 0, (dh.sum(), released)
    assert dh[:8].sum() == dh.sum(), dh.nonzero()


def test_run_steps_lat_with_reads_equals_reference_and_completes_ctxs():
    kp_ref, kp, (rs, rb), (ts, tb) = _elected(8)
    G = ts.term.shape[0]
    r_carry = ref_bl.lat_init(kp_ref, G)
    t_carry = bl.lat_init(kp, G, device="cpu")
    rs, rb, *r_carry = ref_bl.run_steps_lat(
        kp_ref, R, 20, 4, True, True, True, jnp.asarray(0, jnp.int32), rs, rb, *r_carry)
    ts, tb, *t_carry = bl.run_steps_lat(kp, R, 20, 4, True, True, True, 0, ts, tb, *t_carry)
    _same(rs, ts, "state")
    _same(rb, tb, "inbox")
    for r, t in zip(r_carry[:2], t_carry[:2]):
        assert np.array_equal(np.asarray(r), t.numpy()) and t.dtype == torch.int32
    _same_scalar(r_carry[2], t_carry[2], "reads")
    # every leader completes ~one quorum-read ctx per settled step
    assert int(t_carry[2]) > 10 * (G // R) // 2
    assert int(ts.committed.max()) > 0


@pytest.mark.parametrize("do_reads", [False, True], ids=["writes", "reads"])
def test_run_steps_lat_pipelined_equals_reference(do_reads):
    """Both micro-steps of pipeline step i stamp and bucket at now0 + i:
    the stamp ring and histogram must equal the reference's (a port that
    stamped per micro-step, or bucketed on the wrong one, would not)."""
    kp_ref, kp, (rs, rb), (ts, tb) = _elected(8)
    G = ts.term.shape[0]
    r_carry = ref_bl.lat_init(kp_ref, G)
    t_carry = bl.lat_init(kp, G, device="cpu")
    rs, rb, *r_carry = ref_bl.run_steps_lat_pipelined(
        kp_ref, R, 12, 4, do_reads, True, True, jnp.asarray(5, jnp.int32), rs, rb, *r_carry)
    ts, tb, *t_carry = bl.run_steps_lat_pipelined(
        kp, R, 12, 4, do_reads, True, True, 5, ts, tb, *t_carry)
    _same(rs, ts, "state")
    _same(rb, tb, "inbox")
    for name, r, t in zip(("stamp", "hist"), r_carry[:2], t_carry[:2]):
        assert convert.diff_leaves({name: np.asarray(r)}, {name: t.numpy()}) == [], name
    _same_scalar(r_carry[2], t_carry[2], "reads")
    assert int(t_carry[1].sum()) > 0
    assert (int(t_carry[2]) > 0) == do_reads


# -- the ReadIndex mix -----------------------------------------------------------


def test_run_steps_mixed_equals_reference():
    kp_ref, kp, (rs, rb), (ts, tb) = _elected(8)
    rs, rb, rreads = ref_bl.run_steps_mixed(
        kp_ref, R, 20, 4, jnp.asarray(7, jnp.int32), rs, rb, jnp.asarray(0, jnp.int32))
    ts, tb, reads = bl.run_steps_mixed(kp, R, 20, 4, 7, ts, tb, _zero())
    _same(rs, ts, "state")
    _same(rb, tb, "inbox")
    _same_scalar(rreads, reads, "reads")
    assert int(reads) > 0


def test_run_steps_mixed_pipelined_equals_reference():
    kp_ref, kp, (rs, rb), (ts, tb) = _elected(8)
    rs, rb, rreads = ref_bl.run_steps_mixed_pipelined(
        kp_ref, R, 10, 4, jnp.asarray(3, jnp.int32), rs, rb, jnp.asarray(0, jnp.int32))
    ts, tb, reads = bl.run_steps_mixed_pipelined(kp, R, 10, 4, 3, ts, tb, _zero())
    _same(rs, ts, "state")
    _same(rb, tb, "inbox")
    _same_scalar(rreads, reads, "reads")
    assert int(reads) > 0


# -- the served mix ---------------------------------------------------------------


def _mixed_sm_both(groups, steps, ww, hash_keys, acc0=0, fill=None, **repl):
    """Run run_steps_mixed_sm on both sides from one elected state; return
    the port's (state, reads, acc, rej) after checking every leaf."""
    kp_ref, kp, (rs, rb), (ts, tb) = _elected(groups, sm=True, **repl)
    G = groups * R
    ref_kv, kv = RefKV(table_cap=1024, hash_keys=hash_keys), DeviceKV(table_cap=1024, hash_keys=hash_keys)
    kv0 = convert.kv_state_to_numpy(kv.init_state(G, "cpu"))
    if fill is not None:
        kv0["vals"][:] = fill
    rkvs = {k: jnp.asarray(v) for k, v in kv0.items()}
    tkvs = convert.kv_state_from_numpy(kv0, "cpu")
    r_carry = [jnp.asarray(v, jnp.int32) for v in (0, acc0, 0)]
    rs, rb, rkvs, *r_carry = ref_bl.run_steps_mixed_sm(
        kp_ref, R, ref_kv, steps, ww, jnp.asarray(0, jnp.int32), rs, rb, rkvs, *r_carry)
    t_carry = [torch.tensor(v, dtype=torch.int32) for v in (0, acc0, 0)]
    ts, tb, tkvs, *t_carry = bl.run_steps_mixed_sm(kp, R, kv, steps, ww, 0, ts, tb, tkvs, *t_carry)
    _same(rs, ts, "state")
    _same(rb, tb, "inbox")
    _same_kv(rkvs, tkvs)
    for name, r, t in zip(("reads", "acc", "rejects"), r_carry, t_carry):
        _same_scalar(r, t, name)
    return (ts, *t_carry)


@pytest.mark.parametrize("table", ["direct", "hashed"])
def test_run_steps_mixed_sm_equals_reference(table):
    WW = 4
    ts, rd, acc, rej = _mixed_sm_both(8, 25, WW, table == "hashed")
    # served reads are executed lookups of index-valued payloads: the
    # checksum is positive, nothing was rejected, writes flowed
    assert int(rd) > 0 and int(acc) > 0 and int(rej) == 0
    assert int(ts.committed.max()) > 9 * WW


def test_run_steps_mixed_sm_read_gate_equals_reference():
    """apply_batch=2 with write width 8: the apply cursor falls behind the
    commit point, so confirmed ctxs stay ahead of ``processed`` and the
    gate must suppress serving (ungated, ~one ctx per leader per settled
    step would be served)."""
    steps = 12
    ts, rd, _acc, _rej = _mixed_sm_both(4, steps, 8, False, apply_batch=2)
    leaders = int((ts.role == P.LEADER).sum())
    assert int(rd) < (steps - 4) * leaders // 2
    assert int((ts.committed - ts.processed).max()) > 10


def test_run_steps_mixed_sm_hashed_equals_direct():
    """The hashed slot scan (stored keys) serves the same reads as the
    direct-mapped one: same served ctxs, same checksum (port only)."""
    results = {}
    for hashed in (False, True):
        _kp_ref, kp, _ref, (st, box) = _elected(8, sm=True)
        kv = DeviceKV(table_cap=1024, hash_keys=hashed)
        out = bl.run_steps_mixed_sm(kp, R, kv, 25, 4, 0, st, box, kv.init_state(8 * R, "cpu"),
                                    _zero(), _zero(), _zero())
        results[hashed] = tuple(int(x) for x in out[3:])
    assert results[False][0] > 0 and results[False][2] == results[True][2] == 0
    assert results[True] == results[False], results


def test_run_steps_mixed_sm_checksum_wraps_like_int32():
    """The read checksum is an int32 sum that wraps.  The table is filled
    with 2**30 and the carry starts at INT32_MAX, so the first served
    window alone crosses 2**31 many times over; the port reduces in int64
    and wraps, and must equal the reference's int32 arithmetic."""
    _ts, rd, acc, _rej = _mixed_sm_both(8, 6, 4, False, acc0=I32_MAX, fill=2**30)
    assert int(rd) > 0 and int(acc) != I32_MAX


def test_wrap_i32_matches_int32_sums():
    rng = np.random.default_rng(3)
    for n in (1, 7, 300):
        x = rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
        want = np.sum(x, dtype=np.int32)
        got = bl.wrap_i32(torch.as_tensor(x).sum(dtype=torch.int64))
        assert got.dtype == torch.int32 and int(got) == int(want)
    big = torch.tensor([2**30] * 3, dtype=torch.int64).sum()
    assert int(bl.wrap_i32(big)) == -(2**30)
    assert int(bl.wrap_i32(torch.tensor(2**31 - 1) + 1)) == -(2**31)


# -- the membership wave --------------------------------------------------------------


def test_cc_wave_equals_reference():
    """Three waves of cc_step + run_steps(3) (bench.py's period 4), the
    host releasing the one-in-flight gate before each: every leaf, the
    accept mask and the CC index equal; every accepted CC commits and the
    compaction floor advances under the load."""
    kp_ref, kp, (rs, rb), (ts, tb) = _elected(8)
    lead = ts.role.numpy() == P.LEADER
    snap0 = ts.snap_index.numpy()[lead].astype(np.int64).sum()
    waves = []
    for _ in range(3):
        rs = rs._replace(pending_cc=jnp.zeros_like(rs.pending_cc))
        ts = ts._replace(pending_cc=torch.zeros_like(ts.pending_cc))
        rs, rb, racc, ridx = ref_bl.cc_step(kp_ref, R, rs, rb)
        ts, tb, acc, idx = bl.cc_step(kp, R, ts, tb)
        assert np.array_equal(np.asarray(racc), acc.numpy()) and acc.dtype == torch.bool
        assert np.array_equal(np.asarray(ridx), idx.numpy()) and idx.dtype == torch.int32
        _same(rs, ts, "state after cc_step")
        _same(rb, tb, "inbox after cc_step")
        waves.append((acc.numpy(), idx.numpy()))
        rs, rb = ref_bl.run_steps(kp_ref, R, 3, True, True, rs, rb)
        ts, tb = bl.run_steps(kp, R, 3, True, True, ts, tb)
        _same(rs, ts, "state")
        _same(rb, tb, "inbox")
    committed = ts.committed.numpy()
    accepted = sum(int(a.sum()) for a, _ in waves)
    done = sum(int((a & (committed >= i)).sum()) for a, i in waves)
    assert accepted > 0 and done == accepted, (accepted, done)
    assert ts.snap_index.numpy()[lead].astype(np.int64).sum() > snap0


def test_scale_rung_phase_a_equals_reference_run_steps():
    """``scale_100k``'s phase A at 8 groups x 3, two timed calls of 3
    steps through the CPU stand-in, leaves the reference ``run_steps``'
    state and inbox from the same start (the geometry and step count
    ``test_cc_wave_equals_reference`` traces in this process)."""
    kp_ref, _kp = _kps(False)
    with graphs.stand_in():
        _line, extra = scale_100k.phase_a(8, steps=3, device="cpu")
    rs = ref_bl.make_cluster(kp_ref, 8, R)
    rb = ref_ks.empty_inbox(kp_ref, 8 * R)
    for _ in range(2):
        rs, rb = ref_bl.run_steps(kp_ref, R, 3, True, True, rs, rb)
    _same(rs, extra["state"], "phase A state")
    _same(rb, extra["box"], "phase A inbox")


# -- the election storm ------------------------------------------------------------------


def _ref_keep_masks(kp_ref, G, iters, drop_p, seed):
    """The reference's drop masks: its _drop_box on an all-ones inbox."""
    box = ref_ks.empty_inbox(kp_ref, G)
    ones = type(box)(*[None if f is None else jnp.ones_like(f) for f in box])
    key0 = jax.random.PRNGKey(seed)
    p = jnp.asarray(drop_p, jnp.float32)
    return torch.as_tensor(np.stack([
        np.asarray(ref_bl._drop_box(ones, jax.random.fold_in(key0, i), p).mtype) != 0
        for i in range(iters)]))


def _storm_start(kp_ref, kp, groups):
    s = ref_bl.make_cluster(kp_ref, groups, R)
    s, b = (_writable(_np(x)) for x in (s._replace(pre_vote=jnp.ones_like(s.pre_vote)),
                                        ref_ks.empty_inbox(kp_ref, groups * R)))
    return ((_ref_struct(ref_ks.ShardState, s), _ref_struct(ref_ks.Inbox, b)),
            (convert.from_numpy("ShardState", s, "cpu"), convert.from_numpy("Inbox", b, "cpu")))


def test_run_steps_storm_equals_reference_under_reference_masks():
    kp_ref, kp = _kps(False)
    (rs, rb), (ts, tb) = _storm_start(kp_ref, kp, 16)
    masks = _ref_keep_masks(kp_ref, 16 * R, 30, 0.3, 7)
    assert 0.2 < 1 - masks.float().mean() < 0.4
    rs, rb = ref_bl.run_steps_storm(kp_ref, R, 30, 0.3, 7, rs, rb)
    ts, tb = bl.run_steps_storm(kp, R, 30, 0.3, 7, ts, tb, keep_masks=masks)
    _same(rs, ts, "state")
    _same(rb, tb, "inbox")


def test_run_steps_storm_pipelined_equals_reference_under_reference_masks():
    """The reference keys pipeline step i's micro-steps 2i and 2i + 1, so
    its masks are the serial storm's first 2n."""
    kp_ref, kp = _kps(False)
    (rs, rb), (ts, tb) = _storm_start(kp_ref, kp, 16)
    masks = _ref_keep_masks(kp_ref, 16 * R, 30, 0.3, 11)
    rs, rb = ref_bl.run_steps_storm_pipelined(kp_ref, R, 15, 0.3, 11, rs, rb)
    ts, tb = bl.run_steps_storm_pipelined(kp, R, 15, 0.3, 11, ts, tb, keep_masks=masks)
    _same(rs, ts, "state")
    _same(rb, tb, "inbox")


def test_storm_recovers_to_single_leader_with_the_ports_draw():
    kp = bl.bench_params(R, device="cpu")
    state = bl.make_cluster(kp, 16, R, device="cpu")
    state = state._replace(pre_vote=torch.ones_like(state.pre_vote))
    box = empty_inbox(kp, state.term.shape[0], "cpu")
    state, box = bl.run_steps_storm(kp, R, 30, 0.3, 7, state, box)
    for _ in range(40):
        role = state.role.numpy().reshape(-1, R)
        if ((role == P.LEADER).sum(axis=1) == 1).all():
            break
        state, box = bl.run_steps(kp, R, 5, True, False, state, box)
    role = state.role.numpy().reshape(-1, R)
    assert ((role == P.LEADER).sum(axis=1) == 1).all()
    # pre-vote kept failed campaigns from inflating terms
    assert int(state.term.max()) < 30
