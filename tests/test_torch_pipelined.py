"""The port's pipelined loops against its serial loops, bitwise, no JAX.

Port of ``tests/test_pipeline_differential.py``: from one elected 64 x 3
cluster, an election storm (the port's own drop draw), a write phase and
a ReadIndex mix, each run by the pipelined loop at n and by the serial
loop at 2n.  Every state leaf must be equal at every phase end, and the
final inbox and the completed-read counter too.  The storm's draw
depends only on (seed, micro-step), so chunked draws give the same masks
as one, and the storm that draws its own equals the storm fed those masks.
"""

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch import bench_loop as bl
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch.core import params as P
from dragonboat_tpu_torch.core.kstate import empty_inbox

R, GROUPS, N = 3, 64, 10   # N pipeline steps = 2N serial micro-steps per phase
DROP_P = 0.25


def _phases(kp, state, box, seed, pipelined):
    """(state snapshots at each phase end, final inbox, reads)."""
    width = max(1, kp.proposal_cap // 8)
    snaps = [convert.to_numpy(state)]
    if pipelined:
        state, box = bl.run_steps_storm_pipelined(kp, R, N, DROP_P, seed, state, box)
        snaps.append(convert.to_numpy(state))
        state, box = bl.run_steps_pipelined(kp, R, N, True, True, state, box)
        snaps.append(convert.to_numpy(state))
        state, box, reads = bl.run_steps_mixed_pipelined(
            kp, R, N, width, 7, state, box, torch.zeros((), dtype=torch.int32))
    else:
        state, box = bl.run_steps_storm(kp, R, 2 * N, DROP_P, seed, state, box)
        snaps.append(convert.to_numpy(state))
        state, box = bl.run_steps(kp, R, 2 * N, True, True, state, box)
        snaps.append(convert.to_numpy(state))
        state, box, reads = bl.run_steps_mixed(
            kp, R, 2 * N, width, 7, state, box, torch.zeros((), dtype=torch.int32))
    snaps.append(convert.to_numpy(state))
    return snaps, convert.to_numpy(box), reads


@pytest.mark.parametrize("seed", [5, 42])
def test_pipelined_lockstep(seed):
    kp = bl.bench_params(R, device="cpu")
    state0, box0 = bl.elect_all(kp, R, bl.make_cluster(kp, GROUPS, R, device="cpu"))
    a, box_a, reads_a = _phases(kp, state0, box0, seed, pipelined=False)
    b, box_b, reads_b = _phases(kp, state0, box0, seed, pipelined=True)
    for phase, sa, sb in zip(("elect", "storm", "write", "mixed"), a, b):
        assert convert.diff_leaves(sa, sb) == [], f"phase {phase} diverged (seed {seed})"
    assert convert.diff_leaves(box_a, box_b) == [], f"final inbox diverged (seed {seed})"
    assert reads_a.dtype == reads_b.dtype == torch.int32
    assert int(reads_a) == int(reads_b) > 0
    # the phases did something: the drops changed the storm's trajectory
    # against a clean run of the same ticks, and the writes committed
    clean, _ = bl.run_steps(kp, R, 2 * N, True, False, state0, box0)
    assert convert.diff_leaves(convert.to_numpy(clean), a[1]) != []
    assert (a[2]["committed"] > a[1]["committed"]).any()


def test_storm_draw_depends_only_on_seed_and_micro_step():
    kp = bl.bench_params(R, device="cpu")
    like = empty_inbox(kp, GROUPS * R, "cpu").mtype
    once = [bl.storm_keep(9, i, DROP_P, like) for i in range(20)]
    chunked = [bl.storm_keep(9, s + i, DROP_P, like)
               for s in range(0, 20, 3) for i in range(min(3, 20 - s))]
    assert all(torch.equal(x, y) for x, y in zip(once, chunked))
    assert once[0].shape == like.shape and once[0].dtype == torch.bool
    dropped = 1 - torch.stack(once).float().mean().item()
    assert 0.2 < dropped < 0.3, dropped
    # other micro-steps and other seeds draw other masks
    assert not torch.equal(once[0], once[1])
    assert not torch.equal(once[0], bl.storm_keep(10, 0, DROP_P, like))
    assert bl.storm_keep(9, 0, 0.0, like).all() and not bl.storm_keep(9, 0, 1.0, like).any()


def test_storm_own_draw_equals_fed_storm_keep_masks():
    """run_steps_storm keys step i's draw by micro-step i from 0: drawing
    its own masks equals being fed storm_keep(seed, i) for i < n, in the
    serial and the pipelined form."""
    kp = bl.bench_params(R, device="cpu")
    state = bl.make_cluster(kp, 16, R, device="cpu")
    state = state._replace(pre_vote=torch.ones_like(state.pre_vote))
    box = empty_inbox(kp, state.term.shape[0], "cpu")
    masks = torch.stack([bl.storm_keep(3, i, DROP_P, box.mtype) for i in range(20)])
    own = bl.run_steps_storm(kp, R, 20, DROP_P, 3, state, box)
    fed = bl.run_steps_storm(kp, R, 20, DROP_P, 3, state, box, keep_masks=masks)
    piped = bl.run_steps_storm_pipelined(kp, R, 10, DROP_P, 3, state, box, keep_masks=masks)
    for other in (fed, piped):
        for a, b in zip(own, other):
            assert convert.diff_leaves(convert.to_numpy(a), convert.to_numpy(b)) == []
    # another seed's draw takes another trajectory
    shifted = bl.run_steps_storm(kp, R, 20, DROP_P, 4, state, box)
    assert convert.diff_leaves(convert.to_numpy(own[0]), convert.to_numpy(shifted[0])) != []


def test_drop_box_zeroes_dropped_slots_only():
    kp = bl.sm_params(R, device="cpu")
    box = empty_inbox(kp, 4, "cpu")
    ones = type(box)(*[torch.ones_like(f) for f in box])
    keep = torch.as_tensor(np.random.default_rng(1).random((4, kp.inbox_cap)) < 0.5)
    out = bl._drop_box(ones, keep)
    for name, f in zip(out._fields, out):
        k = keep if f.dim() == 2 else keep[..., None].expand_as(f)
        assert f.dtype == getattr(ones, name).dtype, name
        assert bool((f[k] == 1).all()) and bool((f[~k] == 0).all()), name


def test_lat_pipelined_counts_every_release_in_pipeline_steps():
    """run_steps_lat_pipelined stamps both micro-steps with the pipeline
    clock, so every leader release lands in a bucket, and in steady state
    commit and apply finish within one or two pipeline steps."""
    kp = bl.bench_params(R, device="cpu")
    state, box = bl.elect_all(kp, R, bl.make_cluster(kp, 8, R, device="cpu"))
    stamp, hist, reads = bl.lat_init(kp, state.term.shape[0], device="cpu")
    lead = state.role.numpy() == P.LEADER
    state, box, stamp, hist, reads = bl.run_steps_lat_pipelined(
        kp, R, 5, kp.proposal_cap, False, True, True, 0, state, box, stamp, hist, reads)
    h0 = hist.numpy().astype(np.int64)
    a0 = state.processed.numpy()[lead].astype(np.int64).sum()
    state, box, stamp, hist, reads = bl.run_steps_lat_pipelined(
        kp, R, 10, kp.proposal_cap, False, True, True, 5, state, box, stamp, hist, reads)
    dh = hist.numpy().astype(np.int64) - h0
    released = state.processed.numpy()[lead].astype(np.int64).sum() - a0
    assert hist.dtype == torch.int32 and stamp.dtype == torch.int32
    assert dh.sum() == released > 0
    assert dh[:3].sum() == dh.sum(), dh.nonzero()
