"""The port's device router: full raft clusters with zero host routing.

Ports of ``tests/test_device_router.py`` run on the port alone (CPU
tensors), plus the router's slot-layout helpers held equal to the
reference's.
"""

import numpy as np
import torch

from dragonboat_tpu.core import router as ref_router
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.core import router
from dragonboat_tpu_torch.core.kstate import empty_inbox, empty_input, init_state
from dragonboat_tpu_torch.core.router import cluster_step
from dragonboat_tpu_torch.raftpb import MessageType as MT


def make(n_groups, replicas=3):
    kp = KP.KernelParams(
        num_peers=replicas, log_cap=256, inbox_cap=5 * (replicas - 1),
        msg_entries=4, proposal_cap=4, readindex_cap=4,
    )
    G = n_groups * replicas
    rids = np.tile(np.arange(1, replicas + 1, dtype=np.int32), n_groups)
    pids = np.arange(1, replicas + 1, dtype=np.int32)
    return kp, init_state(kp, G, rids, pids, device="cpu")


def _ticking(kp, G):
    return empty_input(kp, G, "cpu")._replace(tick=torch.ones(G, dtype=torch.bool))


def _elect(kp, st, box, n_groups, max_steps):
    tick = _ticking(kp, st.term.shape[0])
    for _ in range(max_steps):
        st, box, _ = cluster_step(kp, 3, st, box, tick)
        if bool((st.role.reshape(n_groups, 3) == KP.LEADER).any(dim=1).all()):
            break
    assert bool((st.role.reshape(n_groups, 3) == KP.LEADER).any(dim=1).all()), \
        "not all groups elected"
    return st, box


def test_device_routed_election_and_commit():
    kp, st = make(4)
    G = st.term.shape[0]
    st, box = _elect(kp, st, empty_inbox(kp, G, "cpu"), 4, 60)
    idle = empty_input(kp, G, "cpu")
    for _ in range(6):  # settle: let the noops commit
        st, box, _ = cluster_step(kp, 3, st, box, idle)
    assert bool((st.committed == 1).all())

    lead_rows = torch.nonzero(st.role == KP.LEADER)[:, 0]
    pv = torch.zeros((G, kp.proposal_cap), dtype=torch.bool)
    pv[lead_rows, :2] = True
    st, box, out = cluster_step(kp, 3, st, box, idle._replace(prop_valid=pv))
    assert bool(out.prop_accepted[lead_rows][:, :2].all())
    for _ in range(6):
        st, box, _ = cluster_step(kp, 3, st, box, idle)
    assert bool((st.committed == 3).all())
    lt = st.lt.reshape(4, 3, -1)
    assert bool((lt == lt[:, :1]).all()), "term rings differ within a group"


def test_device_routed_steady_state_throughput_commits():
    """Pipeline proposals every step; commits advance by every one."""
    kp, st = make(2)
    G = st.term.shape[0]
    st, box = _elect(kp, st, empty_inbox(kp, G, "cpu"), 2, 40)
    idle = empty_input(kp, G, "cpu")
    for _ in range(6):
        st, box, _ = cluster_step(kp, 3, st, box, idle)
    lead = torch.nonzero(st.role == KP.LEADER)[:, 0]
    c0 = int(st.committed[lead].sum())
    steps = 30
    pv = torch.zeros((G, kp.proposal_cap), dtype=torch.bool)
    pv[lead, :] = True
    for _ in range(steps):
        st, box, _ = cluster_step(kp, 3, st, box, idle._replace(prop_valid=pv))
    for _ in range(6):  # drain
        st, box, _ = cluster_step(kp, 3, st, box, idle)
    total = int(st.committed[lead].sum()) - c0
    assert total == 2 * steps * kp.proposal_cap, total


def test_slot_layout_helpers_equal_reference():
    assert router.SLOTS_PER_PEER == ref_router.SLOTS_PER_PEER
    assert router.SLOT_OFFSETS_OF_TYPE == ref_router.SLOT_OFFSETS_OF_TYPE
    for R in (2, 3, 5):
        for t in range(1, R + 1):
            for s in range(1, R + 1):
                if s == t:
                    continue
                assert router.peer_ordinal(t, s, R) == ref_router.peer_ordinal(t, s, R)
                for m in MT:
                    assert (router.slot_candidates(t, s, R, int(m))
                            == ref_router.slot_candidates(t, s, R, int(m)))
