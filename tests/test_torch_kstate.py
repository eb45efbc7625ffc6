"""The port's state layout and host constants against the JAX reference.

``dragonboat_tpu_torch.core.kstate`` / ``params`` / ``raftpb`` must carry
the reference's layout exactly: the same fields in the same order with the
same dtypes, the same fresh state leaf for leaf, the same KernelParams and
message-type values, and a tensor splitmix32 equal to the numpy mixer.
Exact equality throughout: every leaf is int32 or bool.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dragonboat_tpu import raftpb as ref_pb
from dragonboat_tpu.bench_loop import sm_params as ref_sm_params
from dragonboat_tpu.core import kernel as ref_kernel
from dragonboat_tpu.core import kstate as ref_ks
from dragonboat_tpu.core import params as ref_P
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.bench_loop import sm_params
from dragonboat_tpu_torch.core import kernel as tk
from dragonboat_tpu_torch.core import kstate as ks
from dragonboat_tpu_torch.core import params as P

STRUCTS = ("ShardState", "Inbox", "StepInput", "StepOutput")


def ref_np(x):
    return {k: None if v is None else np.asarray(v)
            for k, v in zip(x._fields, x)}


def _kernel_harness_kp(mod):
    # tests/kernel_harness.py's shared geometry
    return mod.KernelParams(num_peers=3, log_cap=256, inbox_cap=4,
                            msg_entries=4, proposal_cap=4, readindex_cap=4)


@pytest.mark.parametrize("geometry,groups,opts", [
    ("kernel_harness", 2, {}),
    ("kernel_harness", 3, {"check_quorum": True, "pre_vote": True,
                           "quiesce": True, "witness": 2}),
    ("sm_params", 4, {"election_timeout": 7, "heartbeat_timeout": 2}),
])
def test_fresh_structs_equal_reference(geometry, groups, opts):
    if geometry == "kernel_harness":
        kp_ref, kp = _kernel_harness_kp(ref_P), _kernel_harness_kp(P)
    else:
        kp_ref, kp = ref_sm_params(3), sm_params(3, device="cpu")
    assert dataclasses.asdict(kp_ref) == dataclasses.asdict(kp)
    G = groups * 3
    rids = np.tile(np.arange(1, 4, dtype=np.int32), groups)
    pids = np.arange(1, 4, dtype=np.int32)
    opts = dict(opts)
    kinds = None
    if "witness" in opts:
        kinds = np.full((G, 3), P.K_VOTER, np.int32)
        kinds[:, opts.pop("witness") - 1] = P.K_WITNESS
    ref = ref_ks.init_state(kp_ref, G, rids, pids, peer_kinds=kinds, **opts)
    got = ks.init_state(kp, G, rids, pids, peer_kinds=kinds, device="cpu", **opts)
    assert convert.diff_leaves(ref_np(ref), convert.to_numpy(got)) == []
    assert convert.diff_leaves(ref_np(ref_ks.empty_inbox(kp_ref, G)),
                               convert.to_numpy(ks.empty_inbox(kp, G, "cpu"))) == []
    assert convert.diff_leaves(ref_np(ref_ks.empty_input(kp_ref, G)),
                               convert.to_numpy(ks.empty_input(kp, G, "cpu"))) == []


def test_contracts_and_fields_equal_reference():
    for name in STRUCTS:
        assert ks.CONTRACTS[name] == ref_ks.CONTRACTS[name], name
        ours, theirs = getattr(ks, name), getattr(ref_ks, name)
        assert ours._fields == theirs._fields, name
        assert list(ks.CONTRACTS[name]) == list(ours._fields), name
    assert tk.CONTRACTS == ref_kernel.CONTRACTS
    assert tk.FLAG_CLASSES == ref_kernel.FLAG_CLASSES


def test_kernel_params_and_constants_equal_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(P.KernelParams)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(ref_P.KernelParams)]
    assert ours == theirs
    for K in range(0, 16):
        assert P.slot_families(K) == ref_P.slot_families(K)
    for name in ("FOLLOWER", "CANDIDATE", "PRE_VOTE_CANDIDATE", "LEADER",
                 "NON_VOTING", "WITNESS", "K_ABSENT", "K_VOTER",
                 "K_NON_VOTING", "K_WITNESS", "R_RETRY", "R_WAIT",
                 "R_REPLICATE", "R_SNAPSHOT", "NO_LEADER"):
        assert getattr(P, name) == getattr(ref_P, name), name
    for m in pb.MessageType:
        assert int(m) == int(ref_pb.MessageType[m.name]), m.name
    kp = convert.kernel_params_from(dataclasses.asdict(ref_sm_params(3)))
    assert kp == sm_params(3, device="cpu")


U32_EDGES = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x9E3779B9, 0x61C88647,
             0xFFFFFFFE, 0xFFFFFFFF]


def test_tensor_splitmix32_equals_numpy_on_u32_edges():
    rng = np.random.default_rng(3)
    xs = np.asarray(U32_EDGES + list(rng.integers(0, 1 << 32, 256)), np.uint64)
    want = ref_P.splitmix32(xs.astype(np.uint32))
    got = P.splitmix32_t(torch.as_tensor(xs.astype(np.int64)))
    assert (got.numpy() == want.astype(np.int64)).all()
    for x in U32_EDGES:
        assert P.splitmix32(x) == ref_P.splitmix32(x)
    # the i32 reading: the uint32 view of negative seeds and the mul32 wrap
    i32 = torch.as_tensor(xs.astype(np.uint32).view(np.int32))
    assert (P.u32(i32).numpy() == xs.astype(np.int64)).all()
    c = 0x632BE5AB
    assert (P.mul32(torch.as_tensor(xs.astype(np.int64)), c).numpy()
            == ((xs * np.uint64(c)) & np.uint64(0xFFFFFFFF)).astype(np.int64)).all()


def test_next_rand_timeout_equals_host_draw():
    """The kernel's timeout mixer equals params.randomized_timeout (the
    reference's host flavour) across u32 edge seeds and counters."""
    kp = _kernel_harness_kp(P)
    seeds = np.asarray(U32_EDGES, np.uint64).astype(np.uint32).view(np.int32)
    G = len(seeds)
    st = ks.init_state(kp, G, 1, [1, 2, 3], seeds=seeds, device="cpu",
                       election_timeout=13)
    for counter in (0, 1, 0x7FFFFFFE):
        st = st._replace(rand_counter=torch.full((G,), counter, dtype=torch.int32))
        nxt, rt = tk._next_rand_timeout(st)
        want = [ref_P.randomized_timeout(int(s), counter + 1, 13) for s in seeds]
        assert rt.tolist() == want
        assert nxt.dtype == rt.dtype == torch.int32


def test_convert_round_trip_and_dtype_guard():
    kp = sm_params(3, device="cpu")
    st = ks.init_state(kp, 6, np.tile([1, 2, 3], 2), [1, 2, 3], device="cpu")
    back = convert.from_numpy("ShardState", convert.to_numpy(st), "cpu")
    assert convert.diff_leaves(convert.to_numpy(st), convert.to_numpy(back)) == []
    fields = convert.to_numpy(st)
    fields["term"] = fields["term"].astype(np.int64)
    with pytest.raises(TypeError):
        convert.from_numpy(ks.ShardState, fields, "cpu")
    with pytest.raises(ValueError):
        convert.from_numpy(ks.ShardState, {"term": fields["term"]}, "cpu")
