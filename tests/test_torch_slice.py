"""The port's whole slice against the JAX reference: elect_all, then
run_steps_sm with the device KV on every replica.

The geometry is the reference's ``test_full_step_sm_pallas_path_bitwise``
(sm_params(3), 8 groups x 3, table_cap 256).  The port runs its K3 wrapper
(the plain arm on the CPU), the reference its XLA range-apply arm, which
the reference pins bitwise to its Pallas kernel.  Every ShardState leaf,
every table leaf and the reject count must be equal; then the port's
result passes the read-back oracle of
``test_bench_pipeline_applies_to_device_kv``.
"""

import numpy as np

from dragonboat_tpu import bench_loop as ref_bl
from dragonboat_tpu_torch import bench_loop as bl
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch.core import params as P

GROUPS, R, TABLE = 8, 3, 256


def _ref_np(x):
    return {k: None if v is None else np.asarray(v) for k, v in zip(x._fields, x)}


def test_run_steps_sm_equals_reference_and_reads_back():
    kp_ref, kp = ref_bl.sm_params(R), bl.sm_params(R, device="cpu")
    rs, rb = ref_bl.elect_all(kp_ref, R, ref_bl.make_cluster(kp_ref, GROUPS, R))
    ts, tb = bl.elect_all(kp, R, bl.make_cluster(kp, GROUPS, R, device="cpu"))
    assert convert.diff_leaves(_ref_np(rs), convert.to_numpy(ts)) == []
    assert convert.diff_leaves(_ref_np(rb), convert.to_numpy(tb)) == []

    ref_kv, ref_kvs = ref_bl.make_device_sm(GROUPS, R, table_cap=TABLE)
    kv, kvs = bl.make_device_sm(GROUPS, R, table_cap=TABLE, device="cpu")
    rs, rb, ref_kvs, rrej = ref_bl.run_steps_sm(
        kp_ref, R, ref_kv, 25, True, True, rs, rb, ref_kvs)
    ts, tb, kvs, trej = bl.run_steps_sm(kp, R, kv, 25, True, True, ts, tb, kvs)
    assert convert.diff_leaves(_ref_np(rs), convert.to_numpy(ts)) == []
    assert convert.diff_leaves(_ref_np(rb), convert.to_numpy(tb)) == []
    assert convert.diff_leaves({k: np.asarray(v) for k, v in ref_kvs.items()},
                               convert.kv_state_to_numpy(kvs)) == []
    assert int(rrej) == int(trej) == 0
    assert int(kvs["count"].sum()) > 0

    # settle (no new proposals) so follower cursors catch up, then the
    # reference's read-back oracle on every replica
    ts, tb, kvs, rej2 = bl.run_steps_sm(kp, R, kv, 6, False, False, ts, tb, kvs)
    assert int(rej2) == 0
    st = convert.to_numpy(ts)
    role, applied, lv, snap = st["role"], st["applied"], st["lv"], st["snap_index"]
    assert (role == P.LEADER).reshape(GROUPS, R).any(axis=1).all()
    for g in range(GROUPS * R):
        hi = int(applied[g])
        assert hi > 0, f"row {g} never applied"
        # the replicated payload ring holds each entry's own index
        for idx in range(max(int(snap[g]) + 1, hi - 5), hi + 1):
            assert lv[g, idx & (kp.log_cap - 1)] == idx, (g, idx)
        # and the table's entry for the newest applied key is that index
        assert kv.lookup(kvs, g, hi & (TABLE - 1)) == hi, g
    keys = kvs["keys"].numpy().reshape(GROUPS, R, -1)
    vals = kvs["vals"].numpy().reshape(GROUPS, R, -1)
    same = 0
    for n, a in enumerate(applied.reshape(GROUPS, R)):
        if a[0] == a[1] == a[2]:          # equal applied -> equal tables
            for r in (1, 2):
                assert (keys[n, 0] == keys[n, r]).all(), (n, r)
                assert (vals[n, 0] == vals[n, r]).all(), (n, r)
            same += 1
    assert same >= 1
