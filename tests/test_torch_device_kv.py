"""DeviceKV and K3's plain arm against the JAX reference.

The port's ``DeviceKV.apply_kernel`` (the sequential plain arm),
``apply_kernel_range``, ``lookup`` and the K3 wrapper ``apply_window``
(which takes the plain arm for CPU tensors) must equal the reference's
``DeviceKV.apply_kernel``, ``apply_kernel_range``, ``lookup`` and
``apply_kernel_pallas`` (interpret mode) bit for bit, over the cases of
``tests/test_device_kv_pallas.py`` and ``tests/test_device_kv.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonboat_tpu.rsm.device_kv import DeviceKV as RefKV
from dragonboat_tpu.rsm.device_kv_pallas import apply_kernel_pallas
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch.rsm.device_kv import DeviceKV
from dragonboat_tpu_torch.rsm.device_kv_kernels import apply_window


def _np_state(st):
    return {k: np.asarray(v) for k, v in st.items()}


def _same(ref_state, ref_r, ref_ok, state, r, ok):
    assert convert.diff_leaves(_np_state(ref_state),
                               convert.kv_state_to_numpy(state)) == []
    assert np.array_equal(np.asarray(ref_r), r.numpy())
    assert np.asarray(ref_r).dtype == r.numpy().dtype == np.int32
    assert np.array_equal(np.asarray(ref_ok), ok.numpy())
    assert ok.dtype == torch.bool


# (table_cap, probe_depth, hash_keys, G, B, key_lo, key_hi, rounds, seed)
# — the cases of tests/test_device_kv_pallas.py
PALLAS_CASES = {
    "hashed": (64, 8, True, 9, 16, -2, 40, 4, 7),
    "direct": (128, 8, False, 16, 32, 0, 64, 3, 11),
    "full_window": (8, 4, True, 4, 12, 0, 30, 1, 3),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_apply_window_plain_equals_reference(case):
    T, D, hashed, G, B, lo, hi, rounds, seed = PALLAS_CASES[case]
    rng = np.random.default_rng(seed)
    ref_kv = RefKV(table_cap=T, probe_depth=D, hash_keys=hashed)
    kv = DeviceKV(table_cap=T, probe_depth=D, hash_keys=hashed)
    st_x, st_p = ref_kv.init_state(G), ref_kv.init_state(G)
    st_t, st_w = kv.init_state(G, "cpu"), kv.init_state(G, "cpu")
    rejects = 0
    for _ in range(rounds):
        keys = rng.integers(lo, hi, size=(G, B), dtype=np.int32)
        vals = rng.integers(-5, 1000, size=(G, B), dtype=np.int32)
        valid = rng.random((G, B)) < 0.8
        cmds = np.stack([keys, vals], axis=-1)
        st_x, (rx, okx) = ref_kv.apply_kernel(st_x, jnp.asarray(cmds), jnp.asarray(valid))
        st_p, (rp, okp) = apply_kernel_pallas(ref_kv, st_p, jnp.asarray(cmds),
                                              jnp.asarray(valid))
        st_t, (rt, okt) = kv.apply_kernel(st_t, torch.as_tensor(cmds),
                                          torch.as_tensor(valid))
        st_w, (rw, okw) = apply_window(kv, st_w, torch.as_tensor(cmds),
                                       torch.as_tensor(valid))
        _same(st_x, rx, okx, st_t, rt, okt)
        _same(st_p, rp, okp, st_w, rw, okw)
        rejects += int((valid & ~np.asarray(okx)).sum())
    if case == "full_window":
        assert rejects > 0, "case should exercise rejects"


def _lanes(rows):
    return np.asarray(rows, np.int32)


# the fixed command lanes of tests/test_device_kv.py:
# (table_cap, probe_depth, cmds [G, B, 2], valid [G, B], lookups [(g, key)])
LOOKUP_CASES = {
    "roundtrip": (64, 8, _lanes([[[5, 100], [9, 200], [5, 101], [0, 0]],
                                 [[7, 300], [7, 301], [7, 302], [1, 400]]]),
                  [[True, True, True, False], [True] * 4],
                  [(0, 5), (0, 9), (0, 0), (1, 7), (1, 1), (1, 3)]),
    "collisions": (16, 16, _lanes([[[k, k * 7] for k in range(100, 110)]]),
                   [[True] * 10], [(0, k) for k in range(98, 112)]),
    "full_window": (4, 4, _lanes([[[k, k] for k in range(1, 9)]]),
                    [[True] * 8], [(0, k) for k in range(0, 10)]),
    "negative_keys": (16, 4, _lanes([[[-1, 42], [3, 7]]]), [[True, True]],
                      [(0, -1), (0, 3), (0, 2)]),
}


@pytest.mark.parametrize("case", sorted(LOOKUP_CASES))
def test_apply_and_lookup_equal_reference(case):
    T, D, cmds, valid, lookups = LOOKUP_CASES[case]
    valid = np.asarray(valid)
    ref_kv, kv = RefKV(table_cap=T, probe_depth=D), DeviceKV(table_cap=T, probe_depth=D)
    G = cmds.shape[0]
    st_r, (rr, okr) = ref_kv.apply_kernel(ref_kv.init_state(G), jnp.asarray(cmds),
                                          jnp.asarray(valid))
    st_t, (rt, okt) = kv.apply_kernel(kv.init_state(G, "cpu"), torch.as_tensor(cmds),
                                      torch.as_tensor(valid))
    _same(st_r, rr, okr, st_t, rt, okt)
    for g, key in lookups:
        assert kv.lookup(st_t, g, key) == ref_kv.lookup(st_r, g, key), (g, key)


def test_range_apply_equals_reference_and_sequential():
    """apply_kernel_range over unevenly advancing windows, against the
    reference's range apply and the port's own sequential arm."""
    rng = np.random.default_rng(5)
    T, G, B = 64, 7, 16
    ref_kv = RefKV(table_cap=T, probe_depth=8, hash_keys=False)
    kv = DeviceKV(table_cap=T, probe_depth=8, hash_keys=False)
    st_r, st_a, st_b = ref_kv.init_state(G), kv.init_state(G, "cpu"), kv.init_state(G, "cpu")
    first = np.zeros(G, np.int64)
    for _ in range(5):
        vals = rng.integers(0, 1000, size=(G, B), dtype=np.int32)
        valid = rng.random((G, B)) < 0.8
        fk = (first & (T - 1)).astype(np.int32)
        keys = ((first[:, None] + np.arange(B)) & (T - 1)).astype(np.int32)
        st_r, (rr, okr) = ref_kv.apply_kernel_range(
            st_r, jnp.asarray(fk), jnp.asarray(vals), jnp.asarray(valid))
        st_a, (ra, oka) = kv.apply_kernel_range(
            st_a, torch.as_tensor(fk), torch.as_tensor(vals), torch.as_tensor(valid))
        st_b, (rb, okb) = kv.apply_kernel(
            st_b, torch.as_tensor(np.stack([keys, vals], -1)), torch.as_tensor(valid))
        _same(st_r, rr, okr, st_a, ra, oka)
        _same(st_r, rr, okr, st_b, rb, okb)
        first += rng.integers(0, B + 1, size=G)


def test_range_apply_wraps_and_counts():
    kv = DeviceKV(table_cap=16, hash_keys=False)
    vals = torch.arange(100, 108, dtype=torch.int32)[None, :]
    st, (r, ok) = kv.apply_kernel_range(
        kv.init_state(1, "cpu"), torch.tensor([12], dtype=torch.int32), vals,
        torch.ones((1, 8), dtype=torch.bool))
    assert bool(ok.all())
    for j in range(8):
        assert kv.lookup(st, 0, (12 + j) & 15) == 100 + j
    assert int(st["count"][0]) == 8
