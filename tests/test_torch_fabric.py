"""K1 and K2's plain PyTorch arms against the JAX reference.

``dragonboat_tpu_torch.parallel.fabric_kernels`` on CPU tensors runs the
plain arms of the quorum-match and lane-gather kernels; they must equal
the reference's XLA arms and its Pallas kernels (interpret mode) bit for
bit, at the shapes of ``tests/test_fabric_pallas.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonboat_tpu.parallel.fabric_pallas import (
    gather_lanes_pallas,
    gather_lanes_xla,
    quorum_match_pallas,
    quorum_match_xla,
)
from dragonboat_tpu_torch.parallel import fabric_kernels as fk


@pytest.mark.parametrize("G,K,M", [(8, 16, 16), (13, 32, 8), (1, 8, 8)])
def test_gather_lanes_plain_equals_reference(G, K, M):
    rng = np.random.default_rng(5)
    vals = rng.integers(-(1 << 20), 1 << 20, (G, K)).astype(np.int32)
    idx = rng.integers(0, K, (G, M)).astype(np.int32)
    ref = np.asarray(gather_lanes_xla(jnp.asarray(vals), jnp.asarray(idx)))
    ref_p = np.asarray(gather_lanes_pallas(jnp.asarray(vals), jnp.asarray(idx),
                                           interpret=True))
    got = fk.gather_lanes(torch.as_tensor(vals), torch.as_tensor(idx)).numpy()
    assert got.dtype == ref.dtype == np.int32
    assert np.array_equal(got, ref) and np.array_equal(got, ref_p)


def test_gather_lanes_sentinel_reads_zero():
    vals = np.asarray([[7, 8, 9, 10]], np.int32)
    idx = np.asarray([[4, 2, 4, 0]], np.int32)
    ref = np.asarray(gather_lanes_pallas(jnp.asarray(vals), jnp.asarray(idx),
                                         interpret=True))
    got = fk.gather_lanes(torch.as_tensor(vals), torch.as_tensor(idx)).numpy()
    assert got.tolist() == ref.tolist() == [[0, 9, 0, 7]]


@pytest.mark.parametrize("seed", [1, 9])
def test_quorum_match_plain_equals_reference(seed):
    """Duplicates, fewer voters than quorum and a zero-voter row."""
    rng = np.random.default_rng(seed)
    G, R = 64, 8
    match = rng.integers(0, 6, (G, R)).astype(np.int32)
    voting = rng.random((G, R)) < 0.7
    voting[0] = False
    quorum = rng.integers(1, R + 1, G).astype(np.int32)
    args = (jnp.asarray(match), jnp.asarray(voting), jnp.asarray(quorum))
    ref = np.asarray(quorum_match_xla(*args))
    ref_p = np.asarray(quorum_match_pallas(*args, interpret=True))
    got = fk.quorum_match(torch.as_tensor(match), torch.as_tensor(voting),
                          torch.as_tensor(quorum)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, ref) and np.array_equal(got, ref_p)
    assert got[0] == np.iinfo(np.int32).max
