"""K1 and K2: the commit rule's order statistic and the router's lane pick.

Counterparts of the reference's ``parallel/fabric_pallas.py``.  Each
function is a wrapper around a hand-written CUDA kernel
(``csrc/quorum_match.cu``, ``csrc/gather_lanes.cu``) with its plain
PyTorch arm beside it: a CPU tensor takes the plain arm, a CUDA tensor
launches the kernel (see ``dragonboat_tpu_torch.kernels``).  The step
(``core/kernel.py``) calls ``quorum_match`` for every commit decision and
the router (``core/router.py``) calls ``gather_lanes`` for every response
field, so on the card both kernels run every step.
"""

from __future__ import annotations

import torch

from dragonboat_tpu_torch import kernels

I32 = torch.int32
INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# K1: quorum match — one order statistic, not a sort
# ---------------------------------------------------------------------------


def quorum_match_plain(match: torch.Tensor, voting: torch.Tensor,
                       quorum: torch.Tensor) -> torch.Tensor:
    """Plain arm, the reference's ``quorum_match_xla``: mask non-voters to
    INT_MAX, sort ascending, take position ``clip(nv - quorum, 0, P-1)``."""
    mv = torch.where(voting, match, INT_MAX)
    srt = torch.sort(mv, dim=1).values
    nv = voting.sum(dim=1, dtype=I32)
    pos = torch.clamp(nv - quorum, 0, match.shape[1] - 1)
    return torch.gather(srt, 1, pos.long()[:, None])[:, 0]


def quorum_match(match: torch.Tensor, voting: torch.Tensor,
                 quorum: torch.Tensor) -> torch.Tensor:
    """``[G]`` i32: per row the ``quorum[g]``-th largest ``match[g, :]``
    among ``voting[g, :]``; the smallest voting match when there are fewer
    voters than the quorum; INT_MAX with no voters.

    ``match [G, P]`` i32, ``voting [G, P]`` bool, ``quorum [G]`` i32, all
    contiguous; P <= 16 on the card."""
    if not kernels.use_kernel(match, voting, quorum):
        return quorum_match_plain(match, voting, quorum)
    G, Pn = match.shape
    kernels.require(match, "match", I32, (G, Pn))
    kernels.require(voting, "voting", torch.bool, (G, Pn))
    kernels.require(quorum, "quorum", I32, (G,))
    if Pn > 16:
        raise ValueError(f"quorum_match kernel takes P <= 16, got {Pn}")
    out = torch.empty((G,), dtype=I32, device=match.device)
    if G == 0:
        return out
    rc = kernels.library().dbt_quorum_match(
        match.data_ptr(), voting.data_ptr(), quorum.data_ptr(),
        out.data_ptr(), G, Pn, kernels.stream_ptr(match.device))
    kernels.check_launch(rc, "quorum_match")
    return out


# ---------------------------------------------------------------------------
# K2: batched lane gather with the router's no-lane sentinel
# ---------------------------------------------------------------------------


def gather_lanes_plain(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain arm: ``torch.gather`` with every index outside [0, K) (the
    router's lane == K sentinel) masked to read 0."""
    K = vals.shape[1]
    inside = (idx >= 0) & (idx < K)
    got = torch.gather(vals, 1, torch.clamp(idx, 0, K - 1).long())
    return torch.where(inside, got, 0)


def gather_lanes(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[g, m] = vals[g, idx[g, m]]``; an index outside [0, K) reads 0.

    ``vals [G, K]`` and ``idx [G, M]``, both contiguous i32 (the router
    passes bool fields as i32 and casts back)."""
    if not kernels.use_kernel(vals, idx):
        return gather_lanes_plain(vals, idx)
    G, K = vals.shape
    M = idx.shape[1]
    kernels.require(vals, "vals", I32, (G, K))
    kernels.require(idx, "idx", I32, (G, M))
    out = torch.empty((G, M), dtype=I32, device=vals.device)
    if G == 0 or M == 0:
        return out
    rc = kernels.library().dbt_gather_lanes(
        vals.data_ptr(), idx.data_ptr(), out.data_ptr(), G, K, M,
        kernels.stream_ptr(vals.device))
    kernels.check_launch(rc, "gather_lanes")
    return out
