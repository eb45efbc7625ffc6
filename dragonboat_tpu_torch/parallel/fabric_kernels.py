"""K1 and K2: the commit rule's order statistic and the router's lane pick.

Counterparts of the reference's ``parallel/fabric_pallas.py``.  Each
function is a wrapper around a hand-written CUDA kernel
(``csrc/quorum_match.cu``, ``csrc/gather_lanes.cu``) with its plain
PyTorch arm beside it: a CPU tensor takes the plain arm, a CUDA tensor
launches the kernel (see ``dragonboat_tpu_torch.kernels``).

Each kernel has two entries.  ``quorum_match(match, voting, quorum)`` and
``gather_lanes(vals, idx)`` keep the TPU kernels' signatures;
``commit_quorum(match, kind)`` and ``gather_lanes_multi(fields, lanes)``
do in one launch what the main path built around several of them.  The
step (``core/kernel.py``) calls ``commit_quorum`` for every commit
decision (a count fixed by the inbox geometry: 16 launches a step at the
bench's 10 slots, 21 at the engine's 8 slots of 5 peers), the invariant
probe (``core/invariants``) calls ``quorum_match``, and the router
(``core/router.py``) calls ``gather_lanes_multi`` once per route for all
twelve response picks, so on the card both kernels run every step.
Launches are counted under the kernel's name (``quorum_match``,
``gather_lanes``) whichever entry made them.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from dragonboat_tpu_torch import kernels
from dragonboat_tpu_torch.core import params as KP

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
    with kernels.on(match.device):
        rc = kernels.library().dbt_quorum_match(
            match.data_ptr(), voting.data_ptr(), quorum.data_ptr(),
            out.data_ptr(), G, Pn, kernels.stream_ptr(match.device))
    kernels.check_launch(rc, "quorum_match")
    return out


def commit_quorum_plain(match: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """Plain arm: the step's voting mask and quorum, then the mask-sort-
    gather of ``quorum_match_plain``."""
    voting = (kind == KP.K_VOTER) | (kind == KP.K_WITNESS)
    quorum = voting.sum(dim=1, dtype=I32) // 2 + 1
    return quorum_match_plain(match, voting, quorum)


def commit_quorum(match: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """``[G]`` i32: ``quorum_match(match, voting, nv // 2 + 1)`` with the
    voting mask (``kind`` is K_VOTER or K_WITNESS) and its count ``nv``
    taken from the peer kinds inside the kernel — the step's commit rule.

    ``match [G, P]`` and ``kind [G, P]`` (K_ABSENT..K_WITNESS), both
    contiguous i32; P <= 16 on the card.  Counted as a ``quorum_match``
    launch."""
    if not kernels.use_kernel(match, kind):
        return commit_quorum_plain(match, kind)
    G, Pn = match.shape
    kernels.require(match, "match", I32, (G, Pn))
    kernels.require(kind, "kind", I32, (G, Pn))
    if Pn > 16:
        raise ValueError(f"commit_quorum kernel takes P <= 16, got {Pn}")
    out = torch.empty((G,), dtype=I32, device=match.device)
    if G == 0:
        return out
    with kernels.on(match.device):
        rc = kernels.library().dbt_commit_quorum(
            match.data_ptr(), kind.data_ptr(), out.data_ptr(), G, Pn,
            KP.K_VOTER, KP.K_WITNESS, kernels.stream_ptr(match.device))
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

    ``vals [G, K]`` and ``idx [G, M]``, both contiguous i32: the TPU
    kernel's own signature, launched as one field by one lane of the
    kernel ``gather_lanes_multi`` launches."""
    if not kernels.use_kernel(vals, idx):
        return gather_lanes_plain(vals, idx)
    G, K = vals.shape
    M = idx.shape[1]
    kernels.require(vals, "vals", I32, (G, K))
    kernels.require(idx, "idx", I32, (G, M))
    out = torch.empty((G, M), dtype=I32, device=vals.device)
    if G == 0 or M == 0:
        return out
    with kernels.on(vals.device):
        rc = kernels.library().dbt_gather_lanes(
            vals.data_ptr(), idx.data_ptr(), out.data_ptr(), G, K, M,
            kernels.stream_ptr(vals.device))
    kernels.check_launch(rc, "gather_lanes")
    return out


#: the most fields and lanes one gather_lanes_multi launch takes
MAX_FIELDS, MAX_LANES = 8, 2
_FIELD_DTYPES = {I32: 4, torch.bool: 1}


def gather_lanes_multi_plain(fields: Sequence[torch.Tensor],
                             lanes: Sequence[torch.Tensor]):
    """Plain arm: ``gather_lanes_plain`` once per (lane, field), each on
    the field's rows as ``[(n, s), K]`` i32 and the lane transposed to
    ``[(n, s), t]``, the result transposed back and cast to the field's
    dtype — the route's pick before the batched kernel."""
    N, Rt, Rs = lanes[0].shape

    def pick(field, lane):
        vals = field.reshape(N * Rs, field.shape[1]).to(I32)
        idx = lane.transpose(1, 2).reshape(N * Rs, Rt)
        got = gather_lanes_plain(vals, idx).reshape(N, Rs, Rt).transpose(1, 2)
        return got.to(field.dtype)

    return tuple(tuple(pick(f, lane) for f in fields) for lane in lanes)


def gather_lanes_multi(fields: Sequence[torch.Tensor],
                       lanes: Sequence[torch.Tensor]):
    """The route's response pick in one launch: for each lane tensor and
    field, ``out[l][f][n, t, s] = fields[f][n * Rs + s, lanes[l][n, t, s]]``
    as an ``[N, Rt, Rs]`` tensor in the field's dtype; a lane outside
    [0, K) reads 0 (False).

    ``fields``: up to 8 ``[G, K]`` tensors, each i32 or bool, G = N * Rs;
    ``lanes``: 1 or 2 ``[N, Rt, Rs]`` i32 tensors; all contiguous.  Returns
    a tuple per lane of a tuple per field.  Counted as a ``gather_lanes``
    launch."""
    fields, lanes = tuple(fields), tuple(lanes)
    if not kernels.use_kernel(*fields, *lanes):
        return gather_lanes_multi_plain(fields, lanes)
    if not (1 <= len(fields) <= MAX_FIELDS and 1 <= len(lanes) <= MAX_LANES):
        raise ValueError(f"gather_lanes_multi takes 1-{MAX_FIELDS} fields and "
                         f"1-{MAX_LANES} lanes, got {len(fields)} and {len(lanes)}")
    N, Rt, Rs = lanes[0].shape
    G, K = fields[0].shape
    if G != N * Rs:
        raise ValueError(f"fields have {G} rows, lanes [{N}, {Rt}, {Rs}] address {N * Rs}")
    for i, f in enumerate(fields):
        if f.dtype not in _FIELD_DTYPES:
            raise TypeError(f"fields[{i}]: dtype {f.dtype}, kernel takes int32 or bool")
        kernels.require(f, f"fields[{i}]", f.dtype, (G, K))
    for i, lane in enumerate(lanes):
        kernels.require(lane, f"lanes[{i}]", I32, (N, Rt, Rs))
    dev = fields[0].device
    outs = tuple(tuple(torch.empty((N, Rt, Rs), dtype=f.dtype, device=dev)
                       for f in fields) for _ in lanes)
    if N * Rt * Rs == 0:
        return outs
    nf, nl = len(fields), len(lanes)
    field_ptrs = (ctypes.c_void_p * nf)(*(f.data_ptr() for f in fields))
    field_bytes = (ctypes.c_int * nf)(*(_FIELD_DTYPES[f.dtype] for f in fields))
    lane_ptrs = (ctypes.c_void_p * nl)(*(lane.data_ptr() for lane in lanes))
    out_ptrs = (ctypes.c_void_p * (nl * nf))(*(o.data_ptr() for per in outs for o in per))
    with kernels.on(dev):
        rc = kernels.library().dbt_gather_lanes_multi(
            ctypes.addressof(field_ptrs), ctypes.addressof(field_bytes), nf,
            ctypes.addressof(lane_ptrs), nl, ctypes.addressof(out_ptrs),
            N, Rt, Rs, K, kernels.stream_ptr(dev))
    kernels.check_launch(rc, "gather_lanes")
    return outs
