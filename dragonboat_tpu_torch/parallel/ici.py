"""The mesh serving path: replica groups laid out over a ``(g, r)`` mesh.

The port of the reference's ``parallel/ici.py``.  There every one of the
``g_size x replicas`` mesh positions is a separate JAX device: each runs the
step on its ``n_local`` rows, ``all_gather``s the out-lanes over the replica
axis ``'r'``, rebuilds the group-major view, runs the single-device router
and keeps the rows addressed to its own replica slot.

Layout
------
The global state has leading dim ``G = g_size * R * n_local`` laid out
block-major, as in the reference: row ``((ig * R) + ir) * n_local + n`` is
replica ``ir + 1`` of group ``ig * n_local + n``, so mesh position
``(ig, ir)`` owns the ``n_local`` consecutive rows of its replica slot.

One device for every position
-----------------------------
This port places every mesh position on ONE device: the engine's CUDA card,
or the CPU when the caller names it.  It is the counterpart of the forced
virtual CPU devices the reference's tests run on.  Two consequences:

- the exchange is a permutation on that device.  The out-lanes go from
  block-major rows to group-major rows (``[g, r, n] -> [g, n, r]``), the
  router runs ONCE over all rows, and the next inbox is permuted back.
  That gives the values of the reference's per-position ``all_gather`` +
  ``route`` + "keep mine", because ``route`` is local to each group of
  ``R`` consecutive group-major rows; the reference computes the same
  route ``R`` times (once on each position of a ``g`` block), the port
  once.  So a serve step launches K1 through ``core/kernel.step`` (once
  per commit decision) and K2 once, through the one ``route``;
- placing positions on separate cards (NCCL collectives or peer copies)
  is not done here; it waits for a four-card configuration
  (ROADMAP.md).

The reference's jitted entries are compiled entries here
(``dragonboat_tpu_torch.graphs``): ``serve_step`` and
``serve_step_donated``, ``ici_cluster_step`` and the body that
``ici_run_steps`` replays are each captured once per geometry as a CUDA
graph on the card and run eagerly on the CPU.  The donating entry updates
state and box in place in its static buffers; callers keep the no-touch
contract.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dragonboat_tpu_torch import graphs
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.core.kernel import step
from dragonboat_tpu_torch.core.kstate import (
    Inbox,
    ShardState,
    StepInput,
    StepOutput,
    empty_inbox,
    init_state,
)
from dragonboat_tpu_torch.core.router import route
from dragonboat_tpu_torch.devices import resolve_device


def _place(x, device: torch.device):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    # a copy, never a view of the caller's numpy buffer
    return torch.tensor(np.asarray(x), device=device)


@dataclass(frozen=True)
class IciCluster:
    """Static geometry of a mesh-laid-out cluster, and its one device."""

    kp: KP.KernelParams
    g_size: int          # mesh axis 'g' (disjoint group sets)
    replicas: int        # R, mesh axis 'r'
    n_local: int         # groups per 'g' block
    num_groups: int      # total groups = g_size * n_local
    device: torch.device

    @property
    def total_rows(self) -> int:
        return self.g_size * self.replicas * self.n_local

    def shard(self, tree):
        """Place a ``[G]``-leading tensor, numpy array or NamedTuple of
        them onto the cluster's device (``None`` leaves stay ``None``)."""
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*[_place(x, self.device) for x in tree])
        return _place(tree, self.device)


def mesh_replica_ids(g_size: int, replicas: int, n_local: int) -> np.ndarray:
    """[G] i32 replica id of every row in the block-major layout."""
    return np.repeat(np.tile(np.arange(1, replicas + 1, dtype=np.int32),
                             g_size), n_local)


def make_ici_cluster(kp: KP.KernelParams, g_size: int, replicas: int,
                     num_groups: int, election: int = 10, device=None
                     ) -> tuple[IciCluster, ShardState, Inbox]:
    """Build a cluster whose replica axis spans mesh axis 'r' (the
    reference's ``make_ici_cluster`` over a ``Mesh`` of that shape).

    ``num_groups`` must divide evenly over mesh axis 'g'."""
    assert num_groups % g_size == 0, "num_groups must divide mesh axis g"
    dev = resolve_device(device)
    n_local = num_groups // g_size
    cluster = IciCluster(kp=kp, g_size=g_size, replicas=replicas,
                         n_local=n_local, num_groups=num_groups, device=dev)
    rids = mesh_replica_ids(g_size, replicas, n_local)
    pids = np.arange(1, replicas + 1, dtype=np.int32)
    state = init_state(kp, cluster.total_rows, rids, pids,
                       election_timeout=election, device=dev)
    return cluster, state, empty_inbox(kp, cluster.total_rows, dev)


def _to_grouped(x, g_size: int, R: int, n_local: int):
    """Block-major ``[g, r, n]`` rows -> group-major ``[g, n, r]`` rows."""
    if x is None:  # optional lanes (s_ent_val without inline payloads)
        return None
    tail = tuple(x.shape[1:])
    return x.reshape((g_size, R, n_local) + tail).transpose(1, 2).reshape(
        (-1,) + tail)


def _to_blocks(x, g_size: int, R: int, n_local: int):
    """Group-major ``[g, n, r]`` rows -> block-major ``[g, r, n]`` rows."""
    if x is None:
        return None
    tail = tuple(x.shape[1:])
    return x.reshape((g_size, n_local, R) + tail).transpose(1, 2).reshape(
        (-1,) + tail)


def _exchange(kp: KP.KernelParams, cluster: IciCluster,
              out: StepOutput) -> Inbox:
    """The message exchange of every mesh position at once: permute the
    out-lanes to group-major rows, route them, permute the next inbox
    back to the block-major rows (module docstring)."""
    geo = (cluster.g_size, cluster.replicas, cluster.n_local)
    grouped = StepOutput(*[_to_grouped(f, *geo) for f in out])
    box = route(kp, cluster.replicas, grouped)
    return Inbox(*[_to_blocks(f, *geo) for f in box])


def _ici_body(kp: KP.KernelParams, cluster: IciCluster,
              state: ShardState, box: Inbox, inp: StepInput):
    """The step of every position's rows, then the exchange."""
    state, out = step(kp, state, box, inp)
    return state, _exchange(kp, cluster, out), out


_ici_step = graphs.compiled(_ici_body, static_argnums=(0, 1))


def ici_cluster_step(cluster: IciCluster, state: ShardState, box: Inbox,
                     inp: StepInput):
    """One cluster step with mesh message routing; returns (state,
    next_box, out).  The counterpart of router.cluster_step for
    mesh-laid-out replicas."""
    return _ici_step(cluster.kp, cluster, state, box, inp)


def _mask_outgoing(out: StepOutput, cut: torch.Tensor) -> StepOutput:
    """Zero the out-lanes addressed over cut LINKS.

    ``cut`` is the per-link mask ``[G, num_peers] bool``: ``cut[g, p]``
    severs the mesh link between row ``g`` and its group peer rid
    ``p + 1`` (mesh addressing pins peer slot ``p`` to rid ``p + 1``, so
    the column index doubles as the slot index).  A whole-True row is a
    per-row partition: the row sends nothing on the mesh, but still
    ticks, persists and applies.  A single column sends that link's
    traffic over the host hub instead (MeshEngine._emit_messages)."""
    P = cut.shape[1]

    def zpeer(a):  # [G, P(, E)] peer-slot lanes: zero slot p where cut
        c = cut.reshape(tuple(cut.shape) + (1,) * (a.ndim - 2))
        return torch.where(c, torch.zeros_like(a), a)

    # response lanes are addressed by rid, not slot: lane k of row g is
    # masked when the link to its destination rid is cut (one-hot
    # compare + any, as the reference)
    rid = torch.arange(1, P + 1, dtype=out.r_to.dtype, device=cut.device)
    cut_to = ((out.r_to[:, :, None] == rid) & cut[:, None, :]).any(dim=-1)
    return out._replace(
        r_type=torch.where(cut_to, torch.zeros_like(out.r_type), out.r_type),
        s_rep=zpeer(out.s_rep), s_hb=zpeer(out.s_hb),
        s_vote=zpeer(out.s_vote), s_timeout_now=zpeer(out.s_timeout_now),
    )


def _mask_incoming(box: Inbox, cut: torch.Tensor) -> Inbox:
    """Zero inbox slots whose SOURCE arrives over a cut link.  Every
    field is zeroed, not just the type: the kernel's inbox contract is
    route()'s (invalid slots are all-zero), and a slot with mtype=0 but a
    live term would still feed term adoption."""
    P = cut.shape[1]
    # one-hot source match; from_=0 (empty slot) matches no rid
    rid = torch.arange(1, P + 1, dtype=box.from_.dtype, device=cut.device)
    cut_src = ((box.from_[:, :, None] == rid) & cut[:, None, :]).any(dim=-1)

    def z(x):
        if x is None:
            return None
        c = cut_src.reshape(tuple(cut_src.shape) + (1,) * (x.ndim - 2))
        return torch.where(c, torch.zeros_like(x), x)

    return Inbox(*[z(x) for x in box])


def _serve_body(kp: KP.KernelParams, cluster: IciCluster,
                state: ShardState, box: Inbox, inp: StepInput,
                cut: torch.Tensor):
    """The SERVING step: host-staged StepInput, an inbox carried between
    steps on the device, and a per-link cut mask reserving the host hub
    for cut / off-mesh links.  Returns (state, next_box, out); ``out`` is
    the unmasked output (the host rebuilds hub traffic from it)."""
    state, out = step(kp, state, box, inp)
    box = _exchange(kp, cluster, _mask_outgoing(out, cut))
    # symmetric receive-side masking: with BOTH endpoints of a cut link
    # masked, a one-sided mask update cannot leak a message across a
    # link the host already re-routed over the hub
    box = _mask_incoming(box, cut)
    return state, box, out


#: The serving entry (non-donating): the depth-0 mesh oracle the engine's
#: dispatch layer wraps in its call telemetry.  Takes (kp, cluster, state,
#: box, inp, cut); ``cut`` is the per-link mask ``[G, num_peers] bool``
#: (see ``_mask_outgoing``).
serve_step = graphs.compiled(_serve_body, static_argnums=(0, 1))

# The reference's donating twin (``jit_serve_step_donated``): state, box
# and input hand their buffers to the graph; the pipelined dispatch keeps
# the no-touch contract: after the call the host reads only the returned
# state, box and output.  ``cut`` is never donated.
serve_step_donated = graphs.compiled(_serve_body, static_argnums=(0, 1),
                                     donate_argnums=(2, 3, 4))


def ici_serve_step(cluster: IciCluster, state: ShardState, box: Inbox,
                   inp: StepInput, cut: torch.Tensor):
    """One serving step: kernel + in-mesh routing + per-link cut mask."""
    return serve_step(cluster.kp, cluster, state, box, inp, cut)


def self_driving_input(kp: KP.KernelParams, state: ShardState,
                       tick: bool = True, propose: bool = True) -> StepInput:
    """bench_loop.full_step's feedback shape for mesh state: proposals on
    leaders, instant-apply cursor, logical clock ticking."""
    G, B = state.term.shape[0], kp.proposal_cap
    dev = state.term.device
    is_leader = state.role == KP.LEADER
    pv = is_leader[:, None].expand(G, B) & bool(propose)
    z = lambda: torch.zeros((G,), dtype=torch.int32, device=dev)  # noqa: E731
    return StepInput(
        prop_valid=pv.contiguous(),
        prop_cc=torch.zeros((G, B), dtype=torch.bool, device=dev),
        ri_valid=torch.zeros((G,), dtype=torch.bool, device=dev),
        ri_low=z(),
        ri_high=z(),
        transfer_to=z(),
        tick=torch.full((G,), bool(tick), dtype=torch.bool, device=dev),
        quiesced=torch.zeros((G,), dtype=torch.bool, device=dev),
        applied=state.processed,
    )


def _run_body(kp: KP.KernelParams, cluster: IciCluster, propose: bool,
              state: ShardState, box: Inbox):
    inp = self_driving_input(kp, state, tick=True, propose=propose)
    state, box, _ = _ici_body(kp, cluster, state, box, inp)
    return state, box


_run = graphs.compiled(_run_body, static_argnums=(0, 1, 2),
                       donate_argnums=(3, 4))


def ici_run_steps(kp: KP.KernelParams, cluster: IciCluster, iters: int,
                  propose: bool, state: ShardState, box: Inbox):
    """``iters`` self-driving mesh steps (the bench's inner loop), one
    replay of the step body each; returns (state, box)."""
    for _ in range(iters):
        state, box = _run(kp, cluster, bool(propose), state, box)
    return graphs.fresh((state, box))
