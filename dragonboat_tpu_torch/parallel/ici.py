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

Placement
---------
A cluster is laid out on one device or split over a grid of ``g * r``
devices, in ``(ig, ir)`` order.

- One device (``make_ici_cluster(..., device=...)``, the degenerate
  layout): state, inbox and input are ``[G]`` tensors on the cluster's
  device, and the exchange is a permutation on it.  The out-lanes go from
  block-major rows to group-major rows (``[g, r, n] -> [g, n, r]``), the
  router runs ONCE over all rows, and the next inbox is permuted back.
  That gives the values of the reference's per-position ``all_gather`` +
  ``route`` + "keep mine", because ``route`` is local to each group of
  ``R`` consecutive group-major rows; the reference computes the same
  route ``R`` times (once on each position of a ``g`` block), this
  layout once.  A serve step launches K1 through ``core/kernel.step``
  (once per commit decision) and K2 once, through the one ``route``.
- Split (``make_ici_cluster(..., devices=[...])``): position
  ``p = ig * R + ir`` owns its rows on ``devices[p]`` (repeats allowed:
  a split forced onto fewer devices, down to one).  State, inbox, input
  and cut mask are ``graphs.Split`` pieces of ``n_local`` rows, and
  joining the pieces in order gives exactly the one-device tensors
  (``IciCluster.shard`` splits, ``IciCluster.gather`` joins).  A step is
  the reference's ``_exchange``: each position steps its rows (K1 inside
  ``core/kernel.step``, so ``g * r`` times the one-device count); each
  position's out-lanes are copied into the other ``R - 1`` positions of
  its ``g`` block (the ``all_gather`` over ``'r'``); each position builds
  the group-major ``[n_local * R]`` view, routes it (one K2 launch per
  position) and keeps its own slot's rows.  Each position's step and its
  route are compiled entries of their own on that position's device
  (``graphs.Compiled.position``); the copies run between their replays,
  into the route's static inputs (``_receive`` says how each is
  ordered).  No graph spans positions, also where they share a device.

The reference's jitted entries are compiled entries here
(``dragonboat_tpu_torch.graphs``): ``serve_step`` and
``serve_step_donated``, ``ici_cluster_step`` and the body that
``ici_run_steps`` replays are each captured once per geometry as a CUDA
graph on the card (per position under a split) and run eagerly on the
CPU.  The donating entry updates state and box in place in its static
buffers; callers keep the no-touch contract.
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
from dragonboat_tpu_torch.devices import put_rows, resolve_device, upload

Split = graphs.Split


def _place(x, device: torch.device):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    # a copy, never a view of the caller's numpy buffer
    return torch.tensor(np.asarray(x), device=device)


def _rows_to(x, rows: slice, device: torch.device):
    """Rows ``rows`` of ``x`` as a fresh tensor on ``device`` (never a
    view of the whole, whatever the devices)."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        return torch.tensor(np.asarray(x)[rows], device=device)
    src = x[rows]
    return torch.empty(src.shape, dtype=src.dtype,
                       device=device).copy_(src)


def _map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[fn(x) for x in tree])
    return fn(tree)


@dataclass(frozen=True)
class IciCluster:
    """Static geometry of a mesh-laid-out cluster and its placement:
    ``devices`` names each position's device in ``(ig, ir)`` order (a
    split layout), or is None and every position is on ``device``."""

    kp: KP.KernelParams
    g_size: int          # mesh axis 'g' (disjoint group sets)
    replicas: int        # R, mesh axis 'r'
    n_local: int         # groups per 'g' block
    num_groups: int      # total groups = g_size * n_local
    device: torch.device  # the one device, or the grid's first
    devices: tuple | None = None

    @property
    def total_rows(self) -> int:
        return self.g_size * self.replicas * self.n_local

    @property
    def positions(self) -> int:
        return self.g_size * self.replicas

    def rows(self, p: int) -> slice:
        """The block-major rows position ``p`` owns."""
        return slice(p * self.n_local, (p + 1) * self.n_local)

    def place(self, tree):
        """A ``[G]``-leading tensor, numpy array or NamedTuple of them
        whole on the cluster's device (``None`` leaves stay ``None``)."""
        return _map(lambda x: _place(x, self.device), tree)

    def shard(self, tree):
        """``tree`` in the cluster's layout: placed whole on one device,
        or split into per-position pieces (a ``graphs.Split``, each piece
        a copy on its position's device)."""
        if self.devices is None:
            return self.place(tree)
        if isinstance(tree, Split):
            return tree
        return Split(_map(lambda x: _rows_to(x, self.rows(p), dev), tree)
                     for p, dev in enumerate(self.devices))

    def gather(self, tree):
        """The whole ``[G]`` tree on the cluster's device: split pieces
        joined in order (a whole tree is returned as it is)."""
        return join(tree, self.device)


def join(tree, device: torch.device):
    """A ``graphs.Split`` of tensors or NamedTuples joined into one tree
    on ``device`` (rows in piece order); anything else as it is."""
    if not isinstance(tree, Split):
        return tree
    first = tree[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in tree])
    return type(first)(*[join(Split(f), device) for f in zip(*tree)])


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:<current>``), so a grid's
    devices compare equal to its tensors'."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def mesh_grid(need: int, device: torch.device, devices=None):
    """The devices of a mesh's ``need`` positions in ``(ig, ir)`` order,
    or None for the one-device layout.

    ``devices`` names them (``need`` entries; repeats force the split
    layout onto fewer devices).  By default the grid follows the
    reference's ``jax.devices()[:need]``: ``cuda:0 .. need-1`` when
    ``device`` is the default card and the process sees at least
    ``need`` cards.  Where it sees fewer, the reference raises; the port
    keeps every position on ``device`` instead (a placement choice: no
    layout moves off the card)."""
    if devices is not None:
        grid = tuple(_indexed(resolve_device(d)) for d in devices)
        if len(grid) != need:
            raise ValueError(f"a mesh of {need} positions needs {need} "
                             f"devices, got {len(grid)}")
        return grid
    if device.type == "cuda" and (device.index or 0) == 0 \
            and torch.cuda.device_count() >= need:
        return tuple(torch.device("cuda", i) for i in range(need))
    return None


def mesh_replica_ids(g_size: int, replicas: int, n_local: int) -> np.ndarray:
    """[G] i32 replica id of every row in the block-major layout."""
    return np.repeat(np.tile(np.arange(1, replicas + 1, dtype=np.int32),
                             g_size), n_local)


def make_ici_cluster(kp: KP.KernelParams, g_size: int, replicas: int,
                     num_groups: int, election: int = 10, device=None,
                     devices=None) -> tuple[IciCluster, ShardState, Inbox]:
    """Build a cluster whose replica axis spans mesh axis 'r' (the
    reference's ``make_ici_cluster`` over a ``Mesh`` of that shape).

    ``num_groups`` must divide evenly over mesh axis 'g'.  With
    ``devices`` (``g_size * replicas`` of them, ``(ig, ir)`` order) the
    layout is split and state and inbox come back as per-position
    pieces; otherwise every position is on ``device``."""
    assert num_groups % g_size == 0, "num_groups must divide mesh axis g"
    grid = None
    if devices is not None:
        grid = mesh_grid(g_size * replicas, None, devices)
    dev = grid[0] if grid else resolve_device(device)
    n_local = num_groups // g_size
    cluster = IciCluster(kp=kp, g_size=g_size, replicas=replicas,
                         n_local=n_local, num_groups=num_groups, device=dev,
                         devices=grid)
    rids = mesh_replica_ids(g_size, replicas, n_local)
    pids = np.arange(1, replicas + 1, dtype=np.int32)
    state = init_state(kp, cluster.total_rows, rids, pids,
                       election_timeout=election, device=dev)
    box = empty_inbox(kp, cluster.total_rows, dev)
    return cluster, cluster.shard(state), cluster.shard(box)


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


# -- the split layout ---------------------------------------------------------


def _position_step(kp: KP.KernelParams, propose: bool, state: ShardState,
                   box: Inbox, inp: StepInput | None, cut):
    """One position's rows stepped on its device: the kernel step (the
    self-driving input when ``inp`` is None), and the out-lanes it may
    send (masked by its rows of the cut mask, when there is one)."""
    if inp is None:
        inp = self_driving_input(kp, state, tick=True, propose=propose)
    state, out = step(kp, state, box, inp)
    return state, out, (None if cut is None else _mask_outgoing(out, cut))


def _position_route(kp: KP.KernelParams, R: int, ir: int, lanes: tuple,
                    cut):
    """The receiving half of the exchange at position ``(ig, ir)``: the
    ``R`` gathered out-lanes of its ``g`` block as the group-major
    ``[n_local * R]`` view, routed, and the rows of slot ``ir`` kept (the
    reference's ``dynamic_index_in_dim``), masked by the position's rows
    of the cut mask."""
    def grouped(xs):
        if xs[0] is None:  # optional lanes (s_ent_val without payloads)
            return None
        return torch.stack(xs, dim=1).reshape((-1,) + tuple(xs[0].shape[1:]))

    box = route(kp, R, StepOutput(*[grouped(f) for f in zip(*lanes)]))

    def mine(x):
        if x is None:
            return None
        return x.reshape((-1, R) + tuple(x.shape[1:]))[:, ir].contiguous()

    box = Inbox(*[mine(x) for x in box])
    return box if cut is None else _mask_incoming(box, cut)


def _receive(slots, senders, device: torch.device) -> tuple:
    """The ``all_gather`` over ``'r'`` into one position: the out-lanes of
    every sender of its ``g`` block, on its ``device``.

    Once the position's route has a graph, each sender's lanes are copied
    into that graph's static inputs (``slots``).  Never ``Tensor.to``
    there: on the sender's own device it returns the sender's buffer,
    which the sender's next replay overwrites.  Ordering: a copy on one
    device runs on that device's current stream, after the sender's step
    replay and before the receiver's route replay.  A copy between two
    cards is ordered by ``copy_`` itself: it runs on the sender's current
    stream after an event recorded on the receiver's, and the receiver's
    current stream waits on an event recorded after it, so the route
    replay that follows reads the copied lanes.  Before the route has a
    graph (its first call, the CPU, ``graphs.eager()``), the lanes are
    passed as they are (moved when the devices differ): the route then
    reads them at once, or copies them into the static inputs it
    captures."""
    if slots is None:
        return tuple(StepOutput(*[None if x is None else x.to(device)
                                  for x in o]) for o in senders)
    for dst, src in zip(slots, senders):
        pairs = [(d, x) for d, x in zip(dst, src) if d is not None]
        if src.term.device == device:
            torch._foreach_copy_([d for d, _ in pairs],
                                 [x for _, x in pairs], non_blocking=True)
        else:
            for d, x in pairs:
                d.copy_(x, non_blocking=True)
    return slots


def _split_step(entry: graphs.Compiled, kp: KP.KernelParams,
                cluster: IciCluster, state: Split, box: Split, inp, cut,
                propose: bool = False):
    """One step of a split mesh (module docstring): every position's
    step, then every position's receive and route.  ``inp`` and ``cut``
    may be whole (they are split here) or None (self-driving input, no
    cut mask).  Each position's step and route are ``entry``'s
    per-position entries; they donate what ``entry`` donates, so a
    donating entry's results stay valid until its next call and a
    non-donating entry's are fresh.  Returns (state, box, out) as
    pieces."""
    R, devs = cluster.replicas, cluster.devices
    if inp is not None and not isinstance(inp, Split):
        inp = cluster.shard(inp)
    if cut is not None and not isinstance(cut, Split):
        cut = cluster.shard(cut)
    donating = bool(entry.donate_argnums)
    states, outs, sent = [], [], []
    for p in range(cluster.positions):
        fn = entry.position(("step", cluster, p), _position_step, (0, 1),
                            (2, 3, 4) if donating else ())
        st, out, masked = fn(kp, bool(propose), state[p], box[p],
                             None if inp is None else inp[p],
                             None if cut is None else cut[p])
        states.append(st)
        outs.append(out)
        sent.append(out if masked is None else masked)
    boxes = []
    for q in range(cluster.positions):
        ig, ir = divmod(q, R)
        fn = entry.position(("route", cluster, q), _position_route,
                            (0, 1, 2),
                            (3,) if donating else ())
        lanes = _receive(fn.last_static(3), sent[ig * R:(ig + 1) * R],
                         devs[q])
        boxes.append(fn(kp, R, ir, lanes, None if cut is None else cut[q]))
    return Split(states), Split(boxes), Split(outs)


def input_slots(entry: graphs.Compiled, cluster: IciCluster) -> list:
    """Each position's static StepInput in ``entry``'s split form (None
    before its graph exists): a caller that stages its next input there
    pays no copy-in."""
    made = entry.positions()
    out = []
    for p in range(cluster.positions):
        fn = made.get(("step", cluster, p))
        out.append(None if fn is None else fn.last_static(4))
    return out


def _ici_split(entry, kp, cluster, state, box, inp):
    return _split_step(entry, kp, cluster, state, box, inp, None)


_ici_step = graphs.compiled(_ici_body, static_argnums=(0, 1),
                            split=_ici_split)


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
serve_step = graphs.compiled(_serve_body, static_argnums=(0, 1),
                             split=_split_step)

# The reference's donating twin (``jit_serve_step_donated``): state, box
# and input hand their buffers to the graph; the pipelined dispatch keeps
# the no-touch contract: after the call the host reads only the returned
# state, box and output.  ``cut`` is never donated.
serve_step_donated = graphs.compiled(_serve_body, static_argnums=(0, 1),
                                     donate_argnums=(2, 3, 4),
                                     split=_split_step)


def ici_serve_step(cluster: IciCluster, state: ShardState, box: Inbox,
                   inp: StepInput, cut: torch.Tensor):
    """One serving step: kernel + in-mesh routing + per-link cut mask."""
    return serve_step(cluster.kp, cluster, state, box, inp, cut)


def self_driving_input(kp: KP.KernelParams, state: ShardState,
                       tick: bool = True, propose: bool = True) -> StepInput:
    """bench_loop.full_step's feedback shape for mesh state: proposals on
    leaders, instant-apply cursor, logical clock ticking (per position
    for split state)."""
    if isinstance(state, Split):
        return Split(self_driving_input(kp, s, tick, propose) for s in state)
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


def _run_split(entry, kp, cluster, propose, state, box):
    state, box, _ = _split_step(entry, kp, cluster, state, box, None, None,
                                propose)
    return state, box


_run = graphs.compiled(_run_body, static_argnums=(0, 1, 2),
                       donate_argnums=(3, 4), split=_run_split)


def ici_run_steps(kp: KP.KernelParams, cluster: IciCluster, iters: int,
                  propose: bool, state: ShardState, box: Inbox):
    """``iters`` self-driving mesh steps (the bench's inner loop), one
    replay of the step body each; returns (state, box)."""
    for _ in range(iters):
        state, box = _run(kp, cluster, bool(propose), state, box)
    return graphs.fresh((state, box))


# -- rows of a layout, from the host ------------------------------------------


def write_rows(state, rows, updates: dict):
    """``state`` with ``updates[f]`` written at global rows ``rows`` of
    each field ``f``, out of place.  ``rows`` is one row (a Python int:
    nothing is uploaded for it) or a host int array.  A value is a Python
    scalar, or a host array whose leading dim is ``len(rows)`` (or 1,
    broadcast), uploaded once to the device of the rows it writes,
    however many fields it feeds.  A split state writes each row into the
    position that owns it: position ``row // n_local``, local row
    ``row % n_local``."""
    if isinstance(state, Split):
        n = int(state[0].term.shape[0])
        parts = list(state)
        if isinstance(rows, (int, np.integer)):
            p, r = divmod(int(rows), n)
            parts[p] = write_rows(parts[p], r, updates)
            return Split(parts)
        rows = np.asarray(rows, np.int64)
        owner = rows // n
        for p in np.unique(owner).tolist():
            sel = owner == p
            picked: dict = {}

            def pick(v):
                if not (isinstance(v, np.ndarray)
                        and v.shape[0] == rows.shape[0]):
                    return v
                if id(v) not in picked:
                    picked[id(v)] = v[sel]
                return picked[id(v)]

            parts[p] = write_rows(parts[p], rows[sel] - p * n,
                                  {f: pick(v) for f, v in updates.items()})
        return Split(parts)
    dev = state.term.device
    idx = (int(rows) if isinstance(rows, (int, np.integer))
           else upload(np.asarray(rows, np.int64), dev))
    up: dict = {}

    def val(v):
        if not isinstance(v, np.ndarray):
            return v
        if id(v) not in up:
            up[id(v)] = upload(v, dev)
        return up[id(v)]

    return state._replace(**{f: put_rows(getattr(state, f), idx, val(v))
                             for f, v in updates.items()})


def take_rows(x, rows) -> np.ndarray:
    """Host copy of global rows ``rows`` (a host int array) of ``x``, a
    tensor or a ``graphs.Split`` of tensors, in the given order: one
    fetch from each position that holds any of them."""
    rows = np.asarray(rows, np.int64)
    if not isinstance(x, Split):
        return x[upload(rows, x.device)].cpu().numpy()
    n = int(x[0].shape[0])
    owner = rows // n
    held = np.unique(owner).tolist()
    if not held:
        return take_rows(x[0], rows)
    parts = [take_rows(x[p], rows[owner == p] - p * n) for p in held]
    got = np.concatenate(parts)
    out = np.empty_like(got)
    out[np.argsort(owner, kind="stable")] = got
    return out


def to_host(x) -> np.ndarray:
    """A tensor, or a ``graphs.Split`` of tensors joined in row order, as
    a host array."""
    if isinstance(x, Split):
        return np.concatenate([to_host(p) for p in x])
    return x.cpu().numpy()
