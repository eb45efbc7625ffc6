"""MeshEngine — raft groups whose replicas are rows of one mesh state.

The port of the reference's ``engine/mesh_engine.py``.  The reference scales
by running one NodeHost per machine and moving every inter-replica message
through its TCP transport (transport.go:86-101, engine.go:1230-1364).  Here
the replicas of a mesh-resident shard are rows of ONE kernel state laid out
over a ``(g, r)`` mesh: replica ``i`` of a group sits in mesh position
``(ig, i - 1)``, and message exchange is the exchange inside the serving
step (``parallel/ici.py``) — the transport seam collapses into that
exchange while the host keeps the serving duties the single-device
KernelEngine has:

  - client proposals / ReadIndex staged into StepInput lanes (with
    follower-host proposals forwarded in-engine to the leader row — the
    reference forwards MsgProp through the raft core);
  - ONE batched ``save_raft_state`` fsync per LogDB per step;
  - snapshots, log queries, eviction to host engines as the slow path.

Placement (``parallel/ici.py``): the engine takes a device grid, one
device per mesh position in ``(ig, ir)`` order, and then each position
owns its rows of the state, the carried inbox and the staged input on its
own device (the split layout; a grid may repeat a device).  By default the
grid follows the reference's ``jax.devices()[:g * r]``: ``cuda:0 ..
g*r-1`` where the process sees that many cards.  Where it sees fewer, the
reference's engine raises; the port's keeps every position on its one
device (the CUDA card unless the caller names the CPU), so it attaches any
geometry.  Lane writes land in the position that owns the row; the
decimated reductions read the positions joined on the grid's first
device.

Deployment note: in this process every attached NodeHost drives its own
replicas and ONE shared engine advances the mesh.  Payload bytes live in a
per-shard mirror shared by the replicas (the device ring carries terms).
Partition chaos (monkey.go:170) is a device-side mask: a cut row neither
sends nor receives on the mesh.

Escalation is whole-group: all state is durable through each replica's
LogDB, so on ``needs_host`` (or InstallSnapshot, or a membership the mesh
cannot address) every member is rebuilt as a host-resident pycore Node on
its own NodeHost and the group continues over the regular transport.
"""

from __future__ import annotations

import threading

import numpy as np

from dragonboat_tpu_torch import capacity as _capacity
from dragonboat_tpu_torch import fabric as _fabric
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.config import MeshSpec
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.core.kstate import init_state
from dragonboat_tpu_torch.devices import resolve_device
from dragonboat_tpu_torch.engine.kernel_engine import (
    KernelEngine,
    KernelNode,
    _F_WITSNAP,
    _KERNEL_MTYPES,
    _LaneInit,
)
from dragonboat_tpu_torch.logger import get_logger
from dragonboat_tpu_torch.parallel import ici
from dragonboat_tpu_torch.parallel.ici import (
    IciCluster,
    mesh_grid,
    mesh_replica_ids,
)

_LOG = get_logger("mesh_engine")

MT = pb.MessageType


class MeshEngine(KernelEngine):
    """A KernelEngine whose rows are laid out over a ``(g, r)`` mesh.

    Row layout matches parallel/ici.py block-major addressing: row
    ``((ig * R) + ir) * n_local + n`` is replica ``ir + 1`` of group lane
    ``ig * n_local + n``."""

    def __init__(self, kp: KP.KernelParams, spec: MeshSpec,
                 events=None, fleet_stats_every: int = 10,
                 pipeline_depth: int = 0,
                 health_top_k: int = 8,
                 health_thresholds=None,
                 invariant_probe: bool = True,
                 capacity_watermark_pct: float = 10.0,
                 capacity_budget_bytes: int = 0,
                 device=None, devices=None) -> None:
        dev = resolve_device(device)
        self.spec = spec
        # what the caller asked for (attach_mesh_engine compares it)
        self.placement = (dev, mesh_grid(spec.g_size * spec.replicas, dev,
                                         devices))
        grid = self.placement[1]
        dev = grid[0] if grid else dev
        self.cluster = IciCluster(
            kp=kp, g_size=spec.g_size, replicas=spec.replicas,
            n_local=spec.n_local, num_groups=spec.g_size * spec.n_local,
            device=dev, devices=grid)
        total = self.cluster.total_rows
        # read by KernelEngine.__init__ below: hub-fallback deliveries
        # stage slot-exact against route()'s layout (_InboxBuilder)
        self._slot_exact_replicas = spec.replicas
        super().__init__(kp, total, send_message=None, events=events,
                         fleet_stats_every=fleet_stats_every,
                         pipeline_depth=pipeline_depth,
                         health_top_k=health_top_k,
                         health_thresholds=health_thresholds,
                         invariant_probe=invariant_probe,
                         capacity_watermark_pct=capacity_watermark_pct,
                         capacity_budget_bytes=capacity_budget_bytes,
                         device=dev)
        # replica ids are fixed by the mesh addressing (route() targets
        # rid 1..R); rows keep them even while ABSENT
        rids = mesh_replica_ids(spec.g_size, spec.replicas, spec.n_local)
        self.state = self.cluster.shard(init_state(
            kp, total, replica_id=rids,
            peer_ids=np.zeros((total, kp.num_peers), np.int32), device=dev))
        # group-lane bookkeeping
        self._lane_of: dict[int, int] = {}            # shard_id -> lane
        # newest membership ccid written to each group's shared peer
        # books (guards against lagging-member rollback)
        self._books_ccid: dict[int, int] = {}
        self._members: dict[int, dict[int, KernelNode]] = {}  # sid -> rid -> n
        self._mirrors: dict[int, dict[int, pb.Entry]] = {}    # sid -> mirror
        self._free_lanes = list(range(self.cluster.num_groups - 1, -1, -1))
        self._free = []   # base's row free-list is unused (rows are fixed)
        self._refs = 0    # attached NodeHosts (registry lifecycle)

    # -- row addressing ----------------------------------------------------

    def _row(self, lane: int, replica_id: int) -> int:
        R, n_local = self.spec.replicas, self.spec.n_local
        ig, n = divmod(lane, n_local)
        return (ig * R + (replica_id - 1)) * n_local + n

    # -- lane lifecycle ----------------------------------------------------

    def add_shard(self, node: KernelNode, init: _LaneInit) -> None:
        """Place one REPLICA into its mesh row.  The first member of a
        shard allocates the group lane; later members (possibly attached
        by other NodeHosts, possibly after a restart) join it.  As in the
        base engine only the admission lock is taken: the row is written
        by the next step's batched injection."""
        rids = [rid for rid, _ in init.peers]
        if any(not (1 <= r <= self.spec.replicas) for r in rids) or not (
                1 <= node.replica_id <= self.spec.replicas):
            raise ValueError(
                f"mesh-resident shard {node.shard_id}: replica ids {rids} "
                f"outside mesh addressing 1..{self.spec.replicas}")
        if any(kind == KP.K_WITNESS for _, kind in init.peers):
            # admission-time twin of the update_lane_membership guard: a
            # restart rebuilds init.peers from the durable membership, and
            # a witness member must keep the group on the host engines
            # (its mesh row would be ABSENT — traffic to it vanishes)
            raise ValueError(
                f"mesh-resident shard {node.shard_id}: witness members "
                f"are host-engine only")
        with self._admit_mu:
            lane = self._lane_of.get(node.shard_id)
            if lane is None:
                if not self._free_lanes:
                    raise RuntimeError("mesh engine is at capacity")
                lane = self._free_lanes.pop()
                self._lane_of[node.shard_id] = lane
                self._members[node.shard_id] = {}
                self._mirrors[node.shard_id] = {}
            members = self._members[node.shard_id]
            if node.replica_id in members:
                raise RuntimeError(
                    f"replica {node.replica_id} of shard {node.shard_id} "
                    f"already mesh-resident")
            row = self._row(lane, node.replica_id)
            node.lane = row
            node.engine = self
            node.mirror = self._mirrors[node.shard_id]   # shared payloads
            members[node.replica_id] = node
            self.nodes[row] = node
            self.by_shard[(node.shard_id, node.replica_id)] = node
            self._pending_inject[row] = self._inject(row, node, init)
            self._note_link_classes(node)

    def remove_replica(self, node: KernelNode) -> KernelNode | None:
        """Detach one replica (stop_replica, eviction); the group lane
        lives on for the remaining members."""
        with self.mu, self._admit_mu:
            return self._remove_locked(node)

    def remove_replicas(self, nodes) -> None:
        """Detach many replicas under ONE hold of the engine locks
        (NodeHost.close): one acquisition per replica would wait for a
        step each time while the other hosts keep stepping."""
        with self.mu, self._admit_mu:
            for node in nodes:
                self._remove_locked(node)

    def _remove_locked(self, node: KernelNode) -> KernelNode | None:
        if self.by_shard.pop((node.shard_id, node.replica_id), None) is None:
            return None
        addr = self._link_class_book(node).get(node.replica_id)
        if addr:
            _fabric.METER.drop_link_classes(addr)
        members = self._members.get(node.shard_id, {})
        members.pop(node.replica_id, None)
        self.nodes.pop(node.lane, None)
        self._removed_nodes.append(node)
        self._inv_dirty.add(node.lane)
        self._clear_lane(node.lane, self._pending_inject.pop(
            node.lane, None) is not None)
        self._dispatch.set_cut(node.lane, False)
        if not members:
            lane = self._lane_of.pop(node.shard_id, None)
            self._members.pop(node.shard_id, None)
            self._mirrors.pop(node.shard_id, None)
            self._books_ccid.pop(node.shard_id, None)
            if lane is not None:
                self._free_lanes.append(lane)
        return node

    def remove_shard(self, shard_id: int) -> KernelNode | None:
        raise NotImplementedError(
            "mesh engine removes per-replica: use remove_replica(node)")

    def _is_registered(self, n: KernelNode) -> bool:
        # identity, for the same reason as the base engine: a deferred
        # retire must not mistake a re-admitted replica for this node
        return self.by_shard.get((n.shard_id, n.replica_id)) is n

    def _mirror_floor(self, n: KernelNode) -> int:
        members = list(self._members.get(n.shard_id, {}).values())
        return min((m.sm.get_last_applied() for m in members),
                   default=n.sm.get_last_applied())

    # -- fabric link classes ----------------------------------------------

    @staticmethod
    def _link_class_book(node: KernelNode) -> dict:
        """rid -> raft address from the node's own durable membership —
        the same book update_lane_membership reads."""
        m = node.sm.get_membership()
        return {**m.addresses, **m.non_votings, **m.witnesses}

    def _note_link_classes(self, node: KernelNode) -> None:
        """Refresh the fabric meter's carrier class for every co-
        resident link of ``node`` from the live cut mask (resident =
        mesh-carried, hub = cut/partitioned), both directions.  Links
        to absent or off-mesh peers stay unregistered: they are hub
        links by construction and the meter already counts their
        traffic.  The meter takes only its own lock."""
        book = self._link_class_book(node)
        me = book.get(node.replica_id)
        if not me:
            return
        for rid, peer in list(self._members.get(node.shard_id, {}).items()):
            if rid == node.replica_id:
                continue
            them = self._link_class_book(peer).get(rid) or book.get(rid)
            if not them:
                continue
            cls = (_fabric.LINK_CLASS_HUB
                   if bool(self._dispatch.cut[node.lane, rid - 1])
                   else _fabric.LINK_CLASS_RESIDENT)
            _fabric.METER.set_link_class(me, them, cls)
            _fabric.METER.set_link_class(them, me, cls)

    # -- chaos surface -----------------------------------------------------

    def set_partitioned(self, node: KernelNode, cut: bool) -> None:
        """Device-side partition mask for one replica row (every link)."""
        with self.mu:
            if self._is_registered(node):
                self._dispatch.set_cut(node.lane, cut)
                self._note_link_classes(node)

    def set_link_hub_served(self, node: KernelNode, peer_rid: int,
                            cut: bool) -> None:
        """Cut (or heal) ONE mesh link, symmetrically: traffic between
        ``node``'s row and its group peer ``peer_rid`` leaves the mesh
        and rides the host hub — where transport faults (drop/delay)
        apply to it like any other hub traffic.  Both endpoints are
        masked together: hub fallback relies on the peer's sender-side
        mask to emit its half over the host (MeshDispatch.set_link_cut)."""
        if not (1 <= peer_rid <= self.spec.replicas):
            return
        with self.mu:
            if not self._is_registered(node):
                return
            self._dispatch.set_link_cut(node.lane, peer_rid, cut)
            peer = self._members.get(node.shard_id, {}).get(peer_rid)
            if peer is not None:
                self._dispatch.set_link_cut(
                    peer.lane, node.replica_id, cut)
            self._note_link_classes(node)

    def hub_accepts(self, node: KernelNode, m: pb.Message) -> bool:
        """NodeHost inbound gate for a mesh-resident replica: kernel-
        family traffic lands only when the hub is that link's carrier
        (link_hub_served); host-mediated traffic (snapshot streams and
        the like) always lands."""
        if m.type not in _KERNEL_MTYPES:
            return True
        return self.link_hub_served(node, int(m.from_))

    def link_hub_served(self, node: KernelNode, from_rid: int) -> bool:
        """True when the hub must deliver ``from_rid`` -> ``node``: the
        link is cut, or the sender is off-mesh/absent.  Resident links
        return False — the mesh already carried the message, so the hub
        copy (if any) is a stray and the NodeHost drops it."""
        if not (1 <= from_rid <= self.spec.replicas):
            return True
        if self._members.get(node.shard_id, {}).get(from_rid) is None:
            return True
        return bool(self._dispatch.cut[node.lane, from_rid - 1])

    # -- the step ----------------------------------------------------------

    def _make_dispatch(self):
        """The mesh backend (engine/dispatch.py MeshDispatch): the serving
        entries of parallel/ici.py, with the carried inbox, the pending
        flag and the cut mask owned by the backend.  The step loop
        itself stays KernelEngine's — this seam is the ONLY
        dispatch-level difference."""
        from dragonboat_tpu_torch.engine.dispatch import MeshDispatch

        return MeshDispatch(self.cluster)

    def _emit_messages(self, g, n, o, fl, pid, kind,
                       replicates, others) -> None:
        # intra-group messages ride the mesh inside the step; the host
        # sends ONLY the hub-fallback traffic of cut links (READ_INDEX
        # forwarding and snapshot streams go through the per-node host
        # path).  A witness peer needing a snapshot CANNOT be served
        # over the mesh (witness replicas are host-resident, their mesh
        # row is absent) — the group escalates to the host engines
        if fl[_F_WITSNAP] and o["s_wit_snap"][g].any():
            self._wit_snap_fallback.add(n.shard_id)
        cut = self._dispatch.cut[g]
        if not cut.any():
            return
        # hub fallback: rebuild EXACTLY the messages the mesh exchange
        # masked out (sender-side per-link mask, parallel/ici.py
        # _mask_outgoing reads the same unmasked output fields) and keep
        # only the ones addressed over cut links.  The wit_snap branch is
        # suppressed — it is host-escalation, handled above, not link
        # traffic.
        fl = fl.copy()
        fl[_F_WITSNAP] = False
        reps: list = []
        oths: list = []
        super()._emit_messages(g, n, o, fl, pid, kind, reps, oths)
        R = self.spec.replicas
        for built, dst in ((reps, replicates), (oths, others)):
            for item in built:
                to = item[1].to
                if 1 <= to <= R and cut[to - 1]:
                    dst.append(item)

    def _prop_target(self, n: KernelNode):
        """Forward proposals to the group's leader row (any NodeHost is a
        valid entry point, like the reference's MsgProp forwarding). Falls
        back to the proposer's own row when no leader is known — the
        kernel then drops and the client retries."""
        lane_cut = self._dispatch.cut[n.lane]
        if lane_cut.all():
            # a fully partitioned host's proposals must not tunnel
            # through shared memory to the leader row — stage on the cut
            # row, where the kernel drops them (the client sees DROPPED,
            # as it would against the reference's silenced transport)
            return n.lane, n
        lid = n._leader_cache
        if lid and lid != n.replica_id:
            leader = self._members.get(n.shard_id, {}).get(lid)
            # per-link discipline: forwarding IS a proposer->leader send,
            # so a cut link (or a fully cut leader row) blocks it — the
            # proposal stays on the proposer's row, the kernel drops it
            # there and the client retries
            if (leader is not None
                    and not lane_cut[lid - 1]
                    and not self._dispatch.cut[leader.lane].all()):
                return leader.lane, leader
        return n.lane, n

    # -- membership / escalation ------------------------------------------

    def update_lane_membership(self, node: KernelNode) -> None:
        """Refresh the peer books of EVERY row of this group from the RSM
        membership.  A membership the mesh cannot address (ids outside
        1..R, or more members than peer slots) evicts the whole group."""
        m = node.sm.get_membership()
        kp = self.kp
        ids = (list(m.addresses) + list(m.non_votings) + list(m.witnesses))
        if (len(ids) > kp.num_peers
                or any(not (1 <= r <= self.spec.replicas) for r in ids)):
            self._evict(node, reason=f"membership {sorted(ids)} outside "
                                     f"mesh addressing")
            return
        if m.witnesses:
            # witness replicas are never mesh-resident (their row stays
            # ABSENT), so mesh-routed traffic to them would vanish and
            # the ring floor would wait on their match forever — the
            # group serves witnesses from the host engines instead
            self._evict(node, reason="witness member on a mesh group")
            return
        # the applied CC releases THIS replica's one-in-flight gate only
        # (pycore clears pending_config_change per replica at apply) — a
        # lagging follower's apply must not release the leader row's
        # gate while a newer CC is still uncommitted there
        s = ici.write_rows(self.state, node.lane, {"pending_cc": False})
        # shared peer books: members apply the same CCs at different
        # steps, so only the NEWEST applied membership may write them —
        # a lagging member's view would roll the group's books back
        # (config_change_id is monotonic, membership.go ccid)
        last_ccid = self._books_ccid.get(node.shard_id, -1)
        if m.config_change_id >= last_ccid:
            self._books_ccid[node.shard_id] = m.config_change_id
            pids = np.zeros((kp.num_peers,), np.int32)
            kinds = np.zeros((kp.num_peers,), np.int32)
            i = 0
            for rid in sorted(m.addresses):
                pids[i], kinds[i] = rid, KP.K_VOTER
                i += 1
            for rid in sorted(m.non_votings):
                pids[i], kinds[i] = rid, KP.K_NON_VOTING
                i += 1
            members = list(self._members.get(node.shard_id, {}).values())
            lanes = np.array([mb.lane for mb in members], np.int64)
            # every member's row, each in the position that owns it
            with _capacity.METER.sanctioned("membership_up"):
                s = ici.write_rows(s, lanes, {"pid": pids[None, :],
                                              "kind": kinds[None, :]})
            self._kind_np[lanes] = kinds
            self._pid_np[lanes] = pids
        self.state = s

    def _evict(self, n: KernelNode, reason: str, carry=None) -> None:
        """Whole-group escalation: every member leaves the mesh and is
        rebuilt host-side by ITS OWN NodeHost; the group continues over
        the regular transport (all state is already durable)."""
        members = list(self._members.get(n.shard_id, {}).values())
        if not members:
            return
        _LOG.info("shard %d: leaving the mesh (%s)", n.shard_id, reason)
        for member in members:
            if self.remove_replica(member) is None:
                continue
            cb = getattr(member, "on_evict_cb", None)
            if cb is not None:
                cb(member, (carry or []) if member is n else [])


# ---------------------------------------------------------------------------
# process-wide registry: NodeHosts sharing a MeshSpec.name share one engine
# (the in-process form of hosts jointly executing one mesh program)
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, MeshEngine] = {}
_REG_MU = threading.Lock()


def attach_mesh_engine(kp: KP.KernelParams, spec: MeshSpec,
                       events=None, fleet_stats_every: int = 10,
                       pipeline_depth: int = 0,
                       health_top_k: int = 8,
                       health_thresholds=None,
                       invariant_probe: bool = True,
                       capacity_watermark_pct: float = 10.0,
                       capacity_budget_bytes: int = 0,
                       device=None, devices=None) -> MeshEngine:
    """The process-wide engine of ``spec.name`` (made by the first
    caller).  ``devices`` is the mesh's device grid (``MeshEngine``);
    every caller must ask for the same placement."""
    dev = resolve_device(device)
    with _REG_MU:
        eng = _REGISTRY.get(spec.name)
        if eng is None:
            # the first attaching host's pipeline depth wins (the engine
            # is process-wide; geometry/kp/device mismatches raise below)
            eng = MeshEngine(kp, spec, events=events,
                             fleet_stats_every=fleet_stats_every,
                             pipeline_depth=pipeline_depth,
                             health_top_k=health_top_k,
                             health_thresholds=health_thresholds,
                             invariant_probe=invariant_probe,
                             capacity_watermark_pct=capacity_watermark_pct,
                             capacity_budget_bytes=capacity_budget_bytes,
                             device=dev, devices=devices)
            _REGISTRY[spec.name] = eng
        else:
            if eng.spec != spec:
                raise RuntimeError(
                    f"mesh '{spec.name}' geometry mismatch: engine has "
                    f"{eng.spec}, caller wants {spec}")
            if eng.kp != kp:
                raise RuntimeError(
                    f"mesh '{spec.name}' kernel params mismatch")
            want = (dev, mesh_grid(spec.g_size * spec.replicas, dev,
                                   devices))
            if eng.placement != want:
                raise RuntimeError(
                    f"mesh '{spec.name}' device mismatch: engine is on "
                    f"{eng.placement}, caller wants {want}")
        eng._refs += 1
        return eng


def detach_mesh_engine(eng: MeshEngine) -> None:
    with _REG_MU:
        eng._refs -= 1
        if eng._refs <= 0:
            _REGISTRY.pop(eng.spec.name, None)
            # last host off the mesh: flush an env-armed profiler
            # capture now (KernelEngine.close semantics — the engine is
            # shared, so only full detach may stop it)
            eng.close()
