"""Unified engine dispatch: ONE step loop, two backends.

The port of the reference's ``engine/dispatch.py``.  ``KernelEngine.step_all``
is the only step loop; a dispatch backend contributes only ``dispatch()``
and its entries.  ``SerialDispatch`` is the single-device backend, bound to
the port's ``core/kernel.step`` and ``step_donated`` (the step's commit
rule launches K1 on the card).  ``MeshDispatch`` is the mesh serving
backend over ``parallel/ici.py``'s ``serve_step`` and
``serve_step_donated``: the inbox stays on the device between steps, the
exchange inside the step routes it (one K2 launch a step on the card), and
a per-link cut mask sends cut links over the host hub.

The entries are compiled (``dragonboat_tpu_torch.graphs``): each backend
binds forks of them with a graph pool of its own (``pool``; an engine
replays on its own thread, and its output flag reduction joins the
pool).  On the
card the host staging writes straight into the graph's static inputs
(``last_static``), so a step copies nothing device to device but the
hub deliveries and cut mask of a mesh step.

The module-level tuples and dicts below are the reference's machine-read
contract, copied as they stand (with the package prefix rewritten, and the
mesh entries naming the port's functions): which methods only the
step-loop owner may define, the sanctioned subclass seams, the feature
knobs the step loop must read, every dispatch entry, the sanctioned
device->host sync sites, and the per-entry transfer ledger.  In the port
the crossing sites count under their ``capacity.METER`` tags as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from dragonboat_tpu_torch import capacity as _capacity
from dragonboat_tpu_torch import graphs
from dragonboat_tpu_torch.core import params as KP
from dragonboat_tpu_torch.core.kernel import (
    FLAG_CLASSES,
    step as kernel_step,
    step_donated as kernel_step_donated,
)
from dragonboat_tpu_torch.core.kstate import Inbox, empty_inbox
from dragonboat_tpu_torch.parallel.ici import (
    IciCluster,
    input_slots,
    serve_step,
    serve_step_donated,
)

#: the one class allowed to define step-loop internals
STEP_LOOP_OWNER = "KernelEngine"

#: step-loop internals: defining any of these in a subclass of the owner
#: is a second step-loop implementation (EU001)
STEP_LOOP_METHODS = (
    "step_all",
    "_flush_injections",
    "_stage_lane",
    "_stage_props",
    "_process_outputs",
    "_kernel_call",
    "_capacity_entries",
    "_device_pending",
    "_fleet_inbox_from",
    "_capacity_trees",
    "_capacity_model_classes",
    "_make_health_digest",
    "_make_invariant_digest",
)

#: sanctioned subclass seams: addressing, membership, escalation,
#: host-side message emission, and the dispatch-backend factory
DISPATCH_SEAMS = (
    "_make_dispatch",
    "_emit_messages",
    "_prop_target",
    "_mirror_floor",
    "_is_registered",
    "_evict",
    "add_shard",
    "remove_shard",
    "update_lane_membership",
)

#: ExpertConfig-fed engine attributes gating dispatch features; every
#: one must be read on a path reachable from step_all in EVERY concrete
#: engine (EU002 flags per-path drift)
ENGINE_FEATURE_KNOBS = (
    "pipeline_depth",
    "fleet_stats_every",
    "health_top_k",
    "invariant_probe",
)

#: feature calls (not attributes) that must stay reachable from the
#: step loop on every path — the masked output fetch is gated on the
#: [G, C] activity matrix this produces
ENGINE_FEATURE_CALLS = ("output_row_flags",)

#: every jit entry a dispatch backend may call.  ``donated`` entries
#: must be kstate.DONATION-declared (EU003 cross-checks via KC008);
#: non-donated entries carry a waiver naming why donation is out.
DISPATCH_ENTRIES = {
    "step": {
        "module": "dragonboat_tpu_torch/core/kernel.py",
        "function": "step",
        "donated": False,
        "waiver": "depth-0 serial oracle: the differential reference "
                  "entry must leave its inputs readable",
    },
    "step_donated": {
        "module": "dragonboat_tpu_torch/core/kernel.py",
        "function": "step_donated",
        "donated": True,
        "waiver": "",
    },
    "serve_step": {
        "module": "dragonboat_tpu_torch/parallel/ici.py",
        "function": "serve_step",
        "donated": False,
        "waiver": "depth-0 mesh oracle: the differential reference "
                  "entry must leave its inputs readable",
    },
    "serve_step_donated": {
        "module": "dragonboat_tpu_torch/parallel/ici.py",
        "function": "serve_step_donated",
        "donated": True,
        "waiver": "",
    },
}

#: every sanctioned device->host SYNC site in the engine layer, keyed by
#: the host-side qualname whose body may force a device value
#: (``int()`` / ``.item()`` / ``np.asarray`` / ``block_until_ready``).
#: The transfer pass (analysis/transfer.py TB005 — the engine-scope
#: sharpening of PS006) fails any other engine-layer sync; the runtime
#: leg counts each under ``tag`` via capacity.METER.  Declaring a site
#: here is a REVIEWED claim that the sync is off the per-step critical
#: path or deliberately masked/lazy.
SYNC_POINTS = {
    "_LazyOut.__getitem__": {
        "tag": "lazy_out",
        "why": "memoized per-field StepOutput fetch — the masked-fetch "
               "path that replaced the eager 42-field sweep",
    },
    "KernelEngine._process_outputs": {
        "tag": "output_flags",
        "why": "the [G, 8] activity matrix gating the masked fetch, "
               "plus the save-window lt rows for persisted lanes",
    },
    "KernelEngine._emit_messages": {
        "tag": "wit_snap_floor",
        "why": "witness-snapshot floor probe (snap_index scalar) on the "
               "rare wit_snap retire path only",
    },
}

#: the machine-read transfer contract: every value crossing the
#: device<->host boundary through the dispatch seam, per jit entry
#: (analysis/transfer.py sizes each row in closed form from the
#: CONTRACTS grammar and gates the per-step totals against
#: analysis/transfer_budget.json).  Row schema:
#:   value    contract class name or inline contract string
#:   param    entry parameter the upload binds (classification cross-check)
#:   site     host qualname performing the crossing
#:   tag      capacity.METER tag the site counts under
#:   per_step crossing happens on EVERY step of this entry's profile
#:   masked   download is lane/field-masked (the _LazyOut discipline)
#:   cached   upload is memoized until invalidated (not per-step)
#: ``_control`` rows are step-loop control-plane crossings (admissions,
#: membership, telemetry) that belong to no single entry.
TRANSFER_LEDGER = {
    "step": {
        "resident": ("ShardState",),
        "up": (
            {"value": "Inbox", "param": "inbox",
             "site": "_InboxBuilder.to_device", "tag": "inbox_up",
             "per_step": True},
            {"value": "StepInput", "param": "inp",
             "site": "_InputBuilder.to_device", "tag": "input_up",
             "per_step": True},
        ),
        "down": (
            {"value": "[G, 8] bool",
             "site": "KernelEngine._process_outputs",
             "tag": "output_flags", "per_step": True},
            {"value": "StepOutput", "site": "_LazyOut.__getitem__",
             "tag": "lazy_out", "per_step": False, "masked": True},
            {"value": "[G, CAP] i32",
             "site": "KernelEngine._process_outputs", "tag": "lt_rows",
             "per_step": False, "masked": True},
        ),
    },
    "step_donated": {
        "resident": ("ShardState",),
        "up": (
            {"value": "Inbox", "param": "inbox",
             "site": "_InboxBuilder.to_device", "tag": "inbox_up",
             "per_step": True},
            {"value": "StepInput", "param": "inp",
             "site": "_InputBuilder.to_device", "tag": "input_up",
             "per_step": True},
        ),
        "down": (
            {"value": "[G, 8] bool",
             "site": "KernelEngine._process_outputs",
             "tag": "output_flags", "per_step": True},
            {"value": "StepOutput", "site": "_LazyOut.__getitem__",
             "tag": "lazy_out", "per_step": False, "masked": True},
            {"value": "[G, CAP] i32",
             "site": "KernelEngine._process_outputs", "tag": "lt_rows",
             "per_step": False, "masked": True},
        ),
    },
    "serve_step": {
        "resident": ("ShardState", "Inbox"),
        "up": (
            {"value": "StepInput", "param": "inp",
             "site": "_InputBuilder.to_device", "tag": "input_up",
             "per_step": True},
            {"value": "[G, P] bool", "param": "cut",
             "site": "MeshDispatch.dispatch", "tag": "cut_up",
             "per_step": False, "cached": True},
            {"value": "Inbox", "site": "_InboxBuilder.to_device",
             "tag": "inbox_up", "per_step": False},
        ),
        "down": (
            {"value": "[G, 8] bool",
             "site": "KernelEngine._process_outputs",
             "tag": "output_flags", "per_step": True},
            {"value": "StepOutput", "site": "_LazyOut.__getitem__",
             "tag": "lazy_out", "per_step": False, "masked": True},
            {"value": "[G, CAP] i32",
             "site": "KernelEngine._process_outputs", "tag": "lt_rows",
             "per_step": False, "masked": True},
        ),
    },
    "serve_step_donated": {
        "resident": ("ShardState", "Inbox"),
        "up": (
            {"value": "StepInput", "param": "inp",
             "site": "_InputBuilder.to_device", "tag": "input_up",
             "per_step": True},
            {"value": "[G, P] bool", "param": "cut",
             "site": "MeshDispatch.dispatch", "tag": "cut_up",
             "per_step": False, "cached": True},
            {"value": "Inbox", "site": "_InboxBuilder.to_device",
             "tag": "inbox_up", "per_step": False},
        ),
        "down": (
            {"value": "[G, 8] bool",
             "site": "KernelEngine._process_outputs",
             "tag": "output_flags", "per_step": True},
            {"value": "StepOutput", "site": "_LazyOut.__getitem__",
             "tag": "lazy_out", "per_step": False, "masked": True},
            {"value": "[G, CAP] i32",
             "site": "KernelEngine._process_outputs", "tag": "lt_rows",
             "per_step": False, "masked": True},
        ),
    },
    "fleet_stats": {
        "resident": ("ShardState",),
        "up": (
            {"value": "[G, K] i32", "param": "inbox_from",
             "site": "KernelEngine._collect_fleet_stats",
             "tag": "fleet_down", "per_step": False},
        ),
        "down": (
            {"value": "FleetStats",
             "site": "KernelEngine._collect_fleet_stats",
             "tag": "fleet_down", "per_step": False},
        ),
    },
    "fleet_health": {
        "resident": ("ShardState", "HealthDigest"),
        "up": (
            {"value": "[G, K] i32", "param": "inbox_from",
             "site": "KernelEngine._collect_health",
             "tag": "health_down", "per_step": False},
        ),
        "down": (
            {"value": "HealthReport",
             "site": "KernelEngine._collect_health",
             "tag": "health_down", "per_step": False},
        ),
    },
    "check_invariants": {
        "resident": ("ShardState", "InvariantDigest"),
        "up": (
            {"value": "[G] i32",
             "site": "KernelEngine._collect_invariants",
             "tag": "invariants_down", "per_step": False},
        ),
        "down": (
            {"value": "InvariantReport",
             "site": "KernelEngine._collect_invariants",
             "tag": "invariants_down", "per_step": False},
        ),
    },
    "_control": (
        {"value": "ShardState", "dir": "up",
         "site": "KernelEngine._flush_injections", "tag": "inject_up",
         "per_step": False},
        {"value": "[G, P] i32", "dir": "up",
         "site": "KernelEngine.update_lane_membership",
         "tag": "membership_up", "per_step": False},
        {"value": "[G, P] i32", "dir": "up",
         "site": "MeshEngine.update_lane_membership",
         "tag": "membership_up", "per_step": False},
        {"value": "ShardRow", "dir": "down",
         "site": "KernelEngine.health_row", "tag": "health_row",
         "per_step": False},
        {"value": "[G] i32", "dir": "down",
         "site": "KernelEngine._emit_messages", "tag": "wit_snap_floor",
         "per_step": False},
    ),
}


class SerialDispatch:
    """Single-device backend: inbox re-staged from host every step."""

    def __init__(self, kp: KP.KernelParams,
                 step_fn=None, donated_fn=None) -> None:
        self.kp = kp
        # this backend's graphs: one pool, never replayed at once
        self.pool = graphs.Pool()
        # step_fn/donated_fn let the engine bind ITS module globals
        # (chaos tests swap in mutated kernels there); each is forked, or
        # compiled as its entry is, into this backend's pool
        self._fns = {
            "step": graphs.bind(
                step_fn if step_fn is not None else kernel_step,
                kernel_step, self.pool),
            "step_donated": graphs.bind(
                donated_fn if donated_fn is not None else kernel_step_donated,
                kernel_step_donated, self.pool),
        }
        # per-instance telemetry wrappers (own counters; a capture counts
        # as the entry's compile)
        self.entries = {
            "step": _capacity.TRACKER.wrap("step", self._fns["step"]),
            "step_donated": _capacity.TRACKER.wrap(
                "step_donated", self._fns["step_donated"]),
        }

    def dispatch(self, state, inbox, inp, donate: bool):
        """One step.  ``donate=True`` routes through the donating entry
        (core/kernel.py ``step_donated``): under its no-touch contract
        the host must not read the passed state/inbox/input again after
        this call — step_all's retire-before-dispatch order upholds
        that.  The staged inbox and input are written into the entry's
        static inputs once its graph exists."""
        name = "step_donated" if donate else "step"
        fn = self._fns[name]
        return self.entries[name](
            self.kp, state, inbox.to_device(fn.last_static(2)),
            inp.to_device(fn.last_static(3)))

    def pending(self) -> bool:
        """No device-resident inbox: nothing carries between steps."""
        return False

    def note_output_flags(self, flags) -> None:
        """No carried inbox, so retired activity flags carry no drain
        information here; MeshDispatch derives pending() from them."""

    def inbox_from(self, inbox_buf):
        """[G, K] sender ids for the inbox-occupancy histogram — the
        host-staged builder is the inbox here."""
        return inbox_buf.from_

    def shard(self, tree):
        """Single device: placement is a no-op."""
        return tree

    def join(self, tree):
        """Single device: the state is already whole."""
        return tree

    def resident_trees(self) -> tuple:
        return ()

    def resident_classes(self) -> tuple:
        return ()


def _merge_hub(staged: Inbox, box: Inbox) -> Inbox:
    """The carried inbox with the live slots of a hub-staged inbox
    written over it (both on one device, the same rows)."""
    if box.ent_val is not None and staged.ent_val is None:
        staged = staged._replace(ent_val=torch.zeros_like(box.ent_val))
    live = staged.mtype != 0

    def merge(s, b):
        if s is None:
            return None
        m = live.reshape(tuple(live.shape) + (1,) * (s.ndim - 2))
        return torch.where(m, s, b)

    return Inbox(*[merge(s, b) for s, b in zip(staged, box)])


#: FLAG_CLASSES columns that carry inter-replica messages — the classes
#: whose routed traffic keeps the mesh draining (need_snapshot/wit_snap/
#: rtr are host-escalation signals, not inbox content)
_MSG_FLAG_COLS = [FLAG_CLASSES.index(c)
                  for c in ("resp", "rep", "hb", "vote", "timeout_now")]


class MeshDispatch:
    """Mesh backend (``parallel/ici.py``): messages ride the exchange
    inside the step, the inbox stays on the device between steps, and a
    per-link cut mask decides which links the mesh serves —
    traffic for cut links (and off-mesh peers) rides the host hub and is
    merged back into the carried inbox at its route() slot.

    On a split cluster (``cluster.devices``) the carried inbox, the
    staged input and the cached cut mask are per-position pieces on the
    positions' devices, and a hub delivery merges into the piece of the
    position that owns its row."""

    def __init__(self, cluster: IciCluster) -> None:
        self.cluster = cluster
        total = cluster.total_rows
        # the inbox carried between steps on the device (messages ride
        # the mesh, not the host queues)
        self.box = cluster.shard(empty_inbox(cluster.kp, total,
                                             cluster.device))
        # drain-pending, derived host-side from the [G, C] activity
        # flags the step loop already fetches every step
        self._pending_msgs = False
        # per-link cut mask [rows, num_peers]: cut[row, p] severs the
        # mesh link between the row and its group peer rid p+1 (mesh
        # addressing pins peer slot p to rid p+1).  Device copy cached
        # until the mask changes.
        self.cut = np.zeros((total, cluster.kp.num_peers), bool)
        self._cut_dev = None
        self.pool = graphs.Pool()
        self._fns = {"serve_step": serve_step.fork(self.pool),
                     "serve_step_donated": serve_step_donated.fork(self.pool)}
        self.entries = {
            "serve_step": _capacity.TRACKER.wrap(
                "serve_step", self._fns["serve_step"]),
            "serve_step_donated": _capacity.TRACKER.wrap(
                "serve_step_donated", self._fns["serve_step_donated"]),
        }

    def _pieces(self, intos=None) -> list:
        """(device, rows, static input or None) of every position of a
        split cluster, for the staging builders."""
        cl = self.cluster
        intos = intos or [None] * cl.positions
        return [(dev, cl.rows(p), intos[p])
                for p, dev in enumerate(cl.devices)]

    def dispatch(self, state, inbox, inp, donate: bool):
        """Advance the mesh: host-staged inputs, device-routed messages.
        Kernel-family traffic between mesh rows rides the exchange inside
        the step; the host inbox builder is consulted ONLY for hub-
        fallback deliveries (cut links, off-mesh senders), staged
        slot-exact by _InboxBuilder and merged into the carried inbox
        before the entry runs.  ``donate=True`` routes through the
        donating entry (no-touch contract on state, the carried inbox and
        the staged input); the cached cut mask is never donated."""
        cl = self.cluster
        split = cl.devices is not None
        if inbox is not None and inbox.mtype.any():
            if split:
                staged = inbox.to_device(pieces=self._pieces())
                self.box = graphs.Split(
                    _merge_hub(s, b) for s, b in zip(staged, self.box))
            else:
                self.box = _merge_hub(inbox.to_device(), self.box)
        name = "serve_step_donated" if donate else "serve_step"
        fn = self._fns[name]
        if split:
            staged_inp = inp.to_device(
                pieces=self._pieces(input_slots(fn, cl)))
        else:
            staged_inp = inp.to_device(fn.last_static(4))
        if self._cut_dev is None:
            with _capacity.METER.sanctioned("cut_up"):
                if split:
                    self._cut_dev = graphs.Split(
                        torch.tensor(self.cut[rows], device=dev)
                        for dev, rows, _ in self._pieces())
                else:
                    self._cut_dev = torch.tensor(self.cut, device=cl.device)
        state, box, out = self.entries[name](
            cl.kp, cl, state, self.box, staged_inp, self._cut_dev)
        self.box = box
        return state, out

    def pending(self) -> bool:
        return self._pending_msgs

    def note_output_flags(self, flags) -> None:
        """Derive drain-pending from the retired step's [G, C] activity
        flags (already host-side — no extra crossing): any messaging
        class set means the exchange routed traffic into the carried
        inbox (or the hub is about to carry it), so the next step has
        work.  Conservative under cut links — flags are computed from
        the unmasked output, so a fully-cut row costs at most one idle
        step — and never an undercount: the carried inbox only ever
        holds routed copies of flagged output lanes."""
        self._pending_msgs = bool(flags[:, _MSG_FLAG_COLS].any())

    def inbox_from(self, inbox_buf):
        # the mesh inbox stays on the device between steps; no host copy
        # (a split one is joined on the cluster's device)
        return self.cluster.gather(self.box.from_)

    def shard(self, tree):
        """Place a [G]-leading tree whole on the cluster's device: the
        digests live where the reductions read the (joined) state."""
        return self.cluster.place(tree)

    def join(self, tree):
        """A state-shaped tree whole on the cluster's device: split
        pieces joined in row order, for the decimated reductions."""
        return self.cluster.gather(tree)

    def set_cut(self, lane: int, cut: bool) -> None:
        """Flip one row's WHOLE partition mask (every link of the row)
        and invalidate the cached device copy (next dispatch re-stages
        it).  This is the chaos PartitionNode surface: the row neither
        sends nor receives on the mesh."""
        self.cut[lane, :] = cut
        self._cut_dev = None

    def set_link_cut(self, lane: int, peer_rid: int, cut: bool) -> None:
        """Flip ONE directed half-link: row ``lane`` stops exchanging
        with group peer rid ``peer_rid`` over the mesh.  Callers must
        cut links symmetrically (both endpoints) — hub fallback relies
        on the peer's sender-side mask to emit its half over the host."""
        self.cut[lane, peer_rid - 1] = cut
        self._cut_dev = None

    def resident_trees(self) -> tuple:
        # the carried inbox stays on the device between steps here
        return (self.box,)

    def resident_classes(self) -> tuple:
        return ("Inbox",)
