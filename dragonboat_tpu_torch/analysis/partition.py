"""Mesh placement check: the split layout's G axis as a checked contract.

The port's form of the dynamic leg of the reference's ``partition`` pass
(PS002's cross-check, ``dragonboat_tpu/analysis/partition.py``).  There a
2-device ``('g', 'r')`` mesh runs one ``ici_serve_step`` and every
declared ``part=`` of ``ShardState``, ``Inbox`` and ``StepOutput`` is
diffed against the actual ``jax.sharding`` of the outputs.  Here the
split layout of ``parallel/ici.py`` holds each mesh position's rows as
its own tensors, so the check reads the pieces directly: after a serve
step every ``part=G`` leaf of position ``(ig, ir)`` must lie on that
position's device with ``n_local`` rows, and the pieces must be one per
position.

- PS002  [dynamic] a ``part=G`` leaf of a position on another device, or
         with a row count other than ``n_local``, or a tree that is not
         split into one piece per position

The static walk of the reference's pass (PS001 cross-G reductions,
PS003 replicated-with-sharded operands, PS006 implicit syncs in the
engine hot paths) has no torch form yet (ROADMAP.md).
"""

from __future__ import annotations

from dragonboat_tpu_torch.analysis.common import Finding, parse_contracts

PASS = "partition"

KSTATE_FILE = "dragonboat_tpu_torch/core/kstate.py"

#: the structs a serve step leaves split, as in the reference's check
CHECKED = ("ShardState", "Inbox", "StepOutput")


def placement_check(cluster, **trees) -> list[Finding]:
    """PS002 findings for the split trees ``trees`` (class name ->
    ``graphs.Split`` of that struct, e.g. ``ShardState=state``) of
    ``cluster``; [] when every ``part=G`` leaf of every position lies on
    the position's device with ``n_local`` rows."""
    from dragonboat_tpu_torch import graphs
    from dragonboat_tpu_torch.core import kstate

    contracts = parse_contracts(kstate.CONTRACTS, KSTATE_FILE)
    findings: list[Finding] = []

    def bad(msg: str) -> None:
        findings.append(Finding(PASS, KSTATE_FILE, 1, "PS002",
                                f"[dynamic] {msg}"))

    devices = cluster.devices
    if devices is None:
        bad("the cluster is not split: its positions share one [G] "
            "layout, there is no per-position placement to check")
        return findings
    for cls, tree in trees.items():
        if not isinstance(tree, graphs.Split) \
                or len(tree) != cluster.positions:
            bad(f"{cls} is not split into {cluster.positions} per-position "
                f"pieces ({type(tree).__name__})")
            continue
        for p, (piece, dev) in enumerate(zip(tree, devices)):
            ig, ir = divmod(p, cluster.replicas)
            for fname, fc in contracts.get(cls, {}).items():
                val = getattr(piece, fname, None)
                if val is None or fc.part != "G":
                    continue
                if val.device != dev:
                    bad(f"{cls}.{fname} of position ({ig}, {ir}) is on "
                        f"{val.device}, its position's device is {dev}")
                if val.ndim == 0 or val.shape[0] != cluster.n_local:
                    bad(f"{cls}.{fname} of position ({ig}, {ir}) has "
                        f"shape {tuple(val.shape)}, want {cluster.n_local} "
                        "leading rows")
    return findings


def dynamic_check(device=None, devices=None) -> list[Finding]:
    """One serve step of a small split mesh, then ``placement_check``:
    the reference's 2-position ``(1, 2)`` geometry, its positions on
    ``devices`` (default: both on ``device``, the CUDA card unless the
    caller names another)."""
    import numpy as np

    from dragonboat_tpu_torch.core.params import KernelParams
    from dragonboat_tpu_torch.devices import resolve_device
    from dragonboat_tpu_torch.parallel import ici

    dev = resolve_device(device)
    # small but legal: router.route needs inbox_cap >= 5 * (R - 1)
    kp = KernelParams(num_peers=2, log_cap=8, inbox_cap=8, msg_entries=2,
                      proposal_cap=2, readindex_cap=4)
    cluster, state, box = ici.make_ici_cluster(
        kp, 1, 2, num_groups=2, devices=devices or [dev, dev])
    cut = np.zeros((cluster.total_rows, kp.num_peers), np.bool_)
    state, box, out = ici.ici_serve_step(
        cluster, state, box, ici.self_driving_input(kp, state),
        cluster.shard(cut))
    return placement_check(cluster, ShardState=state, Inbox=box,
                           StepOutput=out)


def run(root: str, files: list[str] | None = None, dynamic: bool = True,
        device=None) -> list[Finding]:
    """The pass: the dynamic placement check in default mode with
    ``dynamic`` (nothing is checked statically yet)."""
    if files is not None or not dynamic:
        return []
    return dynamic_check(device)
