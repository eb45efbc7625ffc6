"""Op budget gate: the step's aten op counts stay within budget.

The port's counterpart of the reference's ``hlo_budget`` pass.  There the
self-driving loop is lowered and the ``gather`` / ``scatter`` / ``while``
instructions of the optimized HLO are counted; the port's step has no HLO
— it is eager PyTorch that a CUDA graph captures, one launch per aten op
(near enough) — so the count here is of the aten ops one call of the step
body dispatches, under a ``TorchDispatchMode`` on the CPU.  That count is
the quantity that bounds the port's main path: the graphed 8192 x 3 step
is device-bound on ~10.6k small kernels (``PERF.md`` §5), and a change
that regrows it fails the lint instead of waiting for the next chip run.

Two bodies are counted, as the reference lowers two graphs:

- ``run_steps``: one call of ``bench_loop._run_body`` (the serial bench
  loop's step body: ``core/kernel.step`` + ``core/router.route`` + the
  self-driving input), with the one-hot ring reads the card uses
  (``onehot_reads``, as the reference measures);
- ``serve_step``: one ``parallel/ici.serve_step`` on a split ``(1, 2)``
  mesh, both positions on the CPU (``ici._serve_body``'s split form:
  each position's step and cut mask, then each position's route), its
  input and cut mask already split, so only the captured bodies count.

Classes (``CLASSES``): ``gather`` (``gather``, ``index.Tensor``,
``index_select``, ``take_along_dim``), ``scatter`` (``scatter*``,
``index_put*``, ``index_copy``), ``sync`` (``nonzero``,
``masked_select``, ``_local_scalar_dense``: a host read or a
data-dependent shape — budget 0) and ``total``.  Each call of a hand
kernel's wrapper (K1 ``commit_quorum`` / ``quorum_match``, K2
``gather_lanes`` / ``gather_lanes_multi``, K3 ``apply_window``) counts as
ONE op, under ``kernels``, and the ops of the plain arm it takes on the
CPU are not counted: ``total`` then stands for the card's launches,
except where an aten op launches other than one kernel (``chip_smoke.py``
``[op_budget]`` prints both).

Counts are group-count-independent (op count, not op size: every branch
of the step is static), so the gate measures at a small G for speed
(``tests/test_torch_lint_static.py`` holds two Gs equal).  The workflow
when a change legitimately shifts the counts: run ``python -m
dragonboat_tpu_torch.analysis --reseed-op-budget``, review the diff of
``op_budget.json``, and justify the new counts in ``PERF.md``.

The measurement (~2 s on the CPU) is cached in
``analysis/.op_budget_cache.json`` (git-ignored) keyed by a sha256 over
every Python source of the package, the measurement config and the torch
version: any edit to the package invalidates it.

- OB000  the budget file is missing or unreadable
- OB001  a class's count exceeds its budget (``sync`` above 0 included)
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import os

from dragonboat_tpu_torch.analysis.common import Finding, rel

PASS = "op-budget"

BUDGET_FILE = "dragonboat_tpu_torch/analysis/op_budget.json"
CACHE_FILE = "dragonboat_tpu_torch/analysis/.op_budget_cache.json"

#: the package whose modules are hashed into the cache key: every one of
#: them, since the counted bodies import across it (kernels, devices,
#: raftpb and the rest as well as the step's own modules)
CACHE_PACKAGE = "dragonboat_tpu_torch"

#: gated classes, in report order
CLASSES = ("gather", "scatter", "sync", "total")
#: the bodies counted, in report order
ENTRIES = ("run_steps", "serve_step")
#: the measurement geometry of each body (small G: counts do not depend
#: on it)
DEFAULT_CONFIG = {
    "run_steps": {"body": "bench_loop._run_body", "groups": 4,
                  "replicas": 3, "onehot_reads": True},
    "serve_step": {"body": "parallel/ici.serve_step, split (1, 2)",
                   "groups": 4, "replicas": 2, "onehot_reads": True},
}

_GATHER = frozenset({"gather", "index_select", "take_along_dim"})
_SCATTER_PREFIXES = ("scatter", "index_put", "_index_put_impl",
                     "index_copy")
_SYNC = frozenset({"nonzero", "nonzero_static", "argwhere",
                   "masked_select", "_local_scalar_dense"})

#: the plain arms a CPU call of a hand kernel's wrapper takes: (module,
#: attribute, kernel name); the wrapper calls them through the module's
#: globals (or the class), so the count sees each wrapper call once
PLAIN_ARMS = (
    ("dragonboat_tpu_torch.parallel.fabric_kernels", "commit_quorum_plain",
     "quorum_match"),
    ("dragonboat_tpu_torch.parallel.fabric_kernels", "quorum_match_plain",
     "quorum_match"),
    ("dragonboat_tpu_torch.parallel.fabric_kernels", "gather_lanes_plain",
     "gather_lanes"),
    ("dragonboat_tpu_torch.parallel.fabric_kernels",
     "gather_lanes_multi_plain", "gather_lanes"),
    ("dragonboat_tpu_torch.rsm.device_kv:DeviceKV", "apply_kernel",
     "kv_apply"),
)


def op_class(name: str, overload: str) -> str | None:
    """The gated class of one aten op (packet name, overload name)."""
    if name in _GATHER or (name == "index" and overload == "Tensor"):
        return "gather"
    if name.startswith(_SCATTER_PREFIXES):
        return "scatter"
    if name in _SYNC or name.startswith("unique"):
        return "sync"
    return None


class Counts:
    """Op counts of one measured call."""

    def __init__(self) -> None:
        self.by_op: collections.Counter = collections.Counter()
        self.classes = dict.fromkeys(CLASSES, 0)
        self.kernels: collections.Counter = collections.Counter()
        self._inside = 0        # >0: inside a hand kernel's plain arm

    def op(self, name: str, overload: str) -> None:
        if self._inside:
            return
        key = f"{name}.{overload}" if overload else name
        self.by_op[key] += 1
        cls = op_class(name, overload)
        if cls is not None:
            self.classes[cls] += 1
        self.classes["total"] += 1

    def as_dict(self) -> dict:
        return {**self.classes, "kernels": dict(sorted(self.kernels.items())),
                "by_op": dict(sorted(self.by_op.items()))}


@contextlib.contextmanager
def counting():
    """Count the aten ops dispatched inside the block (a ``Counts``),
    each hand kernel's wrapper call as one op of its kernel."""
    import importlib

    from torch.utils._python_dispatch import TorchDispatchMode

    counts = Counts()

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts.op(func.overloadpacket.__name__,
                      func._schema.overload_name)
            return func(*args, **(kwargs or {}))

    def arm(fn, kernel):
        def wrapped(*a, **kw):
            if not counts._inside:
                counts.kernels[kernel] += 1
                counts.classes["total"] += 1
            counts._inside += 1
            try:
                return fn(*a, **kw)
            finally:
                counts._inside -= 1
        return wrapped

    patched = []
    for mod_path, attr, kernel in PLAIN_ARMS:
        mod_name, _, cls_name = mod_path.partition(":")
        owner = importlib.import_module(mod_name)
        if cls_name:
            owner = getattr(owner, cls_name)
        orig = getattr(owner, attr)
        patched.append((owner, attr, orig))
        setattr(owner, attr, arm(orig, kernel))
    try:
        with _Mode():
            yield counts
    finally:
        for owner, attr, orig in patched:
            setattr(owner, attr, orig)


def _params(cfg: dict):
    from dragonboat_tpu_torch.bench_loop import bench_params

    return dataclasses.replace(bench_params(cfg["replicas"], device="cpu"),
                               onehot_reads=cfg["onehot_reads"])


def run_steps_inputs(cfg: dict, device="cpu"):
    """(kp, replicas, state, box) of the ``run_steps`` body."""
    from dragonboat_tpu_torch.bench_loop import make_cluster
    from dragonboat_tpu_torch.core.kstate import empty_inbox

    kp = _params(cfg)
    R = cfg["replicas"]
    state = make_cluster(kp, cfg["groups"], R, device=device)
    return kp, R, state, empty_inbox(kp, state.term.shape[0], device)


def serve_step_inputs(cfg: dict, devices=("cpu", "cpu")):
    """(kp, cluster, state, box, inp, cut) of the ``serve_step`` body,
    every piece split over the (1, R) positions on ``devices``."""
    import numpy as np

    from dragonboat_tpu_torch.parallel import ici

    kp = _params(cfg)
    R = cfg["replicas"]
    cluster, state, box = ici.make_ici_cluster(
        kp, 1, R, num_groups=cfg["groups"], devices=list(devices))
    inp = cluster.shard(ici.self_driving_input(kp, state))
    cut = cluster.shard(np.zeros((cluster.total_rows, kp.num_peers),
                                 np.bool_))
    return kp, cluster, state, box, inp, cut


def measure(entry: str, cfg: dict) -> dict:
    """Op counts of one call of ``entry``'s body on the CPU at ``cfg``."""
    from dragonboat_tpu_torch import bench_loop
    from dragonboat_tpu_torch.parallel import ici

    if entry == "run_steps":
        kp, R, state, box = run_steps_inputs(cfg)
        with counting() as counts:
            bench_loop._run_body(kp, R, True, True, state, box)
    elif entry == "serve_step":
        args = serve_step_inputs(cfg)
        with counting() as counts:
            ici.serve_step(*args)
    else:
        raise ValueError(f"no op-budget entry {entry!r}")
    return counts.as_dict()


def measure_all(config: dict | None = None) -> dict:
    config = config or DEFAULT_CONFIG
    return {entry: measure(entry, config[entry]) for entry in ENTRIES}


def load_budget(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def source_hash(root: str, cfg: dict | None = None) -> str:
    """sha256 over every Python source of the package + measurement
    config + the torch version (a torch upgrade can change which aten ops
    a call dispatches when no repo source moved)."""
    import torch

    h = hashlib.sha256()
    h.update(("torch:" + torch.__version__).encode())
    srcs = sorted(
        os.path.relpath(os.path.join(d, n), root)
        for d, _, names in os.walk(os.path.join(root, CACHE_PACKAGE))
        for n in names if n.endswith(".py"))
    for src in srcs:
        h.update(src.encode())
        with open(os.path.join(root, src), "rb") as f:
            h.update(f.read())
    h.update(json.dumps(cfg or {}, sort_keys=True).encode())
    return h.hexdigest()


def _cache_load(root: str, key: str) -> dict | None:
    path = os.path.join(root, CACHE_FILE)
    try:
        with open(path, encoding="utf-8") as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return None
    if cache.get("source_hash") != key:
        return None
    measured = cache.get("measured")
    return measured if isinstance(measured, dict) else None


def _cache_store(root: str, key: str, measured: dict) -> None:
    path = os.path.join(root, CACHE_FILE)
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"source_hash": key, "measured": measured}, f,
                      indent=1, sort_keys=True)
            f.write("\n")
    except OSError:
        pass  # cache is best-effort; the lint result never depends on it


def measured_counts(root: str, config: dict, use_cache: bool = True
                    ) -> dict:
    """Every entry's counts at ``config``, from the cache when its key
    holds."""
    key = source_hash(root, config)
    if use_cache:
        cached = _cache_load(root, key)
        if cached is not None and set(ENTRIES) <= set(cached):
            return cached
    measured = measure_all(config)
    if use_cache:
        _cache_store(root, key, measured)
    return measured


def run(root: str, budget_path: str | None = None,
        measured: dict | None = None, use_cache: bool = True
        ) -> list[Finding]:
    """Gate ``measured`` (entry -> counts; default: a fresh or cached
    measurement at the budget file's config) against the budget."""
    path = budget_path or os.path.join(root, BUDGET_FILE)
    relpath = rel(root, path)
    try:
        spec = load_budget(path)
    except (OSError, ValueError) as e:
        return [Finding(PASS, relpath, 1, "OB000",
                        f"budget file missing or unreadable ({e}) — run "
                        "python -m dragonboat_tpu_torch.analysis "
                        "--reseed-op-budget to seed it")]
    config = {**DEFAULT_CONFIG, **spec.get("config", {})}
    if measured is None:
        measured = measured_counts(root, config, use_cache)
    findings = []
    for entry in ENTRIES:
        budget = spec.get("budget", {}).get(entry, {})
        got_map = measured.get(entry)
        if got_map is None:
            continue
        for cls in CLASSES:
            limit = budget.get(cls, 0 if cls == "sync" else None)
            got = got_map.get(cls, 0)
            if limit is not None and got > limit:
                findings.append(Finding(
                    PASS, relpath, 1, "OB001",
                    f"[{entry}] {cls} op count {got} exceeds budget "
                    f"{limit} (the step regrew {cls} ops; if the change is "
                    "justified, --reseed-op-budget and record why in "
                    "PERF.md)"))
    return findings


def reseed(root: str, budget_path: str | None = None) -> dict:
    """Measure and (re)write the budget file; returns the new spec."""
    import torch

    path = budget_path or os.path.join(root, BUDGET_FILE)
    measured = measure_all(DEFAULT_CONFIG)
    spec = {
        "config": DEFAULT_CONFIG,
        "budget": {entry: {cls: measured[entry][cls] for cls in CLASSES}
                   for entry in ENTRIES},
        "observed": measured,
        "torch": torch.__version__,
        "note": ("Budgets gate the aten ops one call of each body "
                 "dispatches on the CPU (each hand kernel's wrapper call "
                 "one op, its plain arm uncounted): gather, scatter, "
                 "sync (must stay 0) and total.  Counts are "
                 "group-count-independent.  Update via python -m "
                 "dragonboat_tpu_torch.analysis --reseed-op-budget and a "
                 "PERF.md note justifying the change."),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
        f.write("\n")
    _cache_store(root, source_hash(root, spec["config"]), measured)
    return spec
