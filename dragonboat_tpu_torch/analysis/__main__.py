"""The port's lint driver: the analysis passes over ``dragonboat_tpu_torch``.

    python -m dragonboat_tpu_torch.analysis                  # static passes
    python -m dragonboat_tpu_torch.analysis --dynamic        # + device legs
    python -m dragonboat_tpu_torch.analysis --dynamic --device cpu
    python -m dragonboat_tpu_torch.analysis --pass safety
    python -m dragonboat_tpu_torch.analysis --reseed-op-budget

The counterpart of the reference's ``scripts/lint.py``: its nine passes,
each with its static leg (``analysis/__init__.py`` lists the few rules
that have no torch form):

  concurrency   ``# guarded-by:`` discipline and the CC003 lock-order graph
                over the thread-shared modules, the port's compiled
                entries and engine layer included
  determinism   wall clock / unseeded RNG / set-iteration order in the
                replay paths
  contracts     the abstract interpreter over core/kernel.py (KC001-KC006:
                named-axis broadcasts, silent dtype conversions, bool/i32
                comparisons, unmasked ring indices, out-of-domain and
                mis-shaped stores), CONTRACTS tables parse (KC007) and the
                DONATION table matches the compiled entries' donated
                positions (KC008); ``--dynamic`` adds KC007's
                declared-vs-actual diff of the tensors one real step and
                one reduction pass build
  engine-unity  one step loop, one dispatch abstraction (EU001-EU006)
  safety        the INVARIANTS declarations and the kernel's store
                obligations (RS001-RS004, RS006); ``--dynamic`` adds the
                model checker's fast scope (RS005)
  transfer      the declared device<->host seam (TB001-TB006);
                ``--dynamic`` adds the guarded step loop at four
                geometries, diffed against the ledger
  partition     the static walk: cross-G reductions (PS001), replicated
                values mixed with split ones (PS003), implicit syncs in
                hot host paths (PS006); ``--dynamic`` adds one serve step
                of a split mesh, every position's leaves on its own
                device with its rows (PS002)
  tracer-safety host control flow, host reads, syncs and frozen host
                effects in the scope a CUDA graph captures (TS001-TS004)
  op-budget     the aten op counts of one step body and one split serve
                step on the CPU against ``analysis/op_budget.json``
                (OB001; ``--reseed-op-budget`` rewrites the file)

``--dynamic`` runs on ``--device`` (default: the CUDA card; with no card
it raises — pass ``--device cpu``); the dynamic legs' verdicts are cached
by source hash, torch version and device type, and the op budget's
counts by source hash and torch version (it always measures on the
CPU).  Waivers live in
``dragonboat_tpu_torch/analysis/waivers.toml`` (the reference's format);
waived findings are printed with their reasons, and on a full run (no
``--pass``) a waiver that matches no file (SW001) or suppressed nothing
(SW002) is itself a finding.  The exit status is 1 when any unwaived
finding remains, 2 on an unreadable waiver file.  The reference driver's
fork pool, ``--changed-only``, JSON and SARIF output are not carried:
the passes here take a few seconds together without ``--dynamic``.
"""

from __future__ import annotations

import argparse
import fnmatch
import os
import sys
import time

from dragonboat_tpu_torch.analysis import (
    common,
    concurrency,
    contracts,
    determinism,
    engine_unity,
    op_budget,
    partition,
    safety,
    tracer_safety,
    transfer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

WAIVERS_FILE = "dragonboat_tpu_torch/analysis/waivers.toml"


def _passes(dynamic: bool, device, use_cache: bool) -> dict:
    return {
        "concurrency": lambda root: concurrency.run(root),
        "determinism": lambda root: determinism.run(root),
        "contracts": lambda root: contracts.run(
            root, dynamic=dynamic, device=device),
        "engine-unity": lambda root: engine_unity.run(root),
        "safety": lambda root: safety.run(
            root, dynamic=dynamic, device=device, use_cache=use_cache),
        "transfer": lambda root: transfer.run(
            root, dynamic=dynamic, device=device, use_cache=use_cache),
        "partition": lambda root: partition.run(
            root, dynamic=dynamic, device=device),
        "tracer-safety": lambda root: tracer_safety.run(root),
        "op-budget": lambda root: op_budget.run(root, use_cache=use_cache),
    }


PASS_NAMES = tuple(_passes(False, None, True))


def run_passes(selected=PASS_NAMES, dynamic: bool = False, device=None,
               use_cache: bool = True, root: str = ROOT) -> dict:
    """pass name -> (raw findings, wall seconds), in ``selected`` order."""
    passes = _passes(dynamic, device, use_cache)
    out = {}
    for name in selected:
        t0 = time.perf_counter()
        found = passes[name](root)
        out[name] = (found, time.perf_counter() - t0)
    return out


def _repo_rel_files(root: str) -> list[str]:
    """Repo-relative paths of all files (skips caches and .git)."""
    skip = {"__pycache__", ".git", ".pytest_cache", ".hypothesis"}
    out: list[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in skip]
        for fn in filenames:
            out.append(common.rel(root, os.path.join(dirpath, fn)))
    return out


def stale_waiver_findings(waivers: list[common.Waiver],
                          root: str) -> list[common.Finding]:
    """SW001/SW002: waivers that outlived the code they excused (only
    meaningful after a full run)."""
    relpath = WAIVERS_FILE
    files = _repo_rel_files(root)
    findings = []
    for w in waivers:
        if not any(fnmatch.fnmatch(p, w.path) for p in files):
            findings.append(common.Finding(
                "stale-waiver", relpath, w.line, "SW001",
                f"waiver path pattern {w.path!r} (pass {w.pass_name}) "
                "matches no file in the repo — delete the entry"))
        elif w.hits == 0:
            findings.append(common.Finding(
                "stale-waiver", relpath, w.line, "SW002",
                f"waiver for pass {w.pass_name}, path {w.path!r} "
                "suppressed zero findings this run — the code it "
                "excused is gone; delete the entry"))
    return findings


def main(argv: list[str] | None = None, root: str = ROOT) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dragonboat_tpu_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASS_NAMES,
                    help="run only this pass (repeatable; default: all)")
    ap.add_argument("--dynamic", action="store_true",
                    help="add the device legs: RS005, the transfer "
                         "dynamic leg, KC007's runtime diff, PS002's "
                         "placement check")
    ap.add_argument("--device", default=None,
                    help="device of the dynamic legs (default: the CUDA "
                         "card)")
    ap.add_argument("--reseed-op-budget", action="store_true",
                    help="measure the op counts on the CPU, rewrite "
                         "analysis/op_budget.json and exit")
    args = ap.parse_args(argv)

    if args.reseed_op_budget:
        spec = op_budget.reseed(root)
        for entry, budget in spec["budget"].items():
            print(f"{entry}: {budget}")
        print(f"wrote {op_budget.BUDGET_FILE}: review its diff and "
              "justify the new counts in PERF.md")
        return 0

    try:
        waivers = common.load_waivers(os.path.join(root, WAIVERS_FILE))
    except common.WaiverError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    selected = args.passes or list(PASS_NAMES)
    unwaived: list[common.Finding] = []
    results = run_passes(selected, args.dynamic, args.device, root=root)
    for name, (found, secs) in results.items():
        u, w = common.apply_waivers(found, waivers)
        unwaived += u
        print(f"== {name}: {len(u)} finding(s), {len(w)} waived, "
              f"{secs:.2f} s ==")
        for f in u:
            print(f"  {f.format()}")
        for f, wv in w:
            print(f"  [waived: {wv.reason}] {f.format()}")

    if args.passes is None:
        stale = stale_waiver_findings(waivers, root)
        unwaived += stale
        print(f"== stale-waiver: {len(stale)} finding(s) ==")
        for f in stale:
            print(f"  {f.format()}")

    if unwaived:
        print(f"\nFAIL: {len(unwaived)} unwaived finding(s)")
    else:
        print("\nOK: no unwaived findings")
    return 1 if unwaived else 0


if __name__ == "__main__":
    sys.exit(main())
