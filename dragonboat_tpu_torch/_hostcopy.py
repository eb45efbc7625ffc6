"""Keep the port's verbatim copies of the reference's host layer in step.

The host layer behind ``NodeHost`` (wire records, config, request books,
LogDBs, transport, the host-resident RSM, the pycore slow path) imports no
JAX.  The port still imports nothing of ``dragonboat_tpu``, so it keeps its
own copies of these modules, byte for byte the reference's except that the
``dragonboat_tpu`` package prefix reads ``dragonboat_tpu_torch``, and two
rewrites that touch comments and docstrings only: citations of the Go
reference checkout drop its absolute location (``reference/raftpb/...``),
and the JAX package's change and issue numbers read ``round N``.  The
modules that touch JAX (``tracing``, ``capacity``, the device reductions
``core/fleet``, ``core/health`` and ``core/invariants``, ``engine/dispatch``,
``engine/kernel_engine``, ``nodehost``, ``chaos/runner``) are ported by
hand and are not listed here.  The hand ports that follow one reference
file each (``HAND_PORTS``: the chaos runner, the model checker from
``scripts/model_check.py``, the capacity rungs from
``scripts/scale_100k.py``, the analysis passes, whose scopes name the
port's files, ``logdb/kv``, which refuses a corrupt SST the reference
reads past its end, and the three user examples, which take ``--device``
and import their state machine from the port's package) are each held to a recorded diff against the
rewritten reference text under ``tests/hand_ports/``, so an edit on either
side shows as drift until the diff is recorded again.

    python -m dragonboat_tpu_torch._hostcopy          # rewrite the copies
    python -m dragonboat_tpu_torch._hostcopy --check  # exit 1 on drift
    python -m dragonboat_tpu_torch._hostcopy --record-hand-diffs

The copy reads the reference's source files as text; it imports nothing of
the reference package.
"""

from __future__ import annotations

import difflib
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "dragonboat_tpu"
PORT = ROOT / "dragonboat_tpu_torch"

#: module paths (relative, without ``.py``) copied verbatim
MODULES = (
    "raftpb/__init__", "raftpb/gowire",
    "config", "client", "events", "logger", "lifecycle", "flight",
    "telemetry", "request", "raftio", "statemachine", "quiesce",
    "registry", "vfs", "native", "tools", "fabric", "control",
    "history", "gossip", "analysis/common",
    "core/logentry", "core/peer", "core/pycore",
    "logdb/__init__", "logdb/memdb", "logdb/kvdb", "logdb/tan",
    "logdb/sharded", "logdb/logreader",
    "rsm/__init__", "rsm/statemachine", "rsm/encoded", "rsm/session",
    "rsm/membership", "rsm/snapshotio", "rsm/chunkwriter", "rsm/gosnapshot",
    "server/__init__", "server/env", "server/metrics_http", "server/rate",
    "server/settings",
    "transport/__init__", "transport/chan", "transport/chunks",
    "transport/hub", "transport/tcp",
    "node", "engine/__init__", "engine/apply_pool",
    "chaos/__init__", "chaos/crashfs", "chaos/faultplan", "chaos/oracle",
)

#: hand ports (path under the port) -> the reference file each follows
HAND_PORTS = {
    "chaos/runner.py": "dragonboat_tpu/chaos/runner.py",
    "model_check.py": "scripts/model_check.py",
    "scale_100k.py": "scripts/scale_100k.py",
    "logdb/kv.py": "dragonboat_tpu/logdb/kv.py",
    "analysis/determinism.py": "dragonboat_tpu/analysis/determinism.py",
    "analysis/concurrency.py": "dragonboat_tpu/analysis/concurrency.py",
    "analysis/safety.py": "dragonboat_tpu/analysis/safety.py",
    "analysis/engine_unity.py": "dragonboat_tpu/analysis/engine_unity.py",
    "analysis/contracts.py": "dragonboat_tpu/analysis/contracts.py",
    "analysis/transfer.py": "dragonboat_tpu/analysis/transfer.py",
    "examples/helloworld.py": "examples/helloworld.py",
    "examples/ondisk.py": "examples/ondisk.py",
    "examples/multigroup_device.py": "examples/multigroup_device.py",
}
HAND_DIFFS = ROOT / "tests" / "hand_ports"

# ``dragonboat_tpu`` as a package name: followed by ``.name`` or by
# `` import``; file paths (``/tmp/dragonboat_tpu/``) and longer names
# (``dragonboat_tpu_torch``, ``dragonboat_tpu_jax_cache``) do not match
_PREFIX = re.compile(r"\bdragonboat_tpu(?=\.[A-Za-z_]|\s+import\b)")


# citations of the Go reference checkout (an absolute directory before
# ``reference/``), and the JAX package's change and issue numbers ("PR"
# or "ISSUE" and a number), as they appear in its comments and docstrings
_GO_CHECKOUT = re.compile(r"/\w+/(?=reference/)")
_CHANGE_NO = re.compile(r"\b(?:PR|ISSUE) (?=\d)")


def rewrite(text: str) -> str:
    """The reference's module text with the package prefix rewritten
    (and the two comment rewrites above)."""
    text = _GO_CHECKOUT.sub("", text)
    text = _CHANGE_NO.sub("round ", text)
    return _PREFIX.sub("dragonboat_tpu_torch", text)


def expected() -> dict[Path, str]:
    """Port path -> the text the copy must hold."""
    return {PORT / f"{m}.py": rewrite((REF / f"{m}.py").read_text())
            for m in MODULES}


def drift() -> list[str]:
    """Copies that are missing or differ from the reference's text."""
    return sorted(str(p.relative_to(ROOT)) for p, text in expected().items()
                  if not p.exists() or p.read_text() != text)


def hand_diff(port_rel: str) -> str:
    """The port file's diff against the rewritten reference text, no
    context, hunk positions dropped (a shift elsewhere is no drift)."""
    ref = rewrite((ROOT / HAND_PORTS[port_rel]).read_text())
    port = (PORT / port_rel).read_text()
    out = []
    for line in difflib.unified_diff(ref.splitlines(), port.splitlines(),
                                     n=0, lineterm=""):
        if line.startswith(("---", "+++")):
            continue
        out.append("@@" if line.startswith("@@") else line)
    return "\n".join(out) + "\n"


def _hand_diff_path(port_rel: str) -> Path:
    return HAND_DIFFS / (port_rel[:-3].replace("/", "_") + ".diff")


def hand_drift() -> list[str]:
    """Hand ports whose diff against the reference is not the recorded
    one."""
    return sorted(f"dragonboat_tpu_torch/{p}" for p in HAND_PORTS
                  if not _hand_diff_path(p).exists()
                  or _hand_diff_path(p).read_text() != hand_diff(p))


def record_hand_diffs() -> None:
    HAND_DIFFS.mkdir(parents=True, exist_ok=True)
    for p in HAND_PORTS:
        _hand_diff_path(p).write_text(hand_diff(p))


def write() -> None:
    for path, text in expected().items():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def main(argv: list[str]) -> int:
    if "--check" in argv:
        bad = drift() + hand_drift()
        for name in bad:
            print(f"drift: {name}")
        return 1 if bad else 0
    if "--record-hand-diffs" in argv:
        record_hand_diffs()
        return 0
    write()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
