"""Keep the port's verbatim copies of the reference's host layer in step.

The host layer behind ``NodeHost`` (wire records, config, request books,
LogDBs, transport, the host-resident RSM, the pycore slow path) imports no
JAX.  The port still imports nothing of ``dragonboat_tpu``, so it keeps its
own copies of these modules, byte for byte the reference's except that the
``dragonboat_tpu`` package prefix reads ``dragonboat_tpu_torch``, and two
rewrites that touch comments and docstrings only: citations of the Go
reference checkout drop its absolute location (``reference/raftpb/...``),
and the JAX package's change numbers read ``round N``.  The
modules that touch JAX (``tracing``, ``capacity``, the device reductions
``core/fleet``, ``core/health`` and ``core/invariants``, ``engine/dispatch``,
``engine/kernel_engine``, ``nodehost``) are ported by hand and are not
listed here.

    python -m dragonboat_tpu_torch._hostcopy          # rewrite the copies
    python -m dragonboat_tpu_torch._hostcopy --check  # exit 1 on drift

The copy reads the reference's source files as text; it imports nothing of
the reference package.
"""

from __future__ import annotations

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
    "core/logentry", "core/peer", "core/pycore",
    "logdb/__init__", "logdb/memdb", "logdb/kv", "logdb/kvdb", "logdb/tan",
    "logdb/sharded", "logdb/logreader",
    "rsm/__init__", "rsm/statemachine", "rsm/encoded", "rsm/session",
    "rsm/membership", "rsm/snapshotio", "rsm/chunkwriter", "rsm/gosnapshot",
    "server/__init__", "server/env", "server/metrics_http", "server/rate",
    "server/settings",
    "transport/__init__", "transport/chan", "transport/chunks",
    "transport/hub",
    "node", "engine/__init__", "engine/apply_pool",
)

# ``dragonboat_tpu`` as a package name: followed by ``.name`` or by
# `` import``; file paths (``/tmp/dragonboat_tpu/``) and longer names
# (``dragonboat_tpu_torch``, ``dragonboat_tpu_jax_cache``) do not match
_PREFIX = re.compile(r"\bdragonboat_tpu(?=\.[A-Za-z_]|\s+import\b)")


# citations of the Go reference checkout (an absolute directory before
# ``reference/``), and the JAX package's change numbers ("PR" and a
# number), as they appear in its comments and docstrings
_GO_CHECKOUT = re.compile(r"/\w+/(?=reference/)")
_CHANGE_NO = re.compile(r"\bPR (?=\d)")


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


def write() -> None:
    for path, text in expected().items():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def main(argv: list[str]) -> int:
    if "--check" in argv:
        bad = drift()
        for name in bad:
            print(f"drift: {name}")
        return 1 if bad else 0
    write()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
