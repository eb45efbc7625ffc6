"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``dragonboat_tpu_torch/csrc/*.cu`` are compiled at first use
with ``nvcc`` for ``sm_90a`` (one process per source, all started together,
then one link) into a single shared library with a plain C interface, which
is loaded with ``ctypes``.  The library lands in
``dragonboat_tpu_torch/build/`` (git-ignored) under a name keyed by a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as is.  Nothing here runs at import: the CPU tests import
every module on a machine with no ``nvcc``.

Every wrapper follows one rule: a CPU tensor takes the plain PyTorch arm,
a CUDA tensor launches the kernel or raises (no fallback).  Each launch
adds one to ``launches[name]``; nothing else touches the counts.  A launch
made while a CUDA graph is captured (``dragonboat_tpu_torch.graphs``) is
recorded on that graph, whose every replay adds it again; a launch in a
graph's warm-up counts nowhere.

Several engine threads (one per ``NodeHost``) launch kernels at once, so
building and loading the library is serialized by one lock (the first
use from several threads builds and loads once) and the launch counts
are updated under another.
``plain_arms()`` forces the plain arms on the card, for runs that compare
the kernel path with the plain path.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from dragonboat_tpu_torch import graphs

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: launches per kernel since the last reset_launches()
launches: dict[str, int] = {"quorum_match": 0, "gather_lanes": 0,
                            "kv_apply": 0}

_state: dict = {"lib": None, "force_plain": False}
# serializes build() and library(): re-entrant, library() calls build()
_lib_mu = threading.RLock()
# guards the read-modify-write of the launch counts
_count_mu = threading.Lock()

_C_INT = ctypes.c_int
_C_PTR = ctypes.c_void_p
# C signatures of csrc/*.cu's extern "C" entry points: every pointer and
# the stream are c_void_p, every size a c_int; each returns cudaError_t
_SIGNATURES = {
    "dbt_quorum_match": (_C_PTR,) * 4 + (_C_INT,) * 2 + (_C_PTR,),
    "dbt_commit_quorum": (_C_PTR,) * 3 + (_C_INT,) * 4 + (_C_PTR,),
    "dbt_gather_lanes": (_C_PTR,) * 3 + (_C_INT,) * 3 + (_C_PTR,),
    # fields, field_bytes, n_fields, lanes, n_lanes, outs (host arrays),
    # A, B, C, K, stream
    "dbt_gather_lanes_multi": (_C_PTR, _C_PTR, _C_INT, _C_PTR, _C_INT, _C_PTR)
    + (_C_INT,) * 4 + (_C_PTR,),
    "dbt_kv_apply": (_C_PTR,) * 8 + (_C_INT,) * 5 + (_C_PTR,),
}


def reset_launches() -> None:
    with _count_mu:
        for k in launches:
            launches[k] = 0


@contextlib.contextmanager
def plain_arms():
    """Run the plain PyTorch arms even on CUDA tensors (the comparison
    runs of ``chip_smoke.py``); the kernels are not launched inside."""
    prev = _state["force_plain"]
    _state["force_plain"] = True
    try:
        yield
    finally:
        _state["force_plain"] = prev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the wrapper must launch its kernel: every tensor lies on
    the same CUDA device.  False for CPU tensors (the plain arm).  Raises
    for tensors on mixed devices or on any other device type."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return not _state["force_plain"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdbt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every csrc/*.cu (in parallel) and link one shared library;
    returns its path.  A library already built from the same sources and
    flags is reused.  Raises with the compiler's output on failure."""
    with _lib_mu:
        return _build_locked()


def _build_locked() -> Path:
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _obj, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        (BUILD_DIR / "nvcc.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(o) for _s, o, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = _state["lib"]
    if lib is not None:
        return lib
    with _lib_mu:
        if _state["lib"] is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = _C_INT
            _state["lib"] = lib
        return _state["lib"]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error; count it otherwise (on the
    graph this thread captures, if any: its replays count it)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    sink = graphs.launch_sink()
    if sink is not None:
        sink[name] += 1
        return
    with _count_mu:
        launches[name] += 1


def add_launches(counts) -> None:
    """Add a replayed graph's launches (name -> count) to the counts."""
    with _count_mu:
        for name, n in counts.items():
            launches[name] += n


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple[int, ...]) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")
