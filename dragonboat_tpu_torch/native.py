"""Loader for the native runtime primitives (native/dbtpu_native.c).

Compiles the C library on first use (cached under the user cache dir,
keyed by source hash) and exposes it through ctypes.  Every entry point
has a pure-Python fallback, so the package works identically — just
slower on the recovery/framing hot loops — when no C toolchain exists.

``tan_scan(buf, magic)`` is the one that matters: single-pass frame
validation over a whole tan log image (startup recovery over GBs of WAL,
reference internal/tan/db.go replay path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "dbtpu_native.c")

_mu = threading.Lock()
_lib = None
_tried = False


class _Rec(ctypes.Structure):
    _fields_ = [("offset", ctypes.c_uint64),
                ("payload_off", ctypes.c_uint64),
                ("payload_len", ctypes.c_uint32)]


def _build() -> str | None:
    """Compile (or reuse a cached build of) the shared library."""
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.path.join(
        os.environ.get("XDG_CACHE_HOME",
                       os.path.expanduser("~/.cache")),
        "dragonboat_tpu")
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, f"dbtpu_native-{digest}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"  # per-process: concurrent first
    # builds must not race each other into a corrupt cached artifact
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", _SRC, "-lz", "-o", tmp],
                capture_output=True, timeout=120)
            if r.returncode == 0:
                os.replace(tmp, so)
                return so
        except (OSError, subprocess.TimeoutExpired):
            continue
    return None


def _load():
    global _lib, _tried
    with _mu:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("DRAGONBOAT_TPU_NO_NATIVE") == "1":
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.dbtpu_tan_scan.restype = ctypes.c_int
            lib.dbtpu_tan_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
                ctypes.POINTER(_Rec), ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_int)]
            lib.dbtpu_frame_check.restype = ctypes.c_int
            lib.dbtpu_frame_check.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
            lib.dbtpu_crc32.restype = ctypes.c_uint32
            lib.dbtpu_crc32.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def tan_scan(buf: bytes, magic: int):
    """-> (records, scan_end, torn): records = [(offset, payload_off,
    payload_len)] for every frame whose magic and CRC validate, in file
    order; scan_end = offset past the last valid frame; torn = True when
    the scan stopped at a bad/partial frame (crash tail or corruption)."""
    lib = _load()
    if lib is None:
        return _tan_scan_py(buf, magic)
    n = len(buf)
    # worst case: every record is an empty payload (12 bytes of frame)
    max_out = n // 12 + 1
    out = (_Rec * max_out)()
    n_out = ctypes.c_uint64()
    scan_end = ctypes.c_uint64()
    status = ctypes.c_int()
    lib.dbtpu_tan_scan(
        buf, ctypes.c_uint64(n), ctypes.c_uint32(magic),
        out, ctypes.c_uint64(max_out),
        ctypes.byref(n_out), ctypes.byref(scan_end), ctypes.byref(status))
    recs = [(out[i].offset, out[i].payload_off, out[i].payload_len)
            for i in range(n_out.value)]
    return recs, scan_end.value, status.value == 1


def _tan_scan_py(buf: bytes, magic: int):
    import struct

    recs = []
    off, n = 0, len(buf)
    while off + 12 <= n:
        m, plen, crc = struct.unpack_from("<III", buf, off)
        if m != magic or off + 12 + plen > n:
            return recs, off, True
        if zlib.crc32(buf[off + 12: off + 12 + plen]) != crc:
            return recs, off, True
        recs.append((off, off + 12, plen))
        off += 12 + plen
    return recs, off, off != n


def frame_check(payload: bytes, crc: int) -> bool:
    lib = _load()
    if lib is None:
        return zlib.crc32(payload) == crc
    return bool(lib.dbtpu_frame_check(
        payload, ctypes.c_uint64(len(payload)), ctypes.c_uint32(crc)))
