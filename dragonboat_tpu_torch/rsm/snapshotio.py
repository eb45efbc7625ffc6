"""Versioned snapshot file format with per-block CRCs.

Parity with the reference's snapshot formats (``internal/rsm/snapshotio.go``
header + ``rwv.go`` block writer/validator + ``encoded.go`` compression):
a fixed header (version, sizes, checksum type, header CRC), a session
payload, the user-SM payload written in CRC-framed blocks, and a footer
with the payload checksum.  Corrupt blocks fail recovery instead of
feeding bad state to the SM.

V2 layout (little-endian):
  magic "DBTPUSNP" | u32 version | u32 header_crc | u64 session_len
  | session bytes | blocks: [u32 len | u32 crc | bytes]* | u32 0 terminator

V3 adds the compression envelope (encoded.go analog): each block frame is
[u32 stored_len | u32 crc(stored) | u8 compressed | stored bytes], where
compressed blocks hold zlib(raw).  The payload checksum covers the RAW
bytes, so V2 and V3 of the same payload verify identically.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import BinaryIO

MAGIC = b"DBTPUSNP"
V2 = 2
V3 = 3
# version-field flag: the file is a SHRUNKEN snapshot (snapshotio.go:462
# ShrinkSnapshot) — a valid container whose payload was dropped because an
# on-disk SM holds the data durably itself; only the (empty) session image
# remains.  Recovery must never feed a shrunk payload to a non-on-disk SM.
SHRUNK = 0x100
BLOCK_SIZE = 256 * 1024
# only compress when it actually shrinks the block by a margin (skip
# incompressible payloads rather than pay decompress for nothing)
_MIN_GAIN = 0.9


class SnapshotFormatError(ValueError):
    pass


class BlockWriter:
    """CRC-framed block writer (rwv.go IVWriter; V3 adds compression)."""

    def __init__(self, f: BinaryIO, block_size: int = BLOCK_SIZE,
                 compress: bool = False) -> None:
        self.f = f
        self.block_size = block_size
        self.compress = compress
        self.buf = bytearray()
        self.payload_crc = 0

    def write(self, data: bytes) -> int:
        self.buf += data
        while len(self.buf) >= self.block_size:
            self._flush_block(self.buf[: self.block_size])
            del self.buf[: self.block_size]
        return len(data)

    def _flush_block(self, block: bytes) -> None:
        self.payload_crc = zlib.crc32(block, self.payload_crc)
        if not self.compress:
            self.f.write(struct.pack("<II", len(block), zlib.crc32(block)))
            self.f.write(block)
            return
        packed = zlib.compress(block, 1)
        stored, flag = ((packed, 1)
                        if len(packed) < len(block) * _MIN_GAIN
                        else (block, 0))
        # frame CRC covers the flag byte too — a flipped flag must fail
        # validation, not reach zlib or stream wrong bytes to the SM
        crc = zlib.crc32(stored, zlib.crc32(bytes([flag])))
        self.f.write(struct.pack("<IIB", len(stored), crc, flag))
        self.f.write(stored)

    def close(self) -> None:
        if self.buf:
            self._flush_block(bytes(self.buf))
            self.buf.clear()
        self.f.write(struct.pack("<I", 0))  # terminator
        self.f.write(struct.pack("<I", self.payload_crc))


class BlockReader:
    """Validating reader over CRC-framed blocks (rwv.go IVReader)."""

    def __init__(self, f: BinaryIO, version: int = V2) -> None:
        self.f = f
        self.version = version
        self.payload_crc = 0
        self.buf = bytearray()
        self.eof = False

    def _fill(self) -> None:
        if self.eof:
            return
        hdr = self.f.read(4)
        (ln,) = struct.unpack("<I", hdr)
        if ln == 0:
            (expect,) = struct.unpack("<I", self.f.read(4))
            if expect != self.payload_crc:
                raise SnapshotFormatError("payload checksum mismatch")
            self.eof = True
            return
        if self.version >= V3:
            crc, flag = struct.unpack("<IB", self.f.read(5))
        else:
            (crc,) = struct.unpack("<I", self.f.read(4))
            flag = 0
        stored = self.f.read(ln)
        expect = (zlib.crc32(stored, zlib.crc32(bytes([flag])))
                  if self.version >= V3 else zlib.crc32(stored))
        if len(stored) != ln or expect != crc:
            raise SnapshotFormatError("block checksum mismatch")
        try:
            block = zlib.decompress(stored) if flag else stored
        except zlib.error as e:
            raise SnapshotFormatError(f"corrupt compressed block: {e}")
        self.payload_crc = zlib.crc32(block, self.payload_crc)
        self.buf += block

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            while not self.eof:
                self._fill()
            out = bytes(self.buf)
            self.buf.clear()
            return out
        while len(self.buf) < n and not self.eof:
            self._fill()
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out


def write_snapshot(f: BinaryIO, session_data: bytes,
                   write_payload, compress: bool = False,
                   shrunk: bool = False) -> None:
    """write_payload(w) receives a BlockWriter for the SM payload."""
    header = struct.pack("<Q", len(session_data))
    f.write(MAGIC)
    version = (V3 if compress else V2) | (SHRUNK if shrunk else 0)
    f.write(struct.pack("<I", version))
    f.write(struct.pack("<I", zlib.crc32(header)))
    f.write(header)
    f.write(struct.pack("<I", zlib.crc32(session_data)))
    f.write(session_data)
    w = BlockWriter(f, compress=compress)
    write_payload(w)
    w.close()


def read_snapshot(f: BinaryIO):
    """Returns (session_bytes, BlockReader for the payload).  The reader
    carries ``.shrunk`` — True for a shrunken on-disk-SM snapshot whose
    payload was dropped (ShrinkSnapshot, snapshotio.go:462)."""
    if f.read(8) != MAGIC:
        raise SnapshotFormatError("bad magic")
    (version,) = struct.unpack("<I", f.read(4))
    shrunk = bool(version & SHRUNK)
    version &= ~SHRUNK
    if version not in (V2, V3):
        raise SnapshotFormatError(f"unsupported version {version}")
    (hcrc,) = struct.unpack("<I", f.read(4))
    header = f.read(8)
    if zlib.crc32(header) != hcrc:
        raise SnapshotFormatError("header checksum mismatch")
    (slen,) = struct.unpack("<Q", header)
    (scrc,) = struct.unpack("<I", f.read(4))
    session = f.read(slen)
    if zlib.crc32(session) != scrc:
        raise SnapshotFormatError("session checksum mismatch")
    reader = BlockReader(f, version=version)
    reader.shrunk = shrunk
    return session, reader


def shrink_snapshot_file(path: str, fs, session_data: bytes = b"") -> None:
    """Atomically replace a recorded snapshot with its shrunken form: a
    valid container holding ``session_data`` (normally an empty session
    image) and zero payload blocks (snapshotio.go:462 ShrinkSnapshot +
    :486 ReplaceSnapshot)."""
    tmp = path + ".shrinking"
    with fs.open(tmp, "wb") as f:
        write_snapshot(f, session_data, lambda w: None, shrunk=True)
        fs.fsync(f)
    fs.replace(tmp, path)


def is_shrunk_snapshot(path: str, fs) -> bool:
    """Header-only check (snapshotter.go Shrunk)."""
    with fs.open(path, "rb") as f:
        if f.read(8) != MAGIC:
            return False
        raw = f.read(4)
        if len(raw) != 4:
            return False
        (version,) = struct.unpack("<I", raw)
        return bool(version & SHRUNK)
