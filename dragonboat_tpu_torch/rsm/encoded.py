"""Encoded-entry payload envelope (entry compression).

Parity with the reference's ``internal/rsm/encoded.go``: a proposal's
payload is wrapped at propose time into an ENCODED entry whose Cmd is

    | header (1 byte)              | body                        |
    | Version 4b | Compression 3b | Session 1b |

with Version 0, Session unset (the reference never sets it on the
propose path, ``request.go:1094``), and the body being the raw payload
(NoCompression), a snappy BLOCK (the golang/snappy block format the
reference uses via ``internal/utils/dio/io.go:40-130``), or — a repo
extension — a zlib stream (flag value outside the reference's range;
fast C-backed path for fleets that don't need Go interop).

The snappy block codec here is an independent implementation of the
public snappy format spec (uvarint decoded-length preamble, then
literal/copy elements); the encoder always emits copy-2 elements
(1-64 byte matches, 16-bit offsets), which every conforming decoder —
including the Go fleet's — accepts.
"""

from __future__ import annotations

from dragonboat_tpu_torch import raftpb as pb

EE_HEADER_SIZE = 1
EE_V0 = 0 << 4
EE_NO_COMPRESSION = 0 << 1
EE_SNAPPY = 1 << 1
EE_ZLIB = 2 << 1           # repo extension: NOT understood by Go fleets
_VER_MASK = 0x0F << 4
_CT_MASK = 0x07 << 1
_SESSION_MASK = 0x01

# config.CompressionType spellings accepted by Config.entry_compression
NO_COMPRESSION = "no-compression"
SNAPPY = "snappy"
ZLIB = "zlib"
COMPRESSION_TYPES = (NO_COMPRESSION, SNAPPY, ZLIB)

# the reference's snappy block limit (encoded.go:161 MaxBlockLen comment:
# "roughly limited to 3.42GBytes"); shared ceiling for every type here
MAX_PAYLOAD = (1 << 32) - 1


# ---------------------------------------------------------------------------
# snappy block format (public spec; independent implementation)
# ---------------------------------------------------------------------------


def _put_uvarint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _read_uvarint(buf, pos: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("snappy: truncated length preamble")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
        if shift > 63:
            raise ValueError("snappy: length preamble overflow")


def _emit_literal(out: bytearray, lit) -> None:
    n = len(lit) - 1
    if n < 60:
        out.append(n << 2)
    elif n < (1 << 8):
        out.append(60 << 2)
        out.append(n)
    elif n < (1 << 16):
        out.append(61 << 2)
        out += n.to_bytes(2, "little")
    elif n < (1 << 24):
        out.append(62 << 2)
        out += n.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += n.to_bytes(4, "little")
    out += lit


def _emit_copy2(out: bytearray, offset: int, length: int) -> None:
    """Copy elements as copy-2 chunks (tag 0b10): 1-64 byte length,
    16-bit offset — the simplest element every decoder accepts."""
    while length > 0:
        n = min(64, length)
        out.append(((n - 1) << 2) | 2)
        out += offset.to_bytes(2, "little")
        length -= n


def snappy_block_encode(data: bytes) -> bytes:
    """Greedy hash-match encoder: 4-byte anchors hashed into a FIXED
    16K-slot position table (the golang/snappy shape — O(1) memory at
    any payload size; a dict keyed by raw 4-byte slices costs ~100x the
    input in transient allocations), matches verified by comparison,
    16-bit offsets, copy-2 elements."""
    if len(data) > MAX_PAYLOAD:
        raise ValueError("snappy: payload too large")
    out = bytearray()
    _put_uvarint(out, len(data))
    n = len(data)
    i = lit_start = 0
    # table sized to the input (golang/snappy: grow from 256 toward 16K
    # while smaller than the payload) — a sub-KB proposal must not pay
    # a 16K-slot zero-fill per call on the propose hot path
    table_size, shift = 256, 24
    while table_size < (1 << 14) and table_size < n:
        table_size <<= 1
        shift -= 1
    table = [0] * table_size              # position+1; 0 = empty slot
    while i + 4 <= n:
        v = int.from_bytes(data[i:i + 4], "little")
        h = ((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift
        j = table[h] - 1
        table[h] = i + 1
        if 0 <= j and i - j < (1 << 16) and data[j:j + 4] == data[i:i + 4]:
            length = 4
            while (i + length < n and length < (1 << 24)
                   and data[j + length] == data[i + length]):
                length += 1
            if lit_start < i:
                _emit_literal(out, data[lit_start:i])
            _emit_copy2(out, i - j, length)
            i += length
            lit_start = i
        else:
            i += 1
    if lit_start < n:
        _emit_literal(out, data[lit_start:])
    return bytes(out)


def snappy_block_decode(buf) -> bytes:
    want, pos = _read_uvarint(buf, 0)
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        t = tag & 3
        if t == 0:                               # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                if pos + nb > n:
                    raise ValueError("snappy: truncated literal length")
                ln = int.from_bytes(buf[pos:pos + nb], "little")
                pos += nb
            ln += 1
            if pos + ln > n:
                raise ValueError("snappy: truncated literal")
            out += buf[pos:pos + ln]
            pos += ln
            continue
        if t == 1:                               # copy-1
            ln = ((tag >> 2) & 0x7) + 4
            if pos >= n:
                raise ValueError("snappy: truncated copy-1")
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif t == 2:                             # copy-2
            ln = (tag >> 2) + 1
            if pos + 2 > n:
                raise ValueError("snappy: truncated copy-2")
            off = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:                                    # copy-4
            ln = (tag >> 2) + 1
            if pos + 4 > n:
                raise ValueError("snappy: truncated copy-4")
            off = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise ValueError("snappy: invalid copy offset")
        for _ in range(ln):                      # overlapping copies
            out.append(out[-off])
    if len(out) != want:
        raise ValueError(
            f"snappy: decoded {len(out)} bytes, preamble said {want}")
    return bytes(out)


# ---------------------------------------------------------------------------
# the encoded-entry envelope (encoded.go GetEncoded / GetPayload)
# ---------------------------------------------------------------------------


def get_encoded(compression: str, cmd: bytes) -> bytes:
    """Wrap a proposal payload (GetEncoded, encoded.go:75).  Empty
    payloads never reach here — the propose path keeps them as plain
    APPLICATION entries, as the reference does (request.go:1091)."""
    if not cmd:
        raise ValueError("empty payload cannot be encoded")
    if len(cmd) > MAX_PAYLOAD:
        raise ValueError("payload too big")
    if compression == NO_COMPRESSION:
        return bytes([EE_V0 | EE_NO_COMPRESSION]) + cmd
    if compression == SNAPPY:
        return bytes([EE_V0 | EE_SNAPPY]) + snappy_block_encode(cmd)
    if compression == ZLIB:
        import zlib

        return bytes([EE_V0 | EE_ZLIB]) + zlib.compress(cmd, 1)
    raise ValueError(f"unknown entry compression {compression!r}")


def get_payload(entry) -> bytes:
    """The payload ready for the state machine (GetPayload,
    encoded.go:54): ENCODED entries are unwrapped, everything else
    passes through."""
    if entry.type != pb.EntryType.ENCODED:
        return entry.cmd
    cmd = entry.cmd
    if not cmd:
        raise ValueError("encoded entry with empty cmd")
    header = cmd[0]
    if header & _VER_MASK != EE_V0:
        raise ValueError(f"unknown encoded-entry version {header >> 4}")
    if header & _SESSION_MASK:
        raise ValueError("session-bearing encoded entries not supported")
    ct = header & _CT_MASK
    body = cmd[EE_HEADER_SIZE:]
    if ct == EE_NO_COMPRESSION:
        return bytes(body)
    if ct == EE_SNAPPY:
        return snappy_block_decode(body)
    if ct == EE_ZLIB:
        import zlib

        return zlib.decompress(body)
    raise ValueError(f"unknown encoded-entry compression flag {ct >> 1}")
