"""The reference's V2 snapshot container format (write + validate).

A Go receiver validates EVERY snapshot chunk stream against this layout
(chunk.go:214 -> rsm.NewSnapshotValidator), so anything the go wire
ships as a snapshot image must be bytes a Go fleet accepts.  Layout
(internal/rsm/snapshotio.go saveHeader + rwv.go BlockWriter):

    [ header region: 1024 bytes                                   ]
      u64 LE header_len | SnapshotHeader protobuf | zero padding
    [ payload blocks: <=2 MiB each, 4-byte CRC32-IEEE appended    ]
    [ tail: u64 LE total_block_bytes | 8-byte magic               ]

SnapshotHeader (raftpb/snapshotheader.go MarshalTo): session_size(1),
data_store_size(2), unreliable_time(3), git_version(4, unconditional),
header_checksum(5, emitted once computed), payload_checksum(6),
checksum_type(7), version(8), compression_type(9).  HeaderChecksum is
the CRC32 of the header marshaled WITHOUT it; PayloadChecksum is the
CRC32 of the concatenated block CRCs (rwv.go processNewBlock feeds fh).

Used today for the witness image (GetWitnessSnapshot parity — payload
is the reference's empty LRU session bank: u64 LE 4096 | u64 LE 0);
``validate_v2`` reimplements the reference's v2validator so tests can
prove emitted bytes pass the exact algorithm a Go receiver runs.
"""

from __future__ import annotations

import struct
import zlib

HEADER_SIZE = 1024                        # settings.SnapshotHeaderSize
BLOCK_SIZE = 2 * 1024 * 1024              # settings.SnapshotChunkSize
CHECKSUM_SIZE = 4
TAIL_SIZE = 16
MAGIC = bytes([0x3F, 0x5B, 0xCB, 0xF1, 0xFA, 0xBA, 0x81, 0x9F])
LRU_MAX_SESSION_COUNT = 4096              # settings hard default
V2 = 2
CRC32IEEE = 0
NO_COMPRESSION = 0


def _uvarint(out: bytearray, x: int) -> None:
    while x >= 0x80:
        out.append((x & 0x7F) | 0x80)
        x >>= 7
    out.append(x)


def _marshal_header(unreliable_time: int, payload_checksum: bytes,
                    header_checksum: bytes | None) -> bytes:
    """snapshotheader.go MarshalTo — unconditional scalar emit, the two
    checksum fields only when present."""
    out = bytearray()
    out.append(0x08)
    _uvarint(out, 0)                      # session_size (writer leaves 0)
    out.append(0x10)
    _uvarint(out, 0)                      # data_store_size
    out.append(0x18)
    _uvarint(out, unreliable_time)
    out.append(0x22)
    _uvarint(out, 0)                      # git_version: empty string
    if header_checksum is not None:
        out.append(0x2A)
        _uvarint(out, len(header_checksum))
        out += header_checksum
    out.append(0x32)
    _uvarint(out, len(payload_checksum))
    out += payload_checksum
    out.append(0x38)
    _uvarint(out, CRC32IEEE)              # checksum_type
    out.append(0x40)
    _uvarint(out, V2)                     # version
    out.append(0x48)
    _uvarint(out, NO_COMPRESSION)         # compression_type
    return bytes(out)


def write_v2(payload: bytes, unreliable_time: int = 1) -> bytes:
    """The complete container for ``payload`` (block split + CRCs + tail
    + header), as newSnapshotWriter/Close produce it."""
    blocks = bytearray()
    crc_cat = bytearray()                 # fh: concatenated block CRCs
    total = 0
    for off in range(0, len(payload), BLOCK_SIZE):
        block = payload[off:off + BLOCK_SIZE]
        crc = struct.pack("<I", zlib.crc32(block))
        blocks += block + crc
        crc_cat += crc
        total += len(block) + CHECKSUM_SIZE
    if not payload:                       # Close flushes even empty
        pass
    tail = struct.pack("<Q", total) + MAGIC
    payload_checksum = struct.pack("<I", zlib.crc32(bytes(crc_cat)))
    # HeaderChecksum: CRC32 of the header marshaled WITHOUT it
    pre = _marshal_header(unreliable_time, payload_checksum, None)
    hc = struct.pack("<I", zlib.crc32(pre))
    hdr = _marshal_header(unreliable_time, payload_checksum, hc)
    if len(hdr) > HEADER_SIZE - 8:
        raise ValueError("snapshot header too large")
    region = struct.pack("<Q", len(hdr)) + hdr
    region += bytes(HEADER_SIZE - len(region))
    return region + bytes(blocks) + tail


def empty_lru_session() -> bytes:
    """rsm.GetEmptyLRUSession: max count + zero sessions."""
    return struct.pack("<QQ", LRU_MAX_SESSION_COUNT, 0)


def witness_image() -> bytes:
    """rsm.GetWitnessSnapshot (snapshotio.go:139): a well-formed V2
    container whose payload is the empty session bank."""
    return write_v2(empty_lru_session())


def validate_v2(data: bytes) -> bool:
    """The reference receiver's validation, reimplemented from
    rwv.go v2validator (AddChunk over the whole image + Validate):
    header length sane, every block's CRC matches, tail magic + total
    correct.  Exists so tests prove emitted bytes pass the EXACT
    algorithm chunk.go:214 runs on an inbound stream."""
    if len(data) < HEADER_SIZE:
        return False
    (hlen,) = struct.unpack_from("<Q", data, 0)
    if hlen > HEADER_SIZE - 8:
        return False
    body = data[HEADER_SIZE:]
    if len(body) < TAIL_SIZE:
        return False
    tail, blocks = body[-TAIL_SIZE:], body[:-TAIL_SIZE]
    if tail[8:] != MAGIC:
        return False
    (total,) = struct.unpack_from("<Q", tail, 0)
    if total != len(blocks):
        return False
    i = 0
    step = BLOCK_SIZE + CHECKSUM_SIZE
    while len(blocks) - i > step:
        if not _block_ok(blocks[i:i + step]):
            return False
        i += step
    rest = blocks[i:]
    return len(rest) == 0 or _block_ok(rest)


def _block_ok(block: bytes) -> bool:
    if len(block) <= CHECKSUM_SIZE:
        return False
    payload, crc = block[:-CHECKSUM_SIZE], block[-CHECKSUM_SIZE:]
    return struct.pack("<I", zlib.crc32(payload)) == crc


def read_v2(data: bytes) -> bytes:
    """Extract the payload stream from a reference V2 container
    (SnapshotReader semantics: skip the 1024-byte header region,
    de-block verifying each CRC, strip the tail).  Raises ValueError on
    any mismatch."""
    if not validate_v2(data):
        raise ValueError("not a valid reference V2 snapshot container")
    blocks = data[HEADER_SIZE:-TAIL_SIZE]
    out = bytearray()
    step = BLOCK_SIZE + CHECKSUM_SIZE
    i = 0
    while i < len(blocks):
        block = blocks[i:i + step]
        out += block[:-CHECKSUM_SIZE]
        i += step
    return bytes(out)


# ---------------------------------------------------------------------------
# session-bank translation (lrusession.go save/load <-> rsm/session.py)
# ---------------------------------------------------------------------------


def go_session_bank_decode(payload: bytes) -> tuple[list, int]:
    """Parse the Go LRU session bank at the head of a payload stream:
    ``u64 max | u64 count | count x (u64 json_len | Session JSON)``
    (lrusession.go save + session.go save).  Returns ([(client_id,
    responded_to, {series: (value, data_bytes)})...], bytes_consumed)."""
    import base64
    import json

    if len(payload) < 16:
        raise ValueError("go session bank: truncated")
    count = struct.unpack_from("<Q", payload, 8)[0]
    off = 16
    sessions = []
    for _ in range(count):
        if off + 8 > len(payload):
            raise ValueError("go session bank: truncated session")
        (jlen,) = struct.unpack_from("<Q", payload, off)
        off += 8
        rec = json.loads(payload[off:off + jlen].decode())
        off += jlen
        hist = {}
        for series, res in (rec.get("History") or {}).items():
            d = res.get("Data")
            hist[int(series)] = (
                int(res.get("Value") or 0),
                base64.b64decode(d) if d else b"",
            )
        sessions.append((int(rec.get("ClientID") or 0),
                         int(rec.get("RespondedUpTo") or 0), hist))
    return sessions, off


def go_session_bank_encode(sessions: list) -> bytes:
    """The inverse: our session records -> the Go bank bytes (JSON keys
    as Go's json.Marshal of rsm.Session emits them; Go's Unmarshal is
    order-insensitive)."""
    import base64
    import json

    out = bytearray(struct.pack("<QQ", LRU_MAX_SESSION_COUNT,
                                len(sessions)))
    for client_id, responded_to, hist in sessions:
        rec = {
            "History": {
                str(series): {
                    "Value": value,
                    "Data": (base64.b64encode(data).decode()
                             if data else None),
                }
                for series, (value, data) in sorted(hist.items())
            },
            "ClientID": client_id,
            "RespondedUpTo": responded_to,
        }
        blob = json.dumps(rec, separators=(",", ":")).encode()
        out += struct.pack("<Q", len(blob))
        out += blob
    return bytes(out)


# ---------------------------------------------------------------------------
# whole-image transcode (regular SM snapshots, file-based catchup)
# ---------------------------------------------------------------------------


def native_image_to_go(data: bytes) -> bytes:
    """Our DBTPUSNP container -> the reference container: sessions
    re-banked into the Go format, the user payload carried verbatim.
    The result is what a Go peer's validator AND its recovery path
    expect for a regular-SM snapshot image."""
    import io

    from dragonboat_tpu_torch.rsm.session import LRUSession
    from dragonboat_tpu_torch.rsm.snapshotio import read_snapshot

    session_bytes, reader = read_snapshot(io.BytesIO(data))
    if getattr(reader, "shrunk", False):
        # a shrunken image's empty payload is a bookkeeping artifact,
        # not state; rebuilding it as a full reference container would
        # bypass the receiver's shrunk guards and wipe the SM
        raise ValueError("shrunken snapshot cannot cross the go wire")
    user = b"".join(iter(lambda: reader.read(1 << 20), b""))
    lru = LRUSession.load(io.BytesIO(session_bytes)) if session_bytes \
        else LRUSession()
    sessions = [
        (s.client_id, s.responded_to,
         {k: (r.value, r.data) for k, r in s.history.items()})
        for s in lru.sessions.values()
    ]
    return write_v2(go_session_bank_encode(sessions) + user)


def go_image_to_native(data: bytes) -> bytes:
    """The reference container -> our DBTPUSNP container: the Go
    session bank becomes our LRUSession image, the user payload is
    carried verbatim — so a Go-written snapshot recovers a TPU replica
    through the ordinary read_snapshot path (sessions included: dedup
    state survives the fleet boundary)."""
    import io

    from dragonboat_tpu_torch.rsm.session import LRUSession, Session
    from dragonboat_tpu_torch.statemachine import Result
    from dragonboat_tpu_torch.rsm.snapshotio import write_snapshot

    payload = read_v2(data)
    sessions, consumed = go_session_bank_decode(payload)
    user = payload[consumed:]
    lru = LRUSession()
    for client_id, responded_to, hist in sessions:
        s = Session(client_id=client_id, responded_to=responded_to)
        for series, (value, d) in hist.items():
            s.history[series] = Result(value=value, data=d)
        lru.sessions[client_id] = s
    sbuf = io.BytesIO()
    lru.save(sbuf)
    out = io.BytesIO()
    write_snapshot(out, sbuf.getvalue(), lambda w: w.write(user))
    return out.getvalue()


def sniff_v2_file(path: str) -> bool:
    """Cheap reference-container sniff without reading the image:
    first 8 bytes (header length — our DBTPUSNP magic reads as an
    impossible value) + last 8 (tail magic)."""
    import os

    try:
        size = os.path.getsize(path)
        if size < HEADER_SIZE + TAIL_SIZE:
            return False
        with open(path, "rb") as f:
            head = f.read(8)
            f.seek(-8, 2)
            tail = f.read(8)
    except OSError:
        return False
    (hlen,) = struct.unpack("<Q", head)
    return hlen <= HEADER_SIZE - 8 and tail == MAGIC


class GoStreamTranscoder:
    """Streaming our-container -> reference-container transcode (the
    live-stream path: rsm/chunkwriter.py produces the repo container
    progressively; a real Go receiver validates reference blocks as
    they arrive, so the byte stream must be reference-shaped IN FLIGHT).

    Feed container bytes with ``write``; reference-file fragments come
    out through ``out(bytes)`` in validator-aligned units (the 1024-byte
    header first, then 2 MiB CRC'd blocks, then the 16-byte tail at
    ``close``).  Sessions are re-banked go-side; the user payload passes
    through verbatim.  Mirrors what chunkwriter.go emits for a streamed
    Go snapshot, dummy payload checksum included."""

    def __init__(self, out) -> None:
        self.out = out
        self.buf = bytearray()
        self.state = "preamble"          # -> session -> blocks -> done
        self.version = 0
        self.slen = 0
        self.scrc = 0
        self.payload_crc = 0
        # go-side block framer state
        self._go_block = bytearray()
        self._started = False

    # -- go-side emission ------------------------------------------------

    def _emit_header(self) -> None:
        # chunkwriter.go getHeader: streamed headers carry a DUMMY
        # payload checksum ({0,0,0,0}) since the total is unknown
        pre = _marshal_header(1, b"\x00\x00\x00\x00", None)
        hc = struct.pack("<I", zlib.crc32(pre))
        hdr = _marshal_header(1, b"\x00\x00\x00\x00", hc)
        region = struct.pack("<Q", len(hdr)) + hdr
        region += bytes(HEADER_SIZE - len(region))
        self.out(region)
        self._started = True

    def _go_write(self, data: bytes) -> None:
        self._go_block += data
        while len(self._go_block) >= BLOCK_SIZE:
            block = bytes(self._go_block[:BLOCK_SIZE])
            del self._go_block[:BLOCK_SIZE]
            self.out(block + struct.pack("<I", zlib.crc32(block)))

    def _go_close(self) -> None:
        if self._go_block:
            block = bytes(self._go_block)
            self._go_block.clear()
            self.out(block + struct.pack("<I", zlib.crc32(block)))
        self.out(struct.pack("<Q", self._emitted_block_bytes) + MAGIC)

    # -- our-side incremental parse --------------------------------------

    def write(self, data: bytes) -> None:
        self.buf += data
        progressed = True
        while progressed:
            progressed = False
            if self.state == "preamble":
                # MAGIC(8) version(4) hcrc(4) header(8) scrc(4)
                if len(self.buf) < 28:
                    return
                if bytes(self.buf[:8]) != b"DBTPUSNP":
                    raise ValueError("not a repo snapshot container")
                (self.version,) = struct.unpack_from("<I", self.buf, 8)
                if self.version & 0x100:
                    # a shrunken image's empty payload is bookkeeping,
                    # not state — transcoding it would bypass the
                    # receiver's shrunk guards and wipe the SM
                    raise ValueError(
                        "shrunken snapshot cannot cross the go wire")
                if self.version not in (2, 3):
                    raise ValueError(
                        f"unsupported container version {self.version}")
                (self.slen,) = struct.unpack_from("<Q", self.buf, 16)
                (self.scrc,) = struct.unpack_from("<I", self.buf, 24)
                del self.buf[:28]
                self.state = "session"
                progressed = True
            elif self.state == "session":
                if len(self.buf) < self.slen:
                    return
                session = bytes(self.buf[:self.slen])
                del self.buf[:self.slen]
                if zlib.crc32(session) != self.scrc:
                    raise ValueError("session checksum mismatch")
                import io

                from dragonboat_tpu_torch.rsm.session import LRUSession

                lru = (LRUSession.load(io.BytesIO(session))
                       if session else LRUSession())
                sessions = [
                    (s.client_id, s.responded_to,
                     {k: (r.value, r.data) for k, r in s.history.items()})
                    for s in lru.sessions.values()
                ]
                self._emitted_block_bytes = 0
                out0 = self.out

                def counting(b, _o=out0, _s=self):
                    if _s._started:
                        _s._emitted_block_bytes += len(b)
                    _o(b)

                self.out = counting
                self._emit_header()
                self._go_write(go_session_bank_encode(sessions))
                self.state = "blocks"
                progressed = True
            elif self.state == "blocks":
                if len(self.buf) < 4:
                    return
                (ln,) = struct.unpack_from("<I", self.buf, 0)
                if ln == 0:                 # terminator + payload crc
                    if len(self.buf) < 8:
                        return
                    (expect,) = struct.unpack_from("<I", self.buf, 4)
                    if expect != self.payload_crc:
                        raise ValueError("payload checksum mismatch")
                    del self.buf[:8]
                    self.state = "done"
                    return
                hdr = 9 if self.version >= 3 else 8
                if len(self.buf) < hdr + ln:
                    return
                if self.version >= 3:
                    crc, flag = struct.unpack_from("<IB", self.buf, 4)
                else:
                    (crc,) = struct.unpack_from("<I", self.buf, 4)
                    flag = 0
                stored = bytes(self.buf[hdr:hdr + ln])
                del self.buf[:hdr + ln]
                expect = (zlib.crc32(stored, zlib.crc32(bytes([flag])))
                          if self.version >= 3 else zlib.crc32(stored))
                if expect != crc:
                    raise ValueError("block checksum mismatch")
                block = zlib.decompress(stored) if flag else stored
                self.payload_crc = zlib.crc32(block, self.payload_crc)
                self._go_write(block)
                progressed = True
            else:
                return

    def close(self) -> None:
        if self.state != "done":
            raise ValueError(
                f"stream ended mid-{self.state} (truncated container)")
        self._go_close()
