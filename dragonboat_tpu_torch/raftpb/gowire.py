"""Go-wire interop codec — byte-compatible with the reference raftpb.

The reference serializes its transport/storage types in a HYBRID format:

- ``Message`` / ``MessageBatch`` / ``Snapshot`` / ``Membership`` /
  ``SnapshotFile`` / ``State`` / ``EntryBatch`` are protobuf (gogo
  generated, nullable=false), with the notable gogo property that every
  scalar field is emitted **unconditionally** — zero values included —
  in ascending field order (``reference/raftpb/message.go:32``,
  ``snapshot.go:72``, ``membership.go:29``, ``state.go:27``,
  ``messagebatch.go:23``, ``snapshotfile.go:28``, ``entrybatch.go:25``).
- ``Entry`` is **Colfer** (the hand-optimized
  ``reference/raftpb/raft_optimized.go:161-301``): per-field
  header byte = field number, 0x80 flag selects an 8-byte big-endian
  fixed form for values >= 2**49, little-endian 7-bit varints below,
  zero fields skipped entirely, record terminated by 0x7f.  Entries
  embedded in a protobuf ``Message``/``EntryBatch`` are length-delimited
  Colfer blobs.

This module encodes/decodes the package's own dataclasses
(:mod:`dragonboat_tpu_torch.raftpb`) to and from that wire, so a TPU host can
join a DCN cluster speaking the reference's TCP protocol.  Maps are
emitted in sorted key order (Go's map iteration is random, so any order
is conformant; sorted keeps us deterministic for tests and checksums).

Provenance note for reviewers: the build environment has no Go
toolchain, so the golden fixtures in ``tests/test_gowire.py`` are
hand-traced from the generated marshal code cited above rather than
emitted by the reference binary; each fixture cites the lines it was
traced from.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Sequence

from dragonboat_tpu_torch import raftpb as pb

# --------------------------------------------------------------------------
# protobuf primitives (common.go encodeVarintRaft / sovRaft / skipRaft)
# --------------------------------------------------------------------------


def _uvarint(out: bytearray, x: int) -> None:
    while x >= 0x80:
        out.append((x & 0x7F) | 0x80)
        x >>= 7
    out.append(x)


def _read_uvarint(mv, i: int) -> tuple[int, int]:
    x = 0
    shift = 0
    while True:
        if i >= len(mv):
            raise ValueError("gowire: truncated varint")
        if shift >= 64:
            raise ValueError("gowire: varint overflow")
        b = mv[i]
        i += 1
        x |= (b & 0x7F) << shift
        if b < 0x80:
            return x & 0xFFFFFFFFFFFFFFFF, i
        shift += 7


def _tag(out: bytearray, field: int, wire: int) -> None:
    _uvarint(out, (field << 3) | wire)


def _bool(out: bytearray, v: bool) -> None:
    out.append(1 if v else 0)


def _bytes(out: bytearray, b: bytes) -> None:
    _uvarint(out, len(b))
    out += b


def _read_bytes(mv, i: int) -> tuple[bytes, int]:
    n, i = _read_uvarint(mv, i)
    if i + n > len(mv):
        raise ValueError("gowire: truncated length-delimited field")
    return bytes(mv[i:i + n]), i + n


def _skip_field(mv, i: int, wire: int) -> int:
    """skipRaft: tolerate unknown fields like the generated decoders."""
    if wire == 0:
        _, i = _read_uvarint(mv, i)
        return i
    if wire == 1:
        return i + 8
    if wire == 2:
        n, i = _read_uvarint(mv, i)
        return i + n
    if wire == 5:
        return i + 4
    raise ValueError(f"gowire: unsupported wire type {wire}")


# --------------------------------------------------------------------------
# Entry — Colfer (raft_optimized.go:161-301 marshal, :303-? unmarshal)
# --------------------------------------------------------------------------

_FIXED_THRESHOLD = 1 << 49


def _colfer_u64(out: bytearray, field: int, x: int) -> None:
    if x >= _FIXED_THRESHOLD:
        out.append(field | 0x80)
        out += struct.pack(">Q", x)
    elif x != 0:
        out.append(field)
        _uvarint(out, x)      # colfer varints are the same LE base-128


def _colfer_read_u64(mv, i: int) -> tuple[int, int]:
    """The <2**49 varint arm (up to 8 groups, 9th byte taken whole —
    raft_optimized.go unmarshal ``shift == 56`` break)."""
    if i >= len(mv):
        raise ValueError("gowire: truncated colfer varint")
    x = mv[i]
    i += 1
    if x >= 0x80:
        x &= 0x7F
        shift = 7
        while True:
            if i >= len(mv):
                raise ValueError("gowire: truncated colfer varint")
            b = mv[i]
            i += 1
            if b < 0x80 or shift == 56:
                x |= b << shift
                break
            x |= (b & 0x7F) << shift
            shift += 7
    return x, i


def encode_entry(e: pb.Entry) -> bytes:
    out = bytearray()
    _colfer_u64(out, 0, e.term)
    _colfer_u64(out, 1, e.index)
    t = int(e.type)
    if t != 0:
        # field 2 is int32: negatives take the 0x80 flag + two's
        # complement varint; our EntryType enum is never negative
        out.append(2)
        _uvarint(out, t)
    _colfer_u64(out, 3, e.key)
    _colfer_u64(out, 4, e.client_id)
    _colfer_u64(out, 5, e.series_id)
    _colfer_u64(out, 6, e.responded_to)
    if e.cmd:
        out.append(7)
        _uvarint(out, len(e.cmd))
        out += e.cmd
    out.append(0x7F)
    return bytes(out)


def decode_entry(data) -> pb.Entry:
    mv = memoryview(data)
    vals = {0: 0, 1: 0, 2: 0, 3: 0, 4: 0, 5: 0, 6: 0}
    cmd = b""
    i = 0
    if i >= len(mv):
        raise ValueError("gowire: empty entry")
    # colfer decodes fields in ascending order; headers double as both
    # field id and format flag
    for field in range(7):
        if i >= len(mv):
            raise ValueError("gowire: truncated entry")
        h = mv[i]
        if h == field:
            i += 1
            vals[field], i = _colfer_read_u64(mv, i)
        elif h == (field | 0x80) and field != 2:
            i += 1
            if i + 8 > len(mv):
                raise ValueError("gowire: truncated entry fixed64")
            vals[field] = struct.unpack_from(">Q", mv, i)[0]
            i += 8
        elif h == (2 | 0x80) and field == 2:
            # negative int32: Go marshals the magnitude (^v+1), so the
            # decoded varint IS |v| — not producible by valid EntryTypes
            i += 1
            x, i = _colfer_read_u64(mv, i)
            vals[2] = -x
    if i < len(mv) and mv[i] == 7:
        i += 1
        n, i = _colfer_read_u64(mv, i)
        if i + n > len(mv):
            raise ValueError("gowire: truncated entry cmd")
        cmd = bytes(mv[i:i + n])
        i += n
    if i >= len(mv) or mv[i] != 0x7F:
        raise ValueError("gowire: entry missing 0x7f terminator")
    return pb.Entry(
        term=vals[0], index=vals[1], type=pb.EntryType(vals[2]),
        key=vals[3], client_id=vals[4], series_id=vals[5],
        responded_to=vals[6], cmd=cmd)


def encode_entry_batch(entries: Sequence[pb.Entry]) -> bytes:
    out = bytearray()
    for e in entries:
        _tag(out, 1, 2)
        _bytes(out, encode_entry(e))
    return bytes(out)


def decode_entry_batch(data) -> tuple[pb.Entry, ...]:
    mv = memoryview(data)
    i = 0
    ents = []
    while i < len(mv):
        key, i = _read_uvarint(mv, i)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 2:
            blob, i = _read_bytes(mv, i)
            ents.append(decode_entry(blob))
        else:
            i = _skip_field(mv, i, wire)
    return tuple(ents)


# --------------------------------------------------------------------------
# State (state.go:27) — every field always emitted
# --------------------------------------------------------------------------


def encode_state(s: pb.State) -> bytes:
    out = bytearray()
    _tag(out, 1, 0)
    _uvarint(out, s.term)
    _tag(out, 2, 0)
    _uvarint(out, s.vote)
    _tag(out, 3, 0)
    _uvarint(out, s.commit)
    return bytes(out)


def decode_state(data) -> pb.State:
    mv = memoryview(data)
    i = 0
    term = vote = commit = 0
    while i < len(mv):
        key, i = _read_uvarint(mv, i)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 0:
            term, i = _read_uvarint(mv, i)
        elif field == 2 and wire == 0:
            vote, i = _read_uvarint(mv, i)
        elif field == 3 and wire == 0:
            commit, i = _read_uvarint(mv, i)
        else:
            i = _skip_field(mv, i, wire)
    return pb.State(term=term, vote=vote, commit=commit)


# --------------------------------------------------------------------------
# Membership (membership.go:29): ccid(1), addresses(2), removed(3),
# non_votings(4), witnesses(5); map entries are {key:1 varint,
# value:2 string | bool}
# --------------------------------------------------------------------------


def _map_str(out: bytearray, field: int, m: dict[int, str]) -> None:
    for k in sorted(m):
        v = m[k].encode()
        _tag(out, field, 2)
        inner = bytearray()
        _tag(inner, 1, 0)
        _uvarint(inner, k)
        _tag(inner, 2, 2)
        _bytes(inner, v)
        _bytes(out, bytes(inner))


def _read_map_str(mv, i: int) -> tuple[int, str, int]:
    blob, i = _read_bytes(mv, i)
    k, v = 0, b""
    j = 0
    while j < len(blob):
        key, j = _read_uvarint(blob, j)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 0:
            k, j = _read_uvarint(blob, j)
        elif field == 2 and wire == 2:
            v, j = _read_bytes(blob, j)
        else:
            j = _skip_field(blob, j, wire)
    return k, v.decode(), i


def encode_membership(m: pb.Membership) -> bytes:
    out = bytearray()
    _tag(out, 1, 0)
    _uvarint(out, m.config_change_id)
    _map_str(out, 2, m.addresses)
    for k in sorted(m.removed):
        _tag(out, 3, 2)
        inner = bytearray()
        _tag(inner, 1, 0)
        _uvarint(inner, k)
        _tag(inner, 2, 0)
        _bool(inner, m.removed[k])
        _bytes(out, bytes(inner))
    _map_str(out, 4, m.non_votings)
    _map_str(out, 5, m.witnesses)
    return bytes(out)


def decode_membership(data) -> pb.Membership:
    mv = memoryview(data)
    i = 0
    ccid = 0
    addresses: dict[int, str] = {}
    removed: dict[int, bool] = {}
    non_votings: dict[int, str] = {}
    witnesses: dict[int, str] = {}
    while i < len(mv):
        key, i = _read_uvarint(mv, i)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 0:
            ccid, i = _read_uvarint(mv, i)
        elif field == 2 and wire == 2:
            k, v, i = _read_map_str(mv, i)
            addresses[k] = v
        elif field == 3 and wire == 2:
            blob, i = _read_bytes(mv, i)
            k, v = 0, False
            j = 0
            while j < len(blob):
                bkey, j = _read_uvarint(blob, j)
                bf, bw = bkey >> 3, bkey & 7
                if bf == 1 and bw == 0:
                    k, j = _read_uvarint(blob, j)
                elif bf == 2 and bw == 0:
                    b, j = _read_uvarint(blob, j)
                    v = bool(b)
                else:
                    j = _skip_field(blob, j, bw)
            removed[k] = v
        elif field == 4 and wire == 2:
            k, v, i = _read_map_str(mv, i)
            non_votings[k] = v
        elif field == 5 and wire == 2:
            k, v, i = _read_map_str(mv, i)
            witnesses[k] = v
        else:
            i = _skip_field(mv, i, wire)
    return pb.Membership(config_change_id=ccid, addresses=addresses,
                         removed=removed, non_votings=non_votings,
                         witnesses=witnesses)


# --------------------------------------------------------------------------
# SnapshotFile (snapshotfile.go:28): filepath(2), file_size(3),
# file_id(4), metadata(5, only when non-nil)
# --------------------------------------------------------------------------


def encode_snapshot_file(f: pb.SnapshotFile) -> bytes:
    out = bytearray()
    _tag(out, 2, 2)
    _bytes(out, f.filepath.encode())
    _tag(out, 3, 0)
    _uvarint(out, f.file_size)
    _tag(out, 4, 0)
    _uvarint(out, f.file_id)
    if f.metadata:
        _tag(out, 5, 2)
        _bytes(out, f.metadata)
    return bytes(out)


def decode_snapshot_file(data) -> pb.SnapshotFile:
    mv = memoryview(data)
    i = 0
    fp, size, fid, meta = b"", 0, 0, b""
    while i < len(mv):
        key, i = _read_uvarint(mv, i)
        field, wire = key >> 3, key & 7
        if field == 2 and wire == 2:
            fp, i = _read_bytes(mv, i)
        elif field == 3 and wire == 0:
            size, i = _read_uvarint(mv, i)
        elif field == 4 and wire == 0:
            fid, i = _read_uvarint(mv, i)
        elif field == 5 and wire == 2:
            meta, i = _read_bytes(mv, i)
        else:
            i = _skip_field(mv, i, wire)
    return pb.SnapshotFile(file_id=fid, filepath=fp.decode(),
                           metadata=meta, file_size=size)


# --------------------------------------------------------------------------
# Snapshot (snapshot.go:72): filepath(2) .. witness(14); checksum(8)
# only when non-nil, files(7) repeated; everything else always emitted
# --------------------------------------------------------------------------


def encode_snapshot(s: pb.Snapshot) -> bytes:
    out = bytearray()
    _tag(out, 2, 2)
    _bytes(out, s.filepath.encode())
    _tag(out, 3, 0)
    _uvarint(out, s.file_size)
    _tag(out, 4, 0)
    _uvarint(out, s.index)
    _tag(out, 5, 0)
    _uvarint(out, s.term)
    _tag(out, 6, 2)
    _bytes(out, encode_membership(s.membership))
    for f in s.files:
        _tag(out, 7, 2)
        _bytes(out, encode_snapshot_file(f))
    if s.checksum:
        _tag(out, 8, 2)
        _bytes(out, s.checksum)
    _tag(out, 9, 0)
    _bool(out, s.dummy)
    _tag(out, 10, 0)
    _uvarint(out, s.shard_id)
    _tag(out, 11, 0)
    _uvarint(out, int(s.type))
    _tag(out, 12, 0)
    _bool(out, s.imported)
    _tag(out, 13, 0)
    _uvarint(out, s.on_disk_index)
    _tag(out, 14, 0)
    _bool(out, s.witness)
    return bytes(out)


def decode_snapshot(data) -> pb.Snapshot:
    mv = memoryview(data)
    i = 0
    kw: dict = {"membership": pb.Membership(), "files": []}
    while i < len(mv):
        key, i = _read_uvarint(mv, i)
        field, wire = key >> 3, key & 7
        if field == 2 and wire == 2:
            b, i = _read_bytes(mv, i)
            kw["filepath"] = b.decode()
        elif field == 3 and wire == 0:
            kw["file_size"], i = _read_uvarint(mv, i)
        elif field == 4 and wire == 0:
            kw["index"], i = _read_uvarint(mv, i)
        elif field == 5 and wire == 0:
            kw["term"], i = _read_uvarint(mv, i)
        elif field == 6 and wire == 2:
            b, i = _read_bytes(mv, i)
            kw["membership"] = decode_membership(b)
        elif field == 7 and wire == 2:
            b, i = _read_bytes(mv, i)
            kw["files"].append(decode_snapshot_file(b))
        elif field == 8 and wire == 2:
            kw["checksum"], i = _read_bytes(mv, i)
        elif field == 9 and wire == 0:
            v, i = _read_uvarint(mv, i)
            kw["dummy"] = bool(v)
        elif field == 10 and wire == 0:
            kw["shard_id"], i = _read_uvarint(mv, i)
        elif field == 11 and wire == 0:
            v, i = _read_uvarint(mv, i)
            kw["type"] = pb.StateMachineType(v)
        elif field == 12 and wire == 0:
            v, i = _read_uvarint(mv, i)
            kw["imported"] = bool(v)
        elif field == 13 and wire == 0:
            kw["on_disk_index"], i = _read_uvarint(mv, i)
        elif field == 14 and wire == 0:
            v, i = _read_uvarint(mv, i)
            kw["witness"] = bool(v)
        else:
            i = _skip_field(mv, i, wire)
    kw["files"] = tuple(kw["files"])
    return pb.Snapshot(**kw)


# --------------------------------------------------------------------------
# Message (message.go:32): type(1) .. hint(10) always; entries(11)
# repeated Colfer blobs; snapshot(12) always; hint_high(13) always
# --------------------------------------------------------------------------


def encode_message(m: pb.Message) -> bytes:
    out = bytearray()
    _tag(out, 1, 0)
    _uvarint(out, int(m.type))
    _tag(out, 2, 0)
    _uvarint(out, m.to)
    _tag(out, 3, 0)
    _uvarint(out, m.from_)
    _tag(out, 4, 0)
    _uvarint(out, m.shard_id)
    _tag(out, 5, 0)
    _uvarint(out, m.term)
    _tag(out, 6, 0)
    _uvarint(out, m.log_term)
    _tag(out, 7, 0)
    _uvarint(out, m.log_index)
    _tag(out, 8, 0)
    _uvarint(out, m.commit)
    _tag(out, 9, 0)
    _bool(out, m.reject)
    _tag(out, 10, 0)
    _uvarint(out, m.hint)
    for e in m.entries:
        _tag(out, 11, 2)
        _bytes(out, encode_entry(e))
    _tag(out, 12, 2)
    _bytes(out, encode_snapshot(m.snapshot))
    _tag(out, 13, 0)
    _uvarint(out, m.hint_high)
    return bytes(out)


def decode_message(data) -> pb.Message:
    mv = memoryview(data)
    i = 0
    kw: dict = {"entries": []}
    while i < len(mv):
        key, i = _read_uvarint(mv, i)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 0:
            v, i = _read_uvarint(mv, i)
            kw["type"] = pb.MessageType(v)
        elif field == 2 and wire == 0:
            kw["to"], i = _read_uvarint(mv, i)
        elif field == 3 and wire == 0:
            kw["from_"], i = _read_uvarint(mv, i)
        elif field == 4 and wire == 0:
            kw["shard_id"], i = _read_uvarint(mv, i)
        elif field == 5 and wire == 0:
            kw["term"], i = _read_uvarint(mv, i)
        elif field == 6 and wire == 0:
            kw["log_term"], i = _read_uvarint(mv, i)
        elif field == 7 and wire == 0:
            kw["log_index"], i = _read_uvarint(mv, i)
        elif field == 8 and wire == 0:
            v, i = _read_uvarint(mv, i)
            kw["commit"] = v
        elif field == 9 and wire == 0:
            v, i = _read_uvarint(mv, i)
            kw["reject"] = bool(v)
        elif field == 10 and wire == 0:
            kw["hint"], i = _read_uvarint(mv, i)
        elif field == 11 and wire == 2:
            b, i = _read_bytes(mv, i)
            kw["entries"].append(decode_entry(b))
        elif field == 12 and wire == 2:
            b, i = _read_bytes(mv, i)
            kw["snapshot"] = decode_snapshot(b)
        elif field == 13 and wire == 0:
            kw["hint_high"], i = _read_uvarint(mv, i)
        else:
            i = _skip_field(mv, i, wire)
    kw["entries"] = tuple(kw["entries"])
    return pb.Message(**kw)


# --------------------------------------------------------------------------
# MessageBatch (messagebatch.go:23): requests(1) repeated;
# deployment_id(2), source_address(3), bin_ver(4) always
# --------------------------------------------------------------------------


# the fabric trace header rides an unknown-to-the-reference field: the
# gogo decoder (and ours) skips any unrecognized tag, so a reference
# peer sees nothing and an old frame simply carries no header
FABRIC_FIELD = 15


def encode_message_batch(requests: Sequence[pb.Message],
                         deployment_id: int = 0,
                         source_address: str = "",
                         bin_ver: int = 0,
                         fabric: bytes | None = None) -> bytes:
    out = bytearray()
    for m in requests:
        _tag(out, 1, 2)
        _bytes(out, encode_message(m))
    _tag(out, 2, 0)
    _uvarint(out, deployment_id)
    _tag(out, 3, 2)
    _bytes(out, source_address.encode())
    _tag(out, 4, 0)
    _uvarint(out, bin_ver)
    if fabric is not None:
        _tag(out, FABRIC_FIELD, 2)
        _bytes(out, fabric)
    return bytes(out)


def decode_message_batch(data) -> tuple[
        tuple[pb.Message, ...], int, str, int, bytes | None]:
    """-> (requests, deployment_id, source_address, bin_ver, fabric) —
    ``fabric`` is the raw version-prefixed header blob (field 15) or
    None when the frame carries no header (old peers)."""
    mv = memoryview(data)
    i = 0
    msgs: list[pb.Message] = []
    dep, src, ver = 0, "", 0
    fabric: bytes | None = None
    while i < len(mv):
        key, i = _read_uvarint(mv, i)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 2:
            b, i = _read_bytes(mv, i)
            msgs.append(decode_message(b))
        elif field == 2 and wire == 0:
            dep, i = _read_uvarint(mv, i)
        elif field == 3 and wire == 2:
            b, i = _read_bytes(mv, i)
            src = b.decode()
        elif field == 4 and wire == 0:
            ver, i = _read_uvarint(mv, i)
        elif field == FABRIC_FIELD and wire == 2:
            b, i = _read_bytes(mv, i)
            fabric = bytes(b)
        else:
            i = _skip_field(mv, i, wire)
    return tuple(msgs), dep, src, ver, fabric


# --------------------------------------------------------------------------
# Chunk (chunk.go:44-146 MarshalTo): the snapshot-stream record a Go
# fleet ships on its snapshot connections.  Same unconditional-emit
# framing as the other gogo records; note there is NO field 11.
# --------------------------------------------------------------------------

# raft.go:256-261: streamed transfers don't know their total up front —
# the tail chunk carries the LastChunkCount sentinel instead
LAST_CHUNK_COUNT = (1 << 64) - 1
POISON_CHUNK_COUNT = (1 << 64) - 2
# raftio/binversion.go:30: the reference REJECTS received batches and
# chunks whose BinVer differs (transport.go:312, chunk.go:108) — every
# outbound go-wire record must stamp this
TRANSPORT_BIN_VERSION = 210


@dataclasses.dataclass(frozen=True)
class GoChunk:
    """The reference's pb.Chunk, reference field layout (chunk.go:11-31).
    Deliberately distinct from the repo's own ``raftpb.Chunk`` (native
    wire: concatenated stream + embedded chunk-0 message) — the Go wire
    splits PER FILE and synthesizes the InstallSnapshot receiver-side."""

    shard_id: int = 0
    replica_id: int = 0          # target
    from_: int = 0               # sender replica
    chunk_id: int = 0
    chunk_size: int = 0
    chunk_count: int = 0
    data: bytes = b""
    index: int = 0
    term: int = 0
    membership: pb.Membership = dataclasses.field(
        default_factory=pb.Membership)
    filepath: str = ""
    file_size: int = 0
    deployment_id: int = 0
    file_chunk_id: int = 0
    file_chunk_count: int = 0
    has_file_info: bool = False
    file_info: pb.SnapshotFile = dataclasses.field(
        default_factory=lambda: pb.SnapshotFile(file_id=0, filepath=""))
    bin_ver: int = TRANSPORT_BIN_VERSION
    on_disk_index: int = 0
    witness: bool = False

    def is_last(self) -> bool:
        # IsLastChunk (raft.go:267): counted transfers end at
        # chunk_count == chunk_id+1; streamed ones at the sentinel
        return (self.chunk_count == LAST_CHUNK_COUNT
                or self.chunk_count == self.chunk_id + 1)

    def is_last_file_chunk(self) -> bool:
        # IsLastFileChunk (raft.go:273)
        return self.file_chunk_id + 1 == self.file_chunk_count

    def is_poison(self) -> bool:
        return self.chunk_count == POISON_CHUNK_COUNT


def encode_chunk(c: GoChunk) -> bytes:
    out = bytearray()
    _tag(out, 1, 0)
    _uvarint(out, c.shard_id)
    _tag(out, 2, 0)
    _uvarint(out, c.replica_id)
    _tag(out, 3, 0)
    _uvarint(out, c.from_)
    _tag(out, 4, 0)
    _uvarint(out, c.chunk_id)
    _tag(out, 5, 0)
    _uvarint(out, c.chunk_size)
    _tag(out, 6, 0)
    _uvarint(out, c.chunk_count)
    if c.data:
        _tag(out, 7, 2)
        _bytes(out, c.data)
    _tag(out, 8, 0)
    _uvarint(out, c.index)
    _tag(out, 9, 0)
    _uvarint(out, c.term)
    _tag(out, 10, 2)
    _bytes(out, encode_membership(c.membership))
    _tag(out, 12, 2)
    _bytes(out, c.filepath.encode())
    _tag(out, 13, 0)
    _uvarint(out, c.file_size)
    _tag(out, 14, 0)
    _uvarint(out, c.deployment_id)
    _tag(out, 15, 0)
    _uvarint(out, c.file_chunk_id)
    _tag(out, 16, 0)
    _uvarint(out, c.file_chunk_count)
    _tag(out, 17, 0)
    _bool(out, c.has_file_info)
    _tag(out, 18, 2)
    _bytes(out, encode_snapshot_file(c.file_info))
    _tag(out, 19, 0)
    _uvarint(out, c.bin_ver)
    _tag(out, 20, 0)
    _uvarint(out, c.on_disk_index)
    _tag(out, 21, 0)
    _bool(out, c.witness)
    return bytes(out)


def decode_chunk(data) -> GoChunk:
    mv = memoryview(data)
    i = 0
    kw: dict = {}
    while i < len(mv):
        key, i = _read_uvarint(mv, i)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 0:
            kw["shard_id"], i = _read_uvarint(mv, i)
        elif field == 2 and wire == 0:
            kw["replica_id"], i = _read_uvarint(mv, i)
        elif field == 3 and wire == 0:
            kw["from_"], i = _read_uvarint(mv, i)
        elif field == 4 and wire == 0:
            kw["chunk_id"], i = _read_uvarint(mv, i)
        elif field == 5 and wire == 0:
            kw["chunk_size"], i = _read_uvarint(mv, i)
        elif field == 6 and wire == 0:
            kw["chunk_count"], i = _read_uvarint(mv, i)
        elif field == 7 and wire == 2:
            kw["data"], i = _read_bytes(mv, i)
        elif field == 8 and wire == 0:
            kw["index"], i = _read_uvarint(mv, i)
        elif field == 9 and wire == 0:
            kw["term"], i = _read_uvarint(mv, i)
        elif field == 10 and wire == 2:
            b, i = _read_bytes(mv, i)
            kw["membership"] = decode_membership(b)
        elif field == 12 and wire == 2:
            b, i = _read_bytes(mv, i)
            kw["filepath"] = b.decode()
        elif field == 13 and wire == 0:
            kw["file_size"], i = _read_uvarint(mv, i)
        elif field == 14 and wire == 0:
            kw["deployment_id"], i = _read_uvarint(mv, i)
        elif field == 15 and wire == 0:
            kw["file_chunk_id"], i = _read_uvarint(mv, i)
        elif field == 16 and wire == 0:
            kw["file_chunk_count"], i = _read_uvarint(mv, i)
        elif field == 17 and wire == 0:
            v, i = _read_uvarint(mv, i)
            kw["has_file_info"] = bool(v)
        elif field == 18 and wire == 2:
            b, i = _read_bytes(mv, i)
            kw["file_info"] = decode_snapshot_file(b)
        elif field == 19 and wire == 0:
            kw["bin_ver"], i = _read_uvarint(mv, i)
        elif field == 20 and wire == 0:
            kw["on_disk_index"], i = _read_uvarint(mv, i)
        elif field == 21 and wire == 0:
            v, i = _read_uvarint(mv, i)
            kw["witness"] = bool(v)
        else:
            i = _skip_field(mv, i, wire)
    return GoChunk(**kw)
