"""dragonboat_tpu_torch.raftpb — the wire/state record algebra of the framework.

TPU-native re-expression of the reference's ``raftpb`` package
(``reference/raftpb/``).  The reference hand-rolls protobuf structs
(``raftpb/message.go:6-20``, ``raftpb/entry.go:6-15``, ``raftpb/state.go:11``,
``raftpb/update.go:74-112``); here the same algebra exists in two forms:

1. **Host records** (this module): frozen dataclasses used by the host runtime
   (NodeHost, LogDB, transport, RSM).  These carry variable-length payloads
   (``Entry.cmd``, membership maps, snapshots) that never live on device.
2. **Device lanes** (``dragonboat_tpu_torch.core``): fixed-width SoA arrays holding
   the subset of fields the batched Raft kernel needs (terms, indexes,
   cursors, flow-control state).  The kernel engine's staging buffers
   (``engine.kernel_engine._InboxBuilder`` / ``_InputBuilder``) and the
   device router (``core.router``) convert between the two.

Enum values mirror the reference exactly (``raftpb/types.go:8-215``) so that
recorded histories, golden tests, and host interop stay comparable.
"""

from __future__ import annotations

import enum
import struct
import zlib
from dataclasses import dataclass, field, replace
from typing import Iterable, Sequence


class MessageType(enum.IntEnum):
    """Raft message algebra — parity with reference/raftpb/types.go:8-38."""

    LOCAL_TICK = 0
    ELECTION = 1
    LEADER_HEARTBEAT = 2
    CONFIG_CHANGE_EVENT = 3
    NOOP = 4
    PING = 5
    PONG = 6
    PROPOSE = 7
    SNAPSHOT_STATUS = 8
    UNREACHABLE = 9
    CHECK_QUORUM = 10
    BATCHED_READ_INDEX = 11
    REPLICATE = 12
    REPLICATE_RESP = 13
    REQUEST_VOTE = 14
    REQUEST_VOTE_RESP = 15
    INSTALL_SNAPSHOT = 16
    HEARTBEAT = 17
    HEARTBEAT_RESP = 18
    READ_INDEX = 19
    READ_INDEX_RESP = 20
    QUIESCE = 21
    SNAPSHOT_RECEIVED = 22
    LEADER_TRANSFER = 23
    TIMEOUT_NOW = 24
    RATE_LIMIT = 25
    REQUEST_PREVOTE = 26
    REQUEST_PREVOTE_RESP = 27
    LOG_QUERY = 28


NUM_MESSAGE_TYPES = 29


class EntryType(enum.IntEnum):
    """Parity with reference/raftpb/types.go:110-115."""

    APPLICATION = 0
    CONFIG_CHANGE = 1
    ENCODED = 2
    METADATA = 3


class ConfigChangeType(enum.IntEnum):
    """Parity with reference/raftpb/types.go:137-142."""

    ADD_NODE = 0
    REMOVE_NODE = 1
    ADD_NON_VOTING = 2
    ADD_WITNESS = 3


class StateMachineType(enum.IntEnum):
    """Parity with reference/raftpb/types.go:164-169."""

    UNKNOWN = 0
    REGULAR = 1
    CONCURRENT = 2
    ON_DISK = 3


class CompressionType(enum.IntEnum):
    NO_COMPRESSION = 0
    SNAPPY = 1  # host payloads use zlib when snappy unavailable; tagged distinctly


class ChecksumType(enum.IntEnum):
    CRC32IEEE = 0
    HIGHWAY = 1


# Client-session sentinel values — parity with client/session.go semantics:
# a NoOP session proposal carries SeriesID==NoOPSeriesID and is not deduped.
NOOP_SERIES_ID = 0
SERIES_ID_FIRST_PROPOSAL = 1
# SeriesID used by a client to unregister its session.
SERIES_ID_FOR_UNREGISTER = (1 << 64) - 1
SERIES_ID_FOR_REGISTER = (1 << 64) - 2

U64_MASK = (1 << 64) - 1


@dataclass(frozen=True, slots=True)
class Entry:
    """One raft log entry — parity with reference/raftpb/entry.go:6-15."""

    term: int = 0
    index: int = 0
    type: EntryType = EntryType.APPLICATION
    key: int = 0
    client_id: int = 0
    series_id: int = 0
    responded_to: int = 0
    cmd: bytes = b""

    def is_empty(self) -> bool:
        return len(self.cmd) == 0

    def is_config_change(self) -> bool:
        return self.type == EntryType.CONFIG_CHANGE

    def is_session_managed(self) -> bool:
        # parity: raftpb/raft.go IsSessionManaged — config change entries and
        # NoOP-session client ops are not session managed.
        if self.is_config_change():
            return False
        return self.client_id != 0 or self.series_id != NOOP_SERIES_ID

    def is_noop_session(self) -> bool:
        return self.series_id == NOOP_SERIES_ID

    def is_new_session_request(self) -> bool:
        return (
            not self.is_config_change()
            and len(self.cmd) == 0
            and self.client_id != 0
            and self.series_id == SERIES_ID_FOR_REGISTER
        )

    def is_end_of_session_request(self) -> bool:
        return (
            not self.is_config_change()
            and len(self.cmd) == 0
            and self.client_id != 0
            and self.series_id == SERIES_ID_FOR_UNREGISTER
        )

    def is_update(self) -> bool:
        return (
            not self.is_config_change()
            and not self.is_new_session_request()
            and not self.is_end_of_session_request()
        )

    def is_proposal(self) -> bool:
        return not self.is_config_change()


@dataclass(frozen=True, slots=True)
class State:
    """Persistent raft state — parity with reference/raftpb/state.go:11."""

    term: int = 0
    vote: int = 0
    commit: int = 0

    def is_empty(self) -> bool:
        return self == State()


@dataclass(frozen=True, slots=True)
class Membership:
    """Replicated membership — parity with reference/raftpb/membership.go:11-17."""

    config_change_id: int = 0
    addresses: dict[int, str] = field(default_factory=dict)  # voters
    non_votings: dict[int, str] = field(default_factory=dict)
    witnesses: dict[int, str] = field(default_factory=dict)
    removed: dict[int, bool] = field(default_factory=dict)

    def copy(self) -> "Membership":
        return Membership(
            self.config_change_id,
            dict(self.addresses),
            dict(self.non_votings),
            dict(self.witnesses),
            dict(self.removed),
        )


@dataclass(frozen=True, slots=True)
class ConfigChange:
    """Parity with the reference's raftpb.ConfigChange payload."""

    config_change_id: int = 0
    type: ConfigChangeType = ConfigChangeType.ADD_NODE
    replica_id: int = 0
    address: str = ""
    initialize: bool = False


@dataclass(frozen=True, slots=True)
class SnapshotFile:
    """External file attached to a snapshot (rsm/files.go parity)."""

    file_id: int = 0
    filepath: str = ""
    metadata: bytes = b""
    file_size: int = 0


@dataclass(frozen=True, slots=True)
class Snapshot:
    """Snapshot metadata — parity with reference/raftpb/snapshot.go:16-60."""

    filepath: str = ""
    file_size: int = 0
    index: int = 0
    term: int = 0
    membership: Membership = field(default_factory=Membership)
    files: tuple[SnapshotFile, ...] = ()
    checksum: bytes = b""
    dummy: bool = False
    shard_id: int = 0
    type: StateMachineType = StateMachineType.UNKNOWN
    imported: bool = False
    on_disk_index: int = 0
    witness: bool = False

    def is_empty(self) -> bool:
        return self.index == 0


@dataclass(frozen=True, slots=True)
class Bootstrap:
    """Initial membership record — parity with raftpb.Bootstrap."""

    addresses: dict[int, str] = field(default_factory=dict)
    join: bool = False
    type: StateMachineType = StateMachineType.REGULAR


@dataclass(frozen=True, slots=True)
class SystemCtx:
    """ReadIndex context pair — parity with raftpb.SystemCtx {Low, High}."""

    low: int = 0
    high: int = 0


@dataclass(frozen=True, slots=True)
class ReadyToRead:
    index: int = 0
    system_ctx: SystemCtx = field(default_factory=SystemCtx)


@dataclass(frozen=True, slots=True)
class Message:
    """Parity with reference/raftpb/message.go:6-20."""

    type: MessageType = MessageType.NOOP
    to: int = 0
    from_: int = 0
    shard_id: int = 0
    term: int = 0
    log_term: int = 0
    log_index: int = 0
    commit: int = 0
    reject: bool = False
    hint: int = 0
    hint_high: int = 0
    entries: tuple[Entry, ...] = ()
    snapshot: Snapshot = field(default_factory=Snapshot)

    def is_local(self) -> bool:
        """Local-only message types never cross the transport
        (parity: raftpb/raft.go IsLocalMessageType)."""
        return self.type in _LOCAL_TYPES

    def is_response(self) -> bool:
        return self.type in _RESPONSE_TYPES


_LOCAL_TYPES = frozenset(
    {
        MessageType.ELECTION,
        MessageType.LEADER_HEARTBEAT,
        MessageType.UNREACHABLE,
        MessageType.SNAPSHOT_STATUS,
        MessageType.CHECK_QUORUM,
        MessageType.LOCAL_TICK,
        MessageType.BATCHED_READ_INDEX,
        MessageType.SNAPSHOT_RECEIVED,
        MessageType.RATE_LIMIT,
        MessageType.LOG_QUERY,
    }
)

_RESPONSE_TYPES = frozenset(
    {
        MessageType.REPLICATE_RESP,
        MessageType.REQUEST_VOTE_RESP,
        MessageType.HEARTBEAT_RESP,
        MessageType.READ_INDEX_RESP,
        MessageType.REQUEST_PREVOTE_RESP,
    }
)


@dataclass(frozen=True, slots=True)
class FabricContext:
    """One sampled proposal's trace context riding a transport frame
    (fabric.py cross-host propagation): the lifecycle trace key, the
    origin NodeHost address, the shard, and the host-hub hop count so
    far.  ``origin == receiver`` marks a context returning home (the
    quorum ack), anything else an outbound replicate."""

    key: int = 0
    origin: str = ""
    hop: int = 0
    shard_id: int = 0


@dataclass(frozen=True, slots=True)
class FabricHeader:
    """Versioned optional trace header on a MessageBatch.  Absent by
    default — old frames (and old peers) carry/see nothing; the native
    wire appends it as a magic-guarded trailer the old decoder ignores,
    the go wire ships it in an unknown-to-the-reference protobuf field
    its decoder skips.  ``sent_us`` is the sender's injected monotonic
    clock at flush time (per-link delivery-latency attribution)."""

    version: int = 1
    sent_us: int = 0
    ctxs: tuple[FabricContext, ...] = ()


# bump when the FabricContext layout changes; decoders return None for
# versions they do not understand (mixed-version clusters interop — the
# header degrades to absent, never to a parse error)
FABRIC_WIRE_VERSION = 1
# native-wire trailer guard: little-endian b"FBH1" after the message
# array (still inside the CRC-covered body)
_FABRIC_MAGIC = 0x31484246


def encode_fabric_header(h: FabricHeader) -> bytes:
    """Version-prefixed header blob shared by both wire formats."""
    buf = bytearray(struct.pack("<BQI", h.version, h.sent_us, len(h.ctxs)))
    for c in h.ctxs:
        o = c.origin.encode()
        buf += struct.pack("<QQII", c.key, c.shard_id, c.hop, len(o))
        buf += o
    return bytes(buf)


def decode_fabric_header(data) -> FabricHeader | None:
    """None for an unknown version (forward compat), raises on a
    truncated blob of a known version (corruption, not skew)."""
    mv = memoryview(data)
    version, sent_us, n = struct.unpack_from("<BQI", mv, 0)
    if version != FABRIC_WIRE_VERSION:
        return None
    off = 13
    ctxs = []
    for _ in range(n):
        key, shard_id, hop, olen = struct.unpack_from("<QQII", mv, off)
        off += 24
        origin = bytes(mv[off:off + olen]).decode()
        if len(origin.encode()) != olen:
            raise ValueError("fabric header truncated")
        off += olen
        ctxs.append(FabricContext(key=key, origin=origin, hop=hop,
                                  shard_id=shard_id))
    return FabricHeader(version=version, sent_us=sent_us, ctxs=tuple(ctxs))


@dataclass(frozen=True, slots=True)
class MessageBatch:
    """Transport frame — parity with raftpb/messagebatch.go:6, plus the
    optional fabric trace header (absent on old frames)."""

    requests: tuple[Message, ...] = ()
    deployment_id: int = 0
    source_address: str = ""
    bin_ver: int = 0
    fabric: FabricHeader | None = None


@dataclass(frozen=True, slots=True)
class LeaderUpdate:
    leader_id: int = 0
    term: int = 0


@dataclass(frozen=True, slots=True)
class LogQueryResult:
    error: int = 0  # 0 ok, 1 out of range, 2 unavailable
    first_index: int = 0
    last_index: int = 0
    entries: tuple[Entry, ...] = ()


@dataclass(frozen=True, slots=True)
class UpdateCommit:
    """Parity with reference/raftpb/update.go:60-72."""

    processed: int = 0
    last_applied: int = 0
    stable_log_to: int = 0
    stable_log_term: int = 0
    stable_snapshot_to: int = 0
    ready_to_read: int = 0


@dataclass(frozen=True, slots=True)
class Update:
    """Device→host result batch for one shard —
    parity with reference/raftpb/update.go:74-112."""

    shard_id: int = 0
    replica_id: int = 0
    state: State = field(default_factory=State)
    fast_apply: bool = False
    entries_to_save: tuple[Entry, ...] = ()
    committed_entries: tuple[Entry, ...] = ()
    more_committed_entries: bool = False
    snapshot: Snapshot = field(default_factory=Snapshot)
    ready_to_reads: tuple[ReadyToRead, ...] = ()
    messages: tuple[Message, ...] = ()
    last_applied: int = 0
    update_commit: UpdateCommit = field(default_factory=UpdateCommit)
    dropped_entries: tuple[Entry, ...] = ()
    dropped_read_indexes: tuple[SystemCtx, ...] = ()
    log_query_result: LogQueryResult = field(default_factory=LogQueryResult)
    leader_update: LeaderUpdate | None = None

    def has_update(self) -> bool:
        return bool(
            not self.state.is_empty()
            or self.entries_to_save
            or self.committed_entries
            or self.messages
            or self.ready_to_reads
            or not self.snapshot.is_empty()
            or self.dropped_entries
            or self.dropped_read_indexes
            or self.leader_update is not None
        )


# ---------------------------------------------------------------------------
# Serialization.
#
# The reference uses hand-optimized protobuf wire format
# (raftpb/raft_optimized.go).  Interop with Go processes is a non-goal for the
# TPU build; what matters is a stable, checksummed, compact binary format for
# (a) the LogDB on-disk layout, (b) the TCP transport frames, (c) golden tests.
# We use a little-endian fixed-header format: cheap to encode from Python and
# trivially fuzzable.  All varints in the reference become fixed u64 here —
# entries are dominated by payloads, and storage batches are compressed.
# ---------------------------------------------------------------------------

_ENTRY_HDR = struct.Struct("<QQBQQQQI")  # term,index,type,key,client,series,responded,cmdlen
_MSG_HDR = struct.Struct("<BQQQQQQQBQQII")  # type,to,from,shard,term,logterm,logindex,commit,reject,hint,hinthigh,nentries,snaplen
_STATE = struct.Struct("<QQQ")


def encode_entry(e: Entry, buf: bytearray) -> None:
    buf += _ENTRY_HDR.pack(
        e.term, e.index, e.type, e.key, e.client_id, e.series_id, e.responded_to, len(e.cmd)
    )
    buf += e.cmd


def decode_entry(data: memoryview, off: int) -> tuple[Entry, int]:
    term, index, typ, key, client, series, responded, cmdlen = _ENTRY_HDR.unpack_from(data, off)
    off += _ENTRY_HDR.size
    cmd = bytes(data[off : off + cmdlen])
    off += cmdlen
    return (
        Entry(term, index, EntryType(typ), key, client, series, responded, cmd),
        off,
    )


def entry_size(e: Entry) -> int:
    """In-memory size estimate used for rate limiting — parity with
    the reference's Entry.SizeUpperLimit usage in server/rate.go."""
    return _ENTRY_HDR.size + len(e.cmd)


def encode_state(s: State) -> bytes:
    return _STATE.pack(s.term, s.vote, s.commit)


def decode_state(data: bytes) -> State:
    t, v, c = _STATE.unpack(data)
    return State(t, v, c)


def _encode_membership(m: Membership, buf: bytearray) -> None:
    def emap(d: dict[int, str]) -> None:
        buf.extend(struct.pack("<I", len(d)))
        for k in sorted(d):
            v = d[k].encode()
            buf.extend(struct.pack("<QI", k, len(v)))
            buf.extend(v)

    buf.extend(struct.pack("<Q", m.config_change_id))
    emap(m.addresses)
    emap(m.non_votings)
    emap(m.witnesses)
    buf.extend(struct.pack("<I", len(m.removed)))
    for k in sorted(m.removed):
        buf.extend(struct.pack("<Q", k))


def _decode_membership(data: memoryview, off: int) -> tuple[Membership, int]:
    def dmap() -> dict[int, str]:
        nonlocal off
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        out: dict[int, str] = {}
        for _ in range(n):
            k, ln = struct.unpack_from("<QI", data, off)
            off += 12
            out[k] = bytes(data[off : off + ln]).decode()
            off += ln
        return out

    (ccid,) = struct.unpack_from("<Q", data, off)
    off += 8
    addresses = dmap()
    non_votings = dmap()
    witnesses = dmap()
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    removed: dict[int, bool] = {}
    for _ in range(n):
        (k,) = struct.unpack_from("<Q", data, off)
        off += 8
        removed[k] = True
    return Membership(ccid, addresses, non_votings, witnesses, removed), off


_SNAP_HDR = struct.Struct("<QQQQBBBBI")  # index,term,shard,ondisk,dummy,type,imported,witness,pathlen


def encode_snapshot(s: Snapshot, buf: bytearray) -> None:
    p = s.filepath.encode()
    buf += _SNAP_HDR.pack(
        s.index, s.term, s.shard_id, s.on_disk_index,
        int(s.dummy), int(s.type), int(s.imported), int(s.witness), len(p),
    )
    buf += p
    buf += struct.pack("<Q", s.file_size)
    buf += struct.pack("<I", len(s.checksum))
    buf += s.checksum
    _encode_membership(s.membership, buf)
    buf += struct.pack("<I", len(s.files))
    for f in s.files:
        fp = f.filepath.encode()
        buf += struct.pack("<QQII", f.file_id, f.file_size, len(fp),
                           len(f.metadata))
        buf += fp
        buf += f.metadata


def decode_snapshot(data: memoryview, off: int) -> tuple[Snapshot, int]:
    index, term, shard, ondisk, dummy, typ, imported, witness, plen = _SNAP_HDR.unpack_from(
        data, off
    )
    off += _SNAP_HDR.size
    path = bytes(data[off : off + plen]).decode()
    off += plen
    (fsize,) = struct.unpack_from("<Q", data, off)
    off += 8
    (clen,) = struct.unpack_from("<I", data, off)
    off += 4
    checksum = bytes(data[off : off + clen])
    off += clen
    membership, off = _decode_membership(data, off)
    (nf,) = struct.unpack_from("<I", data, off)
    off += 4
    files = []
    for _ in range(nf):
        fid, fsz, fplen, mlen = struct.unpack_from("<QQII", data, off)
        off += 24
        fpath = bytes(data[off : off + fplen]).decode()
        off += fplen
        meta = bytes(data[off : off + mlen])
        off += mlen
        files.append(SnapshotFile(fid, fpath, meta, fsz))
    return (
        Snapshot(
            filepath=path,
            file_size=fsize,
            index=index,
            term=term,
            membership=membership,
            files=tuple(files),
            checksum=checksum,
            dummy=bool(dummy),
            shard_id=shard,
            type=StateMachineType(typ),
            imported=bool(imported),
            on_disk_index=ondisk,
            witness=bool(witness),
        ),
        off,
    )


def encode_message(m: Message, buf: bytearray) -> None:
    snap = bytearray()
    if not m.snapshot.is_empty():
        encode_snapshot(m.snapshot, snap)
    buf += _MSG_HDR.pack(
        int(m.type), m.to, m.from_, m.shard_id, m.term, m.log_term, m.log_index,
        m.commit, int(m.reject), m.hint, m.hint_high, len(m.entries), len(snap),
    )
    for e in m.entries:
        encode_entry(e, buf)
    buf += snap


def decode_message(data: memoryview, off: int) -> tuple[Message, int]:
    (typ, to, frm, shard, term, logterm, logindex, commit, reject, hint, hinthigh,
     nent, snaplen) = _MSG_HDR.unpack_from(data, off)
    off += _MSG_HDR.size
    entries = []
    for _ in range(nent):
        e, off = decode_entry(data, off)
        entries.append(e)
    snapshot = Snapshot()
    if snaplen:
        snapshot, off = decode_snapshot(data, off)
    return (
        Message(
            type=MessageType(typ),
            to=to,
            from_=frm,
            shard_id=shard,
            term=term,
            log_term=logterm,
            log_index=logindex,
            commit=commit,
            reject=bool(reject),
            hint=hint,
            hint_high=hinthigh,
            entries=tuple(entries),
            snapshot=snapshot,
        ),
        off,
    )


def encode_message_batch(b: MessageBatch) -> bytes:
    buf = bytearray()
    src = b.source_address.encode()
    buf += struct.pack("<QII", b.deployment_id, b.bin_ver, len(src))
    buf += src
    buf += struct.pack("<I", len(b.requests))
    for m in b.requests:
        encode_message(m, buf)
    if b.fabric is not None:
        # versioned optional trailer, still under the CRC: the decoder
        # reads exactly n messages, so an old peer ignores these bytes
        buf += struct.pack("<I", _FABRIC_MAGIC)
        buf += encode_fabric_header(b.fabric)
    crc = zlib.crc32(bytes(buf))
    return struct.pack("<I", crc) + bytes(buf)


def decode_message_batch(data: bytes) -> MessageBatch:
    (crc,) = struct.unpack_from("<I", data, 0)
    body = memoryview(data)[4:]
    if zlib.crc32(bytes(body)) != crc:
        raise ValueError("message batch checksum mismatch")
    off = 0
    deployment_id, bin_ver, slen = struct.unpack_from("<QII", body, off)
    off += 16
    src = bytes(body[off : off + slen]).decode()
    off += slen
    (n,) = struct.unpack_from("<I", body, off)
    off += 4
    msgs = []
    for _ in range(n):
        m, off = decode_message(body, off)
        msgs.append(m)
    fabric = None
    if len(body) - off >= 4:
        (magic,) = struct.unpack_from("<I", body, off)
        if magic == _FABRIC_MAGIC:
            fabric = decode_fabric_header(body[off + 4:])
    return MessageBatch(tuple(msgs), deployment_id, src, bin_ver, fabric)


def encode_bootstrap(b: Bootstrap) -> bytes:
    buf = bytearray()
    buf += struct.pack("<BI", int(b.join), len(b.addresses))
    for k in sorted(b.addresses):
        v = b.addresses[k].encode()
        buf += struct.pack("<QI", k, len(v))
        buf += v
    buf += struct.pack("<B", int(b.type))
    return bytes(buf)


def decode_bootstrap(data: bytes) -> Bootstrap:
    mv = memoryview(data)
    join, n = struct.unpack_from("<BI", mv, 0)
    off = 5
    addrs: dict[int, str] = {}
    for _ in range(n):
        k, ln = struct.unpack_from("<QI", mv, off)
        off += 12
        addrs[k] = bytes(mv[off : off + ln]).decode()
        off += ln
    (typ,) = struct.unpack_from("<B", mv, off)
    return Bootstrap(addrs, bool(join), StateMachineType(typ))


def encode_config_change(cc: ConfigChange) -> bytes:
    addr = cc.address.encode()
    return (
        struct.pack(
            "<QBQBI", cc.config_change_id, int(cc.type), cc.replica_id,
            int(cc.initialize), len(addr),
        )
        + addr
    )


def decode_config_change(data: bytes) -> ConfigChange:
    ccid, typ, rid, init, alen = struct.unpack_from("<QBQBI", data, 0)
    off = struct.calcsize("<QBQBI")
    addr = data[off : off + alen].decode()
    return ConfigChange(ccid, ConfigChangeType(typ), rid, addr, bool(init))


def entries_to_apply(entries: Sequence[Entry], applied: int) -> Sequence[Entry]:
    """Skip entries at or below the applied index —
    parity with reference/raftpb/entry.go:27 (EntriesToApply)."""
    if not entries:
        return entries
    last = entries[-1].index
    if last <= applied:
        return ()
    first = entries[0].index
    if first > applied + 1:
        raise ValueError(f"gap between applied {applied} and first entry {first}")
    return entries[applied + 1 - first :]


# ---------------------------------------------------------------------------
# Snapshot wire chunk — parity raftpb/chunk.go:11 (Chunk).
#
# A snapshot transfer is a stream of fixed-size chunks; chunk 0 additionally
# carries the encoded InstallSnapshot message (metadata + membership) so the
# receiver can rebuild and deliver it once the file is reassembled.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Chunk:
    shard_id: int = 0
    replica_id: int = 0          # target
    from_: int = 0               # sender replica
    chunk_id: int = 0
    chunk_count: int = 0
    chunk_size: int = 0          # bytes of data in this chunk
    file_size: int = 0           # total snapshot file size
    index: int = 0               # snapshot index (transfer identity)
    term: int = 0
    deployment_id: int = 0
    bin_ver: int = 1
    source_address: str = ""           # sender NodeHost address (chunk 0)
    data: bytes = b""
    message: "Message | None" = None   # chunk 0 only

    def is_last(self) -> bool:
        return self.chunk_id == self.chunk_count - 1


_CHUNK_HDR = struct.Struct("<QQQQQQQQQQIII")


def encode_chunk(c: Chunk) -> bytes:
    buf = bytearray()
    mbuf = bytearray()
    if c.message is not None:
        encode_message(c.message, mbuf)
    src = c.source_address.encode()
    buf += _CHUNK_HDR.pack(
        c.shard_id, c.replica_id, c.from_, c.chunk_id, c.chunk_count,
        c.chunk_size, c.file_size, c.index, c.term, c.deployment_id,
        len(src), len(mbuf), len(c.data),
    )
    buf += src
    buf += mbuf
    buf += c.data
    crc = zlib.crc32(bytes(buf))
    return struct.pack("<I", crc) + bytes(buf)


def decode_chunk(data: bytes) -> Chunk:
    (crc,) = struct.unpack_from("<I", data, 0)
    body = memoryview(data)[4:]
    if zlib.crc32(bytes(body)) != crc:
        raise ValueError("chunk checksum mismatch")
    (shard_id, replica_id, from_, chunk_id, chunk_count, chunk_size,
     file_size, index, term, deployment_id, slen, mlen, dlen) = \
        _CHUNK_HDR.unpack_from(body, 0)
    off = _CHUNK_HDR.size
    src = bytes(body[off:off + slen]).decode()
    off += slen
    message = None
    if mlen:
        message, _ = decode_message(body, off)
        off += mlen
    payload = bytes(body[off:off + dlen])
    return Chunk(
        shard_id=shard_id, replica_id=replica_id, from_=from_,
        chunk_id=chunk_id, chunk_count=chunk_count, chunk_size=chunk_size,
        file_size=file_size, index=index, term=term,
        deployment_id=deployment_id, source_address=src, data=payload,
        message=message,
    )
