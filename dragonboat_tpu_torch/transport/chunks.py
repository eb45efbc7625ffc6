"""Snapshot chunk streaming: split, reassemble, GC.

Parity with the reference's chunked snapshot transfer
(``internal/transport/snapshot.go:49,211-217`` sender split,
``chunk.go:106-194`` receiver ``Chunk.Add`` with per-transfer locks, a
concurrency cap and tick-based GC of stalled transfers).  The sender reads
the snapshot file and emits ``raftpb.Chunk`` records; the receiver
reassembles them into a local file and delivers the original
InstallSnapshot message (filepath rewritten) once the last chunk lands.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

from dragonboat_tpu_torch import raftpb as pb

SNAPSHOT_CHUNK_SIZE = 2 * 1024 * 1024   # snapshot.go:49 snapshotChunkSize
MAX_CONCURRENT_STREAMS = 128            # chunk.go:42 MaxConcurrentStreaming
GC_TICKS = 30                           # stalled-transfer timeout in ticks


def split_snapshot_message(m: pb.Message, deployment_id: int,
                           chunk_size: int = SNAPSHOT_CHUNK_SIZE,
                           source_address: str = ""):
    """Yield Chunk records for an InstallSnapshot message
    (snapshot.go:211 SendSnapshot read-and-split).

    External snapshot files (rsm/files.go) ride the SAME chunk stream,
    concatenated after the container in ``ss.files`` order; the receiver
    splits them back out using the per-file sizes recorded on the
    snapshot (ChunkSink._split_external_files)."""
    ss = m.snapshot
    main_size = os.path.getsize(ss.filepath) if ss.filepath else 0
    file_size = main_size + sum(f.file_size for f in ss.files)
    count = max(1, (file_size + chunk_size - 1) // chunk_size)

    def byte_stream():
        paths = ([ss.filepath] if ss.filepath else []) + [
            f.filepath for f in ss.files]
        for p in paths:
            with open(p, "rb") as f:
                while True:
                    block = f.read(chunk_size)
                    if not block:
                        break
                    yield block

    class _concat:
        def __init__(self):
            self.gen = byte_stream()
            self.buf = b""

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self, n):
            while len(self.buf) < n:
                block = next(self.gen, None)
                if block is None:
                    break
                self.buf += block
            out, self.buf = self.buf[:n], self.buf[n:]
            return out

    with (_concat() if file_size else _null_file()) as f:
        for cid in range(count):
            data = f.read(chunk_size)
            yield pb.Chunk(
                shard_id=m.shard_id,
                replica_id=m.to,
                from_=m.from_,
                chunk_id=cid,
                chunk_count=count,
                chunk_size=len(data),
                file_size=file_size,
                index=ss.index,
                term=ss.term,
                deployment_id=deployment_id,
                source_address=source_address if cid == 0 else "",
                data=data,
                message=m if cid == 0 else None,
            )


class _null_file:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def read(self, n):
        return b""


@dataclass
class _Transfer:
    message: pb.Message | None = None
    next_chunk: int = 0
    chunk_count: int = 0
    path: str = ""
    fh: object = None
    idle_ticks: int = 0
    validated: int = 0
    source_address: str = ""


class ChunkSink:
    """Receiver-side reassembly — parity chunk.go:106 (Chunk.Add)."""

    def __init__(self, snapshot_dir: str, deployment_id: int,
                 deliver, max_concurrent: int = MAX_CONCURRENT_STREAMS):
        """``deliver(message, source_address)`` is called with the rebuilt
        InstallSnapshot (filepath pointing at the reassembled local file)."""
        self.dir = snapshot_dir
        self.deployment_id = deployment_id
        self.deliver = deliver
        self.max_concurrent = max_concurrent
        self.mu = threading.Lock()
        self.transfers: dict[tuple[int, int, int], _Transfer] = {}
        # reference-layout chunks (go-wire transports) reassemble under
        # their own semantics; shares dir/deliver/GC with this sink
        self._go: "GoChunkSink | None" = None

    def add(self, c) -> bool:
        """Returns False when the chunk is rejected (out of order, over the
        concurrency cap, wrong deployment).  Dispatches reference-layout
        ``gowire.GoChunk`` records (no embedded message, per-file split)
        to the go-wire reassembler."""
        if not isinstance(c, pb.Chunk):
            if self._go is None:
                # construct under the lock: one reader thread per inbound
                # connection — two concurrent first-chunks must not each
                # build a sink and orphan the loser's open transfer
                with self.mu:
                    if self._go is None:
                        self._go = GoChunkSink(
                            self.dir, self.deployment_id, self.deliver,
                            self.max_concurrent)
            return self._go.add(c)
        if c.deployment_id != self.deployment_id:
            return False
        key = (c.shard_id, c.replica_id, c.from_)
        completed = None
        with self.mu:
            t = self.transfers.get(key)
            if c.chunk_id == 0:
                if t is not None:
                    self._abort_locked(key)
                if len(self.transfers) >= self.max_concurrent:
                    return False
                if c.message is None:
                    return False
                os.makedirs(self.dir, exist_ok=True)
                path = os.path.join(
                    self.dir,
                    f"incoming-{c.shard_id:016X}-{c.replica_id:016X}"
                    f"-{c.index:016X}.gbsnap",
                )
                t = _Transfer(message=c.message, chunk_count=c.chunk_count,
                              path=path, fh=open(path, "wb"),
                              source_address=c.source_address)
                self.transfers[key] = t
            elif t is None or c.chunk_id != t.next_chunk:
                # out-of-order/stale chunk: drop the whole transfer
                if t is not None:
                    self._abort_locked(key)
                return False
            t.idle_ticks = 0
            t.fh.write(c.data)
            t.validated += len(c.data)
            t.next_chunk = c.chunk_id + 1
            # streamed transfers (chunkwriter.py) carry chunk_count=0 until
            # the tail chunk, whose count/file_size close the transfer
            if c.is_last():
                t.fh.close()
                if c.file_size and t.validated != c.file_size:
                    os.remove(t.path)
                    del self.transfers[key]
                    return False
                del self.transfers[key]
                completed = t
        if completed is not None:
            # deliver OUTSIDE the lock: dispatch recurses into the whole
            # nodehost message path and must not serialize other transfers
            m = completed.message
            from dataclasses import replace
            files = self._split_external_files(completed.path,
                                               m.snapshot.files)
            m = replace(m, snapshot=replace(m.snapshot,
                                            filepath=completed.path,
                                            files=files))
            self.deliver(m, completed.source_address)
        return True

    @staticmethod
    def _split_external_files(path: str, files):
        """The sender concatenated external snapshot files after the
        container (split_snapshot_message); carve them back out next to
        the reassembled file and truncate the container to its own bytes
        (chunk.go multi-file reassembly, compressed into one stream)."""
        if not files:
            return files
        from dataclasses import replace
        total = os.path.getsize(path)
        main_size = total - sum(f.file_size for f in files)
        out = []
        with open(path, "rb") as f:
            f.seek(main_size)
            for sf in files:
                dst = f"{path}.xf{sf.file_id}"
                remaining = sf.file_size
                with open(dst, "wb") as o:
                    while remaining:
                        block = f.read(min(remaining, 1 << 20))
                        if not block:
                            break
                        o.write(block)
                        remaining -= len(block)
                out.append(replace(sf, filepath=dst))
        with open(path, "r+b") as f:
            f.truncate(main_size)
        return tuple(out)

    def _abort_locked(self, key) -> None:
        t = self.transfers.pop(key, None)
        if t is not None and t.fh is not None:
            try:
                t.fh.close()
                os.remove(t.path)
            except OSError:
                pass

    def tick(self) -> None:
        """Advance the GC clock; drop stalled transfers (chunk.go GC)."""
        with self.mu:
            stalled = []
            for key, t in self.transfers.items():
                t.idle_ticks += 1
                if t.idle_ticks >= GC_TICKS:
                    stalled.append(key)
            for key in stalled:
                self._abort_locked(key)
        if self._go is not None:
            self._go.tick()

    def inflight(self) -> int:
        with self.mu:
            n = len(self.transfers)
        return n + (self._go.inflight() if self._go is not None else 0)


# ---------------------------------------------------------------------------
# Go-wire snapshot streaming (snapshot.go getChunks / chunk.go Add): the
# reference splits PER FILE (each chunk names its file and carries
# file_chunk_id/count alongside the global chunk_id/count) and the
# RECEIVER synthesizes the InstallSnapshot message from chunk fields —
# there is no embedded chunk-0 message on this wire.  The local on-disk
# layout of a reassembled transfer stays the repo's own (incoming-*.gbsnap
# + .xfN external files, same as the native sink) — only the WIRE format
# must match the Go fleet.
# ---------------------------------------------------------------------------


def split_snapshot_message_go(m: pb.Message, deployment_id: int,
                              chunk_size: int = SNAPSHOT_CHUNK_SIZE):
    """Yield reference-layout GoChunks for an InstallSnapshot
    (snapshot.go:204 getChunks + :225 loadChunkData read-at-send).
    Witness snapshots ship as the reference's single synthetic chunk
    (snapshot.go:262 getWitnessChunk) carrying a well-formed EMPTY image
    in the REFERENCE container format (rsm/gosnapshot.py) — the Go
    receiver validates every chunk-0 payload against its SnapshotHeader
    layout (chunk.go:214 NewSnapshotValidator) even though witness
    snapshots are partial and never recovered from."""
    from dragonboat_tpu_torch.raftpb import gowire

    ss = m.snapshot
    if ss.witness:
        data = witness_image_bytes()
        yield gowire.GoChunk(
            shard_id=m.shard_id, replica_id=m.to, from_=m.from_,
            chunk_id=0, chunk_count=1, chunk_size=len(data), data=data,
            index=ss.index, term=ss.term, membership=ss.membership,
            filepath="witness.snapshot", file_size=len(data),
            deployment_id=deployment_id, file_chunk_id=0,
            file_chunk_count=1, on_disk_index=0, witness=True)
        return
    if not ss.filepath or os.path.getsize(ss.filepath) == 0:
        raise ValueError("empty snapshot file")  # snapshot.go:208 panic
    # the Go receiver byte-validates AND later recovers from the main
    # image in ITS container format — transcode ours (sessions
    # re-banked, user payload verbatim; rsm/gosnapshot.py).  External
    # files ride raw: has_file_info chunks are never validated and the
    # bytes are the user's own.
    from dragonboat_tpu_torch.rsm.gosnapshot import (
        native_image_to_go,
        sniff_v2_file,
    )

    main_path = ss.filepath
    tmp_path = None
    if not sniff_v2_file(main_path):
        # transcode into a sibling temp file and stream from disk: the
        # paced transfer can run for minutes and must not pin a
        # multi-GB image (or its transcoded copy) in memory
        tmp_path = main_path + ".gowire"
        with open(main_path, "rb") as f:
            img = native_image_to_go(f.read())
        with open(tmp_path, "wb") as f:
            f.write(img)
        del img
        main_path = tmp_path
    try:
        files: list[tuple[str, int, pb.SnapshotFile | None]] = [
            (main_path, os.path.getsize(main_path), None)]
        for sf in ss.files:
            files.append((sf.filepath, sf.file_size, sf))
        per_file = [max(1, (sz + chunk_size - 1) // chunk_size)
                    for _, sz, _ in files]
        total = sum(per_file)
        chunk_id = 0
        for (path, size, sf), count in zip(files, per_file):
            with open(path, "rb") as f:
                for fcid in range(count):
                    data = f.read(chunk_size)
                    yield gowire.GoChunk(
                        shard_id=m.shard_id,
                        replica_id=m.to,
                        from_=m.from_,
                        chunk_id=chunk_id,
                        chunk_count=total,
                        chunk_size=len(data),
                        data=data,
                        index=ss.index,
                        term=ss.term,
                        membership=ss.membership,
                        filepath=path,
                        file_size=size,
                        deployment_id=deployment_id,
                        file_chunk_id=fcid,
                        file_chunk_count=count,
                        has_file_info=sf is not None,
                        file_info=sf if sf is not None
                        else pb.SnapshotFile(file_id=0, filepath=""),
                        on_disk_index=ss.on_disk_index,
                        witness=False,  # witness branch returned above
                    )
                    chunk_id += 1
    finally:
        if tmp_path is not None:
            try:
                os.remove(tmp_path)
            except OSError:
                pass


@dataclass
class _GoTransfer:
    next_chunk: int = 0
    path: str = ""                      # container file
    fh: object = None
    idle_ticks: int = 0
    main_written: int = 0
    files: list = field(default_factory=list)   # (SnapshotFile, local path)
    cur_file_fh: object = None
    cur_file_written: int = 0
    first: object = None                # chunk 0 (message fields)


class GoChunkSink:
    """Receiver reassembly for reference-layout chunks (chunk.go:106
    Add): strict global ordering, per-file writes, and the final
    InstallSnapshot synthesized from chunk fields (chunk.go toMessage).
    Shares the native sink's directory, delivery callback and GC
    cadence — ``ChunkSink`` owns one and dispatches by chunk type."""

    def __init__(self, snapshot_dir: str, deployment_id: int, deliver,
                 max_concurrent: int = MAX_CONCURRENT_STREAMS):
        self.dir = snapshot_dir
        self.deployment_id = deployment_id
        self.deliver = deliver
        self.max_concurrent = max_concurrent
        self.mu = threading.Lock()
        self.transfers: dict[tuple[int, int, int], _GoTransfer] = {}

    def add(self, c) -> bool:
        if c.deployment_id != self.deployment_id:
            return False
        key = (c.shard_id, c.replica_id, c.from_)
        if c.is_poison():
            # a failed sender poisons its stream (raftpb LastChunkCount-1,
            # job.go): drop the transfer, nothing to deliver
            with self.mu:
                self._abort_locked(key)
            return False
        completed = None
        with self.mu:
            t = self.transfers.get(key)
            if c.chunk_id == 0:
                if t is not None:
                    self._abort_locked(key)
                if len(self.transfers) >= self.max_concurrent:
                    return False
                os.makedirs(self.dir, exist_ok=True)
                path = os.path.join(
                    self.dir,
                    f"incoming-{c.shard_id:016X}-{c.replica_id:016X}"
                    f"-{c.index:016X}.gbsnap",
                )
                t = _GoTransfer(path=path, fh=open(path, "wb"), first=c)
                self.transfers[key] = t
            elif t is None or c.chunk_id != t.next_chunk:
                if t is not None:
                    self._abort_locked(key)
                return False
            t.idle_ticks = 0
            t.next_chunk = c.chunk_id + 1
            if not c.has_file_info:
                if t.fh is None:     # main file already closed: protocol
                    self._abort_locked(key)   # violation, clean reject
                    return False
                t.fh.write(c.data)
                t.main_written += len(c.data)
                # counted transfers close the main file on its last file
                # chunk; STREAMED ones (rsm.ChunkWriter — file_chunk
                # counts are 0 / the LastChunkCount sentinel) only at
                # the stream tail.  file_size is unknown for streams
                # (0): size validation applies to counted files only.
                if c.is_last_file_chunk() or c.is_last():
                    t.fh.close()
                    t.fh = None
                    if c.file_size and t.main_written != c.file_size:
                        self._abort_locked(key)
                        return False
            else:
                if c.file_chunk_id == 0:
                    if t.cur_file_fh is not None:   # protocol violation
                        self._abort_locked(key)
                        return False
                    dst = f"{t.path}.xf{c.file_info.file_id}"
                    t.cur_file_fh = open(dst, "wb")
                    t.cur_file_written = 0
                    t.files.append((c.file_info, dst))
                if t.cur_file_fh is None:
                    self._abort_locked(key)
                    return False
                t.cur_file_fh.write(c.data)
                t.cur_file_written += len(c.data)
                if c.is_last_file_chunk():
                    t.cur_file_fh.close()
                    t.cur_file_fh = None
                    if t.cur_file_written != c.file_size:
                        self._abort_locked(key)
                        return False
            if c.is_last():
                if t.fh is not None or t.cur_file_fh is not None:
                    self._abort_locked(key)   # a file never closed
                    return False
                del self.transfers[key]
                completed = t
        if completed is not None:
            try:
                self._naturalize(completed)
            except Exception:
                # a malformed image must reject the TRANSFER (files
                # cleaned), not kill the connection reader — every
                # other malformed-chunk path returns False the same way
                for pth in ([completed.path, completed.path + ".transcode"]
                            + [d for _, d in completed.files]):
                    try:
                        os.remove(pth)
                    except OSError:
                        pass
                return False
            self.deliver(self._to_message(completed), "")
        return True

    @staticmethod
    def _naturalize(t: _GoTransfer) -> None:
        """A main image from a Go peer (or a transcoding TPU peer)
        arrives in the reference container; rewrite it into the repo's
        own format (sessions included) so the ordinary recovery path
        reads it.  A TPU live stream (our container bytes, our magic)
        passes through untouched; witness transfers are never
        recovered from, so their image is left as received."""
        if t.first is not None and t.first.witness:
            return
        from dragonboat_tpu_torch.rsm.gosnapshot import (
            go_image_to_native,
            sniff_v2_file,
        )

        if not sniff_v2_file(t.path):
            return                   # our own live stream: pass through
        with open(t.path, "rb") as f:
            data = f.read()
        native = go_image_to_native(data)
        tmp = t.path + ".transcode"
        with open(tmp, "wb") as f:
            f.write(native)
        os.replace(tmp, t.path)
        t.main_written = len(native)

    @staticmethod
    def _to_message(t: _GoTransfer) -> pb.Message:
        """chunk.go toMessage: rebuild the InstallSnapshot from the
        chunk fields, filepaths rewritten to the reassembled local
        files."""
        from dataclasses import replace

        c0 = t.first
        files = tuple(replace(sf, filepath=dst) for sf, dst in t.files)
        ss = pb.Snapshot(
            filepath=t.path,
            file_size=t.main_written,
            index=c0.index,
            term=c0.term,
            membership=c0.membership,
            files=files,
            shard_id=c0.shard_id,
            on_disk_index=c0.on_disk_index,
            witness=c0.witness,
        )
        # term stays 0 (chunk.go toMessage sets no Term): a zero-term
        # message bypasses the staleness gate (raft.go
        # onMessageTermNotMatched / pycore.py:858) — the snapshot's own
        # term rides in ss.term; the sender's message term never crossed
        # this wire
        return pb.Message(
            type=pb.MessageType.INSTALL_SNAPSHOT,
            to=c0.replica_id,
            from_=c0.from_,
            shard_id=c0.shard_id,
            snapshot=ss,
        )

    def _abort_locked(self, key) -> None:
        t = self.transfers.pop(key, None)
        if t is None:
            return
        for fh in (t.fh, t.cur_file_fh):
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass
        for p in [t.path] + [dst for _, dst in t.files]:
            try:
                os.remove(p)
            except OSError:
                pass

    def tick(self) -> None:
        with self.mu:
            stalled = []
            for key, t in self.transfers.items():
                t.idle_ticks += 1
                if t.idle_ticks >= GC_TICKS:
                    stalled.append(key)
            for key in stalled:
                self._abort_locked(key)

    def inflight(self) -> int:
        with self.mu:
            return len(self.transfers)


def adapt_native_chunks_to_go(chunks):
    """Adapt a NATIVE streamed chunk sequence (the on-disk SM live
    stream, rsm/chunkwriter.py — repo-container bytes cut into chunks)
    into reference-layout GoChunks carrying the REFERENCE container,
    transcoded in flight (rsm/gosnapshot.GoStreamTranscoder: sessions
    re-banked, user payload verbatim, reference blocks + tail) — a
    real Go receiver validates the blocks as they arrive, so the bytes
    must be reference-shaped on the wire, not just at rest.  Chunk
    numbering follows chunkwriter.go: mid chunks carry chunk_count=0,
    and a final EMPTY LastChunkCount chunk closes the stream.
    Already-adapted GoChunks pass through."""
    from dragonboat_tpu_torch.raftpb import gowire
    from dragonboat_tpu_torch.rsm.gosnapshot import GoStreamTranscoder

    meta = None
    first = None
    tr = None
    pending: list[bytes] = []
    chunk_id = 0

    def go_chunk(data: bytes, count: int):
        nonlocal chunk_id
        c0 = first
        ss = meta
        ck = gowire.GoChunk(
            shard_id=c0.shard_id, replica_id=c0.replica_id,
            from_=c0.from_, chunk_id=chunk_id, chunk_size=len(data),
            chunk_count=count, data=data, index=c0.index, term=c0.term,
            membership=ss.membership if ss is not None else pb.Membership(),
            filepath=f"snapshot-{c0.index:016X}.gbsnap",
            deployment_id=c0.deployment_id,
            file_chunk_id=chunk_id, file_chunk_count=count,
            on_disk_index=ss.on_disk_index if ss is not None else 0,
            witness=False,
        )
        chunk_id += 1
        return ck

    for c in chunks:
        if not isinstance(c, pb.Chunk):
            yield c
            continue
        if c.message is not None:
            meta = c.message.snapshot
        if first is None:
            first = c
            tr = GoStreamTranscoder(pending.append)
        tr.write(c.data)
        if c.is_last():
            tr.close()
        while pending:
            yield go_chunk(pending.pop(0), 0)
    if first is not None:
        # chunkwriter.go getTailChunk: an empty LastChunkCount chunk
        # closes the streamed transfer
        yield go_chunk(b"", gowire.LAST_CHUNK_COUNT)


def witness_image_bytes() -> bytes:
    """The witness chunk payload in the REFERENCE container format
    (rsm.GetWitnessSnapshot): the Go receiver runs its snapshot
    validator on every chunk-0 payload (chunk.go:214), so the image
    must be bytes that validator accepts — witness snapshots being
    partial (never recovered from) does not exempt them from the
    byte-level check."""
    from dragonboat_tpu_torch.rsm.gosnapshot import witness_image

    return witness_image()
