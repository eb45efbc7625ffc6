"""ChunkWriter — stream a snapshot image straight into transport chunks.

Parity with ``internal/rsm/chunkwriter.go``: on-disk state machines stream
their snapshot live to a lagging peer — the image is cut into
``pb.Chunk`` records as it is produced, never materialized as a local
file on the sender.  The byte stream IS the same container
``rsm/snapshotio.write_snapshot`` emits, so the receiver's reassembled
file is recovered through the ordinary ``read_snapshot`` path.

Chunk numbering for streams (the reference marks the tail with
``LastChunkCount`` since the total is unknown up front, chunk.go):
intermediate chunks carry ``chunk_count=0`` ("more to come"); the final
chunk carries ``chunk_count=chunk_id+1`` and the total ``file_size``,
which is what ``Chunk.is_last()`` keys on.
"""

from __future__ import annotations

from dragonboat_tpu_torch import raftpb as pb

STREAM_CHUNK_SIZE = 2 * 1024 * 1024  # snapshot.go:49 snapshotChunkSize


class ChunkWriter:
    """File-like writer that emits pb.Chunk records via ``emit(chunk)``.

    ``message`` (the InstallSnapshot carrying the image's metadata) must
    be assigned before the first flush — the ordinary flow sets it from
    the on-meta callback before any payload bytes are written."""

    def __init__(self, emit, shard_id: int, to_replica: int, from_: int,
                 deployment_id: int, source_address: str = "",
                 chunk_size: int = STREAM_CHUNK_SIZE) -> None:
        self.emit = emit
        self.shard_id = shard_id
        self.to_replica = to_replica
        self.from_ = from_
        self.deployment_id = deployment_id
        self.source_address = source_address
        self.chunk_size = chunk_size
        self.message: pb.Message | None = None
        self.index = 0
        self.term = 0
        self.buf = bytearray()
        self.chunk_id = 0
        self.total = 0
        self.closed = False

    def write(self, data: bytes) -> int:
        self.buf += data
        self.total += len(data)
        while len(self.buf) >= self.chunk_size:
            self._flush(bytes(self.buf[: self.chunk_size]), last=False)
            del self.buf[: self.chunk_size]
        return len(data)

    def _flush(self, block: bytes, last: bool) -> None:
        assert self.message is not None, "stream meta not set before flush"
        self.emit(pb.Chunk(
            shard_id=self.shard_id,
            replica_id=self.to_replica,
            from_=self.from_,
            chunk_id=self.chunk_id,
            chunk_count=(self.chunk_id + 1) if last else 0,
            chunk_size=len(block),
            file_size=self.total if last else 0,
            index=self.index,
            term=self.term,
            deployment_id=self.deployment_id,
            source_address=self.source_address if self.chunk_id == 0 else "",
            data=block,
            message=self.message if self.chunk_id == 0 else None,
        ))
        self.chunk_id += 1

    def close(self) -> None:
        """Emit the tail chunk (always — a last chunk is what completes
        the transfer on the receiver, even for an empty payload)."""
        if self.closed:
            return
        self.closed = True
        self._flush(bytes(self.buf), last=True)
        self.buf.clear()
