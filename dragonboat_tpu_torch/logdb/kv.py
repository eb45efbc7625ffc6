"""OrderedKV — a small LSM-style ordered key-value engine.

The second storage design point behind :class:`~dragonboat_tpu_torch.raftio.ILogDB`:
the reference ships BOTH a purpose-built log engine (tan) and a sorted-KV
engine (Pebble behind ``internal/logdb/kv``); tan.py is the former, this is
the latter.  Same shape as any LSM: an fsync-gated WAL, an in-memory
memtable, immutable sorted-string tables flushed from it, newest-wins reads
through the stack, and a full-merge compaction that drops tombstones and
anything the owner's compaction filter declares dead (raft entry floors ride
in through that filter — range deletes never write per-key tombstones).

Not a port of Pebble: single-writer (the sharded wrapper provides
concurrency), full-merge instead of leveled compaction (log batches at our
scale produce a handful of tables), per-file CRC instead of per-block, and
values stay on disk — the open-time scan builds only the key index.

Crash safety: a torn WAL tail is truncated on open (the batch was never
acknowledged); an SST is published by atomic rename, so a crash mid-flush
leaves only a ``*.tmp`` that open() sweeps; the WAL is truncated only after
its contents are durable in a published SST.
"""

from __future__ import annotations

import struct
import threading
import zlib
from bisect import bisect_left, insort
from typing import Callable, Iterator, Sequence

WAL_MAGIC = 0x4B560001
SST_MAGIC = 0x4B560002
_WAL_HDR = struct.Struct("<III")      # magic, payload length, crc32
_SST_HDR = struct.Struct("<IQ")       # magic, record count
_REC = struct.Struct("<Iq")           # klen, vlen (-1 == tombstone)

_TOMB = None                          # in-memory tombstone marker


class CorruptKVError(Exception):
    """A non-tail record failed its checksum — the store is damaged."""


class FlushError(Exception):
    """A memtable flush (or its compaction) failed AFTER the triggering
    batch was durably appended to the WAL and applied to the memtable.
    The batch itself is safe — recovery replays it — but the store is
    degraded (the flush retries on the next write/close).  Callers that
    stage side effects on write success must treat this as success for
    the batch and failure for the engine."""


class _SSTable:
    """One immutable sorted table: in-memory key index, values on disk."""

    def __init__(self, fs, path: str) -> None:
        self.fs = fs
        self.path = path
        self.keys: list[bytes] = []
        self._off: list[int] = []      # value file offset (or -1 tombstone)
        self._vlen: list[int] = []
        self._fh = None
        self._load()

    def _load(self) -> None:
        with self.fs.open(self.path, "rb") as f:
            hdr = f.read(_SST_HDR.size)
            if len(hdr) < _SST_HDR.size:
                raise CorruptKVError(f"{self.path}: short header")
            magic, count = _SST_HDR.unpack(hdr)
            if magic != SST_MAGIC:
                raise CorruptKVError(f"{self.path}: bad magic")
            # a flipped length byte must not read gigabytes before the
            # checksum can refuse the table: bound every record's lengths
            # by the bytes the file still holds
            size = f.seek(0, 2)
            f.seek(_SST_HDR.size)
            crc = 0
            off = _SST_HDR.size
            for _ in range(count):
                rh = f.read(_REC.size)
                if len(rh) < _REC.size:
                    raise CorruptKVError(f"{self.path}: short record")
                klen, vlen = _REC.unpack(rh)
                left = size - off - _REC.size
                if klen > left or vlen > left - klen:
                    raise CorruptKVError(
                        f"{self.path}: record length past end of file")
                key = f.read(klen)
                crc = zlib.crc32(rh, crc)
                crc = zlib.crc32(key, crc)
                self.keys.append(key)
                off += _REC.size + klen
                if vlen < 0:
                    self._off.append(-1)
                    self._vlen.append(0)
                else:
                    self._off.append(off)
                    self._vlen.append(vlen)
                    crc = zlib.crc32(f.read(vlen), crc)
                    off += vlen
            tail = f.read(4)
            if len(tail) < 4 or struct.unpack("<I", tail)[0] != crc:
                raise CorruptKVError(f"{self.path}: checksum mismatch")

    def _handle(self):
        if self._fh is None:
            self._fh = self.fs.open(self.path, "rb")
        return self._fh

    def _value(self, i: int):
        if self._off[i] < 0:
            return _TOMB
        f = self._handle()
        f.seek(self._off[i])
        return f.read(self._vlen[i])

    def get(self, key: bytes):
        """(found, value_or_tombstone)."""
        i = bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return True, self._value(i)
        return False, _TOMB

    def iter_range(self, lo: bytes, hi: bytes) -> Iterator[tuple[bytes, object]]:
        i = bisect_left(self.keys, lo)
        while i < len(self.keys) and self.keys[i] < hi:
            yield self.keys[i], self._value(i)
            i += 1

    def iter_all(self) -> Iterator[tuple[bytes, object]]:
        """Every record, no artificial upper bound — the compaction
        merge must never exclude a key (an excluded key is deleted with
        the old tables)."""
        for i in range(len(self.keys)):
            yield self.keys[i], self._value(i)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class OrderedKV:
    """Single-writer ordered KV store over a directory.

    ``compaction_filter(key) -> bool`` (True = drop) is consulted for every
    live key during compaction — the hook range-deletion rides on.
    """

    def __init__(self, root_dir: str, fs=None, memtable_bytes: int = 4 << 20,
                 max_ssts: int = 6,
                 compaction_filter: Callable[[bytes], bool] | None = None):
        from dragonboat_tpu_torch.vfs import default_fs

        self.fs = fs if fs is not None else default_fs()
        self.root = root_dir
        self.fs.makedirs(self.root)
        self.memtable_bytes = memtable_bytes
        self.max_ssts = max_ssts
        self.compaction_filter = compaction_filter
        self._mu = threading.RLock()
        self._mem: dict[bytes, object] = {}
        self._mem_keys: list[bytes] = []   # sorted view of _mem
        self._mem_size = 0
        self._ssts: list[_SSTable] = []    # oldest .. newest
        self._seq = 0
        self._open()

    # -- open / recovery ------------------------------------------------

    def _path(self, name: str) -> str:
        return f"{self.root}/{name}"

    def _open(self) -> None:
        seqs = []
        for fn in sorted(self.fs.listdir(self.root)):
            if fn.endswith(".tmp"):
                self.fs.remove(self._path(fn))   # unpublished flush
            elif fn.startswith("sst-") and fn.endswith(".kv"):
                seqs.append(int(fn[4:-3]))
        for s in sorted(seqs):
            self._ssts.append(_SSTable(self.fs, self._path(f"sst-{s:08d}.kv")))
            self._seq = max(self._seq, s)
        wal = self._path("wal")
        if self.fs.exists(wal):
            self._replay_wal(wal)
        self._wal = self.fs.open(wal, "ab")

    def _replay_wal(self, path: str) -> None:
        good = 0
        with self.fs.open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _WAL_HDR.size <= len(data):
            magic, ln, crc = _WAL_HDR.unpack_from(data, off)
            body = data[off + _WAL_HDR.size: off + _WAL_HDR.size + ln]
            if magic != WAL_MAGIC or len(body) < ln:
                break                      # torn tail
            if zlib.crc32(body) != crc:
                if off + _WAL_HDR.size + ln >= len(data):
                    break                  # torn tail mid-payload
                raise CorruptKVError(f"{path}: mid-log checksum mismatch")
            self._apply_wal_batch(body)
            off += _WAL_HDR.size + ln
            good = off
        if good < len(data):
            with self.fs.open(path, "r+b") as tf:
                tf.truncate(good)
                self.fs.fsync(tf)

    def _apply_wal_batch(self, body: bytes) -> None:
        mv = memoryview(body)
        off = 0
        while off < len(mv):
            op = mv[off]
            klen, vlen = _REC.unpack_from(mv, off + 1)
            off += 1 + _REC.size
            key = bytes(mv[off:off + klen])
            off += klen
            if op == 1:
                self._mem_put(key, bytes(mv[off:off + vlen]))
                off += vlen
            else:
                self._mem_put(key, _TOMB)

    # -- memtable -------------------------------------------------------

    def _mem_put(self, key: bytes, val) -> None:
        if key not in self._mem:
            insort(self._mem_keys, key)
        else:
            self._mem_size -= len(key) + len(self._mem[key] or b"")
        self._mem[key] = val
        self._mem_size += len(key) + len(val or b"")

    # -- write path -----------------------------------------------------

    def write_batch(self, puts: Sequence[tuple[bytes, bytes]],
                    dels: Sequence[bytes] = (), sync: bool = True) -> None:
        """Atomically apply puts+dels: one WAL record, one optional fsync."""
        parts = []
        for k, v in puts:
            parts.append(bytes([1]) + _REC.pack(len(k), len(v)) + k + v)
        for k in dels:
            parts.append(bytes([2]) + _REC.pack(len(k), -1) + k)
        body = b"".join(parts)
        with self._mu:
            self._wal.write(_WAL_HDR.pack(WAL_MAGIC, len(body),
                                          zlib.crc32(body)) + body)
            if sync:
                self.fs.fsync(self._wal)
            for k, v in puts:
                self._mem_put(k, v)
            for k in dels:
                self._mem_put(k, _TOMB)
            if self._mem_size >= self.memtable_bytes:
                if not sync:
                    # no durability claim to scope: an unsynced batch is
                    # best-effort either way, so flush errors propagate raw
                    self._flush_locked()
                else:
                    try:
                        self._flush_locked()
                    except Exception as e:
                        raise FlushError(
                            "flush failed after the batch was made durable"
                        ) from e
                    except BaseException as e:
                        # KeyboardInterrupt/SystemExit must propagate
                        # with their own TYPE (signal semantics), but
                        # carry the durability fact: the batch was
                        # WAL-appended + fsynced before the flush, so a
                        # caller staging side effects on write success
                        # must NOT roll them back (logdb/kvdb.py
                        # save_raft_state checks this attribute)
                        e.batch_durable = True
                        raise

    def put(self, key: bytes, val: bytes, sync: bool = True) -> None:
        self.write_batch([(key, val)], sync=sync)

    def delete(self, key: bytes, sync: bool = True) -> None:
        self.write_batch([], [key], sync=sync)

    # -- flush / compaction ---------------------------------------------

    def _write_sst(self, items: Iterator[tuple[bytes, object]],
                   drop_tombstones: bool) -> str | None:
        """Write a published SST from sorted (key, value) items."""
        self._seq += 1
        name = f"sst-{self._seq:08d}.kv"
        tmp = self._path(name + ".tmp")
        crc = 0
        count = 0
        payload = []
        for key, val in items:
            if val is _TOMB:
                if drop_tombstones:
                    continue
                rec = _REC.pack(len(key), -1) + key
            else:
                rec = _REC.pack(len(key), len(val)) + key + val
            crc = zlib.crc32(rec, crc)
            payload.append(rec)
            count += 1
        if count == 0:
            self._seq -= 1
            return None
        with self.fs.open(tmp, "wb") as f:
            f.write(_SST_HDR.pack(SST_MAGIC, count))
            for rec in payload:
                f.write(rec)
            f.write(struct.pack("<I", crc))
            self.fs.fsync(f)
        self.fs.replace(tmp, self._path(name))
        # the rename itself must be durable before anything depends on
        # the published table (the WAL truncation, old-table deletion)
        self.fs.fsync_dir(self.root)
        return self._path(name)

    def _flush_locked(self) -> None:
        if not self._mem:
            return
        path = self._write_sst(
            ((k, self._mem[k]) for k in self._mem_keys),
            drop_tombstones=False)
        if path is not None:
            self._ssts.append(_SSTable(self.fs, path))
        self._mem.clear()
        self._mem_keys.clear()
        self._mem_size = 0
        self._wal.close()
        with self.fs.open(self._path("wal"), "wb") as f:
            self.fs.fsync(f)
        self._wal = self.fs.open(self._path("wal"), "ab")
        if len(self._ssts) > self.max_ssts:
            self._compact_locked()

    def _merged(self) -> Iterator[tuple[bytes, object]]:
        """Newest-wins merge of all SSTs (memtable excluded).  Unbounded
        iteration: a range-bounded merge would silently drop (then
        delete) any key past the bound."""
        iters = [list(t.iter_all()) for t in self._ssts]
        merged: dict[bytes, object] = {}
        for run in iters:                  # oldest first: later wins
            for k, v in run:
                merged[k] = v
        for k in sorted(merged):
            yield k, merged[k]

    def _compact_locked(self) -> None:
        filt = self.compaction_filter

        def live():
            for k, v in self._merged():
                if v is _TOMB:
                    continue               # full merge: tombstones die here
                if filt is not None and filt(k):
                    continue
                yield k, v

        old = self._ssts
        path = self._write_sst(live(), drop_tombstones=True)
        self._ssts = [_SSTable(self.fs, path)] if path is not None else []
        for t in old:
            t.close()
            self.fs.remove(t.path)

    def flush(self) -> None:
        with self._mu:
            self._flush_locked()

    def compact(self) -> None:
        """Flush and fully merge — physical reclamation point."""
        with self._mu:
            self._flush_locked()
            self._compact_locked()

    # -- read path ------------------------------------------------------

    def get(self, key: bytes):
        with self._mu:
            if key in self._mem:
                v = self._mem[key]
                return None if v is _TOMB else v
            for t in reversed(self._ssts):
                found, v = t.get(key)
                if found:
                    return None if v is _TOMB else v
            return None

    def scan(self, lo: bytes, hi: bytes) -> list[tuple[bytes, bytes]]:
        """Sorted live (key, value) pairs with lo <= key < hi.

        Returns a materialized list: the snapshot is taken under the lock,
        so a caller iterating slowly never blocks (or races) the writer."""
        with self._mu:
            merged: dict[bytes, object] = {}
            for t in self._ssts:           # oldest first: later wins
                for k, v in t.iter_range(lo, hi):
                    merged[k] = v
            i = bisect_left(self._mem_keys, lo)
            while i < len(self._mem_keys) and self._mem_keys[i] < hi:
                k = self._mem_keys[i]
                merged[k] = self._mem[k]
                i += 1
        return [(k, merged[k]) for k in sorted(merged)
                if merged[k] is not _TOMB]

    def close(self) -> None:
        with self._mu:
            self._flush_locked()
            self._wal.close()
            for t in self._ssts:
                t.close()
