"""The RSM apply orchestrator.

Parity with ``internal/rsm/statemachine.go``: drains committed-entry Tasks,
applies session ops / config changes / user updates with at-most-once dedup,
maintains the applied index, and drives snapshot save/recover through the
versioned block-CRC file format.  Wraps the three host SM kinds behind one
managed interface with the reference's RWMutex discipline
(managed.go:57, adapter.go).
"""

from __future__ import annotations

import io
import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Callable, Sequence

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch import statemachine as sm_api
from dragonboat_tpu_torch.rsm.encoded import get_payload
from dragonboat_tpu_torch.rsm.membership import MembershipStore
from dragonboat_tpu_torch.rsm.session import LRUSession
from dragonboat_tpu_torch.rsm.snapshotio import (
    SnapshotFormatError,
    read_snapshot,
    shrink_snapshot_file,
    write_snapshot,
)


@dataclass
class Task:
    """One unit of apply work — parity statemachine.go:111 (Task)."""

    shard_id: int = 0
    replica_id: int = 0
    entries: list[pb.Entry] = field(default_factory=list)
    save: bool = False
    recover: bool = False
    initial: bool = False
    stream: bool = False
    shard_closed: bool = False
    ss_request: object = None


@dataclass
class ApplyResult:
    index: int
    key: int
    client_id: int
    series_id: int
    result: sm_api.Result
    rejected: bool = False


class StateMachine:
    """Managed SM + session/membership apply loop for one shard."""

    def __init__(
        self,
        shard_id: int,
        replica_id: int,
        user_sm: object,
        ordered_config_change: bool = False,
        compress_snapshots: bool = False,
        fs=None,
    ) -> None:
        from dragonboat_tpu_torch.vfs import default_fs

        self.fs = fs if fs is not None else default_fs()
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.compress_snapshots = compress_snapshots
        self.sm = user_sm
        self.sm_type = sm_api.sm_type_of(user_sm)
        self.sessions = LRUSession()
        self.members = MembershipStore(shard_id, ordered_config_change)
        self._mu = threading.RLock()
        self.last_applied = 0
        self.last_applied_term = 0
        self.on_disk_init_index = 0
        if self.sm_type == pb.StateMachineType.ON_DISK:
            self.on_disk_init_index = self.sm.open(lambda: False)
            self.last_applied = self.on_disk_init_index

    # -- reads ----------------------------------------------------------

    def lookup(self, query: object) -> object:
        with self._mu:
            return self.sm.lookup(query)

    def get_membership(self) -> pb.Membership:
        return self.members.get()

    def get_last_applied(self) -> int:
        # deliberately lock-free: the applied cursor is a monotonic int
        # (atomic to read) and the step path polls it every step — taking
        # _mu here would let a slow user Update() holding the apply lock
        # wedge the step worker, exactly what the apply pool exists to
        # prevent (engine.go:1153 apply/step isolation)
        return self.last_applied

    # -- hash oracles for chaos testing (monkey.go:113-121) ---------------

    def get_session_hash(self) -> int:
        buf = io.BytesIO()
        self.sessions.save(buf)
        return zlib.crc32(buf.getvalue())

    def get_membership_hash(self) -> int:
        return self.members.get_hash()

    # -- apply ----------------------------------------------------------

    def handle(self, entries: Sequence[pb.Entry]) -> list[ApplyResult]:
        """Apply a batch of committed entries in order
        (statemachine.go:877 handle / :935 handleEntry)."""
        out: list[ApplyResult] = []
        with self._mu:
            for e in entries:
                if e.index <= self.last_applied:
                    continue  # on-disk SM replay skip (statemachine.go:912)
                out.append(self._handle_entry(e))
                self.last_applied = e.index
                self.last_applied_term = e.term
        return out

    def _handle_entry(self, e: pb.Entry) -> ApplyResult:
        res = ApplyResult(
            index=e.index, key=e.key, client_id=e.client_id,
            series_id=e.series_id, result=sm_api.Result(),
        )
        if e.type == pb.EntryType.METADATA:
            # witness replication strips payloads (raft.go:770
            # makeMetadataEntries): the entry advances the applied cursor
            # but must never reach sessions or the user SM
            return res
        if e.is_config_change():
            cc = pb.decode_config_change(e.cmd)
            accepted = self.members.handle_config_change(cc, e.index)
            res.rejected = not accepted
            res.result = sm_api.Result(value=e.index if accepted else 0)
            return res
        if e.is_new_session_request():
            r = self.sessions.register_client_id(e.client_id)
            res.result = r
            res.rejected = r.value == 0
            return res
        if e.is_end_of_session_request():
            r = self.sessions.unregister_client_id(e.client_id)
            res.result = r
            res.rejected = r.value == 0
            return res
        if not e.is_session_managed():
            # noop-session update: apply without dedup
            if len(e.cmd) == 0:
                return res  # empty entry (leader noop)
            res.result = self._update(e)
            return res
        # session-managed update with dedup
        cached, has_cached, need_update, session = self.sessions.update_required(e)
        if session is None:
            res.rejected = True  # unknown session (expired / never registered)
            return res
        if has_cached:
            res.result = cached
            return res
        if not need_update:
            # already responded; nothing to return (client moved on)
            res.rejected = True
            return res
        session.clear_to(e.responded_to)
        res.result = self._update(e)
        session.add_response(e.series_id, res.result)
        return res

    def _update(self, e: pb.Entry) -> sm_api.Result:
        entry = sm_api.Entry(index=e.index, cmd=get_payload(e))
        if self.sm_type == pb.StateMachineType.REGULAR:
            return self.sm.update(entry)
        results = self.sm.update([entry])
        return results[0].result if results else sm_api.Result()

    # -- snapshot save/recover (statemachine.go:553/246) -------------------

    def _prepare_save(self):
        """Under the apply lock: meta + session image + the payload writer
        (ctx captured for concurrent/on-disk SMs so the payload itself can
        be produced OUTSIDE the lock — statemachine.go:553 Prepare under
        mu, save concurrent).  The returned collection receives the user
        SM's external snapshot files (rsm/files.go)."""
        index, term = self.last_applied, self.last_applied_term
        membership = self.members.get()
        sbuf = io.BytesIO()
        self.sessions.save(sbuf)
        session_data = sbuf.getvalue()
        fc = _FileCollection()
        if self.sm_type == pb.StateMachineType.REGULAR:
            def write_payload(w):
                self.sm.save_snapshot(w, fc, lambda: False)
        elif self.sm_type == pb.StateMachineType.CONCURRENT:
            ctx = self.sm.prepare_snapshot()

            def write_payload(w):
                self.sm.save_snapshot(ctx, w, fc, lambda: False)
        else:
            ctx = self.sm.prepare_snapshot()

            def write_payload(w):
                self.sm.save_snapshot(ctx, w, lambda: False)
        return index, term, membership, session_data, write_payload, fc

    def save_snapshot(self, path: str) -> tuple[int, int, pb.Membership]:
        index, term, membership, _ = self.save_snapshot_with_files(path)
        return index, term, membership

    def save_snapshot_with_files(self, path: str):
        """save_snapshot + the external files the user SM attached
        (ISnapshotFileCollection, rsm/files.go): each is copied next to
        the snapshot container as ``<path>.xf<file_id>`` and returned as
        a pb.SnapshotFile tuple for the snapshot record."""
        from dragonboat_tpu_torch.vfs import copy_file

        with self._mu:
            index, term, membership, session_data, write_payload, fc = \
                self._prepare_save()
            tmp = path + ".generating"
            with self.fs.open(tmp, "wb") as f:
                write_snapshot(f, session_data, write_payload,
                               compress=self.compress_snapshots)
                self.fs.fsync(f)
        # the external-file copies run OUTSIDE the apply lock: fc is
        # fixed once write_payload returned, snapshot requests are
        # serialized with this shard's applies (apply-pool lane / step
        # path), and a multi-GB artifact copy must not stall lookups
        files = []
        for sf in fc.files:
            dst = f"{path}.xf{sf.file_id}"
            dtmp = dst + ".generating"
            size = copy_file(self.fs, sf.filepath, dtmp)
            self.fs.replace(dtmp, dst)
            files.append(pb.SnapshotFile(
                file_id=sf.file_id, filepath=dst,
                metadata=sf.metadata, file_size=size))
        self.fs.replace(tmp, path)
        return index, term, membership, tuple(files)

    def stream_snapshot(self, w, on_meta=None) -> tuple[int, int, "pb.Membership"]:
        """Streaming save (statemachine.go:568 Stream): write the same
        container ``save_snapshot`` produces into ``w`` (a ChunkWriter),
        without any local file.  ``on_meta(index, term, membership)`` is
        called under the apply lock BEFORE payload bytes are written.

        Only prepare runs under the apply lock; the payload is produced
        outside it (concurrent/on-disk SMs snapshot a prepared ctx), so a
        slow or paced network transfer never blocks applies.  REGULAR SMs
        have no prepared-ctx contract and keep the lock for the write —
        the reference only streams on-disk SMs at all."""
        with self._mu:
            # external files are not carried on the stream path (the
            # reference only streams on-disk SMs, which have no file
            # collection API)
            index, term, membership, session_data, write_payload, _fc = \
                self._prepare_save()
            if on_meta is not None:
                on_meta(index, term, membership)
            if self.sm_type == pb.StateMachineType.REGULAR:
                write_snapshot(w, session_data, write_payload,
                               compress=self.compress_snapshots)
                return index, term, membership
        write_snapshot(w, session_data, write_payload,
                       compress=self.compress_snapshots)
        return index, term, membership

    def recover_from_snapshot(self, path: str, ss: pb.Snapshot) -> None:
        with self._mu:
            with self.fs.open(path, "rb") as f:
                session_data, payload = read_snapshot(f)
                # a shrunken snapshot carries no payload — the on-disk
                # SM's own durable storage has the data (statemachine.go
                # :295 isShrunkSnapshot skip); feeding it to any other SM
                # kind would silently lose state
                shrunk = getattr(payload, "shrunk", False)
                if shrunk and self.sm_type != pb.StateMachineType.ON_DISK:
                    raise SnapshotFormatError(
                        "shrunk snapshot on a non-on-disk SM")
                if shrunk and self.last_applied < ss.index:
                    # the payload was dropped on the assumption the
                    # receiver's own durable storage covers ss.index —
                    # if it doesn't (a lagging peer was handed a shrunk
                    # file), skipping silently would fake an applied
                    # cursor over data that never arrived
                    raise SnapshotFormatError(
                        f"shrunk snapshot at index {ss.index} does not "
                        f"cover this SM (applied {self.last_applied})")
                self.sessions = LRUSession.load(io.BytesIO(session_data))
                if not shrunk:
                    if self.sm_type == pb.StateMachineType.ON_DISK:
                        self.sm.recover_from_snapshot(payload, lambda: False)
                    else:
                        # external files recorded on the snapshot reach
                        # the user SM with their local paths
                        # (rsm/files.go; sm recover contract)
                        ufiles = tuple(
                            sm_api.SnapshotFile(
                                file_id=f.file_id, filepath=f.filepath,
                                metadata=f.metadata)
                            for f in ss.files)
                        self.sm.recover_from_snapshot(payload, ufiles,
                                                      lambda: False)
            self.members.set(ss.membership)
            self.last_applied = ss.index
            self.last_applied_term = ss.term

    def restore_bookkeeping(self, ss: pb.Snapshot) -> None:
        """Advance membership + applied meta WITHOUT touching the user SM
        — the restore path for file-less witness/dummy snapshots
        (raft.go:728 makeWitnessSnapshot carries no data)."""
        with self._mu:
            self.members.set(ss.membership)
            self.last_applied = max(self.last_applied, ss.index)
            self.last_applied_term = ss.term

    def applied_meta(self) -> tuple[int, int, "pb.Membership"]:
        """(applied index, term, membership) as one consistent read."""
        with self._mu:
            return self.last_applied, self.last_applied_term, \
                self.members.get()

    def sync(self) -> None:
        """On-disk SM durability barrier (disk.go Sync)."""
        if self.sm_type == pb.StateMachineType.ON_DISK:
            self.sm.sync()

    def shrink_recorded_snapshot(self, path: str) -> None:
        """Replace the recorded snapshot file with its shrunken form once
        an on-disk SM has synced the data into its own storage
        (snapshotter.go:200 Shrink).  No-op for other SM kinds."""
        if self.sm_type != pb.StateMachineType.ON_DISK:
            return
        sbuf = io.BytesIO()
        LRUSession().save(sbuf)
        shrink_snapshot_file(path, self.fs, sbuf.getvalue())

    def close(self) -> None:
        self.sm.close()


class _FileCollection:
    def __init__(self) -> None:
        self.files: list[sm_api.SnapshotFile] = []

    def add_file(self, file_id: int, path: str, metadata: bytes) -> None:
        # a duplicate id would silently overwrite the copied artifact and
        # desync the recorded sizes from the shipped byte stream
        # (files.go AddFile panics on duplicates)
        if any(f.file_id == file_id for f in self.files):
            raise ValueError(f"duplicate snapshot file id {file_id}")
        self.files.append(sm_api.SnapshotFile(file_id, path, metadata))
