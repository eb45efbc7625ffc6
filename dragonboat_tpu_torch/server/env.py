"""Env — NodeHost data-directory management.

Parity with ``internal/server/environment.go``:

- dir hierarchy  ``<node_host_dir>/<deployment_id %020d>/<host-part>/``
  (getDeploymentIDSubDirName :376; the host-part keeps multiple in-process
  NodeHosts on one box separate, like the reference's per-address dirs);
- exclusive LOCK file via flock so two NodeHosts can never share a data
  dir (:290 LockNodeHostDir, ErrLockDirectory);
- ``dragonboat.ds`` flag file pinning raft address, hostname, deployment
  id, LogDB type, binary version and the hard-settings hash — any
  mismatch refuses the reopen (:390 check, ErrNotOwner /
  ErrHostnameChanged / ErrDeploymentIDChanged / ErrLogDBType /
  ErrIncompatibleData);
- persistent NodeHost identity (NODEHOST.ID; :206-270);
- per-shard snapshot dirs with a REMOVED tombstone flag (:127-204, :304).
"""

from __future__ import annotations

import json
import os
import socket
import uuid

from dragonboat_tpu_torch.logger import get_logger
from dragonboat_tpu_torch.server.settings import hard

_LOG = get_logger("server")

LOCK_FILENAME = "LOCK"
FLAG_FILENAME = "dragonboat.ds"
NHID_FILENAME = "NODEHOST.ID"
REMOVED_FLAG = "REMOVED.dbtpu"
BIN_VER = 1


class EnvError(Exception):
    pass


class DirLockedError(EnvError):
    """Another NodeHost holds the data dir (ErrLockDirectory)."""


class NotOwnerError(EnvError):
    """The data dir belongs to a different raft address (ErrNotOwner)."""


class IncompatibleDataError(EnvError):
    """Hostname / deployment id / LogDB type / bin ver / hard settings
    changed since the dir was created."""


def _sanitize(addr: str) -> str:
    return "".join(c if (c.isalnum() or c in "._-") else "_" for c in addr)


class Env:
    """One NodeHost's view of its data directories."""

    def __init__(self, node_host_dir: str, raft_address: str,
                 deployment_id: int = 0, wal_dir: str = "",
                 fs=None) -> None:
        from dragonboat_tpu_torch.vfs import default_fs

        self.fs = fs if fs is not None else default_fs()
        self.raft_address = raft_address
        self.deployment_id = deployment_id
        self.hostname = socket.gethostname()
        suffix = (f"{deployment_id:020d}", _sanitize(raft_address))
        self.root = os.path.join(os.path.abspath(node_host_dir), *suffix)
        # WALDir (config.go): optionally place the raft log on a separate
        # (low-latency) volume; everything else stays under the root
        self.wal_root = (os.path.join(os.path.abspath(wal_dir), *suffix)
                         if wal_dir else self.root)
        self.fs.makedirs(self.root)
        if self.wal_root != self.root:
            self.fs.makedirs(self.wal_root)
        self._lock_files: list = []
        self._nhid: str | None = None

    # -- dirs -------------------------------------------------------------

    @property
    def logdb_dir(self) -> str:
        d = os.path.join(self.wal_root, "logdb")
        self.fs.makedirs(d)
        return d

    def snapshot_dir(self, shard_id: int, replica_id: int) -> str:
        """GetSnapshotDir (:127): per-replica snapshot home."""
        d = os.path.join(
            self.root, "snapshot",
            f"snapshot-{shard_id:016X}-{replica_id:016X}",
        )
        self.fs.makedirs(d)
        return d

    def remove_snapshot_dir(self, shard_id: int, replica_id: int) -> None:
        """RemoveSnapshotDir (:304): tombstone then best-effort delete."""
        d = self.snapshot_dir(shard_id, replica_id)
        with self.fs.open(os.path.join(d, REMOVED_FLAG), "w") as f:
            f.write("removed\n")
            self.fs.fsync(f)
        for fn in self.fs.listdir(d):
            if fn != REMOVED_FLAG:
                try:
                    self.fs.remove(os.path.join(d, fn))
                except OSError:
                    pass

    def snapshot_dir_removed(self, shard_id: int, replica_id: int) -> bool:
        return self.fs.exists(os.path.join(
            self.snapshot_dir(shard_id, replica_id), REMOVED_FLAG))

    # -- locking ----------------------------------------------------------

    def lock(self) -> None:
        """LockNodeHostDir (:290): exclusive, non-blocking flock on every
        data root (the WAL volume included — two NodeHosts must never
        share a log directory)."""
        if self._lock_files:
            return
        dirs = [self.root]
        if self.wal_root != self.root:
            dirs.append(self.wal_root)
        for d in dirs:
            fp = os.path.join(d, LOCK_FILENAME)
            f = self.fs.open(fp, "a+")
            try:
                self.fs.flock_exclusive(f)
            except OSError:
                f.close()
                self.close()
                raise DirLockedError(
                    f"failed to lock data directory {d}: another "
                    f"NodeHost is using it")
            self._lock_files.append(f)

    def close(self) -> None:
        for f in self._lock_files:
            try:
                self.fs.flock_unlock(f)
            except OSError:
                pass
            f.close()
        self._lock_files = []

    # -- flag file (dragonboat.ds) -----------------------------------------

    def check_node_host_dir(self, logdb_type: str,
                            compatible: tuple[str, ...] = ()) -> None:
        """check (:390): create or validate the data-status flag file, in
        the root AND on the WAL volume (checkNodeHostDir validates both
        data dirs).  The root flag records whether a separate WAL dir was
        in use, so reopening with a changed wal_dir is refused instead of
        silently starting from an empty raft log.

        ``compatible`` lists legacy logdb_type strings this engine can
        open by in-place migration; a matching legacy flag is rewritten
        to the current type so an OLD binary cannot later open the
        migrated dir and silently see an empty log."""
        status = {
            "address": self.raft_address,
            "hostname": self.hostname,
            "deployment_id": self.deployment_id,
            "logdb_type": logdb_type,
            "bin_ver": BIN_VER,
            "hard_hash": hard.hash(),
            "wal": self.wal_root if self.wal_root != self.root else "",
        }
        dirs = [self.root]
        if self.wal_root != self.root:
            dirs.append(self.wal_root)
        # validate EVERY dir before rewriting ANY legacy flag: a refused
        # open (wrong owner/hostname/hard-hash/...) must leave the dir
        # untouched for its rightful binary
        rewrite = [self._check_dir(d, status, compatible) for d in dirs]
        for d, legacy in zip(dirs, rewrite):
            if legacy:
                fp = os.path.join(d, FLAG_FILENAME)
                with self.fs.open(fp, "r") as f:
                    saved = json.loads(f.read())
                saved["logdb_type"] = status["logdb_type"]
                self._write_flag(fp, saved)

    def _write_flag(self, fp: str, status: dict) -> None:
        tmp = fp + ".tmp"
        with self.fs.open(tmp, "w") as f:
            json.dump(status, f)
            self.fs.fsync(f)
        self.fs.replace(tmp, fp)

    def _check_dir(self, d: str, status: dict,
                   compatible: tuple[str, ...] = ()) -> bool:
        """Returns True when the dir carries a legacy-compatible flag the
        caller should rewrite AFTER all dirs validate."""
        fp = os.path.join(d, FLAG_FILENAME)
        if not self.fs.exists(fp):
            self._write_flag(fp, status)
            return False
        with self.fs.open(fp, "r") as f:
            saved = json.loads(f.read())
        legacy = saved.get("logdb_type") in compatible
        if legacy:
            saved = dict(saved)
            saved["logdb_type"] = status["logdb_type"]
        if saved.get("address", "").strip().lower() != \
                self.raft_address.strip().lower():
            raise NotOwnerError(
                f"data dir {d} belongs to raft address "
                f"{saved.get('address')!r}, not {self.raft_address!r}")
        if saved.get("hostname") and saved["hostname"] != self.hostname:
            raise IncompatibleDataError(
                f"hostname changed: {saved['hostname']} -> {self.hostname}")
        if saved.get("deployment_id", 0) != self.deployment_id:
            raise IncompatibleDataError(
                f"deployment id changed: {saved.get('deployment_id')} -> "
                f"{self.deployment_id}")
        if saved.get("logdb_type") and \
                saved["logdb_type"] != status["logdb_type"]:
            raise IncompatibleDataError(
                f"LogDB type changed: {saved['logdb_type']} -> "
                f"{status['logdb_type']}")
        if saved.get("bin_ver") != BIN_VER:
            raise IncompatibleDataError(
                f"binary version changed: {saved.get('bin_ver')} -> {BIN_VER}")
        if saved.get("hard_hash") != hard.hash():
            raise IncompatibleDataError(
                "hard settings changed since this deployment was created — "
                "refusing to open (would corrupt data)")
        if saved.get("wal", "") != status["wal"]:
            raise IncompatibleDataError(
                f"WALDir changed: {saved.get('wal') or '<none>'} -> "
                f"{status['wal'] or '<none>'} — the raft log would be "
                f"left behind")
        return legacy

    # -- identity ----------------------------------------------------------

    def node_host_id(self) -> str:
        """Persistent NodeHost identity (:206 NodeHostID / :212 Prepare)."""
        if self._nhid is not None:
            return self._nhid
        fp = os.path.join(self.root, NHID_FILENAME)
        if self.fs.exists(fp):
            with self.fs.open(fp, "r") as f:
                self._nhid = f.read().strip()
        else:
            self._nhid = f"nhid-{uuid.uuid4()}"
            tmp = fp + ".tmp"
            with self.fs.open(tmp, "w") as f:
                f.write(self._nhid + "\n")
                self.fs.fsync(f)
            self.fs.replace(tmp, fp)
        return self._nhid
