"""Filesystem abstraction with error injection and crash simulation.

Parity with the reference's ``internal/vfs/vfs.go:29-46`` (IFS = OS fs /
strict MemFS / ErrorFS): every storage component (tan log engine, server
Env, snapshotter, import tool) takes an ``IFS`` so tests can

- run whole clusters with zero disk IO (:class:`MemFS`),
- simulate power loss — unsynced writes vanish (:meth:`MemFS.crash`),
- inject IO errors at precise points (:class:`ErrorFS`), which the
  NodeHost turns into controlled crashes the way the reference arms its
  engine crash channel when it detects an ErrorFS (nodehost.go:361-367).

The file objects returned by ``open`` support the stdlib surface the
storage layer uses: read/write/seek/tell/truncate/flush/close and the
context-manager protocol.  Durability goes through ``IFS.fsync(f)`` (not
``os.fsync``) so MemFS can model the synced/unsynced distinction.
"""

from __future__ import annotations

import io
import os
import threading

__all__ = ["OSFS", "MemFS", "ErrorFS", "InjectedError", "default_fs",
           "copy_file"]


class InjectedError(OSError):
    """Raised by ErrorFS at an injection point."""


# ---------------------------------------------------------------------------
# OS filesystem
# ---------------------------------------------------------------------------


class OSFS:
    """The real filesystem (vfs.go Default)."""

    def open(self, path: str, mode: str = "rb"):
        return open(path, mode)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def listdir(self, path: str) -> list[str]:
        return os.listdir(path)

    def remove(self, path: str) -> None:
        os.remove(path)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def getsize(self, path: str) -> int:
        return os.path.getsize(path)

    def fsync(self, f) -> None:
        f.flush()
        os.fsync(f.fileno())

    def fsync_dir(self, path: str) -> None:
        """Make directory-entry changes (rename/create/remove) durable —
        required after ``replace`` before depending on the new name."""
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def flock_exclusive(self, f) -> None:
        """Non-blocking exclusive lock; OSError if held elsewhere."""
        import fcntl

        fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)

    def flock_unlock(self, f) -> None:
        import fcntl

        fcntl.flock(f.fileno(), fcntl.LOCK_UN)


def default_fs() -> OSFS:
    return OSFS()


# ---------------------------------------------------------------------------
# In-memory filesystem with power-loss simulation
# ---------------------------------------------------------------------------


class _MemNode:
    __slots__ = ("data", "synced")

    def __init__(self) -> None:
        self.data = bytearray()       # current (possibly unsynced) content
        self.synced = b""             # content as of the last fsync


class _MemFile:
    """File handle over a _MemNode; supports binary and text modes."""

    def __init__(self, fs: "MemFS", path: str, node: _MemNode, mode: str):
        self._fs = fs
        self._path = path
        self._node = node
        self._binary = "b" in mode
        self._append = "a" in mode
        self._readable = "r" in mode or "+" in mode
        self._writable = any(c in mode for c in "wa+x")
        self._pos = len(node.data) if self._append else 0
        self.closed = False

    # -- io surface --
    def read(self, n: int = -1):
        data = self._node.data
        if n is None or n < 0:
            out = bytes(data[self._pos:])
        else:
            out = bytes(data[self._pos:self._pos + n])
        self._pos += len(out)
        return out if self._binary else out.decode()

    def write(self, b) -> int:
        if not self._binary and isinstance(b, str):
            b = b.encode()
        b = bytes(b)
        if self._append:
            self._pos = len(self._node.data)
        d = self._node.data
        end = self._pos + len(b)
        if end > len(d):
            d.extend(b"\x00" * (end - len(d)))
        d[self._pos:end] = b
        self._pos = end
        return len(b)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = pos
        elif whence == 1:
            self._pos += pos
        else:
            self._pos = len(self._node.data) + pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def truncate(self, n: int | None = None) -> int:
        n = self._pos if n is None else n
        del self._node.data[n:]
        return n

    def flush(self) -> None:  # NOT durable — only IFS.fsync is
        pass

    def fileno(self) -> int:
        raise io.UnsupportedOperation("MemFS files have no OS fd")

    def close(self) -> None:
        self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # iteration (json.load etc. only use read; keep minimal)
    def readable(self) -> bool:
        return self._readable

    def writable(self) -> bool:
        return self._writable


class MemFS:
    """Strict in-memory FS: ``crash()`` drops everything not fsynced —
    the reference's strict MemFS power-loss model (vfs.go NewStrictMem)."""

    def __init__(self) -> None:
        self._mu = threading.RLock()
        self._files: dict[str, _MemNode] = {}
        self._dirs: set[str] = {"/"}
        self._locks: set[str] = set()

    def _norm(self, path: str) -> str:
        return os.path.abspath(path)

    # -- IFS surface --
    def open(self, path: str, mode: str = "rb"):
        p = self._norm(path)
        with self._mu:
            node = self._files.get(p)
            if node is not None and "x" in mode:
                raise FileExistsError(p)
            if node is None:
                # stdlib parity: every "r" flavor (incl. "r+") requires an
                # existing file; only w/a/x create
                if "r" in mode:
                    raise FileNotFoundError(p)
                node = self._files[p] = _MemNode()
            if "w" in mode:
                node.data = bytearray()
            return _MemFile(self, p, node, mode)

    def makedirs(self, path: str) -> None:
        with self._mu:
            self._dirs.add(self._norm(path))

    def listdir(self, path: str) -> list[str]:
        p = self._norm(path) + os.sep
        with self._mu:
            return sorted({f[len(p):].split(os.sep)[0]
                           for f in self._files if f.startswith(p)})

    def remove(self, path: str) -> None:
        p = self._norm(path)
        with self._mu:
            if p not in self._files:
                raise FileNotFoundError(p)
            del self._files[p]

    def replace(self, src: str, dst: str) -> None:
        s, d = self._norm(src), self._norm(dst)
        with self._mu:
            if s not in self._files:
                raise FileNotFoundError(s)
            node = self._files.pop(s)
            # rename is atomic+durable once the source was synced
            self._files[d] = node

    def exists(self, path: str) -> bool:
        p = self._norm(path)
        with self._mu:
            return p in self._files or p in self._dirs or any(
                f.startswith(p + os.sep) for f in self._files)

    def getsize(self, path: str) -> int:
        p = self._norm(path)
        with self._mu:
            if p not in self._files:
                raise FileNotFoundError(p)
            return len(self._files[p].data)

    def fsync(self, f) -> None:
        if not isinstance(f, _MemFile):
            raise TypeError("MemFS.fsync on a non-MemFS file")
        with self._mu:
            f._node.synced = bytes(f._node.data)

    def fsync_dir(self, path: str) -> None:
        pass  # MemFS models renames as atomic+durable (see replace)

    def flock_exclusive(self, f) -> None:
        with self._mu:
            if f._path in self._locks:
                raise OSError(f"{f._path}: already locked")
            self._locks.add(f._path)

    def flock_unlock(self, f) -> None:
        with self._mu:
            self._locks.discard(f._path)

    # -- test surface --
    def crash(self, prefix: str | None = None) -> None:
        """Simulate power loss: revert every file to its last-synced
        content; files never synced disappear.  Locks are released.

        ``prefix`` scopes the loss to one path subtree — the model for a
        single process dying while other NodeHosts share this MemFS
        (each host's data dir is a distinct subtree)."""
        with self._mu:
            pfx = None if prefix is None else self._norm(prefix)
            for p in list(self._files):
                if pfx is not None and not (
                        p == pfx or p.startswith(pfx + os.sep)):
                    continue
                node = self._files[p]
                if node.synced:
                    node.data = bytearray(node.synced)
                else:
                    del self._files[p]
            if pfx is None:
                self._locks.clear()
            else:
                self._locks = {p for p in self._locks
                               if not (p == pfx or
                                       p.startswith(pfx + os.sep))}


# ---------------------------------------------------------------------------
# Error injection
# ---------------------------------------------------------------------------

_FILE_OPS = ("write", "read", "fsync")


class _ErrFile:
    """Wraps a file so write/read also hit the injection hook."""

    def __init__(self, fs: "ErrorFS", path: str, f):
        self._fs = fs
        self._path = path
        self._f = f

    def write(self, b):
        self._fs._check("write", self._path)
        return self._f.write(b)

    def read(self, n: int = -1):
        self._fs._check("read", self._path)
        return self._f.read(n)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False


class ErrorFS:
    """Error-injecting FS wrapper (vfs.go ErrorFS / charybdefs analog).

    ``inject`` is ``(op, path) -> bool``; ops: open, write, read, fsync,
    remove, replace, listdir.  Convenience constructors cover the common
    policies: fail every matching op (:meth:`on_op`), or start failing
    after N successful operations (:meth:`fail_after`) — the pattern used
    to walk a workload through every IO point."""

    def __init__(self, base, inject=None) -> None:
        self.base = base
        self.inject = inject or (lambda op, path: False)
        self.ops = 0
        self._mu = threading.Lock()

    @classmethod
    def on_op(cls, base, *ops: str, path_substr: str = ""):
        def hook(op, path):
            return op in ops and path_substr in path
        return cls(base, hook)

    @classmethod
    def fail_after(cls, base, n: int, *ops: str):
        fs = cls(base)
        target_ops = ops or ("write", "fsync")

        def hook(op, path, fs=fs):
            return op in target_ops and fs.ops > n
        fs.inject = hook
        return fs

    def _check(self, op: str, path: str) -> None:
        with self._mu:
            self.ops += 1
        if self.inject(op, path):
            raise InjectedError(f"injected {op} error: {path}")

    # -- IFS surface (delegating, with checks on mutating/read ops) --
    def open(self, path: str, mode: str = "rb"):
        self._check("open", path)
        return _ErrFile(self, path, self.base.open(path, mode))

    def makedirs(self, path: str) -> None:
        self.base.makedirs(path)

    def listdir(self, path: str) -> list[str]:
        self._check("listdir", path)
        return self.base.listdir(path)

    def remove(self, path: str) -> None:
        self._check("remove", path)
        self.base.remove(path)

    def replace(self, src: str, dst: str) -> None:
        self._check("replace", src)
        self.base.replace(src, dst)

    def exists(self, path: str) -> bool:
        return self.base.exists(path)

    def getsize(self, path: str) -> int:
        return self.base.getsize(path)

    def fsync(self, f) -> None:
        inner = f._f if isinstance(f, _ErrFile) else f
        self._check("fsync", getattr(f, "_path", "?"))
        self.base.fsync(inner)

    def fsync_dir(self, path: str) -> None:
        self._check("fsync", path)
        self.base.fsync_dir(path)

    def flock_exclusive(self, f) -> None:
        inner = f._f if isinstance(f, _ErrFile) else f
        self.base.flock_exclusive(inner)

    def flock_unlock(self, f) -> None:
        inner = f._f if isinstance(f, _ErrFile) else f
        self.base.flock_unlock(inner)


def copy_file(fs, src: str, dst: str, block: int = 1 << 20) -> int:
    """Copy src -> dst through ``fs`` with a trailing fsync; returns the
    byte count.  The one file-copy loop (snapshot containers, external
    snapshot files, import staging) so block size and fsync discipline
    cannot drift between call sites."""
    n = 0
    with fs.open(src, "rb") as f, fs.open(dst, "wb") as out:
        while True:
            chunk = f.read(block)
            if not chunk:
                break
            out.write(chunk)
            n += len(chunk)
        fs.fsync(out)
    return n
