"""CrashPointFS — crash-at-the-Nth-op error injection with torn writes.

Extends :class:`dragonboat_tpu_torch.vfs.ErrorFS`: instead of a static inject
hook, the fs is **armed** with a countdown over matching operations.
When the countdown reaches zero the fs *trips*: the triggering op — and
every matching op after it — raises ``InjectedError`` until
:meth:`heal` is called.  This models a disk that dies and stays dead
until the operator replaces it, which is exactly the window the
NodeHost's controlled-crash + ``restart()`` path must survive.

With ``torn=True`` the tripping op, if it is a ``write``, first lands a
PREFIX of the buffer on the underlying fs before raising — a torn final
record, the crash shape tan's tail-truncation recovery exists for
(logdb/tan.py ``_replay_file``).
"""

from __future__ import annotations

import threading

from dragonboat_tpu_torch.vfs import ErrorFS, InjectedError, _ErrFile

DEFAULT_OPS = ("write", "fsync")


class _CrashFile(_ErrFile):
    """File wrapper whose write path knows how to tear the last write."""

    def write(self, b):
        consumed = self._fs._on_write(self._path, self._f, b)
        if consumed:
            return len(b)
        return self._f.write(b)


class CrashPointFS(ErrorFS):
    """ErrorFS with an armed crash point (charybdefs fault cartridge).

    ``arm(after_ops, torn)`` starts a countdown: the next ``after_ops``
    matching operations succeed, the one after trips the fs.  Ops are
    matched by name (default ``write``/``fsync`` — the durability path)
    and, optionally, by ``path_substr``.
    """

    def __init__(self, base, ops: tuple = DEFAULT_OPS,
                 path_substr: str = "") -> None:
        super().__init__(base, self._inject)
        self.match_ops = ops                 # guarded-by: <init-only>
        self.path_substr = path_substr       # guarded-by: <init-only>
        self._armed = False                  # guarded-by: _cmu
        self._countdown = 0                  # guarded-by: _cmu
        self._torn = False                   # guarded-by: _cmu
        self.tripped = False                 # guarded-by: _cmu
        self.trip_count = 0                  # guarded-by: _cmu
        self._cmu = threading.Lock()

    # -- arming ----------------------------------------------------------

    def arm(self, after_ops: int, torn: bool = False) -> None:
        """Trip after ``after_ops`` more matching operations succeed."""
        with self._cmu:
            self._armed = True
            self._countdown = after_ops
            self._torn = torn
            self.tripped = False

    def heal(self) -> None:
        """Clear the trip — the replacement disk; IO flows again."""
        with self._cmu:
            self._armed = False
            self.tripped = False
            self._torn = False

    # -- injection -------------------------------------------------------

    def _matches(self, op: str, path: str) -> bool:
        return op in self.match_ops and self.path_substr in path

    def _inject(self, op: str, path: str) -> bool:
        if not self._matches(op, path):
            return False
        fail, _ = self._step()
        return fail

    def _step(self) -> tuple:
        """Advance the countdown for one matching op.  Returns
        ``(fail, tear)``: fail the op, and — only on the very op that
        trips while armed torn — tear it."""
        with self._cmu:
            if self.tripped:
                self.trip_count += 1
                return True, False
            if not self._armed:
                return False, False
            if self._countdown > 0:
                self._countdown -= 1
                return False, False
            self.tripped = True
            self.trip_count += 1
            return True, self._torn

    def _on_write(self, path: str, inner_file, b) -> bool:
        """The write path, torn-aware: normally behaves exactly like the
        inject hook, but when the TRIPPING op is a write armed with
        ``torn=True``, half the buffer reaches the file before the
        error — the torn-final-record crash shape.  Returns True when
        the (partial) write was consumed here."""
        with self._mu:
            self.ops += 1
        if not self._matches("write", path):
            return False
        fail, tear = self._step()
        if not fail:
            return False
        if tear:
            data = b.encode() if isinstance(b, str) else bytes(b)
            inner_file.write(data[:max(1, len(data) // 2)])
        raise InjectedError(f"injected write error (crash point): {path}")

    # -- IFS overrides ---------------------------------------------------

    def open(self, path: str, mode: str = "rb"):
        self._check("open", path)
        return _CrashFile(self, path, self.base.open(path, mode))
