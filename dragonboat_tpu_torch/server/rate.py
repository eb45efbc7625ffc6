"""In-memory log rate limiter — parity ``internal/server/rate.go``.

Tracks the byte size of a shard's not-yet-applied log tail; when it
exceeds ``Config.max_in_mem_log_size`` the shard reports rate-limited and
new proposals are rejected with system-busy until applies drain the tail
(the reference additionally aggregates follower states; here the local
size is the signal — the leader is where proposals arrive)."""

from __future__ import annotations

import threading


class RateLimiter:
    def __init__(self, max_size: int) -> None:
        self.max_size = max_size
        self._size = 0
        self._mu = threading.Lock()

    def enabled(self) -> bool:
        return self.max_size > 0

    def increase(self, n: int) -> None:
        with self._mu:
            self._size += n

    def decrease(self, n: int) -> None:
        with self._mu:
            self._size = max(0, self._size - n)

    def reset(self) -> None:
        with self._mu:
            self._size = 0

    def get(self) -> int:
        with self._mu:
            return self._size

    def rate_limited(self) -> bool:
        if not self.enabled():
            return False
        with self._mu:
            return self._size > self.max_size
