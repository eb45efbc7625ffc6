"""ApplyPool — dedicated RSM-apply workers for host-resident shards.

The reference isolates user state-machine latency from the raft step
path with separate apply workers (``engine.go:1153-1204`` applyWorkerMain
/ commitWorkerMain): a step worker persists and hands committed entries
off; a slow ``Update()`` can only ever stall its own shard, never the
stepping of the other shards in its partition.

This pool implements that contract with a ready-queue of shard keys and
one FIFO of closures per shard: a worker claims a shard exclusively,
drains the closures queued so far, and re-queues the shard if more
arrived while it ran.  Per-shard order is preserved; a shard whose SM
blocks occupies exactly one worker.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable

from dragonboat_tpu_torch import lifecycle


class ApplyPool:
    def __init__(self, num_workers: int = 4,
                 on_work_done: Callable[[], None] | None = None,
                 name: str = "apply") -> None:
        self._cv = threading.Condition()
        self._queues: dict[object, deque] = {}   # guarded-by: _cv
        self._ready: deque = deque()             # guarded-by: _cv — keys with work, not being run
        self._running: set = set()               # guarded-by: _cv
        self._stopped = False                    # guarded-by: _cv
        self._on_work_done = on_work_done
        self._threads = []                       # guarded-by: <init-only>
        for i in range(max(1, num_workers)):
            t = threading.Thread(target=self._worker_main,
                                 name=f"{name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def submit(self, key, fn: Callable[[], None],
               trace_keys: tuple = ()) -> None:
        """Enqueue ``fn`` on ``key``'s serial lane.  ``trace_keys`` are
        sampled proposal keys riding in this closure: the worker stamps
        their lifecycle spans when the closure actually starts, so the
        apply_queue->apply delta measures real pool dwell."""
        with self._cv:
            if self._stopped:
                return
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
            q.append((fn, trace_keys))
            if key not in self._running and key not in self._ready:
                self._ready.append(key)
                self._cv.notify()

    def flush(self, key, timeout: float = 10.0) -> bool:
        """Block until ``key`` has no queued or running work (shard stop:
        the SM must not be closed under a still-running apply)."""
        deadline = threading.TIMEOUT_MAX if timeout is None else timeout
        with self._cv:
            return self._cv.wait_for(
                lambda: key not in self._running
                and not self._queues.get(key),
                timeout=deadline)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._queues.clear()
            self._ready.clear()
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)

    def _worker_main(self) -> None:
        while True:
            with self._cv:
                while not self._ready and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                key = self._ready.popleft()
                q = self._queues.get(key)
                if not q:
                    continue
                batch, self._queues[key] = q, deque()
                self._running.add(key)
            try:
                for fn, trace_keys in batch:
                    for tk in trace_keys:
                        lifecycle.TRACER.stamp(tk, lifecycle.STAGE_APPLY)
                    try:
                        fn()
                    except Exception:
                        from dragonboat_tpu_torch.logger import get_logger

                        get_logger("engine").exception(
                            "apply work for %r failed", key)
            finally:
                with self._cv:
                    self._running.discard(key)
                    if self._queues.get(key):
                        self._ready.append(key)
                        self._cv.notify()
                    else:
                        # retired/idle keys must not leak a dict slot
                        # per shard forever (100k-group scale)
                        self._queues.pop(key, None)
                    self._cv.notify_all()  # wake flush() waiters
            if self._on_work_done is not None:
                self._on_work_done()
