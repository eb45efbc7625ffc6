"""Tracing / profiling hooks.

The reference has no tracer (SURVEY §5 flags this as a gap to fill, not a
port): its observability is module loggers + Prometheus counters.  The
TPU build adds a real trace path on top of the same metrics registry:

- ``start_trace(dir)`` / ``stop_trace()`` — ``torch.profiler`` capture
  (host ops, CUDA kernels on the card) written as a Chrome trace,
  viewable in Perfetto;
- ``annotate(name)`` — named span inside the trace
  (``torch.profiler.record_function``), used around the kernel engine's
  step phases;
- ``StepTimer`` — lightweight EWMA + max step-latency accounting that
  feeds the shared metrics registry (``engine.step_us_*`` counters), on
  all the time (the profiler itself is opt-in: capture costs memory),
  plus a bounded ring of the most recent samples for medians.

Environment: ``DRAGONBOAT_TPU_TRACE_DIR`` arms profiler capture at import
of the engine, for drive-by profiling without code changes.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

_active_trace_dir: str | None = None
_profiler = None  # the active torch.profiler.profile, if any
# set while the ACTIVE capture was armed by DRAGONBOAT_TPU_TRACE_DIR
# (maybe_start_from_env) rather than an explicit start_trace call —
# engine close() stops env-armed captures, never user-started ones
_env_armed = False


def monotonic_us() -> int:
    """Monotonic microsecond clock for lifecycle stage stamps.

    Lives HERE (outside the determinism lint scope) so lifecycle.py can
    receive it by injection: the tracer module itself never names a wall
    clock, tests inject a deterministic counter, and the lint keeps the
    replay-path modules honest."""
    return time.monotonic_ns() // 1000


def start_trace(trace_dir: str) -> None:
    """Begin a ``torch.profiler`` capture (host ops, and the CUDA kernels
    when a card is present) that lands in ``trace_dir`` at stop.

    Raises ``RuntimeError`` when a capture is already active: one capture
    at a time, and silently overwriting ``_active_trace_dir`` would make
    ``stop_trace`` report the second dir while the first is written."""
    global _active_trace_dir, _profiler
    if _active_trace_dir is not None:
        raise RuntimeError(
            f"a trace is already active in {_active_trace_dir!r}; call "
            "stop_trace() before starting another capture")
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _profiler = prof
    _active_trace_dir = trace_dir


def stop_trace() -> str | None:
    """End the capture and write it as ``trace.json`` (Chrome trace
    format) under the trace dir; returns the dir (None if none active)."""
    global _active_trace_dir, _env_armed, _profiler
    if _active_trace_dir is None:
        return None
    prof, _profiler = _profiler, None
    d, _active_trace_dir = _active_trace_dir, None
    _env_armed = False
    prof.stop()
    os.makedirs(d, exist_ok=True)
    prof.export_chrome_trace(os.path.join(d, "trace.json"))
    return d


def stop_env_trace() -> str | None:
    """Stop the capture ONLY when it was armed by the environment
    (``DRAGONBOAT_TPU_TRACE_DIR``); returns the flushed dir, or None.

    Engine ``close()`` calls this: a capture is only written on stop,
    so an env-armed trace that survived to interpreter shutdown depended
    on atexit ordering to flush at all — a host that is closed
    deliberately should flush its capture right there, while the CUDA
    context is unambiguously alive.  A capture the USER started with
    ``start_trace`` is left alone (they own its lifetime)."""
    if not _env_armed:
        return None
    return stop_trace()


_env_hook_registered = False


def _atexit_stop() -> None:
    """atexit wrapper: an env-armed capture may already have been
    stopped by hand, and interpreter-shutdown stops must never mask the
    real exit path with a profiler error."""
    try:
        stop_trace()
    except Exception:
        pass


def maybe_start_from_env() -> bool:
    """Arm capture when DRAGONBOAT_TPU_TRACE_DIR is set (idempotent).
    The capture is only written on stop, so an env-armed trace registers
    an atexit stop — otherwise the dir would stay empty.  The hook is
    registered exactly once per process."""
    global _env_hook_registered, _env_armed
    d = os.environ.get("DRAGONBOAT_TPU_TRACE_DIR")
    if d and _active_trace_dir is None:
        import atexit

        start_trace(d)
        _env_armed = True
        if not _env_hook_registered:
            _env_hook_registered = True
            atexit.register(_atexit_stop)
        return True
    return False


def annotate(name: str):
    """Named span in the profiler trace (``torch.profiler.record_function``);
    near-zero cost when no capture is active (a module-flag check, no
    span object)."""
    if _active_trace_dir is None:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


class StepTimer:
    """Step-latency accounting into a Metrics registry.

    Typed instruments via the events.Metrics facade: ``.steps`` /
    ``.total_us`` are counters, ``.ewma_us`` / ``.max_us`` gauges, and
    ``.latency_us`` a fixed-bucket histogram for the Prometheus
    exposition; the legacy snapshot keys are unchanged."""

    def __init__(self, metrics, prefix: str) -> None:
        self.metrics = metrics
        self.prefix = prefix
        self._ewma_us = 0.0
        self._max_us = 0
        #: the most recent step times in microseconds (for medians)
        self.samples: deque = deque(maxlen=4096)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        us = (time.perf_counter() - t0) * 1e6
        self._ewma_us = us if self._ewma_us == 0 else (
            0.9 * self._ewma_us + 0.1 * us)
        self._max_us = max(self._max_us, int(us))
        self.samples.append(us)
        m = self.metrics
        m.inc(f"{self.prefix}.steps")
        m.inc(f"{self.prefix}.total_us", int(us))
        m.set(f"{self.prefix}.ewma_us", int(self._ewma_us))
        m.set(f"{self.prefix}.max_us", self._max_us)
        m.observe(f"{self.prefix}.latency_us", us)
