"""Deterministic chaos harness: seeded fault plans over the storage,
transport, and process seams, driven by a schedule runner with a
convergence oracle (the reference's monkey.go nightly harness,
docs/test.md, re-expressed as replayable fault schedules).

- :mod:`dragonboat_tpu_torch.chaos.faultplan` — seeded FaultPlan generation
  and the canonical-JSON trace contract (same seed -> byte-identical
  trace; a recorded trace replays as a plan).
- :mod:`dragonboat_tpu_torch.chaos.crashfs` — CrashPointFS, an ErrorFS that
  trips at the Nth matching op, optionally tearing the final write.
- :mod:`dragonboat_tpu_torch.chaos.oracle` — pure convergence checks: zero
  committed-entry loss, identical committed prefixes, monotone applied
  indices, hash equality.
- :mod:`dragonboat_tpu_torch.chaos.runner` — builds a MemFS cluster, executes
  a plan against it, and returns the recorded trace + oracle report.
"""

from dragonboat_tpu_torch.chaos.crashfs import CrashPointFS
from dragonboat_tpu_torch.chaos.faultplan import FaultEvent, FaultPlan
from dragonboat_tpu_torch.chaos.oracle import OracleReport, check_convergence
from dragonboat_tpu_torch.chaos.runner import (
    DetectorResult,
    HotspotResult,
    ScheduleResult,
    run_detector_differential,
    run_hotspot,
    run_schedule,
)

__all__ = [
    "CrashPointFS",
    "DetectorResult",
    "FaultEvent",
    "FaultPlan",
    "HotspotResult",
    "OracleReport",
    "check_convergence",
    "ScheduleResult",
    "run_detector_differential",
    "run_hotspot",
    "run_schedule",
]
