"""Hard/soft settings — parity with ``internal/settings/hard.go:5-21``.

Hard settings can NEVER change once a deployment has written data; their
hash is stamped into the data dir's flag file and checked on every reopen
(environment.go check → ErrHardSettingsChanged).  Like the reference, a
``dragonboat-tpu-hard-settings.json`` file in the working directory can
override the defaults at first deployment time.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass, fields


@dataclass(frozen=True)
class HardSettings:
    """Values that shape the on-disk format (hard.go hard struct)."""

    # max client sessions concurrently tracked per raft shard (hard.go)
    lru_max_session_count: int = 4096
    # max size of each entry batch in the log engine (hard.go)
    logdb_entry_batch_size: int = 48
    # block size of the snapshot file format (rsm/snapshotio block CRC)
    snapshot_block_size: int = 128 * 1024

    def hash(self) -> int:
        """Deterministic stamp of every hard value (hard.go Hash())."""
        h = hashlib.md5()
        for f in fields(self):
            h.update(f.name.encode())
            h.update(str(getattr(self, f.name)).encode())
        return int.from_bytes(h.digest()[:8], "little")


@dataclass(frozen=True)
class SoftSettings:
    """Tunables that do NOT affect the data format (soft.go excerpt)."""

    # engine ingress queue lengths (soft.go GetSoftSettings)
    incoming_proposal_queue_length: int = 2048
    incoming_read_index_queue_length: int = 4096
    # snapshot chunk streaming
    snapshot_chunk_size: int = 2 * 1024 * 1024
    max_concurrent_streaming_snapshots: int = 128
    # in-memory log growth guard (logentry GC trigger)
    in_mem_gc_timeout: int = 100


def _load(cls, filename: str):
    defaults = cls()
    try:
        with open(os.path.join(os.getcwd(), filename)) as f:
            overrides = json.load(f)
    except (OSError, ValueError):
        return defaults
    known = {f.name for f in fields(cls)}
    vals = asdict(defaults)
    vals.update({k: v for k, v in overrides.items() if k in known})
    return cls(**vals)


hard: HardSettings = _load(HardSettings, "dragonboat-tpu-hard-settings.json")
soft: SoftSettings = _load(SoftSettings, "dragonboat-tpu-soft-settings.json")
