"""Log storage engines behind raftio.ILogDB.

- :class:`MemLogDB` — in-memory engine for tests and the loopback runtime
  (the analog of the reference's pebble-on-MemFS configuration).
- :mod:`.tan` — the file-backed engine modeled on the reference's tan
  (per-shard append-only log files + in-memory index + manifest,
  ``internal/tan/``), which is batch-append-shaped like the kernel's
  SaveRaftState batches.
- :mod:`.kv` / :mod:`.kvdb` — the sorted-KV LSM engine and its ILogDB
  adapter (the analog of the reference's Pebble logdb,
  ``internal/logdb/kv_logdb.go``) — the second storage design point.
- :class:`LogReader` — the raft core's cached read-side window over stable
  storage (parity internal/logdb/logreader.go).
"""

from dragonboat_tpu_torch.logdb.memdb import MemLogDB
from dragonboat_tpu_torch.logdb.logreader import LogReader
from dragonboat_tpu_torch.logdb.kvdb import KVLogDB, KVLogDBFactory

__all__ = ["MemLogDB", "LogReader", "KVLogDB", "KVLogDBFactory"]

