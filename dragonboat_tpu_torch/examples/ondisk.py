"""Durable mode: tan-backed raft log, crash-safe restart.

The dragonboat-example/ondisk analog: one shard on a real data
directory. Run it twice — the second run recovers every write from the
tan log + snapshots without initial members (they come from storage).

Run: python -m dragonboat_tpu_torch.examples.ondisk DIR [--device cpu]
"""

import time

from dragonboat_tpu_torch.config import Config, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost

from dragonboat_tpu_torch.examples.helloworld import (  # same SM, durable host
    KVStore,
    _args,
)


def main(argv=None) -> int:
    args = _args(argv, (("data_dir",), dict(nargs="?",
                                            default="/tmp/dbtpu-example")))
    data_dir = args.data_dir
    nh = NodeHost(NodeHostConfig(
        raft_address="durable-1", rtt_millisecond=5,
        node_host_dir=data_dir),           # <- durable: tan is the LogDB
        device=args.device)
    print("LogDB engine:", nh.logdb.name())
    restarting = nh.has_node_info(1, 1)
    nh.start_replica({} if restarting else {1: "durable-1"}, False,
                     KVStore, Config(
                         shard_id=1, replica_id=1, election_rtt=10,
                         heartbeat_rtt=1, snapshot_entries=100,
                         compaction_overhead=10))
    deadline = time.time() + 15
    while time.time() < deadline and not nh.get_leader_id(1)[1]:
        time.sleep(0.05)

    if restarting:
        deadline = time.time() + 10
        while time.time() < deadline and nh.stale_read(1, "boot") is None:
            time.sleep(0.05)
        print("recovered from disk: boot =", nh.stale_read(1, "boot"))

    session = nh.get_noop_session(1)
    stamp = str(int(time.time()))
    nh.sync_propose(session, f"boot={stamp}".encode())
    print("wrote boot =", stamp, "| run me again to see it recovered")
    nh.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
