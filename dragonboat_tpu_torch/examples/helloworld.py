"""Hello, dragonboat-tpu: a 3-replica KV shard in one process.

The in-process analog of dragonboat-example/helloworld: three NodeHosts
over the chan transport host one replicated KV state machine; writes go
through SyncPropose (full raft round), reads through SyncRead
(linearizable ReadIndex).

Run: python -m dragonboat_tpu_torch.examples.helloworld [--device cpu]
"""

import argparse
import time

from dragonboat_tpu_torch.config import Config, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.statemachine import IStateMachine, Result


def _args(argv, *extra):
    """``--device`` (the CUDA card unless given; ``cpu`` runs the plain
    arms on the CPU) and the example's own arguments."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="the device of the engines' state (default: the "
                        "CUDA card; raises without one)")
    for args, kw in extra:
        p.add_argument(*args, **kw)
    return p.parse_args(argv)


class KVStore(IStateMachine):
    """cmd = b"key=value"; lookup(key) -> value."""

    def __init__(self, shard_id, replica_id):
        self.kv = {}

    def update(self, entry):
        k, v = entry.cmd.decode().split("=", 1)
        self.kv[k] = v
        return Result(value=len(self.kv))

    def lookup(self, key):
        return self.kv.get(key)

    def save_snapshot(self, w, files, done):
        data = "\n".join(f"{k}={v}" for k, v in sorted(self.kv.items()))
        w.write(data.encode())

    def recover_from_snapshot(self, r, files, done):
        self.kv = dict(line.split("=", 1)
                       for line in r.read().decode().split("\n") if line)


def main(argv=None) -> int:
    args = _args(argv)
    members = {1: "hello-1", 2: "hello-2", 3: "hello-3"}
    hosts = {}
    for replica_id, addr in members.items():
        nh = NodeHost(NodeHostConfig(raft_address=addr, rtt_millisecond=5),
                      device=args.device)
        nh.start_replica(members, False, KVStore, Config(
            shard_id=128, replica_id=replica_id,
            election_rtt=10, heartbeat_rtt=1,
            snapshot_entries=1000, compaction_overhead=50))
        hosts[replica_id] = nh

    # wait for a leader
    leader = None
    deadline = time.time() + 15
    while time.time() < deadline and leader is None:
        for rid, nh in hosts.items():
            lid, ok = nh.get_leader_id(128)
            if ok:
                leader = lid
                break
        time.sleep(0.05)
    assert leader is not None, "no leader elected"
    print(f"leader of shard 128: replica {leader}")

    nh = hosts[leader]
    session = nh.get_noop_session(128)
    for city, weather in [("tokyo", "sunny"), ("dublin", "rain"),
                          ("oakland", "fog")]:
        nh.sync_propose(session, f"{city}={weather}".encode())
        print(f"wrote {city}={weather}")

    # linearizable read from any host (follower hosts forward ReadIndex)
    reader = hosts[1 if leader != 1 else 2]
    print("dublin (linearizable read via follower host):",
          reader.sync_read(128, "dublin"))

    for nh in hosts.values():
        nh.close()
    print("ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
