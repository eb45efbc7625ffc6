"""Many raft groups on the TPU kernel: device-resident shards.

The dragonboat-example/multigroup analog, TPU-first: 32 shards run as
lanes of ONE batched device kernel (Config.device_resident) — a single
jitted step advances all of them. The host keeps the client API,
durable log, and snapshots.

Run: python -m dragonboat_tpu_torch.examples.multigroup_device
[--shards N] [--device cpu]
"""

import time

from dragonboat_tpu_torch.config import Config, ExpertConfig, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.request import RequestDroppedError, RequestTimeoutError

from dragonboat_tpu_torch.examples.helloworld import KVStore, _args


def main(argv=None) -> int:
    args = _args(argv, (("--shards",), dict(type=int, default=32)))
    n = args.shards
    shards = tuple(range(1, n + 1))
    nh = NodeHost(NodeHostConfig(
        raft_address="multi-1", rtt_millisecond=5,
        expert=ExpertConfig(kernel_log_cap=256, kernel_capacity=64)),
        device=args.device)
    for sid in shards:
        nh.start_replica({1: "multi-1"}, False, KVStore, Config(
            shard_id=sid, replica_id=1, election_rtt=10, heartbeat_rtt=1,
            device_resident=True))         # <- lane of the batched kernel
    deadline = time.time() + 120           # first jit compile is slow
    while time.time() < deadline:
        if all(nh.get_leader_id(s)[1] for s in shards):
            break
        time.sleep(0.2)
    elected = sum(nh.get_leader_id(s)[1] for s in shards)
    print(f"{elected}/{n} shards elected on the device kernel")
    assert nh.nodes[1].peer is None, "raft state lives on the device"

    wrote = 0
    deadline = time.time() + 60
    for sid in shards:
        session = nh.get_noop_session(sid)
        while time.time() < deadline:
            try:
                nh.sync_propose(session, f"shard={sid}".encode(),
                                timeout_s=2.0)
                wrote += 1
                break
            except (RequestDroppedError, RequestTimeoutError):
                time.sleep(0.05)
    print(f"wrote to {wrote}/{n} shards through one batched kernel")
    deadline = time.time() + 30
    read_value = None
    while time.time() < deadline:
        try:
            read_value = nh.sync_read(shards[n // 2], "shard")
            break
        except (RequestDroppedError, RequestTimeoutError):
            time.sleep(0.05)  # transient right after elections; retry
    mid = shards[n // 2]
    assert read_value is not None, f"shard {mid} never served the read"
    print(f"shard {mid} reads:", read_value)
    nh.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
