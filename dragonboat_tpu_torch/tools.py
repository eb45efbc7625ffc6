"""tools — offline cluster repair utilities.

Parity with the reference's ``tools`` package, chiefly ImportSnapshot
(tools/import.go:134): when a shard has permanently lost its quorum, an
exported snapshot is imported into selected node-host data dirs with a
REWRITTEN membership, so the survivors restart as a fresh quorum holding
the old state machine data.

Exported snapshots (``sync_request_snapshot(export_path=...)``) are the
SM image file plus a JSON metadata sidecar (``<path>.meta.json``) holding
index/term/membership/shard — the analog of the reference's exported
snapshot dir with its flag file (tools/import.go getSnapshotRecord).
"""

from __future__ import annotations

import json
import os

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.config import NodeHostConfig
from dragonboat_tpu_torch.logdb.tan import TanLogDB
from dragonboat_tpu_torch.logger import get_logger
from dragonboat_tpu_torch.server.env import Env
from dragonboat_tpu_torch.vfs import copy_file

_LOG = get_logger("tools")

META_SUFFIX = ".meta.json"


def write_export_metadata(path: str, ss: pb.Snapshot, fs=None) -> None:
    """Sidecar written next to an exported snapshot image."""
    from dragonboat_tpu_torch.vfs import default_fs

    fs = fs if fs is not None else default_fs()
    meta = {
        "shard_id": ss.shard_id,
        "index": ss.index,
        "term": ss.term,
        "type": int(ss.type),
        "membership": {
            "config_change_id": ss.membership.config_change_id,
            "addresses": {str(k): v
                          for k, v in ss.membership.addresses.items()},
            "non_votings": {str(k): v
                            for k, v in ss.membership.non_votings.items()},
            "witnesses": {str(k): v
                          for k, v in ss.membership.witnesses.items()},
        },
        # external snapshot files (rsm/files.go): recorded by basename —
        # they travel NEXT TO the exported image
        "files": [
            {
                "file_id": f.file_id,
                "basename": os.path.basename(f.filepath),
                "file_size": f.file_size,
                "metadata_hex": f.metadata.hex(),
            }
            for f in ss.files
        ],
    }
    tmp = path + META_SUFFIX + ".tmp"
    with fs.open(tmp, "w") as f:
        json.dump(meta, f)
        fs.fsync(f)
    fs.replace(tmp, path + META_SUFFIX)


def read_export_metadata(path: str, fs=None) -> dict:
    from dragonboat_tpu_torch.vfs import default_fs

    fs = fs if fs is not None else default_fs()
    with fs.open(path + META_SUFFIX, "r") as f:
        return json.loads(f.read())


def import_snapshot(nhconfig: NodeHostConfig, src_path: str,
                    members: dict[int, str], replica_id: int) -> None:
    """ImportSnapshot (tools/import.go:134): place an exported snapshot
    into ``replica_id``'s data dir with membership REWRITTEN to
    ``members``, so the next ``start_replica`` restarts from it.

    Must run while the target NodeHost is DOWN (the env lock enforces
    this).  Every member of ``members`` must run the same import against
    its own data dir before any of them restarts."""
    if replica_id not in members:
        raise ValueError(f"replica {replica_id} not in the new membership")
    from dragonboat_tpu_torch.vfs import default_fs

    fs = (nhconfig.expert.fs if nhconfig.expert.fs is not None
          else default_fs())
    meta = read_export_metadata(src_path, fs=fs)
    membership = pb.Membership(
        config_change_id=meta["index"],
        addresses=dict(members),
    )
    env = Env(nhconfig.node_host_dir, nhconfig.raft_address,
              nhconfig.deployment_id, wal_dir=nhconfig.wal_dir, fs=fs)
    env.lock()
    try:
        env.check_node_host_dir("sharded-tan", compatible=("tan",))
        shard_id = int(meta["shard_id"])
        # place the image in the replica's snapshot dir
        dst_dir = env.snapshot_dir(shard_id, replica_id)
        index = int(meta["index"])
        dst = os.path.join(
            dst_dir,
            f"snapshot-{shard_id:016X}-{replica_id:016X}-{index:016X}"
            ".gbsnap")
        copy_file(fs, src_path, dst)
        # external snapshot files travel next to the exported image and
        # land next to the imported one
        files = []
        src_dir = os.path.dirname(src_path) or "."
        for fm in meta.get("files", ()):
            src_f = os.path.join(src_dir, fm["basename"])
            dst_f = f"{dst}.xf{fm['file_id']}"
            copy_file(fs, src_f, dst_f)
            files.append(pb.SnapshotFile(
                file_id=int(fm["file_id"]), filepath=dst_f,
                metadata=bytes.fromhex(fm.get("metadata_hex", "")),
                file_size=int(fm["file_size"])))
        ss = pb.Snapshot(
            filepath=dst,
            file_size=fs.getsize(dst),
            index=index,
            term=int(meta["term"]),
            membership=membership,
            shard_id=shard_id,
            type=pb.StateMachineType(meta.get("type", 0)),
            imported=True,
            files=tuple(files),
        )
        # rebuild the replica's log-db state around the imported snapshot:
        # drop old state, stamp the snapshot + bootstrap (import.go main
        # flow: ssEnv.FinalizeSnapshot + logdb writes)
        # open the dir's own engine: the geometry the owning NodeHost
        # pinned (TANSHARDS marker), or the default sharded layout for a
        # fresh/legacy dir — a flat TanLogDB here would strand the
        # R_REMOVE + import records outside the partitions
        from dragonboat_tpu_torch.logdb.sharded import ShardedLogDB

        stored = ShardedLogDB.stored_shard_count(env.logdb_dir, fs)
        db = ShardedLogDB(
            env.logdb_dir,
            num_shards=(stored if stored is not None
                        else nhconfig.expert.logdb.shards),
            fs=fs)
        try:
            db.import_snapshot(ss, replica_id)
        finally:
            db.close()
        _LOG.info("imported snapshot idx=%d for shard %d replica %d into %s",
                  index, shard_id, replica_id, env.root)
    finally:
        env.close()
