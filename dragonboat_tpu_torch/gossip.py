"""Gossip registry — dynamic NodeHostID-based addressing.

Parity with the reference's ``internal/registry/gossip.go``: when
``NodeHostConfig.address_by_node_host_id`` is set, raft targets are
persistent NodeHostIDs instead of raft addresses, and each host's
current raft address is disseminated by an anti-entropy gossip protocol
(the reference rides hashicorp/memberlist; this is a self-contained UDP
implementation of the same behavior: per-member versioned meta records
{nhid → raft_address}, periodic push to seeds + random peers, merge by
version, dead-member expiry).

``GossipRegistry`` wraps the static registry: (shard, replica) resolves
to a target string as usual; a target that is a NodeHostID is then
translated through the gossip view (gossip.go:157 Resolve →
metaStore.get).

Beyond addresses, hosts exchange a cluster-wide **shard view**
(``internal/registry/view.go:36-149``): per shard
``{shard_id, replicas, config_change_index, leader_id, term}``, merged
by config-change index (membership) and leader term (leadership), so any
host can answer "who leads shard N" without hosting a replica of it.
``GossipRegistry.get_shard_info`` / ``num_of_shards`` mirror
NodeHostRegistry (``internal/registry/nodehost.go:23-41``).
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time

from dragonboat_tpu_torch.logger import get_logger
from dragonboat_tpu_torch.raftio import INodeRegistry
from dragonboat_tpu_torch.registry import Registry

_LOG = get_logger("gossip")

GOSSIP_INTERVAL_S = 0.15
FANOUT = 3
EXPIRY_S = 30.0


class _Meta:
    __slots__ = ("raft_address", "version", "seen_at")

    def __init__(self, raft_address: str, version: int) -> None:
        self.raft_address = raft_address
        self.version = version
        self.seen_at = time.monotonic()


class ShardView:
    """One shard as the gossip mesh knows it (view.go:68-74)."""

    __slots__ = ("shard_id", "replicas", "config_change_index",
                 "leader_id", "term")

    def __init__(self, shard_id: int, replicas: dict[int, str] | None = None,
                 config_change_index: int = 0, leader_id: int = 0,
                 term: int = 0) -> None:
        self.shard_id = shard_id
        self.replicas = replicas or {}
        self.config_change_index = config_change_index
        self.leader_id = leader_id
        self.term = term


def _merge_shard_view(cur: ShardView, upd: ShardView) -> ShardView:
    """view.go:121 mergeShardView: membership by config-change index,
    leadership by (known leader, higher term)."""
    if cur.config_change_index < upd.config_change_index:
        cur.replicas = upd.replicas
        cur.config_change_index = upd.config_change_index
    if upd.leader_id != 0 and (cur.leader_id == 0 or upd.term > cur.term):
        cur.leader_id = upd.leader_id
        cur.term = upd.term
    return cur


class GossipManager:
    """UDP anti-entropy: each round, push the full view to up to FANOUT
    known members (+ the seeds until they answer)."""

    def __init__(self, nhid: str, raft_address: str, bind_address: str,
                 advertise_address: str = "", seeds: list[str] | None = None,
                 interval_s: float = GOSSIP_INTERVAL_S,
                 shard_info_fn=None) -> None:
        self.nhid = nhid
        self.raft_address = raft_address
        self.interval_s = interval_s
        # () -> list[ShardView] of the LOCAL host's shards, refreshed
        # before every push (nodehost wires get_node_host_info here)
        self.shard_info_fn = shard_info_fn
        self.shards: dict[int, ShardView] = {}
        self._last_refresh = 0.0
        host, port = _parse(bind_address)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            # multi-datagram bursts (chunked big views) overflow the
            # default rcvbuf; losing the SAME tail chunks every round
            # would stall anti-entropy convergence
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 4 << 20)
        except OSError:
            pass
        self.sock.bind((host, port))
        self.sock.settimeout(0.05)
        bound = self.sock.getsockname()
        if not advertise_address and bound[0] in ("0.0.0.0", "", "::"):
            self.sock.close()
            raise ValueError(
                "gossip: a wildcard bind_address requires an explicit "
                "advertise_address (peers would gossip to themselves)")
        self.advertise = advertise_address or f"{bound[0]}:{bound[1]}"
        self.seeds = [s for s in (seeds or []) if s != self.advertise]
        self.mu = threading.Lock()
        # nhid -> meta; members: gossip address -> last seen
        self.view: dict[str, _Meta] = {
            nhid: _Meta(raft_address, int(time.time() * 1000))}
        self.members: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="gossip",
                                        daemon=True)
        self._thread.start()

    # -- protocol ---------------------------------------------------------

    # a UDP datagram caps at ~65507 bytes; stay well under so the view
    # plus one shard chunk always fits (big shard sets span datagrams,
    # the anti-entropy merge is idempotent so chunk loss only delays)
    _MAX_DATAGRAM = 48 << 10

    def _payloads(self) -> list[bytes]:
        """Pack the member view AND the shard views into as many
        size-capped datagrams as needed (memberlist chunks its
        broadcasts the same way — one oversized sendto would EMSGSIZE
        and silently kill ALL dissemination).  Both record kinds are
        merged idempotently on receive, so any record landing in any
        datagram is enough."""
        self._refresh_local_shards()
        with self.mu:
            view_recs = [(n, [m.raft_address, m.version])
                         for n, m in self.view.items()]
            shard_recs = [[v.shard_id,
                           {str(r): a for r, a in v.replicas.items()},
                           v.config_change_index, v.leader_id, v.term]
                          for v in self.shards.values()]
        # the local address record rides every datagram so any single
        # received chunk identifies + locates the sender
        self_view = {n: rec for n, rec in view_recs if n == self.nhid}
        overhead = len(json.dumps({
            "from": self.advertise, "view": self_view, "shards": [],
        })) + 2
        room = self._MAX_DATAGRAM - overhead
        out: list[bytes] = []
        view_chunk: dict = dict(self_view)
        shard_chunk: list = []
        used = 0

        def flush():
            nonlocal view_chunk, shard_chunk, used
            out.append(json.dumps({
                "from": self.advertise,
                "view": view_chunk,
                "shards": shard_chunk,
            }).encode())
            view_chunk, shard_chunk, used = dict(self_view), [], 0

        items = [("v", r) for r in view_recs if r[0] != self.nhid] \
            + [("s", r) for r in shard_recs]
        # randomize chunk membership per push: if a fixed-size prefix of
        # the burst is all a congested receiver keeps, a deterministic
        # order would starve the same records forever
        random.shuffle(items)
        for kind, rec in items:
            cost = len(json.dumps(rec)) + 8
            if used and used + cost > room:
                flush()
            if kind == "v":
                view_chunk[rec[0]] = rec[1]
            else:
                shard_chunk.append(rec)
            used += cost
        flush()
        return out

    def _refresh_local_shards(self, min_interval_s: float | None = None
                              ) -> None:
        """Fold the local host's current shard states into the merged
        store (the reference's delegate pulls getShardInfo the same way
        before each exchange, gossip.go LocalState)."""
        if self.shard_info_fn is None:
            return
        now = time.monotonic()
        if min_interval_s is not None and \
                now - self._last_refresh < min_interval_s:
            return
        self._last_refresh = now
        try:
            local = self.shard_info_fn()
        except Exception:
            _LOG.debug("shard_info_fn failed", exc_info=True)
            return
        with self.mu:
            for v in local:
                cur = self.shards.get(v.shard_id)
                if cur is None:
                    self.shards[v.shard_id] = v
                else:
                    self.shards[v.shard_id] = _merge_shard_view(cur, v)

    def _run(self) -> None:
        last_push = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            if now - last_push >= self.interval_s:
                last_push = now
                self._push()
            try:
                data, addr = self.sock.recvfrom(65536)
            except (socket.timeout, OSError):
                continue
            try:
                msg = json.loads(data.decode())
                if isinstance(msg, dict):
                    self._merge(msg)
            except Exception:
                # a malformed datagram must never kill the gossip thread
                _LOG.debug("dropping malformed gossip datagram from %s",
                           addr, exc_info=True)

    def _push(self) -> None:
        payloads = self._payloads()
        with self.mu:
            known = list(self.members)
        targets = set(self.seeds)
        if known:
            targets.update(random.sample(known, min(FANOUT, len(known))))
        for t in targets:
            for payload in payloads:
                try:
                    self.sock.sendto(payload, _parse(t))
                except (OSError, ValueError):
                    # skip only this datagram: a payload-specific error
                    # (e.g. EMSGSIZE) must not starve the other chunks
                    continue

    def _merge(self, msg: dict) -> None:
        src = msg.get("from")
        now = time.monotonic()
        view = msg.get("view")
        if not isinstance(view, dict):
            view = {}
        with self.mu:
            if isinstance(src, str) and src != self.advertise:
                try:
                    _parse(src)  # only track pushable member addresses
                    self.members[src] = now
                except ValueError:
                    pass
            shards = msg.get("shards")
            if isinstance(shards, list):
                for rec in shards:
                    try:
                        sid = int(rec[0])
                        upd = ShardView(
                            sid,
                            {int(r): str(a) for r, a in rec[1].items()},
                            int(rec[2]), int(rec[3]), int(rec[4]))
                    except (TypeError, ValueError, IndexError,
                            AttributeError):
                        continue
                    cur = self.shards.get(sid)
                    if cur is None:
                        self.shards[sid] = upd
                    else:
                        self.shards[sid] = _merge_shard_view(cur, upd)
            for nhid, rec in view.items():
                if nhid == self.nhid:
                    # the local record is authoritative here — a stale
                    # echo (e.g. after a clock step) must not overwrite
                    # our own advertised address (memberlist's local-node
                    # special case)
                    continue
                try:
                    addr, version = rec[0], int(rec[1])
                except (TypeError, ValueError, IndexError):
                    continue
                cur = self.view.get(nhid)
                if cur is None or version > cur.version:
                    self.view[nhid] = _Meta(addr, version)
                elif cur is not None:
                    cur.seen_at = now
            # expire members we have not heard from
            for m in [m for m, ts in self.members.items()
                      if now - ts > EXPIRY_S]:
                del self.members[m]

    # -- queries ----------------------------------------------------------

    def lookup(self, nhid: str) -> str | None:
        with self.mu:
            m = self.view.get(nhid)
            return m.raft_address if m is not None else None

    def num_members(self) -> int:
        with self.mu:
            return len(self.members) + 1

    def get_shard_info(self, shard_id: int) -> ShardView | None:
        # queries mostly ride the store the push loop maintains; the
        # rate-limited refresh just bounds staleness for hosts that are
        # pure pollers (no shards of their own changing)
        self._refresh_local_shards(min_interval_s=self.interval_s)
        with self.mu:
            v = self.shards.get(shard_id)
            if v is None:
                return None
            return ShardView(v.shard_id, dict(v.replicas),
                             v.config_change_index, v.leader_id, v.term)

    def num_of_shards(self) -> int:
        self._refresh_local_shards(min_interval_s=self.interval_s)
        with self.mu:
            return len(self.shards)

    def set_raft_address(self, raft_address: str) -> None:
        """Re-advertise after an address change (the reason this whole
        subsystem exists: stable identity over movable addresses)."""
        with self.mu:
            self.raft_address = raft_address
            self.view[self.nhid] = _Meta(raft_address,
                                         int(time.time() * 1000))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self.sock.close()


def _parse(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class GossipRegistry(INodeRegistry):
    """INodeRegistry whose targets may be NodeHostIDs (gossip.go:99)."""

    def __init__(self, manager: GossipManager) -> None:
        self.manager = manager
        self.static = Registry()

    def add(self, shard_id: int, replica_id: int, target: str) -> None:
        self.static.add(shard_id, replica_id, target)

    def remove(self, shard_id: int, replica_id: int) -> None:
        self.static.remove(shard_id, replica_id)

    def remove_shard(self, shard_id: int) -> None:
        self.static.remove_shard(shard_id)

    def resolve(self, shard_id: int, replica_id: int) -> tuple[str, str]:
        target, key = self.static.resolve(shard_id, replica_id)
        if target.startswith("nhid-"):
            addr = self.manager.lookup(target)
            if addr is None:
                raise KeyError(
                    f"NodeHostID {target} not (yet) known to gossip")
            return addr, key
        return target, key

    # -- NodeHostRegistry surface (internal/registry/nodehost.go:23-41) --

    def num_of_shards(self) -> int:
        """Number of shards known to the gossip mesh (not just local)."""
        return self.manager.num_of_shards()

    def get_shard_info(self, shard_id: int) -> ShardView | None:
        """Cluster-wide view of one shard: membership at the highest
        config-change index seen, leadership at the highest term."""
        return self.manager.get_shard_info(shard_id)

    def close(self) -> None:
        self.manager.close()
