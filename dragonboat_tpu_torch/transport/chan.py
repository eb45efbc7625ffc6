"""In-process channel transport.

Parity with the reference's ``plugin/chan``: a process-global listening map
address → handler so full multi-NodeHost clusters run in one process with no
sockets (chan.go:49-60) — the primary test transport and the template for
the device-loopback path.
"""

from __future__ import annotations

import threading
from typing import Callable

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.raftio import IConnection, ISnapshotConnection, ITransport


class _Registry:
    def __init__(self) -> None:
        self.mu = threading.RLock()
        self.listening: dict[str, "ChanTransport"] = {}  # guarded-by: mu

    def register(self, addr: str, t: "ChanTransport") -> None:
        with self.mu:
            self.listening[addr] = t

    def unregister(self, addr: str) -> None:
        with self.mu:
            self.listening.pop(addr, None)

    def get(self, addr: str) -> "ChanTransport | None":
        with self.mu:
            return self.listening.get(addr)


_GLOBAL = _Registry()


class _Conn:
    def __init__(self, owner: "ChanTransport", target: str) -> None:
        self.owner = owner
        self.target = target

    def close(self) -> None:
        pass

    def send_message_batch(self, batch: pb.MessageBatch) -> None:
        t = _GLOBAL.get(self.target)
        if t is None or not t.running or self.owner.partitioned:
            raise ConnectionError(f"{self.target} unreachable")
        t.deliver(batch)


class _SnapConn:
    def __init__(self, owner: "ChanTransport", target: str) -> None:
        self.owner = owner
        self.target = target

    def close(self) -> None:
        pass

    def send_chunk(self, chunk: dict) -> None:
        t = _GLOBAL.get(self.target)
        if t is None or not t.running or self.owner.partitioned:
            raise ConnectionError(f"{self.target} unreachable")
        t.deliver_chunk(chunk)


class ChanTransport(ITransport):
    def __init__(self, addr: str, message_handler, chunk_handler) -> None:
        self.addr = addr
        self.message_handler = message_handler
        self.chunk_handler = chunk_handler
        self.running = False
        self.partitioned = False  # monkey-test hook (monkey.go:170)
        # test hooks (monkey transport hooks :83-89): drop predicate,
        # per-message delay (seconds), seeded in-batch reordering, and
        # duplicate injection (raft must tolerate at-least-once delivery)
        self.drop_predicate: Callable[[pb.Message], bool] | None = None
        self.delay_func: Callable[[pb.Message], float] | None = None
        self.reorder_rng = None  # random.Random; shuffles batch requests
        self.duplicate_predicate: Callable[[pb.Message], bool] | None = None

    def name(self) -> str:
        return "chan-transport"

    def start(self) -> None:
        self.running = True
        _GLOBAL.register(self.addr, self)

    def close(self) -> None:
        self.running = False
        _GLOBAL.unregister(self.addr)

    def get_connection(self, target: str) -> IConnection:
        return _Conn(self, target)

    def get_snapshot_connection(self, target: str) -> ISnapshotConnection:
        return _SnapConn(self, target)

    def deliver(self, batch: pb.MessageBatch) -> None:
        if self.partitioned:
            return
        reqs = batch.requests
        if self.drop_predicate is not None:
            reqs = tuple(m for m in reqs if not self.drop_predicate(m))
        if self.duplicate_predicate is not None:
            reqs = reqs + tuple(
                m for m in reqs if self.duplicate_predicate(m))
        if self.reorder_rng is not None and len(reqs) > 1:
            shuffled = list(reqs)
            self.reorder_rng.shuffle(shuffled)
            reqs = tuple(shuffled)
        if reqs is not batch.requests:
            batch = pb.MessageBatch(
                requests=reqs,
                deployment_id=batch.deployment_id,
                source_address=batch.source_address,
                bin_ver=batch.bin_ver,
                # the fabric trace header survives chaos rewrites — a
                # dropped/duplicated message keeps the batch's contexts
                fabric=batch.fabric,
            )
        if self.delay_func is not None:
            delays = [self.delay_func(m) for m in batch.requests]
            d = max(delays, default=0.0)
            if d > 0:
                threading.Timer(d, self.message_handler, (batch,)).start()
                return
        # hub_recv stamping moved to the NodeHost inbound seam
        # (fabric.METER.on_batch_received) — one site covering chan AND
        # tcp, off the fabric header when the sender attached one
        self.message_handler(batch)

    def deliver_chunk(self, chunk: dict) -> None:
        if not self.partitioned:
            self.chunk_handler(chunk)


class ChanTransportFactory:
    """config.TransportFactory equivalent."""

    def create(self, nhconfig, message_handler, chunk_handler) -> ChanTransport:
        return ChanTransport(nhconfig.raft_address, message_handler, chunk_handler)

    def validate(self, addr: str) -> bool:
        return True
