"""TransportHub: send queues, batching, circuit breakers over an ITransport.

Parity with ``internal/transport/transport.go:173`` (Transport): per-target
send queues drained into MessageBatch frames, a circuit breaker per address
(:176-177, :293), failure → unreachable callbacks funneled back to raft as
Unreachable messages, and snapshot chunk dispatch.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from random import Random
from typing import Callable

from dragonboat_tpu_torch import fabric
from dragonboat_tpu_torch import flight
from dragonboat_tpu_torch import lifecycle
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.events import EventHub
from dragonboat_tpu_torch.raftio import INodeRegistry, ITransport, SnapshotInfo

SEND_QUEUE_LEN = 1024 * 2
BREAKER_RESET_SECONDS = 1.0
BREAKER_MAX_RESET_SECONDS = 30.0
BREAKER_JITTER = 0.25


def _msg_size(m: pb.Message) -> int:
    """Approximate queued size (config.go MaxSendQueueSize accounting)."""
    return 64 + sum(pb.entry_size(e) for e in m.entries)


class CircuitBreaker:
    """Failure breaker with capped exponential backoff
    (transport.go GetCircuitBreaker).

    closed --fail()--> open --cooldown elapses--> half-open, where
    ``ready()`` returns True and the next outcome decides: ``succeed()``
    closes the breaker and resets the backoff; another ``fail()``
    re-opens it with a doubled cooldown, capped at ``max_reset``.  A
    fixed ``reset_after`` makes every breaker in a partitioned fleet
    retry in lockstep, hammering a recovering peer once a second —
    backoff spreads the probes out, and the jitter decorrelates
    breakers that tripped on the same tick.  The jitter is drawn from a
    per-breaker seeded PRNG, so a fault schedule replayed with the same
    seeds observes the same cooldowns (the chaos harness depends on
    this).

    ``now`` parameters exist for deterministic unit tests; production
    callers omit them and get the monotonic clock.
    """

    def __init__(self, reset_after: float = BREAKER_RESET_SECONDS,
                 max_reset: float = BREAKER_MAX_RESET_SECONDS,
                 seed: int = 0) -> None:
        self.base_reset = reset_after         # guarded-by: <init-only>
        self.max_reset = max_reset            # guarded-by: <init-only>
        self.reset_after = reset_after        # guarded-by: mu (current cooldown)
        self.tripped_at = 0.0                 # guarded-by: mu
        self.trip_streak = 0                  # guarded-by: mu
        self._rng = Random(seed)              # guarded-by: mu
        self.mu = threading.Lock()

    def ready(self, now: float | None = None) -> bool:
        if now is None:
            now = time.monotonic()
        with self.mu:
            return (now - self.tripped_at) >= self.reset_after

    def state(self, now: float | None = None) -> str:
        """closed | open | half-open — observability + test surface."""
        if now is None:
            now = time.monotonic()
        with self.mu:
            if self.trip_streak == 0:
                return "closed"
            if (now - self.tripped_at) >= self.reset_after:
                return "half-open"
            return "open"

    def fail(self, now: float | None = None) -> bool:
        """Record one failure; returns True when this failure OPENED a
        closed breaker (the closed->open edge, for trip accounting)."""
        if now is None:
            now = time.monotonic()
        with self.mu:
            self.trip_streak += 1
            opened = self.trip_streak == 1
            cooldown = self.base_reset * (2 ** min(self.trip_streak - 1, 30))
            cooldown *= 1.0 + BREAKER_JITTER * self._rng.random()
            self.reset_after = min(cooldown, self.max_reset)
            self.tripped_at = now
        return opened

    def succeed(self) -> None:
        with self.mu:
            self.trip_streak = 0
            self.reset_after = self.base_reset
            self.tripped_at = 0.0


class TransportHub:
    def __init__(
        self,
        source_address: str,
        deployment_id: int,
        transport: ITransport,
        resolver: INodeRegistry,
        unreachable_cb: Callable[[pb.Message], None],
        sync: bool = True,
        events=None,
        snapshot_send_bps: int = 0,
        max_send_queue_bytes: int = 0,
    ) -> None:
        self.snapshot_send_bps = snapshot_send_bps
        # MaxSendQueueSize (config.go): BYTES of queued messages per
        # target; 0 = unlimited. A full queue drops the NEW message and
        # reports it (rate-limited), never silently evicts older ones
        self.max_send_queue_bytes = max_send_queue_bytes
        # shared snapshot-bandwidth bucket: the bytes/s cap is per HOST,
        # so concurrent streams draw from one budget
        self._snap_mu = threading.Lock()
        self._snap_sent = 0                   # guarded-by: _snap_mu
        self._snap_start = 0.0                # guarded-by: _snap_mu
        self.source_address = source_address
        self.deployment_id = deployment_id
        self.transport = transport
        self.resolver = resolver
        self.unreachable_cb = unreachable_cb
        self.sync = sync
        self.events = events if events is not None else EventHub()
        self.mu = threading.Lock()
        self.queues: dict[str, deque[tuple[pb.Message, int]]] = {}  # guarded-by: mu
        self.queue_bytes: dict[str, int] = {}                       # guarded-by: mu
        self.breakers: dict[str, CircuitBreaker] = {}               # guarded-by: mu
        # (addr, snapshot) -> last observed connection state; edge-triggered
        # listener events fire only on state changes (and first observation)
        self.connected: dict[tuple[str, bool], bool] = {}           # guarded-by: mu
        # counters live in the shared process-wide registry (events.Metrics)
        self.metrics = self.events.metrics
        registry = getattr(self.metrics, "registry", None)
        if registry is not None:
            registry.gauge_fn(
                "transport.breakers", self._breaker_states,
                help="per-address circuit breakers by current state",
                labelnames=("state",))
        # per-link fabric telemetry: the meter folds this hub's queue
        # depths and breaker states into /debug/fabric (weakly held —
        # a closed hub just vanishes from the snapshot)
        fabric.METER.attach_hub(source_address, self)

    def _breaker_states(self) -> dict[tuple[str, ...], float]:
        """Callback-gauge source: breaker count per state.  Copies the
        breaker map under ``mu`` and evaluates ``b.state()`` (which takes
        each breaker's own lock) after releasing it — the scrape thread
        never holds two locks at once."""
        with self.mu:
            breakers = list(self.breakers.values())
        counts = {"closed": 0, "open": 0, "half-open": 0}
        for b in breakers:
            counts[b.state()] += 1
        return {(state,): float(n) for state, n in counts.items()}

    def _record_trip(self, addr: str) -> None:
        """closed->open edge accounting (called when ``fail()`` opened)."""
        self.metrics.inc("transport.breaker_trips")
        flight.record(flight.BREAKER_TRIP, addr=addr)

    def _note_connection(self, addr: str, ok: bool, snapshot: bool) -> None:
        """Edge-triggered ConnectionEstablished/Failed events, keyed per
        (addr, snapshot) connection class
        (transport.go SendMessageBatch → sysEvents, event.go:54-90)."""
        key = (addr, snapshot)
        with self.mu:
            prev = self.connected.get(key)
            self.connected[key] = ok
            fire = ok != prev  # first observation (prev None) always fires
        if not fire:
            return
        if ok:
            self.events.connection_established(addr, snapshot)
        else:
            self.events.connection_failed(addr, snapshot)

    def breaker(self, addr: str) -> CircuitBreaker:
        with self.mu:
            b = self.breakers.get(addr)
            if b is None:
                # per-addr deterministic jitter seed: replaying a fault
                # schedule sees identical cooldown sequences per peer
                b = self.breakers[addr] = CircuitBreaker(
                    seed=zlib.crc32(addr.encode()))
            return b

    def trip_breaker(self, addr: str, count: int = 1) -> CircuitBreaker:
        """Force ``count`` failures onto the breaker for ``addr`` — the
        chaos harness's forced-trip fault (monkey.go breaker kicks)."""
        b = self.breaker(addr)
        for _ in range(count):
            if b.fail():
                self._record_trip(addr)
        return b

    def send(self, m: pb.Message) -> bool:
        """Enqueue and (synchronously, in the loopback runtime) flush one
        message — Send (transport.go:115-136)."""
        if m.is_local():
            raise AssertionError("local message sent to transport")
        if m.type == pb.MessageType.INSTALL_SNAPSHOT:
            return self.send_snapshot(m)
        try:
            addr, _key = self.resolver.resolve(m.shard_id, m.to)
        except KeyError:
            self.metrics.inc("transport.dropped")
            return False
        b = self.breaker(addr)
        if not b.ready():
            self.metrics.inc("transport.dropped")
            self._notify_unreachable(m)
            return False
        sz = _msg_size(m)
        with self.mu:
            q = self.queues.setdefault(addr, deque())
            used = self.queue_bytes.get(addr, 0)
            if (self.max_send_queue_bytes
                    and used + sz > self.max_send_queue_bytes) \
                    or len(q) >= SEND_QUEUE_LEN:
                self.metrics.inc("transport.dropped")
                return False
            q.append((m, sz))
            self.queue_bytes[addr] = used + sz
        if self.sync:
            self.flush(addr)
        return True

    def flush(self, addr: str | None = None) -> None:
        addrs = [addr] if addr else list(self.queues)
        for a in addrs:
            with self.mu:
                q = self.queues.get(a)
                if not q:
                    continue
                msgs = tuple(m for m, _ in q)
                nbytes = sum(s for _, s in q)
                q.clear()
                self.queue_bytes[a] = 0
            # fabric trace header: sampled replicate keys + parked
            # quorum-ack returns ride the frame (None when empty, so
            # the bytes are identical to an old peer's frame)
            header = fabric.METER.header_for(self.source_address, a, msgs)
            batch = pb.MessageBatch(
                requests=msgs,
                deployment_id=self.deployment_id,
                source_address=self.source_address,
                fabric=header,
            )
            b = self.breaker(a)
            try:
                conn = self.transport.get_connection(a)
                conn.send_message_batch(batch)
                b.succeed()
                self.metrics.inc("transport.sent", len(msgs))
                # lifecycle sidecar: replicated entries left this host —
                # stamp the sampled spans (flush is transport-agnostic,
                # so hub_send covers chan AND tcp)
                if lifecycle.TRACER.enabled:
                    for m in msgs:
                        if m.type == pb.MessageType.REPLICATE:
                            for e in m.entries:
                                if e.key:
                                    lifecycle.TRACER.stamp(
                                        e.key, lifecycle.STAGE_HUB_SEND)
                fabric.METER.on_send(self.source_address, a, msgs,
                                     nbytes, header)
                self._note_connection(a, True, False)
            except Exception:
                if b.fail():
                    self._record_trip(a)
                self.metrics.inc("transport.send_failed", len(msgs))
                self._note_connection(a, False, False)
                for m in msgs:
                    self._notify_unreachable(m)

    def send_snapshot(self, m: pb.Message) -> bool:
        """Stream an InstallSnapshot in a background job — the reference
        runs snapshot sends in a dedicated job pool (snapshot.go:211,
        job.go:43-69); blocking the engine thread here would stall every
        shard's ticks for the duration of a transfer."""
        from dragonboat_tpu_torch.transport.chunks import (
            split_snapshot_message,
            split_snapshot_message_go,
        )

        # the transport picks the chunk layout: go-wire fleets speak the
        # reference's per-file Chunk records (no embedded message);
        # everything else ships the native concatenated stream
        go_wire = getattr(self.transport, "wire", "native") == "go"

        def job() -> None:
            if go_wire:
                chunks = split_snapshot_message_go(m, self.deployment_id)
            else:
                chunks = split_snapshot_message(
                    m, self.deployment_id,
                    source_address=self.source_address)
            self.send_snapshot_chunks(m, chunks)

        threading.Thread(target=job, name="snapshot-stream",
                         daemon=True).start()
        return True

    def send_snapshot_chunks(self, m: pb.Message, chunks) -> bool:
        """Send an InstallSnapshot as a chunk stream (snapshot.go:211).
        On a go-wire transport, NATIVE chunks (the on-disk SM live
        stream, rsm/chunkwriter.py) are adapted to the reference layout
        per chunk — file-based sends arrive here already split by
        split_snapshot_message_go."""
        if getattr(self.transport, "wire", "native") == "go":
            from dragonboat_tpu_torch.transport.chunks import (
                adapt_native_chunks_to_go,
            )

            chunks = adapt_native_chunks_to_go(chunks)
        try:
            addr, _ = self.resolver.resolve(m.shard_id, m.to)
        except KeyError:
            self._notify_snapshot_failed(m)
            return False
        b = self.breaker(addr)
        if not b.ready():
            self._notify_snapshot_failed(m)
            return False
        info = SnapshotInfo(shard_id=m.shard_id, replica_id=m.to,
                            from_=m.from_, index=m.snapshot.index,
                            term=m.snapshot.term)
        self.events.send_snapshot_started(info)
        try:
            conn = self.transport.get_snapshot_connection(addr)
            # MaxSnapshotSendBytesPerSecond (config.go): pace the stream so
            # a large transfer cannot saturate the links raft traffic uses
            bps = self.snapshot_send_bps
            for c in chunks:
                conn.send_chunk(c)
                fabric.METER.on_chunk_sent(
                    self.source_address, addr,
                    len(getattr(c, "data", b"")))
                if bps > 0:
                    self._pace_snapshot(len(getattr(c, "data", b"")), bps)
            b.succeed()
            self.metrics.inc("transport.snapshots_sent")
            self._note_connection(addr, True, True)
            self.events.send_snapshot_completed(info)
            return True
        except Exception:
            if b.fail():
                self._record_trip(addr)
            self._note_connection(addr, False, True)
            self.events.send_snapshot_aborted(info)
            self._notify_unreachable(m)
            self._notify_snapshot_failed(m)
            return False

    def _pace_snapshot(self, n: int, bps: int) -> None:
        """Shared host-wide pacing (MaxSnapshotSendBytesPerSecond is the
        NodeHost total): all streams draw from one budget.  The window
        resets after idle so old credit can't fund a burst."""
        while True:
            now = time.monotonic()
            with self._snap_mu:
                if now - self._snap_start > 5.0 + self._snap_sent / bps:
                    self._snap_start, self._snap_sent = now, 0
                if n:
                    self._snap_sent += n
                    n = 0
                ahead = self._snap_sent / bps - (now - self._snap_start)
            if ahead <= 0:
                return
            time.sleep(min(ahead, 1.0))

    def _notify_snapshot_failed(self, m: pb.Message) -> None:
        """Feed a rejected SnapshotStatus back to the sender's raft
        (transport failure → raft.go:1136 handleLeaderSnapshotStatus)."""
        self.unreachable_cb(
            pb.Message(
                type=pb.MessageType.SNAPSHOT_STATUS,
                from_=m.to,
                to=m.from_,
                shard_id=m.shard_id,
                reject=True,
            )
        )

    def _notify_unreachable(self, m: pb.Message) -> None:
        self.unreachable_cb(
            pb.Message(
                type=pb.MessageType.UNREACHABLE,
                from_=m.to,
                to=m.from_,
                shard_id=m.shard_id,
            )
        )
