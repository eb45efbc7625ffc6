"""Event publication + metrics — parity with the reference's ``event.go``.

User-provided listeners (raftio.IRaftEventListener / ISystemEventListener)
are invoked from a dedicated worker thread so a slow listener can never
stall the engine (event.go:54-90 runs listeners on the events goroutine).
Exceptions from listeners are logged and swallowed.

Metrics: the legacy ``inc``/``set``/``snapshot`` counter surface is now
a compat shim over the typed instrument registry in
``dragonboat_tpu/telemetry.py`` (Counter/Gauge/Histogram + Prometheus
exposition).  Legacy dotted names keep working and keep their exact
keys in ``snapshot()``; a wrong-typed operation on a name (``inc`` on a
gauge, ``set`` on a counter) logs once and falls back to the old
defaultdict semantics instead of raising, so unmigrated callers degrade
instead of crashing — new code should use ``metrics.registry``
directly and gets the strict typed behavior.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

from dragonboat_tpu_torch import flight
from dragonboat_tpu_torch.logger import get_logger
from dragonboat_tpu_torch.raftio import (
    EntryInfo,
    LeaderInfo,
    NodeInfo,
    SnapshotInfo,
)
from dragonboat_tpu_torch.telemetry import InstrumentTypeError, Registry

_LOG = get_logger("events")


class Metrics:
    """Legacy counter facade over a typed ``telemetry.Registry``.

    ``inc(name)`` lazily registers a Counter, ``set(name)`` a Gauge,
    ``observe(name)`` a Histogram.  A name already registered as the
    other kind is the old counter/gauge conflation bug — the shim logs
    one warning per (op, name) and applies the legacy defaultdict
    semantics so existing callers keep running while they migrate.
    """

    def __init__(self, registry: Registry | None = None) -> None:
        self.registry = registry if registry is not None else Registry()
        # legacy alias: old code synchronized on metrics.mu
        self.mu = self.registry.mu
        self._warn_mu = threading.Lock()
        self._warned: set[tuple[str, str]] = set()    # guarded-by: _warn_mu

    def _warn_once(self, op: str, name: str, use: str) -> None:
        with self._warn_mu:
            if (op, name) in self._warned:
                return
            self._warned.add((op, name))
        _LOG.warning(
            "legacy %s() on %r which is registered as a %s — applying "
            "defaultdict semantics; migrate the caller to the typed "
            "registry", op, name, use)

    def inc(self, name: str, delta: int = 1) -> None:
        try:
            self.registry.counter(name).inc(delta)
        except InstrumentTypeError:
            self._warn_once("inc", name, self.registry.kind_of(name))
            try:
                self.registry.gauge(name)._force_add(delta)
            except InstrumentTypeError:
                pass        # histogram / callback gauge: drop the inc

    def set(self, name: str, value: int) -> None:
        try:
            self.registry.gauge(name).set(value)
        except InstrumentTypeError:
            self._warn_once("set", name, self.registry.kind_of(name))
            try:
                self.registry.counter(name)._force_set(value)
            except InstrumentTypeError:
                pass        # histogram / callback gauge: drop the set

    def observe(self, name: str, value, buckets=None) -> None:
        if buckets is not None:
            self.registry.histogram(name, buckets=buckets).observe(value)
        else:
            self.registry.histogram(name).observe(value)

    def snapshot(self) -> dict:
        return self.registry.snapshot()


class EventHub:
    """Queue-decoupled listener dispatch (event.go:54-90)."""

    def __init__(self, raft_listener=None, system_listener=None,
                 metrics: Metrics | None = None) -> None:
        self.raft_listener = raft_listener
        self.system_listener = system_listener
        self.metrics = metrics or Metrics()
        self._q: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        if raft_listener is not None or system_listener is not None:
            self._worker = threading.Thread(
                target=self._run, name="events", daemon=True)
            self._worker.start()

    def close(self) -> None:
        if self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=2)
            self._worker = None

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:
                _LOG.exception("event listener raised")

    def _dispatch(self, listener, method: str, *args) -> None:
        if listener is None:
            return
        fn: Callable | None = getattr(listener, method, None)
        if fn is None:
            return
        self._q.put((fn, args))

    # -- raft events (listener.go:33) -----------------------------------

    def leader_updated(self, info: LeaderInfo) -> None:
        self.metrics.inc("raft.leader_updated")
        flight.record(flight.LEADER_CHANGE, shard_id=info.shard_id,
                      replica_id=info.replica_id, term=int(info.term),
                      leader_id=int(info.leader_id))
        self._dispatch(self.raft_listener, "leader_updated", info)

    # -- system events (listener.go:59-76) ------------------------------

    def node_host_shutting_down(self) -> None:
        self._dispatch(self.system_listener, "node_host_shutting_down")

    def node_unloaded(self, info: NodeInfo) -> None:
        self._dispatch(self.system_listener, "node_unloaded", info)

    def node_deleted(self, info: NodeInfo) -> None:
        self._dispatch(self.system_listener, "node_deleted", info)

    def node_ready(self, info: NodeInfo) -> None:
        self.metrics.inc("system.node_ready")
        self._dispatch(self.system_listener, "node_ready", info)

    def membership_changed(self, info: NodeInfo) -> None:
        self.metrics.inc("system.membership_changed")
        self._dispatch(self.system_listener, "membership_changed", info)

    def connection_established(self, addr: str, snapshot: bool) -> None:
        self.metrics.inc("transport.connection_established")
        self._dispatch(self.system_listener, "connection_established",
                       addr, snapshot)

    def connection_failed(self, addr: str, snapshot: bool) -> None:
        self.metrics.inc("transport.connection_failed")
        self._dispatch(self.system_listener, "connection_failed",
                       addr, snapshot)

    def send_snapshot_started(self, info: SnapshotInfo) -> None:
        flight.record(flight.SNAPSHOT, phase="send_started",
                      shard_id=info.shard_id, replica_id=info.replica_id,
                      to=info.from_, index=int(info.index),
                      term=int(info.term))
        self._dispatch(self.system_listener, "send_snapshot_started", info)

    def send_snapshot_completed(self, info: SnapshotInfo) -> None:
        self._dispatch(self.system_listener, "send_snapshot_completed", info)

    def send_snapshot_aborted(self, info: SnapshotInfo) -> None:
        self._dispatch(self.system_listener, "send_snapshot_aborted", info)

    def snapshot_received(self, info: SnapshotInfo) -> None:
        self.metrics.inc("snapshot.received")
        flight.record(flight.SNAPSHOT, phase="received",
                      shard_id=info.shard_id, replica_id=info.replica_id,
                      from_=info.from_, index=int(info.index),
                      term=int(info.term))
        self._dispatch(self.system_listener, "snapshot_received", info)

    def snapshot_recovered(self, info: SnapshotInfo) -> None:
        self.metrics.inc("snapshot.recovered")
        self._dispatch(self.system_listener, "snapshot_recovered", info)

    def snapshot_created(self, info: SnapshotInfo) -> None:
        self.metrics.inc("snapshot.created")
        flight.record(flight.SNAPSHOT, phase="created",
                      shard_id=info.shard_id, replica_id=info.replica_id,
                      index=int(info.index), term=int(info.term))
        self._dispatch(self.system_listener, "snapshot_created", info)

    def snapshot_compacted(self, info: SnapshotInfo) -> None:
        self._dispatch(self.system_listener, "snapshot_compacted", info)

    def log_compacted(self, info: EntryInfo) -> None:
        self.metrics.inc("log.compacted")
        self._dispatch(self.system_listener, "log_compacted", info)

    def log_db_compacted(self, info: EntryInfo) -> None:
        self.metrics.inc("logdb.compacted")
        self._dispatch(self.system_listener, "log_db_compacted", info)
