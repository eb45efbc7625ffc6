"""Per-shard node: queues, pending books, Peer, RSM, snapshot glue.

Parity with the reference's ``node.go``: the node owns the per-shard
universe — ingress queues, pending-op books, the raft Peer, the managed
state machine and the snapshotter — and exposes ``step()``, the engine's
unit of work (stepNode/handleEvents → getUpdate → process, node.go:1139+).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from dataclasses import dataclass, field

from dragonboat_tpu_torch import lifecycle
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.client import Session
from dragonboat_tpu_torch.config import Config
from dragonboat_tpu_torch.core.logentry import CompactedError
from dragonboat_tpu_torch.core.peer import Peer
from dragonboat_tpu_torch.core.pycore import CoreConfig, Raft
from dragonboat_tpu_torch.events import EventHub
from dragonboat_tpu_torch.logdb.logreader import LogReader
from dragonboat_tpu_torch.logger import get_logger
from dragonboat_tpu_torch.quiesce import QuiesceState
from dragonboat_tpu_torch.rsm import encoded
from dragonboat_tpu_torch.raftio import EntryInfo, ILogDB, LeaderInfo, SnapshotInfo
from dragonboat_tpu_torch.request import (
    LogicalClock,
    PendingProposal,
    PendingReadIndex,
    PendingSingleton,
    RequestDroppedError,
    RequestResultCode,
    RequestState,
)
from dragonboat_tpu_torch.rsm.statemachine import StateMachine
from dragonboat_tpu_torch.server.rate import RateLimiter
from dragonboat_tpu_torch.server.settings import soft
from dragonboat_tpu_torch.statemachine import Result

_LOG = get_logger("node")


@dataclass
class _SnapshotRequest:
    exported: bool = False
    path: str = ""
    override_compaction: bool = False
    compaction_overhead: int = 0
    key: int = 0


class Node:
    def __init__(
        self,
        cfg: Config,
        logdb: ILogDB,
        sm: StateMachine,
        send_message,          # Callable[[pb.Message], None]
        snapshot_dir: str,
        rng=None,
        events: EventHub | None = None,
        fs=None,
        worker_id: int = 0,
        clock=None,
    ) -> None:
        from dragonboat_tpu_torch.vfs import default_fs

        self.fs = fs if fs is not None else default_fs()
        self.cfg = cfg
        self.shard_id = cfg.shard_id
        self.replica_id = cfg.replica_id
        self.logdb = logdb
        # the step worker that owns this node (engine.go:1107 workerPool);
        # passed to save_raft_state per the single-writer-per-worker
        # contract (raftio/logdb.go:78-83)
        self.worker_id = worker_id
        self.sm = sm
        self.send_message = send_message
        self.snapshot_dir = snapshot_dir
        self.events = events or EventHub()
        self.mu = threading.RLock()
        self.log_reader = LogReader(cfg.shard_id, cfg.replica_id, logdb)

        # ONE logical clock for every book: the host ticker advances it
        # once per round (a per-book advance walk is O(lanes) Python at
        # 100k shards); a standalone Node keeps a private clock that
        # tick() advances itself
        self._clock = clock if clock is not None else LogicalClock()
        self._owns_clock = clock is None
        self.pending_proposals = PendingProposal(clock=self._clock,
                                                 shard_id=cfg.shard_id)
        self.pending_reads = PendingReadIndex(clock=self._clock,
                                              shard_id=cfg.shard_id)
        self.pending_config_change = PendingSingleton(clock=self._clock)
        self.pending_snapshot = PendingSingleton(clock=self._clock)
        self.pending_transfer = PendingSingleton(clock=self._clock)
        self.pending_log_query = PendingSingleton(clock=self._clock)

        self.incoming_msgs: list[pb.Message] = []
        self.incoming_proposals: list[pb.Entry] = []
        self.transfer_target: int | None = None
        self.config_change_entry: pb.Entry | None = None
        self.snapshot_request: _SnapshotRequest | None = None
        self.log_query_range: tuple[int, int, int] | None = None
        self.compaction_request_key: int | None = None
        self.pending_compaction = PendingSingleton(clock=self._clock)

        # quiesce bookkeeping (quiesce.go:24, node.go:195)
        self.qs = QuiesceState(
            shard_id=cfg.shard_id,
            replica_id=cfg.replica_id,
            election_tick=cfg.election_rtt,
            enabled=cfg.quiesce,
        )
        # leader-transfer completion (target, request key): the reference's
        # transfer is fire-and-forget (request.go:564); our future completes
        # on the LeaderUpdate that lands the target, timing out otherwise.
        # The key is captured at request time so a stale edge can never
        # complete a later, unrelated transfer request.
        self._transfer_awaiting: tuple[int, int] | None = None
        # last observed (leader, term): pycore emits a LeaderUpdate on every
        # follower heartbeat, so leader changes must be edge-detected here
        self._last_leader: tuple[int, int] = (0, 0)
        # requestCompaction seam (node.go:972 getCompactedTo)
        self.compacted_to = 0
        # in-memory log growth guard (server/rate.go + Config
        # MaxInMemLogSize): unapplied proposal bytes; over the limit ->
        # proposals rejected with system-busy until applies drain it.
        # Accounting is keyed by proposal key so only bytes that were
        # increased are ever decreased (drops and remote entries must not
        # erode other proposals' accounting)
        self.rate_limiter = RateLimiter(cfg.max_in_mem_log_size)
        self._rl_inflight: dict[int, int] = {}
        # NotifyCommit (nodehost.go:1656): fire committed_event on commit,
        # before apply — set by NodeHost from NodeHostConfig
        self.notify_commit = False
        # set by NodeHost for on-disk SMs: stream a live snapshot image
        # to the peer instead of sending the recorded file
        self.stream_snapshot_cb = None
        # set by NodeHost: dedicated RSM-apply workers
        # (engine/apply_pool.py; engine.go:1153 applyWorkerMain).  None ->
        # apply runs inline on the step path (standalone Node usage).
        self.apply_pool = None
        # core mutations produced by an async apply (config-change
        # application, applied-cursor notification): the raft core is
        # owned by the step thread, so the apply worker posts closures
        # here and the next step drains them (the channel the reference's
        # nodeProxy pattern expresses with configChangeC)
        self._core_notices: list = []

        self.peer: Peer | None = None
        self.stopped = False
        self.applied_since_snapshot = 0
        self.rng = rng
        self.initial_applied = 0

    # -- lifecycle ------------------------------------------------------

    def start(self, initial_members: dict[int, str], initial: bool,
              new_node: bool) -> None:
        """startRaft (node.go:365): build the Peer from persisted state."""
        ccfg = CoreConfig(
            shard_id=self.shard_id,
            replica_id=self.replica_id,
            election_rtt=self.cfg.election_rtt,
            heartbeat_rtt=self.cfg.heartbeat_rtt,
            check_quorum=self.cfg.check_quorum,
            pre_vote=self.cfg.pre_vote,
            is_non_voting=self.cfg.is_non_voting,
            is_witness=self.cfg.is_witness,
        )
        ss = self.logdb.get_snapshot(self.shard_id, self.replica_id)
        self._gc_snapshot_dir(ss)
        if ss is not None:
            self.log_reader.apply_snapshot(ss)
        rs = self.logdb.read_raft_state(
            self.shard_id, self.replica_id,
            ss.index if ss is not None else 0,
        )
        have_state = rs is not None and (
            not rs.state.is_empty() or rs.entry_count > 0 or ss is not None
        )
        if have_state:
            assert rs is not None
            if rs.entry_count > 0:
                self.log_reader.set_range(rs.first_index, rs.entry_count)
            p = Peer.launch(ccfg, self.log_reader, {}, False, False,
                            rng=self.rng)
            members = ss.membership if ss is not None else None
            if members is None or not (
                members.addresses or members.non_votings or members.witnesses
            ):
                # the RSM membership store is authoritative once CCs have
                # applied (snapshotter.go owns membership in the
                # reference): a LIVE SM — kernel/mesh eviction rebuilds a
                # Node around the running SM — carries the current
                # members, where a snapshot may not exist yet and
                # initial_members is empty on a restart
                m = self.sm.get_membership()
                if m.addresses or m.non_votings or m.witnesses:
                    members = m
                else:
                    members = pb.Membership(addresses=dict(initial_members))
            p.raft.set_initial_members(
                dict(members.addresses),
                dict(members.non_votings),
                dict(members.witnesses),
            )
            if not rs.state.is_empty():
                p.raft.load_state(rs.state)
            self.peer = p
            # recover the user SM from the latest snapshot, then the step
            # loop replays the committed tail (node.go:666 replayLog).
            # A missing snapshot file is FATAL: the log below ss.index was
            # compacted away, so skipping recovery would silently restart
            # the user SM empty while claiming applied==ss.index.
            # A LIVE SM already applied past the snapshot (kernel-engine
            # eviction rebuilds a Node around the running SM) — recovery
            # would regress it, so it is skipped.
            if ss is not None and self.sm.get_last_applied() < ss.index \
                    and (ss.witness or ss.dummy):
                # a witness/dummy record has no data file — restore the
                # RSM bookkeeping only (raft.go:728 makeWitnessSnapshot)
                self.sm.restore_bookkeeping(ss)
                self.compacted_to = max(
                    0, ss.index - self.cfg.compaction_overhead)
            elif ss is not None and self.sm.get_last_applied() < ss.index:
                if not ss.filepath or not os.path.exists(ss.filepath):
                    raise RuntimeError(
                        f"shard {self.shard_id} replica {self.replica_id}: "
                        f"snapshot file {ss.filepath!r} (index {ss.index}) "
                        f"is missing — cannot recover")
                self.sm.recover_from_snapshot(ss.filepath, ss)
                # crash window between install-recover and shrink: finish
                # the shrink now (node.go:871-877 — on-disk SM data is in
                # the SM's own storage once synced)
                if self.sm.sm_type == pb.StateMachineType.ON_DISK:
                    self.sm.sync()
                    self.sm.shrink_recorded_snapshot(ss.filepath)
                self.sm.members.set(ss.membership)
                self.sm.last_applied = max(self.sm.last_applied, ss.index)
                self.sm.last_applied_term = ss.term
                # re-seed the compaction cursor so RequestCompaction keeps
                # working across restarts (ss.getCompactedTo analog)
                self.compacted_to = max(
                    0, ss.index - self.cfg.compaction_overhead)
        else:
            self.peer = Peer.launch(
                ccfg, self.log_reader, initial_members, initial, new_node,
                rng=self.rng,
            )
            if initial and new_node:
                self.sm.members.set(pb.Membership(
                    config_change_id=0, addresses=dict(initial_members)))
        applied = self.sm.get_last_applied()
        self.initial_applied = applied
        self.peer.notify_raft_last_applied(applied)
        if applied > 0:
            self.peer.raft.log.processed = max(
                self.peer.raft.log.processed, applied)

    def replay_committed(self) -> None:
        """Replay committed entries above the RSM's applied index
        (replayLog, node.go:666) — driven by the first engine steps."""
        pass  # the normal step loop replays via entries_to_apply

    def destroy(self) -> None:
        self.stopped = True
        for book in (self.pending_proposals, self.pending_reads,
                     self.pending_config_change, self.pending_snapshot,
                     self.pending_transfer, self.pending_log_query,
                     self.pending_compaction):
            book.terminate_all()
        self.sm.close()

    # -- client entry points (called from NodeHost) ------------------------
    #
    # every ingress mutation goes through _post so an engine can redirect
    # a node's intake atomically (kernel-engine eviction swaps the serving
    # object mid-flight; see KernelNode._post)

    def _post(self, mutate) -> None:
        with self.mu:
            mutate(self)

    def _check_ingress(self) -> None:
        """System-busy gates before a proposal is accepted: the in-mem
        rate limiter (request.go canNewRequest + rate.go) and the bounded
        entry queue (queue.go:24 entryQueue capacity)."""
        if self.rate_limiter.rate_limited():
            raise RequestDroppedError("system busy: in-memory log limit")
        with self.mu:
            if len(self.incoming_proposals) >= \
                    soft.incoming_proposal_queue_length:
                raise RequestDroppedError("system busy: proposal queue full")

    def propose(self, session: Session, cmd: bytes,
                timeout_ticks: int) -> RequestState:
        self._check_ingress()
        rs, entry = self.pending_proposals.propose(session, cmd, timeout_ticks)
        if cmd and self.cfg.entry_compression != "no-compression":
            # EncodedEntry envelope at propose time (request.go:1094;
            # unwrapped at apply by rsm/encoded.get_payload on every
            # replica).  Deliberate difference: the reference wraps
            # non-empty payloads even with compression off (1-byte
            # header); here the default config keeps plain APPLICATION
            # entries — both directions of a mixed Go/TPU fleet handle
            # either type, and the uncompressed wire stays byte-stable
            # for existing deployments.
            entry = dataclasses.replace(
                entry, type=pb.EntryType.ENCODED,
                cmd=encoded.get_encoded(self.cfg.entry_compression, cmd))
        if self.rate_limiter.enabled():
            sz = pb.entry_size(entry)
            self.rate_limiter.increase(sz)
            with self.mu:
                self._rl_inflight[entry.key] = sz
        self._post(lambda n: n.incoming_proposals.append(entry))
        return rs

    def _rl_release(self, key: int) -> None:
        """Release a proposal's rate-limiter bytes exactly once (on apply
        OR on drop — whichever settles it)."""
        if not self.rate_limiter.enabled():
            return
        with self.mu:
            sz = self._rl_inflight.pop(key, None)
        if sz is not None:
            self.rate_limiter.decrease(sz)

    def propose_session_op(self, session: Session,
                           timeout_ticks: int) -> RequestState:
        self._check_ingress()
        rs, entry = self.pending_proposals.propose(session, b"", timeout_ticks)
        self._post(lambda n: n.incoming_proposals.append(entry))
        return rs

    def read(self, timeout_ticks: int) -> RequestState:
        with self.mu:
            if len(self.pending_reads.batching) >= \
                    soft.incoming_read_index_queue_length:
                raise RequestDroppedError("system busy: read queue full")
        return self.pending_reads.read(timeout_ticks)

    def request_config_change(self, cc: pb.ConfigChange,
                              timeout_ticks: int) -> RequestState:
        rs, key = self.pending_config_change.request(timeout_ticks)
        entry = pb.Entry(
            type=pb.EntryType.CONFIG_CHANGE,
            key=key,
            cmd=pb.encode_config_change(cc),
        )
        self._post(lambda n: setattr(n, "config_change_entry", entry))
        return rs

    def request_leader_transfer(self, target: int,
                                timeout_ticks: int) -> RequestState:
        rs, key = self.pending_transfer.request(timeout_ticks)

        def mutate(n):
            n.transfer_target = target
            n._transfer_awaiting = (target, key)

        self._post(mutate)
        return rs

    def query_raft_log(self, first: int, last: int, max_size: int,
                       timeout_ticks: int) -> RequestState:
        """QueryRaftLog through the engine path (node.go:517 → 1239
        handleLogQuery): the request rides the step loop; the result lands
        on the returned RequestState as ``log_query_result``."""
        rs, _key = self.pending_log_query.request(timeout_ticks)
        self._post(lambda n: setattr(n, "log_query_range",
                                     (first, last, max_size)))
        return rs

    def request_compaction(self, timeout_ticks: int) -> RequestState:
        """RequestCompaction (node.go:972): LogDB-level compaction up to
        the snapshotter's compacted-to index, on the engine thread."""
        rs, key = self.pending_compaction.request(timeout_ticks)
        self._post(lambda n: setattr(n, "compaction_request_key", key))
        return rs

    def request_snapshot(self, req: _SnapshotRequest | None,
                         timeout_ticks: int) -> RequestState:
        rs, key = self.pending_snapshot.request(timeout_ticks)
        r = req or _SnapshotRequest()
        r.key = key
        self._post(lambda n: setattr(n, "snapshot_request", r))
        return rs

    def handle_message(self, m: pb.Message) -> None:
        self._post(lambda n: n.incoming_msgs.append(m))

    def tick(self) -> None:
        with self.mu:
            self.incoming_msgs.append(
                pb.Message(type=pb.MessageType.LOCAL_TICK))
        # a host-owned clock is advanced once per round by the ticker;
        # a standalone node advances its private clock here
        if self._owns_clock:
            self._clock.advance()
        self.gc_books()

    def gc_books(self) -> None:
        """Fire request timeouts against the absolute clock (each gc is
        a no-op fast path when the book is empty — the host sweeps all
        lanes' books on an amortized cadence)."""
        for book in (self.pending_proposals, self.pending_reads,
                     self.pending_config_change, self.pending_snapshot,
                     self.pending_transfer, self.pending_log_query,
                     self.pending_compaction):
            book.gc()

    # -- the step (engine unit of work; node.go:1139 stepNode) -------------

    def step(self) -> bool:
        if self.stopped or self.peer is None:
            return False
        peer = self.peer
        with self.mu:
            notices, self._core_notices = self._core_notices, []
            msgs, self.incoming_msgs = self.incoming_msgs, []
            props, self.incoming_proposals = self.incoming_proposals, []
            cc_entry, self.config_change_entry = self.config_change_entry, None
            transfer, self.transfer_target = self.transfer_target, None
            ss_req, self.snapshot_request = self.snapshot_request, None
            lq, self.log_query_range = self.log_query_range, None
            compact_key, self.compaction_request_key = (
                self.compaction_request_key, None)

        # 0. core mutations posted by async applies (CC application,
        # applied-cursor advance) — the step thread owns the core
        for fn in notices:
            fn()
        # 1. read index batch (node.go:1296)
        ctx = self.pending_reads.peep()
        if ctx is not None:
            self.qs.record(pb.MessageType.READ_INDEX)
            peer.read_index(ctx)
        # 2. received messages (incl. ticks)
        for m in msgs:
            if m.type == pb.MessageType.LOCAL_TICK:
                # quiesce-aware tick (node.go:1562-1573): a quiesced shard
                # only advances the logical clock — no heartbeats/elections
                self.qs.tick()
                if self.qs.quiesced():
                    peer.quiesced_tick()
                else:
                    peer.tick()
            elif m.type == pb.MessageType.QUIESCE:
                self.qs.try_enter_quiesce()
            elif m.type == pb.MessageType.INSTALL_SNAPSHOT:
                self.qs.record(m.type)
                self._handle_install_snapshot(m)
            elif m.is_local():
                # locally-generated signals (Unreachable, SnapshotStatus, …)
                # bypass the external-message gate (node.go:1347-1400)
                peer.raft.handle(m)
            else:
                self.qs.record(m.type)
                peer.handle(m)
        # 3. config change (node.go:1310)
        if cc_entry is not None:
            self.qs.record(pb.MessageType.CONFIG_CHANGE_EVENT)
            peer.propose_entries([cc_entry])
        # 4. proposals (node.go:1275)
        if props:
            self.qs.record(pb.MessageType.PROPOSE)
            peer.propose_entries(props)
        # 5. leader transfer
        if transfer is not None:
            self.qs.record(pb.MessageType.LEADER_TRANSFER)
            self._start_leader_transfer(transfer)
        # 6. snapshot request — on the apply pool when one is wired:
        # save_snapshot takes the SM apply lock, and a wedged user SM
        # holding it must never block the step worker (the reference
        # takes snapshots on dedicated workers too, engine.go snapshot
        # workers); per-shard pool order also serializes it with applies
        if ss_req is not None:
            if self.apply_pool is not None:
                req = ss_req
                self.apply_pool.submit(
                    self.shard_id, lambda: self._take_snapshot(req))
            else:
                self._take_snapshot(ss_req)
        # 7. raft log query (node.go:1238 handleLogQuery)
        if lq is not None:
            peer.query_raft_log(*lq)
        # 8. LogDB compaction request (node.go:972 requestCompaction)
        if compact_key is not None:
            self._process_compaction(compact_key)
        # entering quiesce propagates to peers so the whole group goes
        # quiet together (node.go:1148 sendEnterQuiesceMessages)
        if self.qs.new_quiesce_state():
            self._send_enter_quiesce_messages()

        if not peer.has_update(True):
            return False
        ud = peer.get_update(True, self.sm.get_last_applied())
        self._process_update(ud)
        peer.commit(ud)
        return True

    # -- update processing (engine.go:1304 processSteps order) -------------

    def _process_update(self, ud: pb.Update) -> None:
        # leader change: listener event + transfer-future completion
        # (node.go:308 processLeaderUpdate)
        if ud.leader_update is not None:
            self._on_leader_update(ud.leader_update)
        # raft log query result (node.go:319 processLogQuery)
        lqr = ud.log_query_result
        if lqr.last_index > 0 or lqr.error != 0:
            self._on_log_query_result(lqr)
        # send replicate messages BEFORE the fsync (thesis §10.2.1,
        # engine.go:1332-1336)
        for m in ud.messages:
            if m.type == pb.MessageType.REPLICATE:
                self._send(m)
        # THE fsync
        self.logdb.save_raft_state([ud], worker_id=self.worker_id)
        if ud.entries_to_save:
            self.log_reader.append(ud.entries_to_save)
        if not ud.snapshot.is_empty():
            self._apply_snapshot(ud.snapshot)
        # non-replicate messages after persistence
        for m in ud.messages:
            if m.type != pb.MessageType.REPLICATE:
                self._send(m)
        # dropped ops
        for e in ud.dropped_entries:
            self._rl_release(e.key)
            self.pending_proposals.dropped(e.key)
        for sc in ud.dropped_read_indexes:
            self.pending_reads.dropped(sc)
        # NotifyCommit: complete committed_event at commit time, before
        # apply (node.go:1062 notifyCommittedEntries)
        if self.notify_commit:
            for e in ud.committed_entries:
                if e.key:
                    self.pending_proposals.committed(e.key)
        # ready-to-read contexts; fire immediately when the applied index
        # already covers the read index (request.go:930 applied())
        for rtr in ud.ready_to_reads:
            self.pending_reads.add_ready(rtr.system_ctx, rtr.index)
        if ud.ready_to_reads:
            self.pending_reads.applied(self.sm.get_last_applied())
        # apply committed entries to the RSM — handed to the apply pool
        # when one is wired so a slow user SM blocks only its own shard
        # (engine.go:1153-1204 apply workers), else inline
        if ud.committed_entries:
            trace_keys = ()
            if lifecycle.TRACER.enabled:
                trace_keys = tuple(
                    e.key for e in ud.committed_entries
                    if e.key and lifecycle.TRACER.sampled(e.key))
                for k in trace_keys:
                    lifecycle.TRACER.stamp(k, lifecycle.STAGE_APPLY_QUEUE)
            if self.apply_pool is not None:
                ents = ud.committed_entries
                self.apply_pool.submit(
                    self.shard_id,
                    lambda: self._apply_entries(ents, async_core=True),
                    trace_keys=trace_keys)
            else:
                for k in trace_keys:
                    lifecycle.TRACER.stamp(k, lifecycle.STAGE_APPLY)
                self._apply_entries(ud.committed_entries)
        # auto snapshot (node.go:694 saveSnapshotRequired); on the async
        # path the apply worker posts the request itself
        if (self.apply_pool is None and self.cfg.snapshot_entries > 0
                and self.applied_since_snapshot >= self.cfg.snapshot_entries):
            self._take_snapshot(_SnapshotRequest())

    def _send(self, m: pb.Message) -> None:
        if m.to == self.replica_id:
            self.handle_message(m)
            return
        # on-disk SMs stream a LIVE image to lagging peers instead of
        # shipping the recorded snapshot file (nodehost.go:1888-1891 →
        # rsm.ChunkWriter; wired by NodeHost._stream_snapshot)
        if (m.type == pb.MessageType.INSTALL_SNAPSHOT
                and self.stream_snapshot_cb is not None
                and self.sm.sm_type == pb.StateMachineType.ON_DISK):
            self.stream_snapshot_cb(self, m)
            return
        self.send_message(m)

    def _apply_entries(self, entries, async_core: bool = False) -> None:
        for e in entries:
            if e.key:
                self._rl_release(e.key)
        results = self.sm.handle(entries)
        for r in results:
            entry = next(e for e in entries if e.index == r.index)
            if entry.is_config_change():
                if async_core:
                    self._on_cc_applied_async(entry, r)
                else:
                    self._on_config_change_applied(entry, r)
            elif r.key:
                self.pending_proposals.applied(
                    r.key, r.client_id, r.series_id, r.result, r.rejected
                )
        with self.mu:
            # incremented here (apply worker) and reset by
            # _record_snapshot (possibly another thread) — racing the +=
            # against the reset would lose the reset and double-snapshot
            self.applied_since_snapshot += len(results)
        applied = self.sm.get_last_applied()
        if async_core:
            self._post_core_notice(
                lambda: self.peer is not None
                and self.peer.notify_raft_last_applied(applied))
        elif self.peer is not None:
            self.peer.notify_raft_last_applied(applied)
        self.pending_reads.applied(applied)
        if (async_core and self.cfg.snapshot_entries > 0
                and self.applied_since_snapshot >= self.cfg.snapshot_entries):
            with self.mu:
                if self.snapshot_request is None:
                    self.snapshot_request = _SnapshotRequest()

    def _post_core_notice(self, fn) -> None:
        with self.mu:
            self._core_notices.append(fn)

    def _on_cc_applied_async(self, entry: pb.Entry, r) -> None:
        """CC applied on an apply worker: the RSM membership store (under
        its own lock) is already updated; the raft-core notification is
        posted to the step thread, which owns the core."""
        cc = pb.decode_config_change(entry.cmd)

        def notice() -> None:
            if self.peer is None:
                return
            if not r.rejected:
                self.peer.apply_config_change(cc)
            else:
                self.peer.reject_config_change()

        self._post_core_notice(notice)
        if not r.rejected:
            self.membership_changed_cb(cc)
        code = (RequestResultCode.REJECTED if r.rejected
                else RequestResultCode.COMPLETED)
        self.pending_config_change.done(
            entry.key, code, Result(value=entry.index))

    def _on_config_change_applied(self, entry: pb.Entry, r) -> None:
        cc = pb.decode_config_change(entry.cmd)
        assert self.peer is not None
        if not r.rejected:
            self.peer.apply_config_change(cc)
            self.membership_changed_cb(cc)
        else:
            self.peer.reject_config_change()
        code = (RequestResultCode.REJECTED if r.rejected
                else RequestResultCode.COMPLETED)
        self.pending_config_change.done(
            entry.key, code, Result(value=entry.index))

    def membership_changed_cb(self, cc: pb.ConfigChange) -> None:
        """Overridden by NodeHost to update the registry."""

    # -- engine-path op completion ---------------------------------------

    def _start_leader_transfer(self, target: int) -> None:
        """Submit the transfer, completing the future immediately for the
        raft-core no-op cases (pycore handle_leader_transfer: target is
        already leader / unknown / a transfer already in flight) so the
        one-slot book is not locked out for the whole timeout."""
        assert self.peer is not None
        raft = self.peer.raft
        if target == raft.leader_id or (
                raft.is_leader() and target == self.replica_id):
            self._finish_transfer(RequestResultCode.COMPLETED, target)
            return
        if raft.is_leader() and (
                raft.leader_transfering() or target not in raft.remotes):
            self._finish_transfer(RequestResultCode.REJECTED)
            return
        self.peer.request_leader_transfer(target)

    def _finish_transfer(self, code: RequestResultCode,
                         target: int = 0) -> None:
        with self.mu:
            awaiting, self._transfer_awaiting = self._transfer_awaiting, None
        if awaiting is not None:
            self.pending_transfer.done(awaiting[1], code,
                                       Result(value=target))

    def _on_leader_update(self, lu: pb.LeaderUpdate) -> None:
        if (lu.leader_id, lu.term) == self._last_leader:
            return  # steady-state heartbeat echo, not a change
        self._last_leader = (lu.leader_id, lu.term)
        self.events.leader_updated(LeaderInfo(
            shard_id=self.shard_id, replica_id=self.replica_id,
            term=lu.term, leader_id=lu.leader_id,
        ))
        if lu.leader_id == 0:
            # step-down notification mid-transfer — the new leader is not
            # known yet; keep the future pending until it is
            return
        with self.mu:
            awaiting = self._transfer_awaiting
        if awaiting is None:
            return
        # only a leader edge landing the TARGET resolves the future; an
        # unrelated re-election mid-transfer leaves it pending (raft's
        # transfer may still land — the timeout is the failure signal,
        # matching the reference's fire-and-forget semantics)
        if lu.leader_id == awaiting[0]:
            self._finish_transfer(RequestResultCode.COMPLETED, awaiting[0])

    def _on_log_query_result(self, r: pb.LogQueryResult) -> None:
        rs = self.pending_log_query.outstanding
        if rs is not None:
            rs.log_query_result = r
        code = (RequestResultCode.COMPLETED if r.error == 0
                else RequestResultCode.REJECTED)
        self.pending_log_query.done(self.pending_log_query.key, code)

    def _process_compaction(self, key: int) -> None:
        compact_to = self.compacted_to
        if compact_to <= 0:
            self.pending_compaction.done(key, RequestResultCode.REJECTED)
            return
        self.logdb.remove_entries_to(self.shard_id, self.replica_id,
                                     compact_to)
        self.events.log_db_compacted(EntryInfo(
            shard_id=self.shard_id, replica_id=self.replica_id,
            index=compact_to))
        self.pending_compaction.done(key, RequestResultCode.COMPLETED,
                                     Result(value=compact_to))

    def _send_enter_quiesce_messages(self) -> None:
        """node.go:993: tell every peer the shard is going quiet."""
        for rid in self.sm.get_membership().addresses:
            if rid != self.replica_id:
                self._send(pb.Message(
                    type=pb.MessageType.QUIESCE,
                    from_=self.replica_id, to=rid, shard_id=self.shard_id,
                ))

    # -- snapshots -------------------------------------------------------

    def _gc_snapshot_dir(self, live: pb.Snapshot | None) -> None:
        """Startup orphan GC (snapshotter.go:200 processOrphans): remove
        half-written images (crash mid-save left a .generating temp) and
        committed-but-superseded snapshot files other than the recorded
        live one."""
        if not self.fs.exists(self.snapshot_dir):
            return
        live_name = (os.path.basename(live.filepath)
                     if live is not None and live.filepath else None)
        prefix = f"snapshot-{self.shard_id:016X}-{self.replica_id:016X}-"
        # installed snapshots land as incoming-* (transport/chunks.py)
        # and must be swept once superseded, like local ones
        in_prefix = f"incoming-{self.shard_id:016X}-{self.replica_id:016X}-"
        for fn in self.fs.listdir(self.snapshot_dir):
            full = os.path.join(self.snapshot_dir, fn)
            if not (fn.startswith(prefix) or fn.startswith(in_prefix)):
                continue  # another shard's files (shared non-env dir)
            if fn.endswith(".generating"):
                try:
                    self.fs.remove(full)
                    _LOG.info("removed orphan snapshot temp %s", fn)
                except OSError:
                    pass
            elif ".gbsnap.xf" in fn and (
                    live_name is None
                    or not fn.startswith(live_name + ".xf")):
                # external snapshot files (rsm/files.go) of superseded
                # snapshots
                try:
                    self.fs.remove(full)
                    _LOG.info("removed superseded snapshot file %s", fn)
                except OSError:
                    pass
            elif fn.endswith(".gbsnap") and fn != live_name:
                try:
                    self.fs.remove(full)
                    _LOG.info("removed superseded snapshot %s", fn)
                except OSError:
                    pass

    def _snapshot_path(self, index: int) -> str:
        return os.path.join(
            self.snapshot_dir,
            f"snapshot-{self.shard_id:016X}-{self.replica_id:016X}-{index:016X}.gbsnap",
        )

    def _take_snapshot(self, req: _SnapshotRequest) -> None:
        """save/doSave (node.go:739-801) executed inline (the reference
        uses the snapshot worker pool; the loopback engine is synchronous)."""
        assert self.peer is not None
        index0 = self.sm.get_last_applied()
        if index0 == 0:
            if req.key:
                self.pending_snapshot.done(req.key, RequestResultCode.REJECTED)
            return
        if self.cfg.is_witness and not req.exported:
            # a witness holds no data: record a file-less witness
            # snapshot (snapshotter.go witness record; raft.go:728) so
            # compaction keeps working without writing an empty image
            index, term, membership = self.sm.applied_meta()
            ss = pb.Snapshot(
                index=index, term=term, membership=membership,
                shard_id=self.shard_id, type=self.sm.sm_type, witness=True,
            )
            self._record_snapshot(ss, req)
            return
        path = req.path if req.exported else self._snapshot_path(index0)
        self.fs.makedirs(os.path.dirname(path) or ".")
        index, term, membership, files = \
            self.sm.save_snapshot_with_files(path)
        ss = pb.Snapshot(
            filepath=path,
            file_size=self.fs.getsize(path),
            index=index,
            term=term,
            membership=membership,
            shard_id=self.shard_id,
            type=self.sm.sm_type,
            files=files,
            on_disk_index=(index if self.sm.sm_type == pb.StateMachineType.ON_DISK
                           else 0),
        )
        if req.exported:
            from dragonboat_tpu_torch.tools import write_export_metadata

            write_export_metadata(path, ss, fs=self.fs)
            with self.mu:
                self.applied_since_snapshot = 0
            if req.key:
                self.pending_snapshot.done(
                    req.key, RequestResultCode.COMPLETED,
                    snapshot_index=index)
        else:
            self._record_snapshot(ss, req)

    def _record_snapshot(self, ss: pb.Snapshot, req: _SnapshotRequest) -> None:
        """Persist the snapshot record + compact the log (node.go:781-801
        after doSave)."""
        index = ss.index
        self.logdb.save_snapshots([pb.Update(
            shard_id=self.shard_id, replica_id=self.replica_id, snapshot=ss
        )])
        # make the snapshot visible to makeInstallSnapshotMessage
        # (snapshotter.Commit → logReader.CreateSnapshot)
        self.log_reader.create_snapshot(ss)
        self.events.snapshot_created(SnapshotInfo(
            shard_id=self.shard_id, replica_id=self.replica_id,
            from_=self.replica_id, index=index, term=ss.term))
        # compact the log, keeping compaction_overhead entries
        overhead = (req.compaction_overhead if req.override_compaction
                    else self.cfg.compaction_overhead)
        compact_to = max(0, index - overhead)
        if compact_to > 0 and not self.cfg.disable_auto_compaction:
            try:
                self.log_reader.compact(compact_to)
                self.logdb.remove_entries_to(
                    self.shard_id, self.replica_id, compact_to)
                self.compacted_to = compact_to
                self.events.log_compacted(EntryInfo(
                    shard_id=self.shard_id, replica_id=self.replica_id,
                    index=compact_to))
            except Exception:
                _LOG.exception("log compaction failed")
        with self.mu:
            self.applied_since_snapshot = 0
        if req.key:
            self.pending_snapshot.done(
                req.key, RequestResultCode.COMPLETED, snapshot_index=index)

    def _handle_install_snapshot(self, m: pb.Message) -> None:
        """Follower-side snapshot install: recover the RSM then feed the
        raft core (host slow path; engine.go:1382 applySnapshotAndUpdate)."""
        assert self.peer is not None
        ss = m.snapshot
        self.peer.raft.handle(m)  # raft-core restore (log + remotes)
        if self.peer.raft.log.inmem.snapshot is not None:
            if ss.witness or ss.dummy:
                # witness snapshots carry no data file (raft.go:728
                # makeWitnessSnapshot): advance the RSM bookkeeping only
                self.sm.restore_bookkeeping(ss)
                self.events.snapshot_recovered(SnapshotInfo(
                    shard_id=self.shard_id, replica_id=self.replica_id,
                    from_=m.from_, index=ss.index, term=ss.term))
                return
            # accepted: recover the user SM from the snapshot file
            self.sm.recover_from_snapshot(ss.filepath, ss)
            # on-disk SM: once the recovered data is synced into the SM's
            # own storage the recorded file is redundant bytes — shrink
            # it to the empty-session container (node.go:871-877 Sync +
            # snapshotter.Shrink)
            if self.sm.sm_type == pb.StateMachineType.ON_DISK:
                self.sm.sync()
                self.sm.shrink_recorded_snapshot(ss.filepath)
            self.events.snapshot_recovered(SnapshotInfo(
                shard_id=self.shard_id, replica_id=self.replica_id,
                from_=m.from_, index=ss.index, term=ss.term))

    def _apply_snapshot(self, ss: pb.Snapshot) -> None:
        self.logdb.save_snapshots([pb.Update(
            shard_id=self.shard_id, replica_id=self.replica_id, snapshot=ss)])
        self.log_reader.apply_snapshot(ss)

    # -- info -----------------------------------------------------------

    def leader_id(self) -> int:
        return self.peer.raft.leader_id if self.peer else 0

    def node_term(self) -> int:
        return self.peer.raft.term if self.peer else self._last_leader[1]

    def is_leader(self) -> bool:
        return bool(self.peer and self.peer.raft.is_leader())
