"""Peer — the message-in/Update-out API over the raft core.

Parity with the reference's ``internal/raft/peer.go``: every input to the
protocol is modelled as a message; the output is a :class:`raftpb.Update`
batch that the engine persists/sends/applies and then ``commit()``s back.
The batched device kernel produces the same Update contract per shard, so
the engine above is executor-agnostic.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.core.logentry import ILogDBReader
from dragonboat_tpu_torch.core.pycore import CoreConfig, Raft

# apply-batch pagination (reference settings.Soft MaxEntriesToApplySize)
MAX_APPLY_SIZE = 8 * 1024 * 1024


class Peer:
    """Single-shard protocol driver — parity internal/raft/peer.go:56-208."""

    def __init__(self, raft: Raft) -> None:
        self.raft = raft
        self.prev_state = self._raft_state()

    # -- construction ---------------------------------------------------

    @staticmethod
    def launch(
        cfg: CoreConfig,
        logdb: ILogDBReader,
        addresses: dict[int, str],
        initial: bool,
        new_node: bool,
        rng=None,
    ) -> "Peer":
        """Start or restart a raft node — parity peer.go:64 (Launch).

        When ``initial and new_node``, bootstrap config-change entries for the
        initial membership are appended at term 1 and marked committed
        (peer.go:404 bootstrap)."""
        r = Raft(cfg, logdb, rng=rng)
        # persisted-state restore is the caller's job via raft.load_state
        p = Peer(r)
        if initial and new_node:
            r.become_follower(1, 0)
            ents = []
            for i, rid in enumerate(sorted(addresses)):
                cc = pb.ConfigChange(
                    type=pb.ConfigChangeType.ADD_NODE,
                    replica_id=rid,
                    address=addresses[rid],
                    initialize=True,
                )
                ents.append(
                    pb.Entry(
                        type=pb.EntryType.CONFIG_CHANGE,
                        term=1,
                        index=i + 1,
                        cmd=pb.encode_config_change(cc),
                    )
                )
            r.log.append(ents)
            r.log.committed = len(ents)
            for rid in sorted(addresses):
                r.add_node(rid)
        return p

    def _raft_state(self) -> pb.State:
        return pb.State(
            term=self.raft.term, vote=self.raft.vote, commit=self.raft.log.committed
        )

    # -- input translators (peer.go:81-170) -----------------------------

    def tick(self) -> None:
        self.raft.handle(pb.Message(type=pb.MessageType.LOCAL_TICK, reject=False))

    def quiesced_tick(self) -> None:
        self.raft.handle(pb.Message(type=pb.MessageType.LOCAL_TICK, reject=True))

    def query_raft_log(self, first: int, last: int, max_size: int) -> None:
        self.raft.handle(
            pb.Message(
                type=pb.MessageType.LOG_QUERY, from_=first, to=last, hint=max_size
            )
        )

    def request_leader_transfer(self, target: int) -> None:
        self.raft.handle(
            pb.Message(
                type=pb.MessageType.LEADER_TRANSFER,
                to=self.raft.replica_id,
                hint=target,
            )
        )

    def propose_entries(self, ents: Sequence[pb.Entry]) -> None:
        self.raft.handle(
            pb.Message(
                type=pb.MessageType.PROPOSE,
                from_=self.raft.replica_id,
                entries=tuple(ents),
            )
        )

    def propose_config_change(self, cc: pb.ConfigChange, key: int) -> None:
        self.raft.handle(
            pb.Message(
                type=pb.MessageType.PROPOSE,
                entries=(
                    pb.Entry(
                        type=pb.EntryType.CONFIG_CHANGE,
                        cmd=pb.encode_config_change(cc),
                        key=key,
                    ),
                ),
            )
        )

    def apply_config_change(self, cc: pb.ConfigChange) -> None:
        if cc.replica_id == 0:
            self.raft.pending_config_change = False
            return
        self.raft.handle(
            pb.Message(
                type=pb.MessageType.CONFIG_CHANGE_EVENT,
                reject=False,
                hint=cc.replica_id,
                hint_high=int(cc.type),
            )
        )

    def reject_config_change(self) -> None:
        self.raft.handle(
            pb.Message(type=pb.MessageType.CONFIG_CHANGE_EVENT, reject=True)
        )

    def restore_remotes(self, ss: pb.Snapshot) -> None:
        self.raft.handle(
            pb.Message(type=pb.MessageType.SNAPSHOT_RECEIVED, snapshot=ss)
        )

    def report_unreachable_node(self, replica_id: int) -> None:
        self.raft.handle(
            pb.Message(type=pb.MessageType.UNREACHABLE, from_=replica_id)
        )

    def report_snapshot_status(self, replica_id: int, reject: bool) -> None:
        self.raft.handle(
            pb.Message(
                type=pb.MessageType.SNAPSHOT_STATUS, from_=replica_id, reject=reject
            )
        )

    def read_index(self, ctx: pb.SystemCtx) -> None:
        self.raft.handle(
            pb.Message(
                type=pb.MessageType.READ_INDEX, hint=ctx.low, hint_high=ctx.high
            )
        )

    def notify_raft_last_applied(self, last_applied: int) -> None:
        self.raft.applied = last_applied

    def handle(self, m: pb.Message) -> None:
        """External message entry — drops responses from unknown peers
        (peer.go:183-194)."""
        if m.is_local():
            raise AssertionError("local message sent to handle()")
        known = self.raft.get_remote(m.from_) is not None
        if known or not m.is_response():
            self.raft.handle(m)

    # -- Update assembly (peer.go:198-292, 432) --------------------------

    def has_update(self, more_to_apply: bool) -> bool:
        r = self.raft
        return bool(
            r.log.entries_to_save()
            or r.log_query_result is not None
            or r.leader_update is not None
            or r.msgs
            or (more_to_apply and r.log.has_entries_to_apply())
            or self._raft_state() != self.prev_state
            or (r.log.inmem.snapshot is not None and not r.log.inmem.snapshot.is_empty())
            or r.ready_to_read
            or r.dropped_entries
            or r.dropped_read_indexes
        )

    def has_entry_to_apply(self) -> bool:
        return self.raft.log.has_entries_to_apply()

    def get_update(self, more_to_apply: bool, last_applied: int) -> pb.Update:
        r = self.raft
        committed: tuple[pb.Entry, ...] = ()
        more = False
        if more_to_apply:
            committed = tuple(r.log.entries_to_apply(MAX_APPLY_SIZE))
            if committed:
                more = committed[-1].index < r.log.committed
        state = pb.State()
        cur = self._raft_state()
        if cur != self.prev_state:
            state = cur
        snapshot = pb.Snapshot()
        if r.log.inmem.snapshot is not None:
            snapshot = r.log.inmem.snapshot
        ud = pb.Update(
            shard_id=r.shard_id,
            replica_id=r.replica_id,
            state=state,
            entries_to_save=tuple(r.log.entries_to_save()),
            committed_entries=committed,
            more_committed_entries=more,
            snapshot=snapshot,
            ready_to_reads=tuple(r.ready_to_read),
            messages=tuple(replace(m, shard_id=r.shard_id) for m in r.msgs),
            last_applied=last_applied,
            dropped_entries=tuple(r.dropped_entries),
            dropped_read_indexes=tuple(r.dropped_read_indexes),
            log_query_result=r.log_query_result or pb.LogQueryResult(),
            leader_update=r.leader_update,
        )
        self._validate_update(ud)
        ud = replace(ud, fast_apply=self._fast_apply(ud))
        ud = replace(ud, update_commit=self._get_update_commit(ud))
        return ud

    @staticmethod
    def _fast_apply(ud: pb.Update) -> bool:
        """Committed entries can be applied without waiting for fsync iff
        none of them are in this Update's to-save batch (peer.go:210-226)."""
        if not ud.snapshot.is_empty():
            return False
        if ud.committed_entries and ud.entries_to_save:
            last_apply = ud.committed_entries[-1].index
            first_save = ud.entries_to_save[0].index
            last_save = ud.entries_to_save[-1].index
            if first_save <= last_apply <= last_save:
                return False
        return True

    @staticmethod
    def _validate_update(ud: pb.Update) -> None:
        if ud.state.commit > 0 and ud.committed_entries:
            if ud.committed_entries[-1].index > ud.state.commit:
                raise AssertionError("applying uncommitted entry")
        if ud.committed_entries and ud.entries_to_save:
            if ud.committed_entries[-1].index > ud.entries_to_save[-1].index:
                raise AssertionError("applying unsaved entry")

    @staticmethod
    def _get_update_commit(ud: pb.Update) -> pb.UpdateCommit:
        uc = pb.UpdateCommit(
            ready_to_read=len(ud.ready_to_reads),
            last_applied=ud.last_applied,
        )
        processed = uc.processed
        if ud.committed_entries:
            processed = ud.committed_entries[-1].index
        stable_log_to, stable_log_term = 0, 0
        if ud.entries_to_save:
            stable_log_to = ud.entries_to_save[-1].index
            stable_log_term = ud.entries_to_save[-1].term
        stable_snapshot_to = 0
        if not ud.snapshot.is_empty():
            stable_snapshot_to = ud.snapshot.index
            processed = max(processed, stable_snapshot_to)
        return pb.UpdateCommit(
            processed=processed,
            last_applied=ud.last_applied,
            stable_log_to=stable_log_to,
            stable_log_term=stable_log_term,
            stable_snapshot_to=stable_snapshot_to,
            ready_to_read=len(ud.ready_to_reads),
        )

    def commit(self, ud: pb.Update) -> None:
        """Mark an Update as processed — parity peer.go:292 (Commit)."""
        r = self.raft
        r.msgs = []
        r.log_query_result = None
        r.leader_update = None
        r.dropped_entries = []
        r.dropped_read_indexes = []
        if not ud.state.is_empty():
            self.prev_state = ud.state
        if ud.update_commit.ready_to_read > 0:
            r.ready_to_read = r.ready_to_read[ud.update_commit.ready_to_read :]
        r.log.commit_update(ud.update_commit)

    def notify_config_change_applied(self) -> None:
        pass

    # convenience accessors used by node/tests
    @property
    def leader_id(self) -> int:
        return self.raft.leader_id

    def is_leader(self) -> bool:
        return self.raft.is_leader()
