"""Full-fidelity single-shard Raft core (host Python).

This is the message-in/state-out protocol engine with the same observable
behavior as the reference's ``internal/raft/raft.go`` (6 states × 29 message
types, pre-vote, check-quorum leases, pipelined replication with per-remote
flow control, ReadIndex, one-at-a-time membership change, leadership
transfer, witness/non-voting members).  It is used as:

1. the conformance anchor — the etcd-derived test suites run against it;
2. the host slow path — variable-width ops (snapshot install, membership
   restore) operate on per-shard state extracted from the device kernel;
3. the differential-test oracle for :mod:`dragonboat_tpu_torch.core.kernel`.

Behavioral citations point into ``reference/internal/raft/`` — this is
a re-implementation from the protocol's documented behavior, not a port of
its goroutine/alloc patterns.
"""

from __future__ import annotations

import enum
import random as _random
from dataclasses import dataclass, field, replace
from typing import Callable

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.core.logentry import (
    CompactedError,
    EntryLog,
    ILogDBReader,
)

NO_LEADER = 0
NO_NODE = 0

# Entry-batch cap when replicating (reference soft.MaxEntrySize is 2MB;
# we cap by byte size the same way).
MAX_ENTRY_SIZE = 2 * 1024 * 1024


class RaftState(enum.IntEnum):
    """Parity: internal/raft/raft.go:63-71 (six states)."""

    FOLLOWER = 0
    CANDIDATE = 1
    PRE_VOTE_CANDIDATE = 2
    LEADER = 3
    NON_VOTING = 4
    WITNESS = 5


class RemoteState(enum.IntEnum):
    """Per-peer replication flow control — parity internal/raft/remote.go:52-70."""

    RETRY = 0
    WAIT = 1
    REPLICATE = 2
    SNAPSHOT = 3


@dataclass
class Remote:
    """Follower progress tracked by the leader — parity internal/raft/remote.go:72."""

    match: int = 0
    next: int = 0
    snapshot_index: int = 0
    state: RemoteState = RemoteState.RETRY
    active: bool = False
    delayed_ack_tick: int = 0
    delayed_ack_rejected: bool = False

    def clear_snapshot_ack(self) -> None:
        self.delayed_ack_tick = 0
        self.delayed_ack_rejected = False

    def set_snapshot_ack(self, tick: int, rejected: bool) -> None:
        assert self.state == RemoteState.SNAPSHOT
        self.delayed_ack_tick = tick
        self.delayed_ack_rejected = rejected

    def ack_tick(self) -> bool:
        if self.delayed_ack_tick > 0:
            self.delayed_ack_tick -= 1
            return self.delayed_ack_tick == 0
        return False

    def become_retry(self) -> None:
        if self.state == RemoteState.SNAPSHOT:
            self.next = max(self.match + 1, self.snapshot_index + 1)
        else:
            self.next = self.match + 1
        self.snapshot_index = 0
        self.state = RemoteState.RETRY

    def retry_to_wait(self) -> None:
        if self.state == RemoteState.RETRY:
            self.state = RemoteState.WAIT

    def wait_to_retry(self) -> None:
        if self.state == RemoteState.WAIT:
            self.state = RemoteState.RETRY

    def become_wait(self) -> None:
        self.clear_snapshot_ack()
        self.become_retry()
        self.retry_to_wait()

    def become_replicate(self) -> None:
        self.next = self.match + 1
        self.snapshot_index = 0
        self.state = RemoteState.REPLICATE

    def become_snapshot(self, index: int) -> None:
        self.snapshot_index = index
        self.state = RemoteState.SNAPSHOT

    def clear_pending_snapshot(self) -> None:
        self.snapshot_index = 0

    def try_update(self, index: int) -> bool:
        if self.next < index + 1:
            self.next = index + 1
        if self.match < index:
            self.wait_to_retry()
            self.match = index
            return True
        return False

    def progress(self, last_index: int) -> None:
        """Optimistic pipelined advance at send time — remote.go:progress."""
        if self.state == RemoteState.REPLICATE:
            self.next = last_index + 1
        elif self.state == RemoteState.RETRY:
            self.retry_to_wait()
        else:
            raise AssertionError(f"progress() in state {self.state}")

    def responded_to(self) -> None:
        if self.state == RemoteState.RETRY:
            self.become_replicate()
        elif self.state == RemoteState.SNAPSHOT:
            if self.match >= self.snapshot_index:
                self.become_retry()

    def decrease_to(self, rejected: int, last: int) -> bool:
        """Backtrack next on rejection — remote.go:decreaseTo (etcd-derived,
        resets next to match+1, more conservative than thesis p21)."""
        if self.state == RemoteState.REPLICATE:
            if rejected <= self.match:
                return False
            self.next = self.match + 1
            return True
        if self.next - 1 != rejected:
            return False
        self.wait_to_retry()
        self.next = max(1, min(rejected, last + 1))
        return True

    def is_paused(self) -> bool:
        return self.state in (RemoteState.WAIT, RemoteState.SNAPSHOT)


@dataclass
class _ReadStatus:
    index: int
    from_: int
    ctx: pb.SystemCtx
    confirmed: set[int] = field(default_factory=set)


class ReadIndexBook:
    """FIFO of pending ReadIndex contexts — parity internal/raft/readindex.go:30."""

    def __init__(self) -> None:
        self.pending: dict[pb.SystemCtx, _ReadStatus] = {}
        self.queue: list[pb.SystemCtx] = []

    def add_request(self, index: int, ctx: pb.SystemCtx, from_: int) -> None:
        if ctx in self.pending:
            return
        self.pending[ctx] = _ReadStatus(index=index, from_=from_, ctx=ctx)
        self.queue.append(ctx)

    def has_pending_request(self) -> bool:
        return bool(self.queue)

    def peep_ctx(self) -> pb.SystemCtx:
        return self.queue[-1]

    def confirm(self, ctx: pb.SystemCtx, from_: int, quorum: int) -> list[_ReadStatus]:
        """Record an ack; once quorum reached, pop every ctx at-or-before it —
        parity readindex.go:73."""
        status = self.pending.get(ctx)
        if status is None:
            return []
        status.confirmed.add(from_)
        if len(status.confirmed) + 1 < quorum:
            return []
        done = 0
        out: list[_ReadStatus] = []
        for c in self.queue:
            done += 1
            s = self.pending[c]
            out.append(s)
            if c == ctx:
                break
        else:
            return []
        self.queue = self.queue[done:]
        for s in out:
            del self.pending[s.ctx]
        return out


@dataclass
class CoreConfig:
    """Protocol knobs for one shard — mirrors config.Config's raft-relevant
    fields (config/config.go:58-198)."""

    shard_id: int = 0
    replica_id: int = 0
    election_rtt: int = 10
    heartbeat_rtt: int = 1
    check_quorum: bool = False
    pre_vote: bool = False
    is_non_voting: bool = False
    is_witness: bool = False
    quiesce: bool = False
    max_entry_size: int = MAX_ENTRY_SIZE
    # count cap per replicate message (the kernel's fixed E entry lanes);
    # None = byte cap only.  The differential harness sets this to the
    # kernel's msg_entries so catch-up proceeds in lockstep — otherwise a
    # lagging follower refills at different rates on the two engines and
    # an election mid-catch-up diverges (found by the seed soak)
    max_entries_per_msg: int | None = None


class Raft:
    """The deterministic raft protocol state machine for one shard."""

    def __init__(
        self,
        cfg: CoreConfig,
        logdb: ILogDBReader,
        rng: Callable[[int], int] | None = None,
    ) -> None:
        self.cfg = cfg
        self.shard_id = cfg.shard_id
        self.replica_id = cfg.replica_id
        self.log = EntryLog(logdb)
        self.term = 0
        self.vote = NO_NODE
        self.leader_id = NO_LEADER
        self.applied = logdb.first_index() - 1
        self.state = RaftState.FOLLOWER
        self.remotes: dict[int, Remote] = {}
        self.non_votings: dict[int, Remote] = {}
        self.witnesses: dict[int, Remote] = {}
        self.votes: dict[int, bool] = {}
        self.msgs: list[pb.Message] = []
        self.dropped_entries: list[pb.Entry] = []
        self.dropped_read_indexes: list[pb.SystemCtx] = []
        self.ready_to_read: list[pb.ReadyToRead] = []
        self.read_index = ReadIndexBook()
        self.pending_config_change = False
        self.leader_transfer_target = NO_NODE
        self.is_leader_transfer_target = False
        self.election_tick = 0
        self.heartbeat_tick = 0
        self.tick_count = 0
        self.election_timeout = cfg.election_rtt
        self.heartbeat_timeout = cfg.heartbeat_rtt
        self.randomized_election_timeout = 0
        self.check_quorum = cfg.check_quorum
        self.pre_vote = cfg.pre_vote
        self.quiesce = False
        self.snapshotting = False
        self.leader_update: pb.LeaderUpdate | None = None
        self.log_query_result: pb.LogQueryResult | None = None
        # injectable randomness: rng(n) -> uniform int in [0, n)
        self._rng: Callable[[int], int] = rng if rng is not None else (
            lambda n: _random.randrange(n)
        )
        # test hook mirroring the reference's hasNotAppliedConfigChange
        self.has_not_applied_config_change: Callable[[], bool] | None = None
        self.set_randomized_election_timeout()

    # ------------------------------------------------------------------
    # setup / persisted-state restore (parity raft.go:241-297 newRaft)
    # ------------------------------------------------------------------

    def load_state(self, st: pb.State) -> None:
        if st.commit < self.log.committed or st.commit > self.log.last_index():
            raise AssertionError(f"out of range commit {st.commit}")
        self.term = st.term
        self.vote = st.vote
        self.log.committed = st.commit

    def set_initial_members(self, members: dict[int, str],
                            non_votings: dict[int, str] | None = None,
                            witnesses: dict[int, str] | None = None) -> None:
        next_idx = self.log.last_index() + 1
        for rid in members:
            self.remotes[rid] = Remote(next=next_idx)
        for rid in (non_votings or {}):
            self.non_votings[rid] = Remote(next=next_idx)
        for rid in (witnesses or {}):
            self.witnesses[rid] = Remote(next=next_idx)
        if self.cfg.is_non_voting or self.replica_id in self.non_votings:
            self.state = RaftState.NON_VOTING
        if self.cfg.is_witness or self.replica_id in self.witnesses:
            self.state = RaftState.WITNESS

    # ------------------------------------------------------------------
    # role predicates / quorum helpers
    # ------------------------------------------------------------------

    def is_leader(self) -> bool:
        return self.state == RaftState.LEADER

    def is_follower(self) -> bool:
        return self.state == RaftState.FOLLOWER

    def is_candidate(self) -> bool:
        return self.state == RaftState.CANDIDATE

    def is_pre_vote_candidate(self) -> bool:
        return self.state == RaftState.PRE_VOTE_CANDIDATE

    def is_non_voting(self) -> bool:
        return self.state == RaftState.NON_VOTING

    def is_witness(self) -> bool:
        return self.state == RaftState.WITNESS

    def voting_members(self) -> dict[int, Remote]:
        out = dict(self.remotes)
        out.update(self.witnesses)
        return out

    def num_voting_members(self) -> int:
        return len(self.remotes) + len(self.witnesses)

    def quorum(self) -> int:
        return self.num_voting_members() // 2 + 1

    def is_single_node_quorum(self) -> bool:
        return self.quorum() == 1

    def leader_has_quorum(self) -> bool:
        """Parity raft.go:395 — counts recently-active voters, resetting
        activity records."""
        c = 0
        for rid, member in self.voting_members().items():
            if rid == self.replica_id or member.active:
                c += 1
            member.active = False
        return c >= self.quorum()

    def self_removed(self) -> bool:
        if self.is_non_voting():
            return self.replica_id not in self.non_votings
        if self.is_witness():
            return self.replica_id not in self.witnesses
        return self.replica_id not in self.remotes

    def nodes(self) -> list[int]:
        return list(self.remotes) + list(self.non_votings) + list(self.witnesses)

    def get_remote(self, rid: int) -> Remote | None:
        return (
            self.remotes.get(rid)
            or self.non_votings.get(rid)
            or self.witnesses.get(rid)
        )

    # ------------------------------------------------------------------
    # tick (parity raft.go:540-680)
    # ------------------------------------------------------------------

    def time_for_election(self) -> bool:
        return self.election_tick >= self.randomized_election_timeout

    def time_for_heartbeat(self) -> bool:
        return self.heartbeat_tick >= self.heartbeat_timeout

    def time_for_check_quorum(self) -> bool:
        return self.election_tick >= self.election_timeout

    def time_to_abort_leader_transfer(self) -> bool:
        return self.leader_transfering() and self.election_tick >= self.election_timeout

    def tick(self) -> None:
        self.quiesce = False
        self.tick_count += 1
        if self.is_leader():
            self.leader_tick()
        else:
            self.non_leader_tick()

    def non_leader_tick(self) -> None:
        assert not self.is_leader()
        self.election_tick += 1
        # section 4.2.1 of the raft thesis: non-voting/witness never campaign
        if self.is_non_voting() or self.is_witness():
            return
        if not self.self_removed() and self.time_for_election():
            self.election_tick = 0
            self.handle(pb.Message(from_=self.replica_id, type=pb.MessageType.ELECTION))

    def leader_tick(self) -> None:
        assert self.is_leader()
        self.election_tick += 1
        time_to_abort = self.time_to_abort_leader_transfer()
        if self.time_for_check_quorum():
            self.election_tick = 0
            if self.check_quorum:
                self.handle(
                    pb.Message(from_=self.replica_id, type=pb.MessageType.CHECK_QUORUM)
                )
        if time_to_abort:
            self.abort_leader_transfer()
        self.heartbeat_tick += 1
        if self.time_for_heartbeat():
            self.heartbeat_tick = 0
            self.handle(
                pb.Message(from_=self.replica_id, type=pb.MessageType.LEADER_HEARTBEAT)
            )
        self.check_pending_snapshot_ack()

    def quiesced_tick(self) -> None:
        if not self.quiesce:
            self.quiesce = True
        self.election_tick += 1

    def set_randomized_election_timeout(self) -> None:
        self.randomized_election_timeout = (
            self.election_timeout + self._rng(self.election_timeout)
        )

    # ------------------------------------------------------------------
    # send helpers (parity raft.go:666-700)
    # ------------------------------------------------------------------

    def _finalize_message_term(self, m: pb.Message) -> pb.Message:
        is_rv = m.type in (pb.MessageType.REQUEST_VOTE, pb.MessageType.REQUEST_PREVOTE)
        is_req = m.type in (
            pb.MessageType.PROPOSE,
            pb.MessageType.READ_INDEX,
            pb.MessageType.LEADER_TRANSFER,
        )
        if not is_req and not is_rv and m.type != pb.MessageType.REQUEST_PREVOTE_RESP:
            m = replace(m, term=self.term)
        return m

    def send(self, m: pb.Message) -> None:
        m = replace(m, from_=self.replica_id, shard_id=self.shard_id)
        m = self._finalize_message_term(m)
        self.msgs.append(m)

    # ------------------------------------------------------------------
    # replication senders (parity raft.go:713-880)
    # ------------------------------------------------------------------

    def make_install_snapshot_message(self, to: int) -> pb.Message:
        ss = self.log.snapshot()
        if ss.is_empty():
            raise AssertionError("empty snapshot")
        if to in self.witnesses:
            ss = replace(ss, filepath="", file_size=0, files=(), witness=True,
                         dummy=False)
        return pb.Message(to=to, type=pb.MessageType.INSTALL_SNAPSHOT, snapshot=ss)

    def make_replicate_message(self, to: int, next_: int, max_size: int) -> pb.Message:
        term = self.log.term(next_ - 1)  # raises CompactedError when gone
        entries = self.log.entries_from(next_, max_size)
        if self.cfg.max_entries_per_msg is not None:
            entries = entries[: self.cfg.max_entries_per_msg]
        if to in self.witnesses:
            # witnesses receive metadata-only entries (raft.go:770 makeMetadataEntries)
            entries = [
                e if e.type == pb.EntryType.CONFIG_CHANGE
                else pb.Entry(term=e.term, index=e.index, type=pb.EntryType.METADATA)
                for e in entries
            ]
        return pb.Message(
            to=to,
            type=pb.MessageType.REPLICATE,
            log_index=next_ - 1,
            log_term=term,
            entries=tuple(entries),
            commit=self.log.committed,
        )

    def send_replicate_message(self, to: int) -> None:
        rp = self.get_remote(to)
        if rp is None:
            raise AssertionError(f"no remote for {to}")
        if rp.is_paused():
            return
        try:
            m = self.make_replicate_message(to, rp.next, self.cfg.max_entry_size)
        except CompactedError:
            # log truncated: send snapshot instead (raft.go:800-812)
            if not rp.active:
                return
            m = self.make_install_snapshot_message(to)
            rp.become_snapshot(m.snapshot.index)
            self.send(m)
            return
        if m.entries:
            rp.progress(m.entries[-1].index)
        self.send(m)

    def broadcast_replicate_message(self) -> None:
        assert self.is_leader()
        for rid in self.nodes():
            if rid != self.replica_id:
                self.send_replicate_message(rid)

    def send_heartbeat_message(self, to: int, hint: pb.SystemCtx, match: int) -> None:
        self.send(
            pb.Message(
                to=to,
                type=pb.MessageType.HEARTBEAT,
                commit=min(match, self.log.committed),
                hint=hint.low,
                hint_high=hint.high,
            )
        )

    def broadcast_heartbeat_message(self) -> None:
        assert self.is_leader()
        if self.read_index.has_pending_request():
            self.broadcast_heartbeat_with_hint(self.read_index.peep_ctx())
        else:
            self.broadcast_heartbeat_with_hint(pb.SystemCtx())

    def broadcast_heartbeat_with_hint(self, ctx: pb.SystemCtx) -> None:
        zero = pb.SystemCtx()
        for rid, rm in self.voting_members().items():
            if rid != self.replica_id:
                self.send_heartbeat_message(rid, ctx, rm.match)
        if ctx == zero:
            for rid, rm in self.non_votings.items():
                self.send_heartbeat_message(rid, zero, rm.match)

    def send_timeout_now_message(self, rid: int) -> None:
        self.send(pb.Message(type=pb.MessageType.TIMEOUT_NOW, to=rid))

    # ------------------------------------------------------------------
    # append / commit (parity raft.go:884-958)
    # ------------------------------------------------------------------

    def try_commit(self) -> bool:
        assert self.is_leader()
        matched = sorted(
            [v.match for v in self.remotes.values()]
            + [v.match for v in self.witnesses.values()]
        )
        q = matched[self.num_voting_members() - self.quorum()]
        return self.log.try_commit(q, self.term)

    def append_entries(self, entries: list[pb.Entry]) -> None:
        last = self.log.last_index()
        stamped = [
            replace(e, term=self.term, index=last + 1 + i)
            for i, e in enumerate(entries)
        ]
        self.log.append(stamped)
        self.remotes[self.replica_id].try_update(self.log.last_index())
        if self.is_single_node_quorum():
            self.try_commit()

    # ------------------------------------------------------------------
    # state transitions (parity raft.go:960-1130)
    # ------------------------------------------------------------------

    def set_leader_id(self, leader_id: int) -> None:
        self.leader_id = leader_id
        self.leader_update = pb.LeaderUpdate(leader_id=leader_id, term=self.term)

    def reset(self, term: int, reset_election_timeout: bool) -> None:
        if self.term != term:
            self.term = term
            self.vote = NO_LEADER
        if reset_election_timeout:
            self.election_tick = 0
            self.set_randomized_election_timeout()
        self.votes = {}
        self.heartbeat_tick = 0
        self.read_index = ReadIndexBook()
        self.pending_config_change = False
        self.abort_leader_transfer()
        last = self.log.last_index()
        for group in (self.remotes, self.non_votings, self.witnesses):
            for rid in group:
                group[rid] = Remote(next=last + 1)
                if rid == self.replica_id:
                    group[rid].match = last

    def become_follower(self, term: int, leader_id: int,
                        reset_election_timeout: bool = True) -> None:
        if self.is_witness():
            raise AssertionError("witness becoming follower")
        self.state = RaftState.FOLLOWER
        self.reset(term, reset_election_timeout)
        self.set_leader_id(leader_id)

    def become_non_voting(self, term: int, leader_id: int) -> None:
        assert self.is_non_voting()
        self.reset(term, True)
        self.set_leader_id(leader_id)

    def become_witness(self, term: int, leader_id: int) -> None:
        assert self.is_witness()
        self.reset(term, True)
        self.set_leader_id(leader_id)

    def become_pre_vote_candidate(self) -> None:
        assert self.pre_vote
        assert not self.is_leader()
        assert not self.is_non_voting() and not self.is_witness()
        self.state = RaftState.PRE_VOTE_CANDIDATE
        self.reset(self.term, True)
        self.set_leader_id(NO_LEADER)

    def become_candidate(self) -> None:
        assert not self.is_leader()
        assert not self.is_non_voting() and not self.is_witness()
        self.state = RaftState.CANDIDATE
        # 2nd paragraph section 5.2 of the raft paper
        self.reset(self.term + 1, True)
        self.set_leader_id(NO_LEADER)
        self.vote = self.replica_id

    def become_leader(self) -> None:
        assert self.is_leader() or self.is_candidate()
        self.state = RaftState.LEADER
        self.reset(self.term, True)
        self.set_leader_id(self.replica_id)
        # restore the pending-config-change flag from the unapplied log tail
        n = self.get_pending_config_change_count()
        if n > 1:
            raise AssertionError("multiple uncommitted config changes")
        if n == 1:
            self.pending_config_change = True
        # p72 of the raft thesis: append an empty entry on promotion
        self.append_entries([pb.Entry(type=pb.EntryType.APPLICATION)])

    def get_pending_config_change_count(self) -> int:
        idx = self.log.committed + 1
        count = 0
        while True:
            ents = self.log.entries_from(idx)
            if not ents:
                return count
            count += sum(1 for e in ents if e.type == pb.EntryType.CONFIG_CHANGE)
            idx = ents[-1].index + 1

    # ------------------------------------------------------------------
    # elections (parity raft.go:1125-1260)
    # ------------------------------------------------------------------

    def handle_vote_resp(self, from_: int, rejected: bool, prevote: bool) -> int:
        if from_ not in self.votes:
            self.votes[from_] = not rejected
        return sum(1 for v in self.votes.values() if v)

    def pre_vote_campaign(self) -> None:
        self.become_pre_vote_candidate()
        self.handle_vote_resp(self.replica_id, False, True)
        if self.is_single_node_quorum():
            self.campaign()
            return
        index = self.log.last_index()
        last_term = self.log.last_term()
        for rid in self.voting_members():
            if rid == self.replica_id:
                continue
            self.send(
                pb.Message(
                    term=self.term + 1,
                    to=rid,
                    type=pb.MessageType.REQUEST_PREVOTE,
                    log_index=index,
                    log_term=last_term,
                )
            )

    def campaign(self) -> None:
        self.become_candidate()
        term = self.term
        self.handle_vote_resp(self.replica_id, False, False)
        if self.is_single_node_quorum():
            self.become_leader()
            return
        hint = 0
        if self.is_leader_transfer_target:
            hint = self.replica_id
            self.is_leader_transfer_target = False
        index = self.log.last_index()
        last_term = self.log.last_term()
        for rid in self.voting_members():
            if rid == self.replica_id:
                continue
            self.send(
                pb.Message(
                    term=term,
                    to=rid,
                    type=pb.MessageType.REQUEST_VOTE,
                    log_index=index,
                    log_term=last_term,
                    hint=hint,
                )
            )

    # ------------------------------------------------------------------
    # membership (parity raft.go:1236-1340)
    # ------------------------------------------------------------------

    def add_node(self, rid: int) -> None:
        self.pending_config_change = False
        if rid == self.replica_id and self.is_witness():
            raise AssertionError("adding self while witness")
        if rid in self.remotes:
            return
        if rid in self.non_votings:
            rp = self.non_votings.pop(rid)
            self.remotes[rid] = rp
            if rid == self.replica_id:
                # local peer promoted to voter
                self.become_follower(self.term, self.leader_id)
        elif rid in self.witnesses:
            raise AssertionError("cannot promote witness to full member")
        else:
            self.remotes[rid] = Remote(match=0, next=self.log.last_index() + 1)

    def add_non_voting(self, rid: int) -> None:
        self.pending_config_change = False
        if rid in self.non_votings:
            return
        if rid in self.remotes or rid in self.witnesses:
            # demotion not allowed; reference panics on voter->nonvoting
            raise AssertionError("demoting member to nonVoting")
        self.non_votings[rid] = Remote(match=0, next=self.log.last_index() + 1)

    def add_witness(self, rid: int) -> None:
        self.pending_config_change = False
        if rid == self.replica_id and not self.is_witness():
            raise AssertionError("adding self as witness while not witness")
        if rid in self.witnesses:
            return
        if rid in self.remotes or rid in self.non_votings:
            raise AssertionError("converting member to witness")
        self.witnesses[rid] = Remote(match=0, next=self.log.last_index() + 1)

    def remove_node(self, rid: int) -> None:
        self.pending_config_change = False
        self.remotes.pop(rid, None)
        self.non_votings.pop(rid, None)
        self.witnesses.pop(rid, None)
        if rid == self.replica_id and self.is_leader():
            self.become_follower(self.term, NO_LEADER)
        if self.leader_transfering() and self.leader_transfer_target == rid:
            self.abort_leader_transfer()
        if self.is_leader() and self.num_voting_members() > 0:
            if self.try_commit():
                self.broadcast_replicate_message()

    def restore_remotes(self, ss: pb.Snapshot) -> None:
        """Rebuild peer books from snapshot membership — raft.go restoreRemotes."""
        next_idx = self.log.last_index() + 1
        match_self = next_idx - 1
        self.remotes = {}
        for rid in ss.membership.addresses:
            if rid == self.replica_id and self.is_non_voting():
                # promoted by snapshot
                self.become_follower(self.term, self.leader_id)
            if rid in self.witnesses:
                raise AssertionError("witness promoted to full member")
            m = match_self if rid == self.replica_id else 0
            self.remotes[rid] = Remote(match=m, next=next_idx)
        if self.replica_id not in self.remotes and self.is_leader():
            self.become_follower(self.term, NO_LEADER)
        self.non_votings = {}
        for rid in ss.membership.non_votings:
            m = match_self if rid == self.replica_id else 0
            self.non_votings[rid] = Remote(match=m, next=next_idx)
        self.witnesses = {}
        for rid in ss.membership.witnesses:
            m = match_self if rid == self.replica_id else 0
            self.witnesses[rid] = Remote(match=m, next=next_idx)

    # ------------------------------------------------------------------
    # leader transfer helpers
    # ------------------------------------------------------------------

    def leader_transfering(self) -> bool:
        return self.leader_transfer_target != NO_NODE and self.is_leader()

    def abort_leader_transfer(self) -> None:
        self.leader_transfer_target = NO_NODE

    # ------------------------------------------------------------------
    # snapshot restore (follower side; parity raft.go:456-530 restore)
    # ------------------------------------------------------------------

    def restore(self, ss: pb.Snapshot) -> bool:
        if ss.index <= self.log.committed:
            return False
        if not self.is_non_voting():
            for rid in ss.membership.non_votings:
                if rid == self.replica_id:
                    raise AssertionError("voter demoted to nonVoting by snapshot")
        if not self.is_witness():
            for rid in ss.membership.witnesses:
                if rid == self.replica_id:
                    raise AssertionError("converted to witness by snapshot")
        if self.log.match_term(ss.index, ss.term):
            # local log already covers the snapshot: just fast-forward commit
            self.log.commit_to(ss.index)
            return False
        self.log.restore(ss)
        return True

    # ------------------------------------------------------------------
    # term-mismatch core rules (parity raft.go:1507-1595)
    # ------------------------------------------------------------------

    @staticmethod
    def _is_request_vote_message(t: pb.MessageType) -> bool:
        return t in (pb.MessageType.REQUEST_VOTE, pb.MessageType.REQUEST_PREVOTE)

    @staticmethod
    def _is_leader_message(t: pb.MessageType) -> bool:
        return t in (
            pb.MessageType.REPLICATE,
            pb.MessageType.INSTALL_SNAPSHOT,
            pb.MessageType.HEARTBEAT,
            pb.MessageType.TIMEOUT_NOW,
            pb.MessageType.READ_INDEX_RESP,
        )

    def drop_request_vote_from_high_term_node(self, m: pb.Message) -> bool:
        if not self._is_request_vote_message(m.type) or not self.check_quorum:
            return False
        if m.term <= self.term:
            return False
        # p42 of the raft thesis: leadership-transfer hint overrides the lease
        if m.hint == m.from_:
            return False
        # recently heard from a quorum-backed leader: protect the lease
        return self.leader_id != NO_LEADER and self.election_tick < self.election_timeout

    def on_message_term_not_matched(self, m: pb.Message) -> bool:
        if m.term == 0 or m.term == self.term:
            return False
        if self.drop_request_vote_from_high_term_node(m):
            return True
        if m.term > self.term:
            is_prevote_expected = m.type == pb.MessageType.REQUEST_PREVOTE or (
                m.type == pb.MessageType.REQUEST_PREVOTE_RESP and not m.reject
            )
            if not is_prevote_expected:
                leader_id = NO_LEADER
                if self._is_leader_message(m.type):
                    leader_id = m.from_
                if self.is_non_voting():
                    self.become_non_voting(m.term, leader_id)
                elif self.is_witness():
                    self.become_witness(m.term, leader_id)
                else:
                    # RequestVote keeps the election tick (KE) so slow nodes
                    # can still campaign later (raft.go:1566-1580)
                    keep = m.type == pb.MessageType.REQUEST_VOTE
                    self.become_follower(m.term, leader_id,
                                         reset_election_timeout=not keep)
            return False
        # m.term < self.term
        if m.type == pb.MessageType.REQUEST_PREVOTE or (
            self._is_leader_message(m.type) and (self.check_quorum or self.pre_vote)
        ):
            # see TestFreeStuckCandidateWithCheckQuorum
            self.send(pb.Message(to=m.from_, type=pb.MessageType.NOOP))
        return True

    # ------------------------------------------------------------------
    # shared handlers (parity raft.go:1398-1490 + 1632-1780)
    # ------------------------------------------------------------------

    def handle_heartbeat_message(self, m: pb.Message) -> None:
        self.log.commit_to(m.commit)
        self.send(
            pb.Message(
                to=m.from_,
                type=pb.MessageType.HEARTBEAT_RESP,
                hint=m.hint,
                hint_high=m.hint_high,
            )
        )

    def handle_install_snapshot_message(self, m: pb.Message) -> None:
        resp = pb.Message(to=m.from_, type=pb.MessageType.REPLICATE_RESP)
        if self.restore(m.snapshot):
            resp = replace(resp, log_index=self.log.last_index())
            self.restore_remotes(m.snapshot)
        else:
            resp = replace(resp, log_index=self.log.committed)
        self.send(resp)

    def handle_replicate_message(self, m: pb.Message) -> None:
        resp = pb.Message(to=m.from_, type=pb.MessageType.REPLICATE_RESP)
        if m.log_index < self.log.committed:
            self.send(replace(resp, log_index=self.log.committed))
            return
        if self.log.match_term(m.log_index, m.log_term):
            self.log.try_append(m.log_index, m.entries)
            last_idx = m.log_index + len(m.entries)
            self.log.commit_to(min(last_idx, m.commit))
            self.send(replace(resp, log_index=last_idx))
        else:
            self.send(
                replace(
                    resp,
                    reject=True,
                    log_index=m.log_index,
                    hint=self.log.last_index(),
                )
            )

    def has_config_change_to_apply(self) -> bool:
        if self.has_not_applied_config_change is not None:
            return self.has_not_applied_config_change()
        # conservative: any committed-but-unapplied entry blocks campaigns
        # (raft.go:1611-1622)
        return self.log.committed > self.applied

    def can_grant_vote(self, m: pb.Message) -> bool:
        return self.vote in (NO_NODE, m.from_) or m.term > self.term

    def handle_node_election(self, m: pb.Message) -> None:
        if self.is_leader():
            return
        if self.has_config_change_to_apply():
            return
        if self.pre_vote and not self.is_leader_transfer_target:
            self.pre_vote_campaign()
        else:
            self.campaign()

    def handle_node_request_pre_vote(self, m: pb.Message) -> None:
        resp = pb.Message(to=m.from_, type=pb.MessageType.REQUEST_PREVOTE_RESP)
        up_to_date = self.log.up_to_date(m.log_index, m.log_term)
        assert m.term >= self.term
        if m.term > self.term and up_to_date:
            resp = replace(resp, term=m.term)
        else:
            resp = replace(resp, term=self.term, reject=True)
        self.send(resp)

    def handle_node_request_vote(self, m: pb.Message) -> None:
        resp = pb.Message(to=m.from_, type=pb.MessageType.REQUEST_VOTE_RESP)
        can_grant = self.can_grant_vote(m)
        up_to_date = self.log.up_to_date(m.log_index, m.log_term)
        if can_grant and up_to_date:
            self.election_tick = 0
            self.vote = m.from_
        else:
            resp = replace(resp, reject=True)
        self.send(resp)

    def handle_node_config_change(self, m: pb.Message) -> None:
        if m.reject:
            self.pending_config_change = False
            return
        cctype = pb.ConfigChangeType(m.hint_high)
        rid = m.hint
        if cctype == pb.ConfigChangeType.ADD_NODE:
            self.add_node(rid)
        elif cctype == pb.ConfigChangeType.REMOVE_NODE:
            self.remove_node(rid)
        elif cctype == pb.ConfigChangeType.ADD_NON_VOTING:
            self.add_non_voting(rid)
        elif cctype == pb.ConfigChangeType.ADD_WITNESS:
            self.add_witness(rid)
        else:
            raise AssertionError("unexpected config change type")

    def handle_log_query(self, m: pb.Message) -> None:
        if self.log_query_result is not None:
            raise AssertionError("log query result not consumed")
        error = 0
        entries: tuple[pb.Entry, ...] = ()
        try:
            entries = tuple(self.log.get_committed_entries(m.from_, m.to, m.hint))
        except CompactedError:
            error = 1
        self.log_query_result = pb.LogQueryResult(
            error=error,
            first_index=self.log.first_index(),
            last_index=self.log.committed + 1,
            entries=entries,
        )

    def handle_local_tick(self, m: pb.Message) -> None:
        if m.reject:
            self.quiesced_tick()
        else:
            self.tick()

    def handle_restore_remote(self, m: pb.Message) -> None:
        self.restore_remotes(m.snapshot)

    # ------------------------------------------------------------------
    # leader handlers (parity raft.go:1780-2050)
    # ------------------------------------------------------------------

    def handle_leader_heartbeat(self, m: pb.Message) -> None:
        self.broadcast_heartbeat_message()

    def handle_leader_check_quorum(self, m: pb.Message) -> None:
        assert self.is_leader()
        if not self.leader_has_quorum():
            self.become_follower(self.term, NO_LEADER)

    def handle_leader_propose(self, m: pb.Message) -> None:
        assert self.is_leader()
        if self.leader_transfering():
            self.report_dropped_proposal(m)
            return
        entries = list(m.entries)
        for i, e in enumerate(entries):
            if e.type == pb.EntryType.CONFIG_CHANGE:
                if self.pending_config_change:
                    self.report_dropped_config_change(e)
                    entries[i] = pb.Entry(type=pb.EntryType.APPLICATION)
                else:
                    self.pending_config_change = True
        self.append_entries(entries)
        self.broadcast_replicate_message()

    def has_committed_entry_at_current_term(self) -> bool:
        assert self.term > 0
        try:
            return self.log.term(self.log.committed) == self.term
        except CompactedError:
            return False

    def add_ready_to_read(self, index: int, ctx: pb.SystemCtx) -> None:
        self.ready_to_read.append(pb.ReadyToRead(index=index, system_ctx=ctx))

    def handle_leader_read_index(self, m: pb.Message) -> None:
        """Section 6.4 of the raft thesis."""
        assert self.is_leader()
        ctx = pb.SystemCtx(low=m.hint, high=m.hint_high)
        if m.from_ in self.witnesses:
            return  # witnesses cannot read
        if not self.is_single_node_quorum():
            if not self.has_committed_entry_at_current_term():
                self.report_dropped_read_index(m)
                return
            self.read_index.add_request(self.log.committed, ctx, m.from_)
            self.broadcast_heartbeat_with_hint(ctx)
        else:
            self.add_ready_to_read(self.log.committed, ctx)
            if m.from_ != self.replica_id and m.from_ in self.non_votings:
                self.send(
                    pb.Message(
                        to=m.from_,
                        type=pb.MessageType.READ_INDEX_RESP,
                        log_index=self.log.committed,
                        hint=m.hint,
                        hint_high=m.hint_high,
                        commit=m.commit,
                    )
                )

    def handle_leader_replicate_resp(self, m: pb.Message, rp: Remote) -> None:
        assert self.is_leader()
        rp.active = True
        if not m.reject:
            paused = rp.is_paused()
            if rp.try_update(m.log_index):
                rp.responded_to()
                if self.try_commit():
                    self.broadcast_replicate_message()
                elif paused:
                    self.send_replicate_message(m.from_)
                # leadership transfer protocol, p29 of the raft thesis
                if (
                    self.leader_transfering()
                    and m.from_ == self.leader_transfer_target
                    and self.log.last_index() == rp.match
                ):
                    self.send_timeout_now_message(self.leader_transfer_target)
        else:
            if rp.decrease_to(m.log_index, m.hint):
                if rp.state == RemoteState.REPLICATE:
                    rp.become_retry()
                self.send_replicate_message(m.from_)

    def handle_leader_heartbeat_resp(self, m: pb.Message, rp: Remote) -> None:
        assert self.is_leader()
        rp.active = True
        rp.wait_to_retry()
        if rp.match < self.log.last_index():
            self.send_replicate_message(m.from_)
        if m.hint != 0:
            self.handle_read_index_leader_confirmation(m)

    def handle_leader_transfer(self, m: pb.Message) -> None:
        assert self.is_leader()
        target = m.hint
        assert target != NO_NODE
        if self.leader_transfering():
            return
        if self.replica_id == target:
            return
        rp = self.remotes.get(target)
        if rp is None:
            return
        self.leader_transfer_target = target
        self.election_tick = 0
        if rp.match == self.log.last_index():
            self.send_timeout_now_message(target)

    def handle_read_index_leader_confirmation(self, m: pb.Message) -> None:
        ctx = pb.SystemCtx(low=m.hint, high=m.hint_high)
        for s in self.read_index.confirm(ctx, m.from_, self.quorum()):
            if s.from_ in (NO_NODE, self.replica_id):
                self.add_ready_to_read(s.index, s.ctx)
            else:
                self.send(
                    pb.Message(
                        to=s.from_,
                        type=pb.MessageType.READ_INDEX_RESP,
                        log_index=s.index,
                        hint=m.hint,
                        hint_high=m.hint_high,
                    )
                )

    def handle_leader_snapshot_status(self, m: pb.Message, rp: Remote) -> None:
        if rp.state != RemoteState.SNAPSHOT:
            return
        if m.hint == 0:
            if m.reject:
                rp.clear_pending_snapshot()
            rp.become_wait()
        else:
            rp.set_snapshot_ack(m.hint, m.reject)
            self.snapshotting = True

    def handle_leader_unreachable(self, m: pb.Message, rp: Remote) -> None:
        if rp.state == RemoteState.REPLICATE:
            rp.become_retry()

    def handle_leader_rate_limit(self, m: pb.Message) -> None:
        pass  # host-side rate limiter consumes these; kernel ignores

    def check_pending_snapshot_ack(self) -> None:
        if self.is_leader() and self.snapshotting:
            self.snapshotting = False
            for group in (self.remotes, self.non_votings, self.witnesses):
                for from_, rp in group.items():
                    if rp.state == RemoteState.SNAPSHOT:
                        if rp.ack_tick():
                            rejected = rp.delayed_ack_rejected
                            rp.clear_snapshot_ack()
                            self.handle(
                                pb.Message(
                                    type=pb.MessageType.SNAPSHOT_STATUS,
                                    from_=from_,
                                    reject=rejected,
                                    hint=0,
                                )
                            )
                        elif rp.delayed_ack_tick > 0:
                            self.snapshotting = True

    # ------------------------------------------------------------------
    # follower handlers (parity raft.go:2100-2200)
    # ------------------------------------------------------------------

    def handle_follower_propose(self, m: pb.Message) -> None:
        if self.leader_id == NO_LEADER:
            self.report_dropped_proposal(m)
            return
        self.send(replace(m, to=self.leader_id))

    def leader_is_available(self) -> None:
        self.election_tick = 0

    def handle_follower_replicate(self, m: pb.Message) -> None:
        self.leader_is_available()
        self.set_leader_id(m.from_)
        self.handle_replicate_message(m)

    def handle_follower_heartbeat(self, m: pb.Message) -> None:
        self.leader_is_available()
        self.set_leader_id(m.from_)
        self.handle_heartbeat_message(m)

    def handle_follower_read_index(self, m: pb.Message) -> None:
        if self.leader_id == NO_LEADER:
            self.report_dropped_read_index(m)
            return
        self.send(replace(m, to=self.leader_id))

    def handle_follower_leader_transfer(self, m: pb.Message) -> None:
        if self.leader_id == NO_LEADER:
            return
        self.send(replace(m, to=self.leader_id))

    def handle_follower_read_index_resp(self, m: pb.Message) -> None:
        ctx = pb.SystemCtx(low=m.hint, high=m.hint_high)
        self.leader_is_available()
        self.set_leader_id(m.from_)
        self.add_ready_to_read(m.log_index, ctx)

    def handle_follower_install_snapshot(self, m: pb.Message) -> None:
        self.leader_is_available()
        self.set_leader_id(m.from_)
        self.handle_install_snapshot_message(m)

    def handle_follower_timeout_now(self, m: pb.Message) -> None:
        # p29 of the raft thesis: same as the clock moving forward quickly
        self.election_tick = self.randomized_election_timeout
        self.is_leader_transfer_target = True
        self.tick()
        self.is_leader_transfer_target = False

    # ------------------------------------------------------------------
    # candidate handlers (parity raft.go:2205-2300)
    # ------------------------------------------------------------------

    def handle_candidate_propose(self, m: pb.Message) -> None:
        self.report_dropped_proposal(m)

    def handle_candidate_read_index(self, m: pb.Message) -> None:
        self.report_dropped_read_index(m)

    def handle_candidate_replicate(self, m: pb.Message) -> None:
        # m.term == self.term implies a leader exists for this term
        self.become_follower(self.term, m.from_)
        self.handle_replicate_message(m)

    def handle_candidate_install_snapshot(self, m: pb.Message) -> None:
        self.become_follower(self.term, m.from_)
        self.handle_install_snapshot_message(m)

    def handle_candidate_heartbeat(self, m: pb.Message) -> None:
        self.become_follower(self.term, m.from_)
        self.handle_heartbeat_message(m)

    def handle_candidate_request_vote_resp(self, m: pb.Message) -> None:
        if m.from_ in self.non_votings:
            return
        count = self.handle_vote_resp(m.from_, m.reject, False)
        if count == self.quorum():
            self.become_leader()
            self.broadcast_replicate_message()
        elif len(self.votes) - count == self.quorum():
            # etcd-raft behavior: majority rejection -> step down
            self.become_follower(self.term, NO_LEADER)

    def handle_pre_vote_candidate_request_pre_vote_resp(self, m: pb.Message) -> None:
        if m.from_ in self.non_votings:
            return
        count = self.handle_vote_resp(m.from_, m.reject, True)
        if count == self.quorum():
            self.campaign()
        elif len(self.votes) - count == self.quorum():
            self.become_follower(self.term, NO_LEADER)

    # ------------------------------------------------------------------
    # dropped-op reporting
    # ------------------------------------------------------------------

    def report_dropped_config_change(self, e: pb.Entry) -> None:
        self.dropped_entries.append(e)

    def report_dropped_proposal(self, m: pb.Message) -> None:
        self.dropped_entries.extend(m.entries)

    def report_dropped_read_index(self, m: pb.Message) -> None:
        self.dropped_read_indexes.append(
            pb.SystemCtx(low=m.hint, high=m.hint_high)
        )

    # ------------------------------------------------------------------
    # dispatch (parity raft.go:1596 Handle, 2332 initializeHandlerMap)
    # ------------------------------------------------------------------

    def handle(self, m: pb.Message) -> None:
        if not self.pre_vote and m.type in (
            pb.MessageType.REQUEST_PREVOTE,
            pb.MessageType.REQUEST_PREVOTE_RESP,
        ):
            raise AssertionError("preVote message while preVote disabled")
        if self.on_message_term_not_matched(m):
            return
        handler = _HANDLERS[self.state].get(m.type)
        if handler is not None:
            handler(self, m)

    def _with_remote(f):  # type: ignore[no-untyped-def]
        def wrapped(self: "Raft", m: pb.Message) -> None:
            rp = self.get_remote(m.from_)
            if rp is None:
                return
            f(self, m, rp)

        return wrapped

    _h_leader_replicate_resp = _with_remote(handle_leader_replicate_resp)
    _h_leader_heartbeat_resp = _with_remote(handle_leader_heartbeat_resp)
    _h_leader_snapshot_status = _with_remote(handle_leader_snapshot_status)
    _h_leader_unreachable = _with_remote(handle_leader_unreachable)


_MT = pb.MessageType

# The static [state][msgtype] dispatch matrix — parity raft.go:2332-2420.
_HANDLERS: dict[RaftState, dict[pb.MessageType, Callable[[Raft, pb.Message], None]]] = {
    RaftState.CANDIDATE: {
        _MT.HEARTBEAT: Raft.handle_candidate_heartbeat,
        _MT.PROPOSE: Raft.handle_candidate_propose,
        _MT.READ_INDEX: Raft.handle_candidate_read_index,
        _MT.REPLICATE: Raft.handle_candidate_replicate,
        _MT.INSTALL_SNAPSHOT: Raft.handle_candidate_install_snapshot,
        _MT.REQUEST_VOTE_RESP: Raft.handle_candidate_request_vote_resp,
        _MT.ELECTION: Raft.handle_node_election,
        _MT.REQUEST_VOTE: Raft.handle_node_request_vote,
        _MT.REQUEST_PREVOTE: Raft.handle_node_request_pre_vote,
        _MT.CONFIG_CHANGE_EVENT: Raft.handle_node_config_change,
        _MT.LOCAL_TICK: Raft.handle_local_tick,
        _MT.SNAPSHOT_RECEIVED: Raft.handle_restore_remote,
        _MT.LOG_QUERY: Raft.handle_log_query,
    },
    RaftState.PRE_VOTE_CANDIDATE: {
        _MT.HEARTBEAT: Raft.handle_candidate_heartbeat,
        _MT.PROPOSE: Raft.handle_candidate_propose,
        _MT.READ_INDEX: Raft.handle_candidate_read_index,
        _MT.REPLICATE: Raft.handle_candidate_replicate,
        _MT.INSTALL_SNAPSHOT: Raft.handle_candidate_install_snapshot,
        _MT.REQUEST_PREVOTE_RESP: Raft.handle_pre_vote_candidate_request_pre_vote_resp,
        _MT.ELECTION: Raft.handle_node_election,
        _MT.REQUEST_VOTE: Raft.handle_node_request_vote,
        _MT.REQUEST_PREVOTE: Raft.handle_node_request_pre_vote,
        _MT.CONFIG_CHANGE_EVENT: Raft.handle_node_config_change,
        _MT.LOCAL_TICK: Raft.handle_local_tick,
        _MT.SNAPSHOT_RECEIVED: Raft.handle_restore_remote,
        _MT.LOG_QUERY: Raft.handle_log_query,
    },
    RaftState.FOLLOWER: {
        _MT.PROPOSE: Raft.handle_follower_propose,
        _MT.REPLICATE: Raft.handle_follower_replicate,
        _MT.HEARTBEAT: Raft.handle_follower_heartbeat,
        _MT.READ_INDEX: Raft.handle_follower_read_index,
        _MT.LEADER_TRANSFER: Raft.handle_follower_leader_transfer,
        _MT.READ_INDEX_RESP: Raft.handle_follower_read_index_resp,
        _MT.INSTALL_SNAPSHOT: Raft.handle_follower_install_snapshot,
        _MT.ELECTION: Raft.handle_node_election,
        _MT.REQUEST_VOTE: Raft.handle_node_request_vote,
        _MT.REQUEST_PREVOTE: Raft.handle_node_request_pre_vote,
        _MT.TIMEOUT_NOW: Raft.handle_follower_timeout_now,
        _MT.CONFIG_CHANGE_EVENT: Raft.handle_node_config_change,
        _MT.LOCAL_TICK: Raft.handle_local_tick,
        _MT.SNAPSHOT_RECEIVED: Raft.handle_restore_remote,
        _MT.LOG_QUERY: Raft.handle_log_query,
    },
    RaftState.LEADER: {
        _MT.LEADER_HEARTBEAT: Raft.handle_leader_heartbeat,
        _MT.CHECK_QUORUM: Raft.handle_leader_check_quorum,
        _MT.PROPOSE: Raft.handle_leader_propose,
        _MT.READ_INDEX: Raft.handle_leader_read_index,
        _MT.REPLICATE_RESP: Raft._h_leader_replicate_resp,
        _MT.HEARTBEAT_RESP: Raft._h_leader_heartbeat_resp,
        _MT.SNAPSHOT_STATUS: Raft._h_leader_snapshot_status,
        _MT.UNREACHABLE: Raft._h_leader_unreachable,
        _MT.LEADER_TRANSFER: Raft.handle_leader_transfer,
        _MT.ELECTION: Raft.handle_node_election,
        _MT.REQUEST_VOTE: Raft.handle_node_request_vote,
        _MT.REQUEST_PREVOTE: Raft.handle_node_request_pre_vote,
        _MT.CONFIG_CHANGE_EVENT: Raft.handle_node_config_change,
        _MT.LOCAL_TICK: Raft.handle_local_tick,
        _MT.SNAPSHOT_RECEIVED: Raft.handle_restore_remote,
        _MT.RATE_LIMIT: Raft.handle_leader_rate_limit,
        _MT.LOG_QUERY: Raft.handle_log_query,
    },
    RaftState.NON_VOTING: {
        _MT.HEARTBEAT: Raft.handle_follower_heartbeat,
        _MT.REPLICATE: Raft.handle_follower_replicate,
        _MT.INSTALL_SNAPSHOT: Raft.handle_follower_install_snapshot,
        _MT.REQUEST_VOTE: Raft.handle_node_request_vote,
        _MT.REQUEST_PREVOTE: Raft.handle_node_request_pre_vote,
        _MT.PROPOSE: Raft.handle_follower_propose,
        _MT.READ_INDEX: Raft.handle_follower_read_index,
        _MT.READ_INDEX_RESP: Raft.handle_follower_read_index_resp,
        _MT.CONFIG_CHANGE_EVENT: Raft.handle_node_config_change,
        _MT.LOCAL_TICK: Raft.handle_local_tick,
        _MT.SNAPSHOT_RECEIVED: Raft.handle_restore_remote,
        _MT.LOG_QUERY: Raft.handle_log_query,
    },
    RaftState.WITNESS: {
        _MT.HEARTBEAT: Raft.handle_follower_heartbeat,
        _MT.REPLICATE: Raft.handle_follower_replicate,
        _MT.INSTALL_SNAPSHOT: Raft.handle_follower_install_snapshot,
        _MT.REQUEST_VOTE: Raft.handle_node_request_vote,
        _MT.REQUEST_PREVOTE: Raft.handle_node_request_pre_vote,
        _MT.CONFIG_CHANGE_EVENT: Raft.handle_node_config_change,
        _MT.LOCAL_TICK: Raft.handle_local_tick,
        _MT.SNAPSHOT_RECEIVED: Raft.handle_restore_remote,
    },
}
