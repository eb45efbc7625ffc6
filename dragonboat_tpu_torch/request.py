"""Request futures + pending-operation books.

Parity with the reference's ``request.go``: every async op returns a
RequestState whose completion fires when the op commits/applies
(RequestState :294, pendingProposal :524, pendingReadIndex :535,
pendingConfigChange :549, pendingSnapshot :557, pendingLeaderTransfer :564),
with tick-driven timeout GC (logicalClock :236).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from enum import IntEnum

from dragonboat_tpu_torch import lifecycle
from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.statemachine import Result


class RequestResultCode(IntEnum):
    """Parity request.go:116 (RequestResult codes)."""

    TIMEOUT = 0
    COMPLETED = 1
    TERMINATED = 2
    REJECTED = 3
    DROPPED = 4
    ABORTED = 5
    COMMITTED = 6


class RequestError(Exception):
    pass


class RequestTimeoutError(RequestError):
    pass


class RequestRejectedError(RequestError):
    pass


class RequestDroppedError(RequestError):
    """No leader / busy — retry later (ErrShardNotReady analog)."""


class RequestTerminatedError(RequestError):
    pass


@dataclass
class RequestResult:
    code: RequestResultCode = RequestResultCode.TIMEOUT
    result: Result = field(default_factory=Result)
    snapshot_index: int = 0

    def completed(self) -> bool:
        return self.code == RequestResultCode.COMPLETED


class RequestState:
    """A completion future (request.go:294)."""

    def __init__(self, key: int = 0, deadline_tick: int = 0) -> None:
        self.key = key
        self.deadline_tick = deadline_tick
        self._event = threading.Event()
        self.result = RequestResult()
        self.committed_event = threading.Event()

    def notify(self, result: RequestResult) -> None:
        self.result = result
        self._event.set()

    def notify_committed(self) -> None:
        self.committed_event.set()

    def wait(self, timeout_s: float | None = None) -> RequestResult:
        if not self._event.wait(timeout_s):
            return RequestResult(code=RequestResultCode.TIMEOUT)
        return self.result

    def get(self, timeout_s: float | None = None) -> Result:
        """Blocking result with error mapping (SyncPropose semantics)."""
        r = self.wait(timeout_s)
        if r.code == RequestResultCode.COMPLETED:
            return r.result
        if r.code == RequestResultCode.TIMEOUT:
            raise RequestTimeoutError("request timed out")
        if r.code == RequestResultCode.REJECTED:
            raise RequestRejectedError("request rejected")
        if r.code == RequestResultCode.DROPPED:
            raise RequestDroppedError("request dropped, shard not ready")
        if r.code == RequestResultCode.TERMINATED:
            raise RequestTerminatedError("shard terminated")
        raise RequestError(f"request failed: {r.code}")


class LogicalClock:
    """One absolute tick counter shared by every request book of a host
    (request.go:236 logicalClock).  The host ticker advances it ONCE per
    tick round; books stamp deadlines against it and compare absolutely
    — the per-book per-lane ``advance()`` walk this replaces was the
    dominant cost of the 100k-lane election pump (~25 s/tick-round of
    pure Python increments, PERF.md)."""

    __slots__ = ("tick",)

    def __init__(self) -> None:
        self.tick = 0

    def advance(self) -> None:
        self.tick += 1


class _ClockedBook:
    """Timeout machinery against a (possibly shared) LogicalClock."""

    def __init__(self, clock: LogicalClock | None = None) -> None:
        self.mu = threading.Lock()
        self.clock = clock if clock is not None else LogicalClock()

    @property
    def tick(self) -> int:
        return self.clock.tick

    def advance(self) -> None:
        """Standalone-book compatibility (tests construct books without
        a host); hosts advance the SHARED clock once per round instead."""
        self.clock.advance()


class PendingProposal(_ClockedBook):
    """Proposal completion book keyed by entry Key (request.go:524/1016).

    Sharded by ``key % shards`` the way the reference splits its book
    into keyed shards (request.go:524 pendingProposal holds N
    proposalShards) so concurrent client threads completing/registering
    different keys never serialize on one lock — the engine's apply
    path touches a different shard than the ingress path almost always.
    The logical clock stays book-wide (ticks are engine-driven).

    Lifecycle tracing: entry keys come off the CLASS-level ``_seq``, so
    they are process-unique — the 1-in-N span sampling in lifecycle.py
    keys off them directly.  Every verb that removes a key from this
    book ends its span: ``applied`` finishes it (the ack), while
    ``dropped``/``gc``/``terminate_all`` scrub it — including the
    engine's in-flight-removal paths, which all funnel through
    ``dropped`` — so the span registry can never outlive the book."""

    _seq = itertools.count(1)

    def __init__(self, shards: int = 8,
                 clock: LogicalClock | None = None,
                 shard_id: int = 0) -> None:
        super().__init__(clock)
        self._shards: list[dict[int, RequestState]] = [   # guarded-by: _locks
            {} for _ in range(shards)]
        self._locks = [threading.Lock() for _ in range(shards)]
        self._n = shards                                  # guarded-by: <init-only>
        # raft shard id this book serves (Chrome-trace pid grouping)
        self.shard_id = shard_id                          # guarded-by: <init-only>

    @property
    def pending(self) -> dict[int, RequestState]:
        """Merged read-only view (tests/diagnostics)."""
        out: dict[int, RequestState] = {}
        for d in self._shards:
            out.update(d)
        return out

    def propose(self, session, cmd: bytes, timeout_ticks: int
                ) -> tuple[RequestState, pb.Entry]:
        key = next(self._seq)
        entry = pb.Entry(
            key=key,
            client_id=session.client_id,
            series_id=session.series_id,
            responded_to=session.responded_to,
            cmd=cmd,
        )
        rs = RequestState(key=key, deadline_tick=self.tick + timeout_ticks)
        i = key % self._n
        with self._locks[i]:
            self._shards[i][key] = rs
        lifecycle.TRACER.begin(key, self.shard_id)
        return rs, entry

    def applied(self, key: int, client_id: int, series_id: int,
                result: Result, rejected: bool) -> None:
        i = key % self._n
        with self._locks[i]:
            rs = self._shards[i].pop(key, None)
        if rs is not None:
            code = (RequestResultCode.REJECTED if rejected
                    else RequestResultCode.COMPLETED)
            rs.notify(RequestResult(code=code, result=result))
            lifecycle.TRACER.finish(key)

    def committed(self, key: int) -> None:
        i = key % self._n
        with self._locks[i]:
            rs = self._shards[i].get(key)
        if rs is not None:
            rs.notify_committed()

    def dropped(self, key: int) -> None:
        i = key % self._n
        with self._locks[i]:
            rs = self._shards[i].pop(key, None)
        if rs is not None:
            rs.notify(RequestResult(code=RequestResultCode.DROPPED))
            lifecycle.TRACER.scrub(key)

    def gc(self) -> None:
        # unlocked emptiness fast path: the amortized host sweep calls
        # gc on EVERY lane's books; an entry racing in is caught by the
        # next sweep (timeouts are tick-granular anyway)
        if not any(self._shards):
            return
        for i in range(self._n):
            with self._locks[i]:
                d = self._shards[i]
                expired = [k for k, rs in d.items()
                           if rs.deadline_tick <= self.tick]
                fired = [d.pop(k) for k in expired]
            for k, rs in zip(expired, fired):
                rs.notify(RequestResult(code=RequestResultCode.TIMEOUT))
                lifecycle.TRACER.scrub(k)

    def terminate_all(self) -> None:
        for i in range(self._n):
            with self._locks[i]:
                fired = list(self._shards[i].items())
                self._shards[i].clear()
            for k, rs in fired:
                rs.notify(RequestResult(code=RequestResultCode.TERMINATED))
                lifecycle.TRACER.scrub(k)


class PendingReadIndex(_ClockedBook):
    """ReadIndex completion book (request.go:535): batches reads under a
    SystemCtx, fires when appliedIndex passes the read index (:930).

    Lifecycle tracing (ROADMAP item 3's attribution prerequisite): read
    keys come off ``PendingProposal._seq`` — the SAME process-unique
    counter as entry keys, so sampling stays 1-in-N over all traced
    operations and a read key can never collide with a proposal span.
    ``read`` opens the span (``read_propose``), ``add_ready`` stamps the
    confirmed quorum round (``read_quorum``), ``applied`` finishes it at
    serve time (``read_serve``); every removal verb scrubs."""

    _ctx = itertools.count(1)

    def __init__(self, clock: LogicalClock | None = None,
                 shard_id: int = 0) -> None:
        super().__init__(clock)
        self.pending: dict[int, list[RequestState]] = {}   # guarded-by: mu — ctx_low -> readers
        self.batching: list[RequestState] = []             # guarded-by: mu
        self.ready: dict[int, int] = {}                    # guarded-by: mu — ctx_low -> index
        self.waiting: list[tuple[int, RequestState]] = []  # guarded-by: mu — (index, rs)
        # raft shard id this book serves (Chrome-trace pid grouping)
        self.shard_id = shard_id                           # guarded-by: <init-only>

    def read(self, timeout_ticks: int) -> RequestState:
        key = next(PendingProposal._seq)
        rs = RequestState(key=key, deadline_tick=self.tick + timeout_ticks)
        with self.mu:
            self.batching.append(rs)
        lifecycle.TRACER.begin_read(key, self.shard_id)
        return rs

    def peep(self) -> pb.SystemCtx | None:
        """Take the current batch under a fresh ctx (nextCtx/peepNextCtx)."""
        with self.mu:
            if not self.batching:
                return None
            ctx = pb.SystemCtx(low=next(self._ctx), high=1)
            self.pending[ctx.low] = self.batching
            self.batching = []
            return ctx

    def add_ready(self, ctx: pb.SystemCtx, index: int) -> None:
        with self.mu:
            readers = self.pending.pop(ctx.low, None)
            if readers is None:
                return
            self.waiting.extend((index, rs) for rs in readers)
        for rs in readers:
            lifecycle.TRACER.stamp(rs.key, lifecycle.STAGE_READ_QUORUM)

    def applied(self, applied_index: int) -> None:
        """Fire every waiting read whose index has been applied."""
        with self.mu:
            still = []
            fire = []
            for index, rs in self.waiting:
                if applied_index >= index:
                    fire.append(rs)
                else:
                    still.append((index, rs))
            self.waiting = still
        for rs in fire:
            rs.notify(RequestResult(code=RequestResultCode.COMPLETED))
            lifecycle.TRACER.finish(rs.key)

    def dropped(self, ctx: pb.SystemCtx) -> None:
        with self.mu:
            readers = self.pending.pop(ctx.low, None)
        for rs in readers or ():
            rs.notify(RequestResult(code=RequestResultCode.DROPPED))
            lifecycle.TRACER.scrub(rs.key)

    def gc(self) -> None:
        # unlocked fast path (racy-but-benign: a concurrent add is
        # caught by the next sweep)
        if not (self.batching or self.waiting or self.pending):
            return
        with self.mu:
            def expire(lst):
                live, dead = [], []
                for item in lst:
                    rs = item[1] if isinstance(item, tuple) else item
                    (dead if rs.deadline_tick <= self.tick else live).append(item)
                return live, dead

            self.batching, dead1 = expire(self.batching)
            self.waiting, dead2 = expire(self.waiting)
            # readers parked under an in-flight ctx (peep() issued, the
            # quorum round lost to a leader change that never reported
            # the ctx back) must still time out — request.go's
            # pendingReadIndex gc scans its pending batches the same way
            dead3 = []
            for ctx_low, readers in list(self.pending.items()):
                live = [rs for rs in readers
                        if rs.deadline_tick > self.tick]
                dead3 += [rs for rs in readers
                          if rs.deadline_tick <= self.tick]
                if live:
                    self.pending[ctx_low] = live
                else:
                    del self.pending[ctx_low]
        for item in dead1 + dead2:
            rs = item[1] if isinstance(item, tuple) else item
            rs.notify(RequestResult(code=RequestResultCode.TIMEOUT))
            lifecycle.TRACER.scrub(rs.key)
        for rs in dead3:
            rs.notify(RequestResult(code=RequestResultCode.TIMEOUT))
            lifecycle.TRACER.scrub(rs.key)

    def terminate_all(self) -> None:
        with self.mu:
            all_rs = list(self.batching)
            all_rs += [rs for readers in self.pending.values() for rs in readers]
            all_rs += [rs for _, rs in self.waiting]
            self.batching, self.pending, self.waiting = [], {}, []
        for rs in all_rs:
            rs.notify(RequestResult(code=RequestResultCode.TERMINATED))
            lifecycle.TRACER.scrub(rs.key)


class PendingSingleton(_ClockedBook):
    """One-in-flight book for config change / snapshot / transfer
    (request.go:549-570)."""

    def __init__(self, clock: LogicalClock | None = None) -> None:
        super().__init__(clock)
        self.key_seq = itertools.count(1)
        self.outstanding: RequestState | None = None       # guarded-by: mu
        self.key = 0                                       # guarded-by: mu

    def request(self, timeout_ticks: int) -> tuple[RequestState, int]:
        with self.mu:
            if self.outstanding is not None:
                raise RequestError("another request is already outstanding")
            self.key = next(self.key_seq)
            rs = RequestState(key=self.key,
                              deadline_tick=self.tick + timeout_ticks)
            self.outstanding = rs
            return rs, self.key

    def done(self, key: int, code: RequestResultCode,
             result: Result = Result(), snapshot_index: int = 0) -> None:
        with self.mu:
            if self.outstanding is None or self.key != key:
                return
            rs, self.outstanding = self.outstanding, None
        rs.notify(RequestResult(code=code, result=result,
                                snapshot_index=snapshot_index))

    def gc(self) -> None:
        if self.outstanding is None:              # unlocked fast path
            return
        with self.mu:
            rs = self.outstanding
            if rs is not None and rs.deadline_tick <= self.tick:
                self.outstanding = None
            else:
                rs = None
        if rs is not None:
            rs.notify(RequestResult(code=RequestResultCode.TIMEOUT))

    def terminate_all(self) -> None:
        with self.mu:
            rs, self.outstanding = self.outstanding, None
        if rs is not None:
            rs.notify(RequestResult(code=RequestResultCode.TERMINATED))
