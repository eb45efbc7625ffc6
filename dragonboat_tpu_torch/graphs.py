"""Compiled entry points: the port's counterpart of ``jax.jit``.

``compiled(fn, static_argnums=..., donate_argnums=...)`` gives ``fn`` the
meaning the reference's decorator gives it.  On CUDA tensors the wrapper
keys a cache on the static arguments (hashable: ``KernelParams`` and the
cluster geometry are frozen dataclasses) and on every tensor leaf's shape,
dtype and device, plus whether the kernels take their plain arms.  For a
new key it runs ``fn`` once on static input buffers on a side stream (the
warm-up: the kernel library is built and loaded, first-launch setup runs),
then captures one ``torch.cuda.CUDAGraph`` of it.  Every call copies the
caller's tensors into the static inputs, skipping a leaf when the caller
passes back the graph's own buffer (how a loop and an engine do it), and
replays the graph.  On CPU tensors the wrapper calls ``fn`` eagerly.

Meaning of the results, as with ``jax.jit``:

- a non-donating entry returns fresh tensors (the graph's outputs cloned):
  a value returned by call N is unchanged after call N+1;
- a donating entry hands its donated arguments' buffers to the graph.  An
  output whose structure (tree shape, leaf shapes and dtypes) matches a
  donated argument is copied back into that argument's static buffers at
  the end of the graph, and those buffers are returned: a loop that
  passes the result back in pays no copy.  Outputs carrying donated
  arguments come in the arguments' order.  Every result of a donating
  call (the copied-back ones and the graph's other outputs) stays valid
  until the next call of the same entry: the caller keeps the
  reference's no-touch rule and reads only what the latest call
  returned.

Scalars that change from call to call are 0-d tensors among the inputs: a
Python number in a non-static position raises ``TypeError``, so no value
is baked into a graph unseen.

Launch counts (``kernels.launches``) and other per-call tallies
(``tally``) are recorded while a graph is captured, on a per-thread
record, and re-applied on every replay; the warm-up counts nowhere.  A
capture that fails raises; there is no fall-back to eager execution on the
card.  ``eager()`` runs the eager bodies on the card for the comparison
runs of ``chip_smoke.py``; nothing on the main path holds it.

Captures use ``capture_error_mode="thread_local"`` (engines on other
threads keep allocating and syncing while one captures) and are
serialized process-wide by one lock.  A sync inside the captured region
fails the capture; the process-wide sync debug mode is left alone here,
since setting it would fail other threads' legitimate syncs.

Memory: graphs share a ``Pool`` when they never run at the same time.  The
module-level entries share ``DEFAULT_POOL`` (one thread drives them);
``fork`` gives an engine its own cache and pool.  ``clear()`` drops every
module-level graph (and its buffers), as a caller does when it is done
with a cluster.

``stand_in()`` selects a CPU replayer for tests: capture runs ``fn`` once
on static buffers, a replay copies the inputs into them, runs ``fn`` and
copies the results into the same static output tensors.  It reproduces a
CUDA graph's buffer reuse and aliasing, so the CPU tests exercise the
copy-in, donation and output lifetimes that otherwise show only on the
card.  The main path never selects it.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref

import torch

_state = {"eager": False, "stand_in": False}
# thread-local: mode None (eager execution), "warmup" (tallies dropped),
# "capture" (tallies recorded into _tls.record)
_tls = threading.local()
# serializes every capture in the process
_capture_mu = threading.Lock()
# one capture stream per device (captures are serialized)
_side_streams: dict = {}
# the module-level entries (fork()s are owned by their engines)
_registry: "weakref.WeakSet[Compiled]" = weakref.WeakSet()


class Pool:
    """A graph memory pool shared by the graphs that name it.  Graphs in
    one pool must never run at the same time.  The allocator releases a
    pool with its last graph, so a pool whose graphs are all gone takes a
    new handle at its next capture."""

    def __init__(self) -> None:
        self._handle = None
        self._graphs: "weakref.WeakSet" = weakref.WeakSet()

    def handle(self):
        if self._handle is None or not self._graphs:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def add(self, graph) -> None:
        self._graphs.add(graph)


DEFAULT_POOL = Pool()


# -- modes -------------------------------------------------------------------


@contextlib.contextmanager
def eager():
    """Run every compiled entry's eager body on the card (the comparison
    runs of ``chip_smoke.py``); no graph is captured or replayed inside."""
    prev = _state["eager"]
    _state["eager"] = True
    try:
        yield
    finally:
        _state["eager"] = prev


@contextlib.contextmanager
def stand_in():
    """Route CPU calls through the CPU stand-in replayer (tests only)."""
    prev = _state["stand_in"]
    _state["stand_in"] = True
    try:
        yield
    finally:
        _state["stand_in"] = prev


def _mode():
    return getattr(_tls, "mode", None)


def capturing() -> bool:
    """True while this thread records a graph (its calls run once, at
    capture, and replay later)."""
    return _mode() == "capture"


def tally(fn) -> None:
    """Run ``fn()`` at each execution of the calling code: now when it runs
    eagerly, at every replay when it is being captured, never during a
    warm-up."""
    mode = _mode()
    if mode is None:
        fn()
    elif mode == "capture":
        _tls.record.callbacks.append(fn)


def launch_sink():
    """Where a kernel launch is counted: None to count it now, else a
    Counter of this thread's capture (or of a warm-up, dropped)."""
    mode = _mode()
    if mode is None:
        return None
    return _tls.record.launches


class _Record:
    __slots__ = ("launches", "callbacks")

    def __init__(self) -> None:
        self.launches: collections.Counter = collections.Counter()
        self.callbacks: list = []


@contextlib.contextmanager
def _in_mode(mode: str, record: _Record):
    prev = (_mode(), getattr(_tls, "record", None))
    _tls.mode, _tls.record = mode, record
    try:
        yield
    finally:
        _tls.mode, _tls.record = prev


# -- trees -------------------------------------------------------------------
# A tree is a tensor, None, a NamedTuple, a tuple or list, or a dict of
# trees; a treedef records the containers, a leaf list the tensors.


def _flatten(x, leaves: list):
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return "T"
    if x is None:
        return None
    if isinstance(x, (tuple, list)):  # NamedTuples too
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    raise TypeError(
        f"compiled entry argument of type {type(x).__name__}: pass a "
        "tensor (0-d for a scalar that changes per call) or mark it static")


def _unflatten(tdef, it):
    if tdef == "T":
        return next(it)
    if tdef is None:
        return None
    kind, kids = tdef
    if kind is dict:
        return {k: _unflatten(v, it) for k, v in kids}
    vals = [_unflatten(v, it) for v in kids]
    if hasattr(kind, "_fields"):
        return kind(*vals)
    return kind(vals)


def leaves_of(x) -> list:
    """The tensors of a tree, in order."""
    out: list = []
    _flatten(x, out)
    return out


def _copy_all(dsts: list, srcs: list) -> None:
    if dsts:
        torch._foreach_copy_(dsts, srcs)


def _clone_all(ts: list) -> list:
    out = [torch.empty_like(t) for t in ts]
    _copy_all(out, ts)
    return out


def _signature(tdef, leaves) -> tuple:
    return (tdef, tuple((tuple(t.shape), t.dtype) for t in leaves))


def _abandon(cg, dev, pool_handle, pool: Pool) -> None:
    """End a capture whose body raised: the stream leaves capture mode,
    the allocator stops recording into the pool, and the pool and the
    capture stream are replaced, so later captures start clean.  The
    body's error is the one reported."""
    with contextlib.suppress(Exception):
        cg.capture_end()
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if end is not None:
        with contextlib.suppress(Exception):
            end(dev.index, pool_handle)
    pool._handle = None
    _side_streams.pop(dev, None)


# -- the wrapper -------------------------------------------------------------


def _graph_path(leaves: list) -> bool:
    """True when a call on these leaves goes through a graph: CUDA
    tensors outside ``eager()``, or CPU tensors under ``stand_in()``."""
    if not leaves or _state["eager"]:
        return False
    dev = leaves[0].device
    if dev.type == "cuda":
        if any(t.device != dev for t in leaves):
            raise ValueError("compiled entry inputs on several devices: "
                             f"{sorted({str(t.device) for t in leaves})}")
        return True
    return dev.type == "cpu" and _state["stand_in"]


class _Graph:
    """One captured geometry: its static inputs, its results and what a
    replay re-applies."""

    def __init__(self) -> None:
        self.static_args: list = []     # per argument: its static tree
        self.in_leaves: list = []       # static input tensors, in order
        self.in_ids: set = set()
        self.out_leaves: list = []      # result tensors after a replay
        self.out_tdef = None
        self.record = _Record()
        self.cuda_graph = None          # torch.cuda.CUDAGraph on the card
        self.body = None                # the stand-in's re-run
        self.capture_s = 0.0            # host seconds of warm-up and capture


class Compiled:
    """``fn`` under graph capture; see the module docstring."""

    def __init__(self, fn, static_argnums=(), donate_argnums=(),
                 pool: Pool | None = None, register: bool = True) -> None:
        self.fn = fn
        self.static_argnums = tuple(sorted(static_argnums))
        self.donate_argnums = tuple(sorted(donate_argnums))
        self.pool = pool or DEFAULT_POOL
        self._graphs: dict = {}  # guarded-by: _mu
        self._last: _Graph | None = None
        self._mu = threading.RLock()
        self.__name__ = getattr(fn, "__name__", "compiled")
        self.__doc__ = getattr(fn, "__doc__", None)
        if register:
            _registry.add(self)

    def fork(self, pool: Pool | None = None, fn=None) -> "Compiled":
        """The same entry (or ``fn``, a stand-in for its function with the
        same signature) with a cache of its own, in ``pool`` (a new one by
        default): what an engine replaying on its own thread needs."""
        return Compiled(fn or self.fn, self.static_argnums,
                        self.donate_argnums, pool=pool or Pool(),
                        register=False)

    # jax's executable-cache probe: capacity.TrackedEntry counts a compile
    # whenever it grows
    def _cache_size(self) -> int:
        return len(self._graphs)

    def capture_seconds(self) -> list:
        """Host seconds each cached graph took to warm up and capture."""
        with self._mu:
            return [g.capture_s for g in self._graphs.values()]

    def clear(self) -> None:
        """Drop every graph of this entry with its buffers."""
        with self._mu:
            self._graphs.clear()
            self._last = None

    def last_static(self, argnum: int):
        """The static input tree of argument ``argnum`` of the graph this
        entry ran last (None before a graph exists): a caller that stages
        its next input there pays no copy-in."""
        g = self._last
        return None if g is None else g.static_args[argnum]

    def __call__(self, *args):
        if _mode() is not None:
            # inside another entry's warm-up or capture: run inline
            return self.fn(*args)
        dyn = [(i, a) for i, a in enumerate(args) if i not in self.static_argnums]
        leaves: list = []
        tdefs = [_flatten(a, leaves) for _i, a in dyn]
        if not _graph_path(leaves):
            return self.fn(*args)
        from dragonboat_tpu_torch import kernels

        key = (tuple(args[i] for i in self.static_argnums), tuple(tdefs),
               tuple((t.shape, t.dtype, t.device) for t in leaves),
               kernels._state["force_plain"])
        with self._mu:
            g = self._graphs.get(key)
            if g is None:
                t = time.perf_counter()
                g = self._capture(args, dyn, tdefs, leaves)
                g.capture_s = time.perf_counter() - t
                self._graphs[key] = g
            self._last = g
            return self._replay(g, leaves)

    # -- capture -----------------------------------------------------------

    def _body(self, g: _Graph, donated: list):
        """The captured function: ``fn`` on the static inputs, then the
        donated arguments' outputs copied back into their buffers."""
        outs = self.fn(*g.static_args)
        multi = type(outs) is tuple
        tops = list(outs) if multi else [outs]
        results = []
        tdefs = []
        claimed = set()
        dsts, srcs = [], []
        for j, top in enumerate(tops):
            lv: list = []
            td = _flatten(top, lv)
            tdefs.append(td)
            sig = _signature(td, lv)
            match = None
            for k, (dsig, dleaves) in enumerate(donated):
                if k not in claimed and dsig == sig:
                    match = k
                    break
            if match is None:
                results.append(lv)
                continue
            claimed.add(match)
            dleaves = donated[match][1]
            for d, s in zip(dleaves, lv):
                if s is d:
                    continue
                # a source that is another static input would be
                # overwritten by an earlier copy of this loop
                dsts.append(d)
                srcs.append(s.clone() if id(s) in g.in_ids else s)
            results.append(list(dleaves))
        _copy_all(dsts, srcs)
        tdef = (tuple, tuple(tdefs)) if multi else tdefs[0]
        return [t for lv in results for t in lv], tdef

    def _capture(self, args, dyn, tdefs, leaves) -> _Graph:
        g = _Graph()
        static = list(args)
        in_leaves = [t.detach().clone(memory_format=torch.contiguous_format)
                     for t in leaves]
        it = iter(in_leaves)
        for (i, _a), td in zip(dyn, tdefs):
            static[i] = _unflatten(td, it)
        g.static_args = static
        g.in_leaves = in_leaves
        g.in_ids = {id(t) for t in in_leaves}
        donated = []
        for i in self.donate_argnums:
            lv = leaves_of(static[i])
            td = _flatten(static[i], [])
            donated.append((_signature(td, lv), lv))

        def body():
            return self._body(g, donated)

        dev = leaves[0].device
        with _capture_mu:
            if dev.type == "cuda":
                self._capture_cuda(g, body, dev)
            else:
                with _in_mode("warmup", _Record()):
                    body()
                with _in_mode("capture", g.record):
                    g.out_leaves, g.out_tdef = body()
                g.body = body
        return g

    def _capture_cuda(self, g: _Graph, body, dev) -> None:
        from dragonboat_tpu_torch import kernels

        kernels.library()
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            side = _side_streams.get(dev)
            if side is None:
                side = _side_streams[dev] = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                with _in_mode("warmup", _Record()):
                    body()
                cg = torch.cuda.CUDAGraph()
                pool = self.pool.handle()
                with _in_mode("capture", g.record):
                    cg.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
                    try:
                        g.out_leaves, g.out_tdef = body()
                    except BaseException:
                        _abandon(cg, dev, pool, self.pool)
                        raise
                    cg.capture_end()
            cur.wait_stream(side)
        self.pool.add(cg)
        g.cuda_graph = cg

    # -- replay ------------------------------------------------------------

    def _replay(self, g: _Graph, leaves: list):
        dsts, srcs = [], []
        for s, t in zip(g.in_leaves, leaves):
            if t is not s:
                dsts.append(s)
                srcs.append(t)
        if any(id(t) in g.in_ids for t in srcs):
            # a caller's leaf that is another static input: read it
            # before the copies overwrite it
            srcs = [t.clone() if id(t) in g.in_ids else t for t in srcs]
        _copy_all(dsts, srcs)
        if g.cuda_graph is not None:
            g.cuda_graph.replay()
        else:
            with _in_mode("warmup", _Record()):
                new, _td = g.body()
            got = [(o, n) for o, n in zip(g.out_leaves, new) if o is not n]
            _copy_all([o for o, _n in got], [n for _o, n in got])
        if g.record.launches:
            from dragonboat_tpu_torch import kernels

            kernels.add_launches(g.record.launches)
        for cb in g.record.callbacks:
            cb()
        out = g.out_leaves
        if not self.donate_argnums:
            out = _clone_all(out)
        return _unflatten(g.out_tdef, iter(out))


def compiled(fn, *, static_argnums=(), donate_argnums=()) -> Compiled:
    """``fn`` as a compiled entry (module docstring)."""
    return Compiled(fn, static_argnums, donate_argnums)


def bind(fn, like: Compiled, pool: Pool) -> Compiled:
    """An engine's own copy of an entry: ``fn`` forked into ``pool`` when
    it is compiled, else compiled with ``like``'s arguments (a caller's
    stand-in for the entry, such as a counting wrapper)."""
    if isinstance(fn, Compiled):
        return fn.fork(pool)
    return like.fork(pool, fn)


def clear() -> None:
    """Drop the graphs of every module-level entry (engines' forks go
    with their engines)."""
    for c in list(_registry):
        c.clear()


def fresh(tree):
    """``tree`` with its tensors copied when they went through a graph:
    what a loop over a donating step body returns, so its results outlive
    the next call as ``jax.jit``'s do."""
    leaves: list = []
    tdef = _flatten(tree, leaves)
    if not _graph_path(leaves) or _mode() is not None:
        return tree
    return _unflatten(tdef, iter(_clone_all(leaves)))
