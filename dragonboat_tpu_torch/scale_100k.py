"""100k-group scale proof on the port (BASELINE config #3 shape).

The port of the reference's ``scripts/scale_100k.py``.  Measures, with
real allocations rather than projections:

  A. the batched kernel SoA state at 100k groups x 3 replicas
     (300k lanes): build time, device/host bytes, per-step time;
  B. the host side at 100k device-resident shards on ONE NodeHost:
     admission rate (batched lane injection), host-book bytes per lane
     (tracemalloc over a 10k slice), RSS, injection-flush time, idle
     staging scan time, and staging time under a proposal wave.

Each phase prints one JSON line (PHASE_A / PHASE_B) with the reference's
keys; partial runs still yield data.  Both rungs carry the capacity
triple — ``predicted_bytes`` (contracts-derived model, capacity.py),
``measured_bytes`` (live tree bytes), ``max_g_at_budget`` (largest G
fitting the card's memory, ``torch.cuda.mem_get_info``'s total, or
SCALE_BUDGET_BYTES) — so a sweep shows the model tracking reality rung
by rung.

The reference's persistent JAX compile cache has no counterpart: the
compiled entries (``graphs.py``) capture one CUDA graph per geometry in
each process, and no graph outlives it.  So ``compile_s`` (phase A) and
``injection_flush_plus_compile_s`` (phase B) time the first call's
warm-up, capture and replay, and ``dispatch_compiles`` counts captured
graphs: each rung asserts one capture at its geometry and none after it.
On the CPU the entries run eagerly and capture nothing, so a CPU run
replays them through ``graphs.stand_in()`` (as the tests do) and the
same assertion holds.  Run on an idle card:

    python -m dragonboat_tpu_torch.scale_100k [--groups N] [--device DEVICE]

``SCALE_PHASE`` (``a``, ``b`` or ``ab``, the default) picks the rungs,
``SCALE_STEPS`` (default 5) phase A's steps per timed call.  ``--device``
names the device (default: the CUDA card; with no card it raises — pass
``--device cpu`` on a machine without one).
"""

import contextlib
import json
import os
import resource
import sys
import time
import tracemalloc

from dragonboat_tpu_torch.devices import resolve_device

GROUPS = 100_000
STEPS = int(os.environ.get("SCALE_STEPS", "5"))


def _note_graphs() -> None:
    """Where the reference enables its persistent compile cache: the
    port's graphs are captured anew in every process."""
    print("SCALE graphs: captured in this process", flush=True)


def _budget_bytes(capacity_mod) -> int:
    """The card's memory (``torch.cuda.mem_get_info``'s total) when one
    is present, else the SCALE_BUDGET_BYTES env (default 16 GiB)."""
    for row in capacity_mod.device_memory_stats():
        if row.get("bytes_limit"):
            return int(row["bytes_limit"])
    return int(os.environ.get("SCALE_BUDGET_BYTES", str(16 << 30)))


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _block_until_ready(t) -> None:
    import torch

    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _platform(t) -> str:
    return "gpu" if t.device.type == "cuda" else "cpu"


def _peak_reset(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    import torch

    if dev.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(dev))


def phase_a(groups: int = GROUPS, steps: int | None = None, device=None):
    """Phase A; prints the PHASE_A line and returns it with the extras a
    caller on the card reads: the geometry, the peak device bytes through
    the first call (warm-up, capture, replays) and through the second
    (replays only), the capture's seconds, and the final state and
    inbox."""
    from dragonboat_tpu_torch import bench_loop, capacity
    from dragonboat_tpu_torch.core.kstate import empty_inbox

    steps = STEPS if steps is None else steps
    dev = resolve_device(device)
    _note_graphs()

    kp = bench_loop.bench_params(3, dev)
    t0 = time.time()
    state = bench_loop.make_cluster(kp, groups, 3, device=dev)
    box = empty_inbox(kp, state.term.shape[0], dev)
    _block_until_ready(state.term)
    build_s = time.time() - t0
    # contracts-derived model vs what the trees actually hold: the two
    # must agree (test_capacity pins <1%); the rung records both
    lanes = int(state.term.shape[0])
    classes = ("ShardState", "Inbox")
    predicted = capacity.predict_bytes(kp, lanes, classes)
    state_bytes = capacity.measure_tree_bytes(state)
    box_bytes = capacity.measure_tree_bytes(box)
    budget = _budget_bytes(capacity)
    max_g = capacity.max_g_for_budget(kp, budget, classes)

    # the loop replays its step body's graph ``steps`` times: the body's
    # graph count is the tracker's cache probe, so the rung itself proves
    # the steady-state contract (one capture at this geometry, zero
    # retraces after).  The body's cache is process-wide: start it empty,
    # so an earlier caller's graph at this geometry is not taken for ours
    def run_steps(*args):
        return bench_loop.run_steps(*args)

    bench_loop._run.clear()
    run_steps._cache_size = bench_loop._run._cache_size
    tracked = capacity.TRACKER.wrap("scale_run_steps", run_steps)
    _peak_reset(dev)
    t0 = time.time()
    state, box = tracked(kp, 3, steps, True, True, state, box)
    _block_until_ready(state.term)
    compile_s = time.time() - t0
    capture_peak = _peak(dev)
    _peak_reset(dev)
    t0 = time.time()
    state, box = tracked(kp, 3, steps, True, True, state, box)
    _block_until_ready(state.term)
    dt = time.time() - t0
    replay_peak = _peak(dev)
    tstats = tracked.stats()
    assert tstats["compiles"] == 1 and tstats["retraces"] == 0, (
        f"scale rung retraced: {tstats}")
    line = {
        "groups": groups, "lanes": groups * 3,
        "platform": _platform(state.term),
        "build_s": round(build_s, 1),
        "state_mb": round(state_bytes / 1e6, 1),
        "inbox_mb": round(box_bytes / 1e6, 1),
        "predicted_bytes": predicted,
        "measured_bytes": state_bytes + box_bytes,
        "max_g_at_budget": max_g,
        "compile_s": round(compile_s, 1),
        "step_ms": round(dt / steps * 1e3, 1),
        "dispatch_compiles": tstats["compiles"],
        "dispatch_retraces": tstats["retraces"],
        "rss_gb": round(rss_gb(), 2),
    }
    print("PHASE_A " + json.dumps(line), flush=True)
    return line, {"kp": kp, "steps": steps, "capture_peak_bytes": capture_peak,
                  "replay_peak_bytes": replay_peak, "first_call_s": compile_s,
                  "capture_s": bench_loop._run.capture_seconds(),
                  "step_s": dt / steps, "state": state, "box": box}


def phase_b(groups: int = GROUPS, device=None):
    """Phase B; prints the PHASE_B line and returns it with the extras a
    caller on the card reads: each pump round's and idle step's seconds
    and the engine's geometry."""
    from dragonboat_tpu_torch import capacity
    from dragonboat_tpu_torch.config import Config, ExpertConfig, NodeHostConfig
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.statemachine import IStateMachine, Result

    class NullSM(IStateMachine):
        """Minimal SM: the measurement targets the books, not the RSM."""

        def __init__(self, shard_id, replica_id):
            self.n = 0

        def update(self, entry):
            self.n += 1
            return Result(value=self.n)

        def lookup(self, q):
            return self.n

        def save_snapshot(self, w, files, done):
            w.write(b"\x00" * 4)

        def recover_from_snapshot(self, r, files, done):
            r.read(4)

    _note_graphs()
    expert = ExpertConfig()
    expert.kernel_capacity = groups
    # no node_host_dir -> MemLogDB: the measurement targets the host
    # books and the staging scan, not storage
    nh = NodeHost(NodeHostConfig(raft_address="scale-1", rtt_millisecond=5,
                                 expert=expert), auto_run=False,
                  device=resolve_device(device))
    base_cfg = dict(election_rtt=10, heartbeat_rtt=1)

    def admit(lo: int, hi: int) -> float:
        t0 = time.time()
        for sid in range(lo, hi):
            nh.start_replica({1: "scale-1"}, False, NullSM, Config(
                shard_id=sid, replica_id=1, device_resident=True,
                **base_cfg))
        return time.time() - t0

    # warm slice to settle dict shapes, then a traced slice for the
    # bytes/lane number, then the untraced remainder (tracemalloc ~2x)
    head = max(2, min(5_000, groups // 4))
    traced = max(2, min(10_000, groups // 2))
    admit_head_s = admit(1, head + 1)
    tracemalloc.start()
    s0, _ = tracemalloc.get_traced_memory()
    t_traced = admit(head + 1, head + traced + 1)
    s1, _ = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    bytes_per_lane = (s1 - s0) / traced
    t_rest = admit(head + traced + 1, groups + 1)
    n_shards = len(nh.nodes)
    # the traced slice runs ~2x slow under tracemalloc: exclude it from
    # BOTH sides of the rate instead of inflating the numerator
    admit_rate = (n_shards - traced) / (admit_head_s + t_rest + 1e-9)

    eng = nh.kernel_engine

    def tick_all():
        # the PRODUCTION tick round: one shared-clock advance + one
        # engine-wide pending tick (consumed as a vectorized broadcast
        # at the next step) — not a per-lane Python walk
        nh._do_tick_round()

    def host(t):
        # the rung's own reads of the engine's device state, at a
        # declared crossing
        with capacity.METER.sanctioned("scale_readback"):
            return t.cpu().numpy()

    # first kernel call: flushes EVERY queued injection at once AND
    # captures the step's graph at this capacity
    tick_all()
    t0 = time.time()
    eng.step_all()
    flush_compile_s = time.time() - t0
    # election pump: single-member shards campaign once their election
    # timer fires; the engine sees ticks only when the host ticks nodes
    from dragonboat_tpu_torch.core import params as KP

    leaders = 0
    pump_rounds = 0
    pump_steps = []
    t_pump = time.time()
    for _ in range(40):
        pump_rounds += 1
        tick_all()
        t0 = time.time()
        eng.step_all()
        pump_steps.append(time.time() - t0)
        leaders = int((host(eng.state.role) == KP.LEADER).sum())
        if leaders >= n_shards:
            break
    pump_s = time.time() - t_pump
    idle = []
    for _ in range(5):
        t0 = time.time()
        eng.step_all()
        idle.append(time.time() - t0)

    # proposal wave on 1k shards through the real client path
    waves = 0
    for sid in range(1, 1001):
        sess = nh.get_noop_session(sid)
        try:
            nh.propose(sess, b"k=1", timeout_s=30)
            waves += 1
        except Exception:
            pass
    stage_t0 = time.time()
    eng.step_all()
    eng.step_all()
    wave_steps_s = time.time() - stage_t0
    committed = int(host(eng.state.committed)[:n_shards].sum())
    # the rung ran entirely through the unified dispatch seam
    # (engine/dispatch.py): its active tracked entry must show exactly
    # one capture at this capacity and zero steady-state retraces
    active = "step_donated" if eng.pipeline_depth > 0 else "step"
    dstats = eng._cap_entries[active].stats()
    assert dstats["compiles"] == 1 and dstats["retraces"] == 0, (
        f"dispatch entry {active!r} retraced at scale: {dstats}")
    # same model the engine's /debug/capacity serves: classes + trees
    # come from the engine so the rung and the endpoint can't diverge
    classes = eng._capacity_model_classes()
    predicted = capacity.predict_bytes(
        eng.kp, int(eng.state.term.shape[0]), classes)
    measured = capacity.measure_tree_bytes(*eng._capacity_trees())
    max_g = capacity.max_g_for_budget(
        eng.kp, _budget_bytes(capacity), classes)
    line = {
        "shards": n_shards,
        "predicted_bytes": predicted,
        "measured_bytes": measured,
        "max_g_at_budget": max_g,
        "admit_per_s": round(admit_rate),
        "bytes_per_lane_host_books": round(bytes_per_lane),
        "rss_gb": round(rss_gb(), 2),
        "injection_flush_plus_compile_s": round(flush_compile_s, 2),
        "election_pump_rounds": pump_rounds,
        "election_pump_s": round(pump_s, 1),
        "leaders": leaders,
        "idle_scan_step_ms": round(1e3 * sum(idle) / max(len(idle), 1), 1),
        "proposals_queued": waves,
        "wave_2steps_s": round(wave_steps_s, 3),
        "committed_total": committed,
        "dispatch_entry": active,
        "dispatch_compiles": dstats["compiles"],
        "dispatch_retraces": dstats["retraces"],
    }
    print("PHASE_B " + json.dumps(line), flush=True)
    nh.close()
    return line, {"pump_step_s": pump_steps, "idle_step_s": idle,
                  "kp": eng.kp}


def main(argv=None) -> int:
    import argparse

    from dragonboat_tpu_torch import graphs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=GROUPS)
    ap.add_argument("--device", default=None,
                    help="device the rungs run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    which = os.environ.get("SCALE_PHASE", "ab")
    # the CPU captures nothing: replay through the stand-in there
    replayer = graphs.stand_in() if dev.type == "cpu" else contextlib.nullcontext()
    with replayer:
        if "a" in which:
            phase_a(args.groups, device=dev)
        if "b" in which:
            phase_b(args.groups, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
