"""The port's own rules, checked on the CPU.

- ``dragonboat_tpu_torch`` imports neither JAX nor the JAX package;
- with no CUDA device, an entry point given no device raises instead of
  running on the CPU (the mesh path's, the chaos runner's and the model
  checker's too);
- a mesh-resident shard attaches the port's MeshEngine on the CPU when the
  host asks for the CPU;
- every kernel wrapper takes its plain arm for CPU tensors and leaves its
  launch count at 0, and refuses tensors it cannot take;
- a kernel build with no ``nvcc`` raises instead of falling back.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch import bench_loop as bl
from dragonboat_tpu_torch import kernels
from dragonboat_tpu_torch.parallel import fabric_kernels as fk
from dragonboat_tpu_torch.rsm.device_kv import DeviceKV
from dragonboat_tpu_torch.rsm.device_kv_kernels import apply_window

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import sys
        from dragonboat_tpu_torch import bench_loop as bl
        from dragonboat_tpu_torch import convert  # noqa: F401
        # the verification harnesses: chaos runner and model checker
        import dragonboat_tpu_torch.chaos  # noqa: F401
        import dragonboat_tpu_torch.model_check  # noqa: F401
        # the capacity rungs and the step sweep
        import dragonboat_tpu_torch.scale_100k  # noqa: F401
        import dragonboat_tpu_torch.sweep_step  # noqa: F401
        # gossip addressing, the TCP transport, the history recorder and
        # the analysis passes (the lint driver's own check is in
        # tests/test_torch_analysis.py)
        import dragonboat_tpu_torch.gossip  # noqa: F401
        import dragonboat_tpu_torch.history  # noqa: F401
        import dragonboat_tpu_torch.transport.tcp  # noqa: F401
        # the operations' lockstep drive and the user examples
        import dragonboat_tpu_torch.lockstep  # noqa: F401
        from dragonboat_tpu_torch.examples import (  # noqa: F401
            helloworld, multigroup_device, ondisk)
        from dragonboat_tpu_torch.analysis import (  # noqa: F401
            common, concurrency, contracts, determinism, engine_unity,
            safety, transfer)
        kp = bl.sm_params(3, device="cpu")
        st, box = bl.elect_all(kp, 3, bl.make_cluster(kp, 2, 3, device="cpu"))
        kv, kvs = bl.make_device_sm(2, 3, table_cap=128, device="cpu")
        st, box, kvs, rej = bl.run_steps_sm(kp, 3, kv, 4, True, True, st, box, kvs)
        assert int(rej) == 0 and int(kvs["count"].sum()) > 0
        # the other bench loops, a few steps each
        import torch
        z = lambda: torch.zeros((), dtype=torch.int32)  # noqa: E731
        st, box, kvs, rd, acc, rej = bl.run_steps_mixed_sm(
            kp, 3, kv, 3, 4, 0, st, box, kvs, z(), z(), z())
        st, box, *lat = bl.run_steps_lat(kp, 3, 2, 4, True, True, True, 0, st, box,
                                         *bl.lat_init(kp, 6, device="cpu"))
        st, box, *lat = bl.run_steps_lat_pipelined(kp, 3, 1, 4, True, True, True, 2,
                                                   st, box, *lat)
        st, box, rd = bl.run_steps_mixed(kp, 3, 2, 4, 0, st, box, rd)
        st, box, rd = bl.run_steps_mixed_pipelined(kp, 3, 1, 4, 2, st, box, rd)
        st, box, acc_cc, idx_cc = bl.cc_step(kp, 3, st, box)
        st, box = bl.run_steps_pipelined(kp, 3, 1, True, True, st, box)
        st, box = bl.run_steps_storm(kp, 3, 2, 0.25, 1, st, box)
        st, box = bl.run_steps_storm_pipelined(kp, 3, 1, 0.25, 1, st, box)
        assert int(rej) == 0 and int(rd) > 0
        # the compiled entries' module, through its CPU stand-in replayer
        from dragonboat_tpu_torch import graphs
        with graphs.stand_in():
            st, box = bl.run_steps(kp, 3, 2, True, True, st, box)
        assert bl._run._cache_size() == 1
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "dragonboat_tpu" or m.startswith("dragonboat_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_entry_points_without_device_raise_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    kp = bl.sm_params(3, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bl.make_cluster(kp, 2, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bl.sm_params(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceKV(table_cap=64).init_state(3)


def test_verify_harnesses_without_device_raise_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from dragonboat_tpu_torch import chaos, model_check

    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_check.run_scope("fast")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_check.main(["--scope", "fast"])
    for run in (chaos.run_schedule, chaos.run_detector_differential,
                chaos.run_hotspot):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(1)


def test_capacity_rungs_without_device_raise_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from dragonboat_tpu_torch import scale_100k, sweep_step

    for run in (scale_100k.phase_a, scale_100k.phase_b, sweep_step.measure):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale_100k.main(["--groups", "2"])


def test_wrappers_take_plain_arm_on_cpu_without_counting():
    kernels.reset_launches()
    rng = np.random.default_rng(0)
    match = torch.as_tensor(rng.integers(0, 9, (6, 3)).astype(np.int32))
    voting = torch.ones((6, 3), dtype=torch.bool)
    quorum = torch.full((6,), 2, dtype=torch.int32)
    assert torch.equal(fk.quorum_match(match, voting, quorum),
                       fk.quorum_match_plain(match, voting, quorum))
    vals = torch.as_tensor(rng.integers(-9, 9, (6, 10)).astype(np.int32))
    idx = torch.as_tensor(rng.integers(0, 11, (6, 3)).astype(np.int32))
    assert torch.equal(fk.gather_lanes(vals, idx), fk.gather_lanes_plain(vals, idx))
    kind = torch.as_tensor(rng.integers(0, 4, (6, 3)).astype(np.int32))
    assert torch.equal(fk.commit_quorum(match, kind), fk.commit_quorum_plain(match, kind))
    fields = [vals, vals > 0]
    lanes = [torch.as_tensor(rng.integers(0, 11, (2, 3, 3)).astype(np.int32))
             for _ in range(2)]
    for got, ref in zip(fk.gather_lanes_multi(fields, lanes),
                        fk.gather_lanes_multi_plain(fields, lanes)):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    kv = DeviceKV(table_cap=16, probe_depth=4)
    cmds = torch.as_tensor(rng.integers(0, 20, (6, 5, 2)).astype(np.int32))
    valid = torch.ones((6, 5), dtype=torch.bool)
    st0 = kv.init_state(6, "cpu")
    st_w, (rw, okw) = apply_window(kv, st0, cmds, valid)
    st_p, (rp, okp) = kv.apply_kernel(st0, cmds, valid)
    assert all(torch.equal(st_w[k], st_p[k]) for k in st_p)
    assert torch.equal(rw, rp) and torch.equal(okw, okp)
    assert int(st0["count"].sum()) == 0, "the CPU arm must not write its input"
    assert kernels.launches == {"quorum_match": 0, "gather_lanes": 0, "kv_apply": 0}


def test_wrappers_refuse_mixed_or_unknown_devices():
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        fk.gather_lanes(a, torch.zeros((2, 3), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fk.gather_lanes(a.to("meta"), torch.zeros((2, 3), dtype=torch.int32,
                                                  device="meta"))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(kernels._state, "lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.library()


def test_nodehost_path_imports_no_jax_and_no_reference_package():
    """Three hosts (the engine tests' geometry, metrics on) elect, write and
    read back; then one host under the default ExpertConfig with
    enable_metrics serves a device shard and /metrics shows its leader."""
    code = textwrap.dedent("""
        import sys, time, urllib.request
        sys.path.insert(0, "tests")
        from test_torch_nodehost import make_cluster, close_all, KVStateMachine
        from dragonboat_tpu_torch.config import Config, NodeHostConfig
        from dragonboat_tpu_torch.nodehost import NodeHost

        def scrape(nh):
            url = f"http://{nh.metrics_address}/metrics"
            return urllib.request.urlopen(url, timeout=10).read().decode()

        def leaders(text):
            line = 'fleet_role_count{role="leader"} '
            return sum(int(float(x[len(line):])) for x in text.splitlines()
                       if x.startswith(line))

        hosts = make_cluster(f"rules{time.monotonic_ns()}", auto_run=False,
                             metrics=True)
        try:
            lead = 0
            for _ in range(40):
                for nh in hosts.values():
                    nh.tick_all(); nh.tick_all()
                for nh in hosts.values():
                    nh.run_once()
                ids = {nh.get_leader_id(1) for nh in hosts.values()}
                if len(ids) == 1 and ids.copy().pop()[1]:
                    lead = ids.pop()[0]
                    break
            assert lead, "no leader"
            nh = hosts[lead]
            rs = nh.propose(nh.get_noop_session(1), b"a=1", timeout_s=2)
            for _ in range(20):
                for h in hosts.values():
                    h.tick_all(); h.tick_all()
                for h in hosts.values():
                    h.run_once()
            assert rs.result.completed(), rs.result
            assert all(h.stale_read(1, "a") == "1" for h in hosts.values())
            assert sum(leaders(scrape(h)) for h in hosts.values()) == 1
        finally:
            close_all(hosts)
        addr = f"rules-dflt{time.monotonic_ns()}"
        nh = NodeHost(NodeHostConfig(raft_address=addr, enable_metrics=True),
                      auto_run=False, device="cpu")
        try:
            nh.start_replica({1: addr}, False, KVStateMachine, Config(
                shard_id=1, replica_id=1, election_rtt=10, heartbeat_rtt=1,
                device_resident=True))
            for _ in range(40):
                nh.tick_all(); nh.tick_all(); nh.run_once()
                if nh.get_leader_id(1) == (1, True):
                    break
            rs = nh.propose(nh.get_noop_session(1), b"b=2", timeout_s=5)
            for _ in range(12):
                nh.tick_all(); nh.tick_all(); nh.run_once()
            assert rs.result.completed() and nh.stale_read(1, "b") == "2"
            assert nh.kernel_engine._inv_seq > 0
            assert leaders(scrape(nh)) == 1
        finally:
            nh.close()
        # the mesh path: three hosts on one MeshEngine, then the serve step
        from dragonboat_tpu_torch.config import ExpertConfig, MeshSpec
        from dragonboat_tpu_torch.core import params as KP
        from dragonboat_tpu_torch.parallel import ici
        tag = f"rules-mesh{time.monotonic_ns()}"
        spec = MeshSpec(name=tag, g_size=1, replicas=3, n_local=2)
        addrs = {r: f"{tag}-{r}" for r in (1, 2, 3)}
        hosts = {r: NodeHost(NodeHostConfig(
            raft_address=addrs[r], expert=ExpertConfig(mesh=spec)),
            auto_run=False, device="cpu") for r in addrs}
        try:
            for r, h in hosts.items():
                h.start_replica(addrs, False, KVStateMachine, Config(
                    shard_id=1, replica_id=r, election_rtt=10,
                    heartbeat_rtt=1, mesh_resident=True))
            eng = hosts[1].mesh_engine
            assert eng is not None and eng is hosts[3].mesh_engine
            lead = 0
            for _ in range(40):
                for h in hosts.values():
                    h.tick_all(); h.tick_all()
                for h in hosts.values():
                    h.run_once()
                ids = {h.get_leader_id(1) for h in hosts.values()}
                if len(ids) == 1 and ids.copy().pop()[1]:
                    lead = ids.pop()[0]
                    break
            assert lead, "no mesh leader"
            rs = hosts[lead].propose(hosts[lead].get_noop_session(1), b"m=3",
                                     timeout_s=5)
            for _ in range(12):
                for h in hosts.values():
                    h.tick_all(); h.tick_all()
                for h in hosts.values():
                    h.run_once()
            assert rs.result.completed(), rs.result
            assert all(h.stale_read(1, "m") == "3" for h in hosts.values())
        finally:
            close_all(hosts)
        kp = KP.KernelParams(num_peers=3, log_cap=64, inbox_cap=10,
                             msg_entries=4, proposal_cap=4, readindex_cap=4,
                             apply_batch=16, compaction_overhead=16)
        cl, st, box = ici.make_ici_cluster(kp, 2, 3, 4, device="cpu")
        import torch
        cut = torch.zeros((cl.total_rows, 3), dtype=torch.bool)
        for _ in range(4):
            st, box, _ = ici.ici_serve_step(cl, st, box,
                                            ici.self_driving_input(kp, st), cut)
        st, box = ici.ici_run_steps(kp, cl, 2, True, st, box)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "dragonboat_tpu" or m.startswith("dragonboat_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_nodehost_without_device_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from dragonboat_tpu_torch.config import NodeHostConfig
    from dragonboat_tpu_torch.nodehost import NodeHost

    with pytest.raises(RuntimeError, match="no CUDA device"):
        NodeHost(NodeHostConfig(raft_address="rules-nodev-1"), auto_run=False)


def test_mesh_nodehost_without_device_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from dragonboat_tpu_torch.config import ExpertConfig, MeshSpec, NodeHostConfig
    from dragonboat_tpu_torch.engine.mesh_engine import attach_mesh_engine
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.parallel import ici

    spec = MeshSpec(name="rules-nodev-mesh", g_size=1, replicas=3, n_local=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NodeHost(NodeHostConfig(raft_address="rules-nodev-2",
                                expert=ExpertConfig(mesh=spec)),
                 auto_run=False)
    kp = bl.bench_params(3, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attach_mesh_engine(kp, spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ici.make_ici_cluster(kp, 1, 3, 2)


def test_mesh_engine_attaches_on_cpu():
    """A mesh-resident shard on a host that names the CPU attaches the
    port's MeshEngine there (the reference's mesh raised before this
    slice); a second attach under the same name with another geometry,
    other kernel params or another device raises."""
    import dataclasses

    from dragonboat_tpu_torch.config import (
        Config, ExpertConfig, MeshSpec, NodeHostConfig)
    from dragonboat_tpu_torch.engine import mesh_engine as me
    from dragonboat_tpu_torch.nodehost import NodeHost

    from test_torch_nodehost import KVStateMachine

    name = f"rules-mesh-cpu{os.getpid()}"
    spec = MeshSpec(name=name, g_size=1, replicas=3, n_local=2)
    addrs = {r: f"{name}-{r}" for r in (1, 2, 3)}
    nh = NodeHost(NodeHostConfig(raft_address=addrs[1],
                                 expert=ExpertConfig(mesh=spec)),
                  auto_run=False, device="cpu")
    try:
        nh.start_replica(addrs, False, KVStateMachine, Config(
            shard_id=1, replica_id=1, election_rtt=10, heartbeat_rtt=1,
            mesh_resident=True))
        eng = nh.mesh_engine
        assert isinstance(eng, me.MeshEngine)
        assert eng.device == torch.device("cpu")
        assert nh.nodes[1].peer is None and nh.nodes[1].engine is eng
        assert eng.by_shard[(1, 1)].lane == eng._row(0, 1)
        assert eng._dispatch.box.mtype.device.type == "cpu"
        kp = eng.kp
        for args, what in (
                ((kp, dataclasses.replace(spec, n_local=4)), "geometry"),
                ((dataclasses.replace(kp, log_cap=2 * kp.log_cap), spec),
                 "kernel params"),
                ((kp, spec, "meta"), "device")):
            kw = {"device": args[2]} if len(args) > 2 else {"device": "cpu"}
            with pytest.raises(RuntimeError, match=f"{what} mismatch"):
                me.attach_mesh_engine(args[0], args[1], **kw)
    finally:
        nh.close()
    assert name not in me._REGISTRY


def test_nodehost_refuses_off_path_settings():
    from dragonboat_tpu_torch.config import ExpertConfig, NodeHostConfig
    from dragonboat_tpu_torch.nodehost import NodeHost

    cases = (
        (dict(expert=ExpertConfig(compile_cache=True)),
         "captured in each process"),
    )
    for i, (kw, item) in enumerate(cases):
        with pytest.raises(ValueError, match=item):
            NodeHost(NodeHostConfig(raft_address=f"rules-off-{i + 2}", **kw),
                     auto_run=False, device="cpu")


def test_gossip_addressing_is_refused():
    """Gossip addressing runs on the port (tests/test_torch_gossip.py); it
    is refused where the reference refuses it: with no gossip config
    (the reference's test_gossip_required_for_nhid_addressing), or with
    no bind address."""
    from dragonboat_tpu_torch.config import (
        ConfigError,
        GossipConfig,
        NodeHostConfig,
    )
    from dragonboat_tpu_torch.nodehost import NodeHost

    for gossip in (GossipConfig(),
                   GossipConfig(advertise_address="127.0.0.1:1",
                                seed=["127.0.0.1:2"])):
        cfg = NodeHostConfig(raft_address="rules-gossip-1",
                             address_by_node_host_id=True, gossip=gossip)
        with pytest.raises(ConfigError, match="gossip"):
            NodeHost(cfg, auto_run=False, device="cpu")


def test_port_kv_refuses_corrupt_sst(tmp_path):
    """The port's ``logdb/kv.py`` departs from the reference on corrupt
    input: a flipped length byte of an SST record raises CorruptKVError
    instead of reading its ~68 GB (the reference raises MemoryError)."""
    from dragonboat_tpu_torch.logdb.kv import CorruptKVError, OrderedKV

    kv = OrderedKV(str(tmp_path))
    kv.put(b"a", b"1" * 64)
    kv.flush()
    kv.close()
    sst = [f for f in os.listdir(tmp_path) if f.endswith(".kv")][0]
    path = os.path.join(tmp_path, sst)
    with open(path, "r+b") as f:
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(CorruptKVError, match="past end of file"):
        OrderedKV(str(tmp_path))


def test_kernel_library_and_counts_are_thread_safe(monkeypatch, tmp_path):
    """library_path() from many threads agrees; concurrent launch counts
    lose no update; a build with no nvcc raises in every thread."""
    import threading

    paths, errors = [], []

    def hammer():
        paths.append(kernels.library_path())
        for _ in range(500):
            kernels.check_launch(0, "quorum_match")

    kernels.reset_launches()
    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(paths)) == 1
    assert kernels.launches["quorum_match"] == 8 * 500
    kernels.reset_launches()

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(kernels._state, "lib", None)

    def load():
        try:
            kernels.library()
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=load) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(errors) == 4 and all("nvcc not found" in e for e in errors)
    assert kernels._state["lib"] is None


def test_host_layer_copies_match_the_reference():
    from dragonboat_tpu_torch import _hostcopy

    assert _hostcopy.drift() == []


def test_hand_ports_differ_from_the_reference_only_by_their_recorded_diffs():
    """The chaos runner, the model checker, the analysis passes and
    ``logdb/kv`` are ported by hand from one reference file each; an edit
    on either side that the recorded diff under tests/hand_ports/ does
    not hold shows as drift."""
    from dragonboat_tpu_torch import _hostcopy

    assert _hostcopy.hand_drift() == []
    runner = _hostcopy.hand_diff("chaos/runner.py")
    # the runner's only JAX code is the health differential's device_get
    removed = [ln for ln in runner.splitlines() if ln.startswith("-")]
    assert any("jax.device_get" in ln for ln in removed)
    # every analysis pass's scope names the port's files, never the
    # reference's
    for rel in _hostcopy.HAND_PORTS:
        if rel.startswith("analysis/"):
            added = [ln for ln in _hostcopy.hand_diff(rel).splitlines()
                     if ln.startswith("+")]
            assert added, rel
            text = (_hostcopy.PORT / rel).read_text()
            assert '"dragonboat_tpu/' not in text, rel
    assert not any("jax" in ln for ln in runner.splitlines()
                   if ln.startswith("+") and "JAX" not in ln)
