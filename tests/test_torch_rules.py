"""The port's own rules, checked on the CPU.

- ``dragonboat_tpu_torch`` imports neither JAX nor the JAX package;
- with no CUDA device, an entry point given no device raises instead of
  running on the CPU;
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
        kp = bl.sm_params(3, device="cpu")
        st, box = bl.elect_all(kp, 3, bl.make_cluster(kp, 2, 3, device="cpu"))
        kv, kvs = bl.make_device_sm(2, 3, table_cap=128, device="cpu")
        st, box, kvs, rej = bl.run_steps_sm(kp, 3, kv, 4, True, True, st, box, kvs)
        assert int(rej) == 0 and int(kvs["count"].sum()) > 0
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
