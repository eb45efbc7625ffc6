"""The port's user examples (``dragonboat_tpu_torch/examples``) run end to
end on the CPU as a user runs them, ``python -m
dragonboat_tpu_torch.examples.<name> --device cpu``, and print the
reference examples' lines (``tests/test_examples.py``)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, *args, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", f"dragonboat_tpu_torch.examples.{name}",
         "--device", "cpu", *args],
        capture_output=True, text=True, env=env, timeout=timeout, cwd=cwd)


def test_helloworld(tmp_path):
    r = _run("helloworld", cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dublin (linearizable read via follower host): rain" in r.stdout


def test_ondisk_two_runs(tmp_path):
    data = str(tmp_path / "data")
    r1 = _run("ondisk", data, cwd=tmp_path)
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert "wrote boot" in r1.stdout
    r2 = _run("ondisk", data, cwd=tmp_path)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "recovered from disk: boot =" in r2.stdout


def test_multigroup_device(tmp_path):
    r = _run("multigroup_device", "--shards", "4", cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "4/4 shards elected" in r.stdout
    assert "wrote to 4/4 shards" in r.stdout


def test_examples_need_a_card_unless_told():
    """With no ``--device`` an example runs on the CUDA card, and raises
    where there is none, before it starts anything."""
    import pytest
    import torch

    from dragonboat_tpu_torch.examples import helloworld

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the example would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        helloworld.main([])
