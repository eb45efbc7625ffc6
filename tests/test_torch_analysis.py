"""The port's analysis passes (``dragonboat_tpu_torch.analysis``) on the CPU.

Each pass is clean on the port; each fires on a bad port-style fixture and
not on its repaired twin; the contracts pass's runtime diff holds the
declared CONTRACTS to the tensors a real step builds, at two of the
reference's ``test_contracts_runtime_roundtrip`` geometries; the transfer
pass's dynamic leg matches the ledger under the (counting) CPU guard; and
``python -m dragonboat_tpu_torch.analysis`` exits 0 on the port with its
nine passes, importing neither JAX nor the JAX package.  The seeded protocol bugs the safety pass owns are held in
``tests/test_torch_model_check.py``.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from dragonboat_tpu_torch.analysis import (
    concurrency,
    contracts,
    determinism,
    engine_unity,
    op_budget,
    partition,
    safety,
    tracer_safety,
    transfer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: every pass over the port, static legs only
CLEAN_RUNS = {
    "concurrency": lambda: concurrency.run(REPO),
    "determinism": lambda: determinism.run(REPO),
    "contracts": lambda: contracts.run(REPO),
    "engine-unity": lambda: engine_unity.run(REPO),
    "safety": lambda: safety.run(REPO, dynamic=False),
    "transfer": lambda: transfer.run(REPO, dynamic=False),
    "partition": lambda: partition.run(REPO, dynamic=False),
    "tracer-safety": lambda: tracer_safety.run(REPO),
    "op-budget": lambda: op_budget.run(REPO, use_cache=False),
}


@pytest.mark.parametrize("name", sorted(CLEAN_RUNS))
def test_pass_clean_on_the_port(name):
    assert [f.format() for f in CLEAN_RUNS[name]()] == []


@pytest.mark.parametrize("G,P,CAP", [(1, 3, 32), (5, 5, 64)])
def test_contracts_runtime_roundtrip(G, P, CAP):
    """KC007: declared contracts match the tensors init_state, one real
    step and one pass of each reduction build (all-distinct satellite
    axes keep the axis names honest)."""
    from dragonboat_tpu_torch.core.params import KernelParams

    kp = KernelParams(num_peers=P, log_cap=CAP, inbox_cap=4, msg_entries=5,
                      proposal_cap=6, readindex_cap=8)
    assert contracts.runtime_check(kp=kp, num_shards=G, root=REPO,
                                   device="cpu") == []


def test_transfer_dynamic_leg_matches_the_ledger_on_cpu():
    assert transfer.live_transfer_check(REPO, use_cache=False,
                                        device="cpu") == []


_KSTATE = os.path.join(REPO, "dragonboat_tpu_torch", "core", "kstate.py")

#: pass -> (fixture path, bad source, repaired source, the rule the bad
#: one fires): one per rule family, each in the port's idiom
FIXTURES = {
    "determinism": (
        "dragonboat_tpu_torch/core/fx.py",
        """
        import time

        def stamp(s):
            return s.term + int(time.time())
        """,
        """
        def stamp(s, now):
            return s.term + now
        """,
        "DT001"),
    "concurrency": (
        "dragonboat_tpu_torch/engine/fx.py",
        """
        import threading

        class Book:
            def __init__(self):
                self.mu = threading.Lock()
                self.rows = {}  # guarded-by: mu

            def put(self, k, v):
                self.rows[k] = v
        """,
        """
        import threading

        class Book:
            def __init__(self):
                self.mu = threading.Lock()
                self.rows = {}  # guarded-by: mu

            def put(self, k, v):
                with self.mu:
                    self.rows[k] = v
        """,
        "CC002"),
    "safety": (
        "dragonboat_tpu_torch/core/kernel.py",
        """
        def _follow_commit(s, m):
            ok = s.role == 0
            return mrep(s, ok, committed=m.commit)
        """,
        """
        def _follow_commit(s, m):
            ok = s.role == 0
            return mrep(s, ok, committed=torch.maximum(s.committed, m.commit))
        """,
        "RS002"),
    "engine-unity": (
        "dragonboat_tpu_torch/engine/fx.py",
        """
        class KernelEngine:
            def step_all(self):
                self._kernel_call()

            def _kernel_call(self):
                pass

        class SideEngine(KernelEngine):
            def step_all(self):
                pass
        """,
        """
        class KernelEngine:
            def step_all(self):
                self._kernel_call()

            def _kernel_call(self):
                pass

        class SideEngine(KernelEngine):
            def _make_dispatch(self):
                return None
        """,
        "EU001"),
    "contracts": (
        "dragonboat_tpu_torch/core/kernel.py",
        """
        from dragonboat_tpu_torch import graphs

        def _step(kp, s, box, inp):
            return s, None

        step_donated = graphs.compiled(_step, static_argnums=(0,),
                                       donate_argnums=(1, 2))
        """,
        """
        from dragonboat_tpu_torch import graphs

        def _step(kp, s, box, inp):
            return s, None

        step_donated = graphs.compiled(_step, static_argnums=(0,),
                                       donate_argnums=(1, 2, 3))
        """,
        "KC008"),
    "transfer": (
        "dragonboat_tpu_torch/engine/fx.py",
        """
        class KernelEngine:
            def leader_term(self, g):
                return int(self.state.term[g])
        """,
        """
        class KernelEngine:
            def leader_term(self, g):
                return int(self._lead_term_np[g])
        """,
        "TB005"),
}


def _fixture_rules(tmp_path, name, src):
    rel, *_ = FIXTURES[name]
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    root, p = str(tmp_path), str(path)
    if name == "determinism":
        found = determinism.run(root, files=[p])
    elif name == "concurrency":
        found = concurrency.run(root, files=[p])
    elif name == "safety":
        found = safety.run(root, files=[_KSTATE, p])
    elif name == "engine-unity":
        found = engine_unity.run(root, files=[p])
    elif name == "contracts":
        # the donation table is the port's own; the fixture kernel is the
        # only donating module
        kstate = tmp_path / "dragonboat_tpu_torch" / "core" / "kstate.py"
        kstate.write_text('DONATION = {"step_donated": {"argnums": '
                          '(1, 2, 3), "params": ("s", "box", "inp")}}\n')
        found = contracts.run(root)
    else:
        found = transfer.run(root, files=[p], dynamic=False)
    return {f.rule for f in found}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_pass_fires_on_a_bad_port_source(tmp_path, name):
    _rel, bad, good, rule = FIXTURES[name]
    assert rule in _fixture_rules(tmp_path / "bad", name, bad)
    assert rule not in _fixture_rules(tmp_path / "good", name, good)


def test_lint_driver_exits_zero_on_the_port_without_jax():
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["python -m dragonboat_tpu_torch.analysis"]
        try:
            runpy.run_module("dragonboat_tpu_torch.analysis",
                             run_name="__main__")
        except SystemExit as e:
            rc = e.code
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "dragonboat_tpu" or m.startswith("dragonboat_tpu."))
        print("EXIT", rc, "LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert "EXIT 0 LOADED []" in res.stdout, res.stdout + res.stderr
    assert "OK: no unwaived findings" in res.stdout
    # the nine passes, each with its static leg
    ran = [ln.split(":")[0].strip("= ") for ln in res.stdout.splitlines()
           if ln.startswith("== ") and "stale-waiver" not in ln]
    assert ran == ["concurrency", "determinism", "contracts", "engine-unity",
                   "safety", "transfer", "partition", "tracer-safety",
                   "op-budget"], res.stdout
