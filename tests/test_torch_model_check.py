"""The port's small-scope model checker (``dragonboat_tpu_torch.model_check``)
against the reference's ``scripts/model_check.py``, on the CPU.

The transition relation is the port's real step; the reference checker
(loaded from its file, as ``tests/test_model_check.py`` loads it) runs
the JAX step over the same scope.  At the fast scope both must explore
the same state set (the same blake2b state keys, so every state's bytes
are equal), the same number of states and transitions, and find no
violation; the seeded mutations each must be caught by the property the
reference test names.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import pytest
import torch

from dragonboat_tpu_torch import model_check as mc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the seeded bugs the port's static safety pass owns, by rule (the
#: reference's tests/test_safety.py STATIC_OWNER)
STATIC_OWNER = {
    "skip_vote_persist": "RS003",
    "commit_without_quorum": "RS002",
    "truncate_committed": "RS004",
}


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "model_check_reference_for_port",
        os.path.join(REPO, "scripts", "model_check.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


ref_mc = _load_reference()


@pytest.fixture(scope="module")
def fast_scope():
    # the step's tensors are a few rows: one thread is faster, and leaves
    # the other test workers their cores
    torch.set_num_threads(1)
    port = mc.ModelChecker(scope="fast", device="cpu")
    ref = ref_mc.ModelChecker(scope="fast")
    return port, port.run(), ref, ref.run()


def test_fast_scope_clean_on_port_step(fast_scope):
    port, res, _, _ = fast_scope
    assert res["violations"] == [], res["violations"]
    assert res["scope_complete"]
    assert res["states_explored"] >= 100
    assert res["transitions"] >= res["states_explored"] // 2
    assert set(res["properties"]) >= {
        "election_safety", "leader_append_only", "log_matching",
        "leader_completeness", "state_machine_safety"}
    # the batched step: far fewer step calls than transitions
    assert 0 < res["step_calls"] < res["transitions"] // 4


def test_fast_scope_explores_the_reference_state_set(fast_scope):
    port, res, ref, want = fast_scope
    assert port._seen == ref._seen
    for key in ("states_explored", "transitions", "net_overflow",
                "frontier_exhausted", "scope_complete", "properties"):
        assert res[key] == want[key], key


@pytest.mark.parametrize("mutation,expect", [
    ("double_vote", "vote_once_per_term"),
    ("commit_without_quorum", "leader_commit_quorum"),
])
def test_checker_catches_mutation(mutation, expect):
    res = mc.run_scope("fast", mutation=mutation, device="cpu")
    assert res["violations"], f"{mutation} escaped the fast scope"
    names = " ".join(v["property"] for v in res["violations"])
    assert expect in names, (mutation, res["violations"][:3])
    assert res["violations"][0]["trail"]


def test_quiesce_scope_clean_and_catches_masked_campaign():
    res = mc.run_scope("quiesce", device="cpu")
    assert res["violations"] == [], res["violations"]
    assert res["scope_complete"]
    assert {"invariant:quiesced_no_campaign",
            "invariant:quiesced_no_vote"} <= set(res["properties"])

    mut = mc.run_scope("quiesce", mutation="quiesce_campaigns", device="cpu")
    assert mut["violations"], "quiesce_campaigns escaped the quiesce scope"
    names = " ".join(v["property"] for v in mut["violations"])
    assert "quiesced_no_campaign" in names, mut["violations"][:3]
    assert mut["violations"][0]["trail"]


def test_mutations_are_the_reference_catalogue():
    assert mc.MUTATIONS == ref_mc.MUTATIONS
    assert (mc.KP_SCOPE, mc.SCOPES) == (ref_mc.KP_SCOPE, ref_mc.SCOPES)


def test_mutation_snippets_track_port_kernel_source():
    assert mc.KERNEL_FILE == os.path.join("dragonboat_tpu_torch", "core",
                                          "kernel.py")
    with open(os.path.join(REPO, mc.KERNEL_FILE), encoding="utf-8") as f:
        src = f.read()
    for name, (find, replace) in mc.MUTATIONS.items():
        assert src.count(find) == 1, f"mutation {name!r} target drifted"
        assert find != replace
        mod = mc.load_kernel_module(name)
        assert mod.__name__ == f"dragonboat_tpu_torch.core.kernel__mut_{name}"
        assert mod.step is not mc.load_kernel_step()


def test_drifted_snippet_raises(monkeypatch):
    monkeypatch.setitem(mc.MUTATIONS, "double_vote",
                        ("nonexistent snippet", "x"))
    with pytest.raises(RuntimeError, match="double_vote"):
        mc.load_kernel_module("double_vote")


def test_every_seeded_bug_is_caught_by_a_port_leg_or_named():
    """The model checker owns double_vote and quiesce_campaigns and
    catches commit_without_quorum, which the runtime probe also catches
    (tests/test_torch_chaos.py); the port's static safety pass owns
    skip_vote_persist, commit_without_quorum and truncate_committed, as
    the reference's does."""
    from tests.test_safety import STATIC_OWNER as REF_STATIC_OWNER

    checker_owned = {"double_vote", "quiesce_campaigns", "commit_without_quorum"}
    probe_owned = {"commit_without_quorum"}
    assert set(mc.MUTATIONS) == checker_owned | probe_owned | set(STATIC_OWNER)
    assert STATIC_OWNER == REF_STATIC_OWNER


@pytest.mark.parametrize("mutation", sorted(STATIC_OWNER))
def test_static_rule_catches_mutation(tmp_path, mutation):
    """The port's own find/replace pair applied to a copy of the port's
    kernel is caught by the rule that owns it."""
    from dragonboat_tpu_torch.analysis import safety

    find, replace = mc.MUTATIONS[mutation]
    core = tmp_path / "dragonboat_tpu_torch" / "core"
    core.mkdir(parents=True)
    for name in ("kstate.py", "kernel.py"):
        with open(os.path.join(REPO, "dragonboat_tpu_torch", "core", name),
                  encoding="utf-8") as f:
            src = f.read()
        if name == "kernel.py":
            assert src.count(find) == 1
            src = src.replace(find, replace)
        (core / name).write_text(src)
    rules = {f.rule for f in safety.run(str(tmp_path), dynamic=False)}
    assert rules == {STATIC_OWNER[mutation]}, (mutation, rules)


def test_cli_on_cpu(capsys):
    assert mc.main(["--scope", "quiesce", "--device", "cpu"]) == 0
    assert "CLEAN" in capsys.readouterr().out
