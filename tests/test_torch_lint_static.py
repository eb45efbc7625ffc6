"""The static half of the port's analysis layer, on the CPU.

``tracer_safety`` (TS001-TS004 in the scope a CUDA graph captures), the
contracts interpreter (KC001-KC006 over ``core/kernel.py``), the
partition pass's static walk (PS001, PS003, PS006) and the op budget
(``analysis/op_budget.py``).  Each rule fires on a bad port-style fixture
and not on its repaired twin; the reference's own fixtures
(``tests/test_analysis.py``, ``tests/test_partition.py``) run through the
reference's pass and their torch translations through the port's find
the same rule ids; the op budget gates, reports a missing file, and
counts the same ops at two group counts.  The passes being clean on the
port is ``tests/test_torch_analysis.py``'s.
"""

import collections
import importlib.util
import json
import os
import shutil
import textwrap

import pytest

from dragonboat_tpu_torch.analysis import (
    contracts,
    op_budget,
    partition,
    tracer_safety,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return str(p)


def _load_reference_tests(name):
    """A reference test module's fixture constants (loaded by path; none
    of its tests is collected through this)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ tracer-safety

_TS_HEAD = """\
    import time

    import numpy as np
    import torch

    from dragonboat_tpu_torch import graphs

"""

#: rule -> (bad body, repaired body) of ``_body(kp, x, now)``, captured
#: by ``graphs.compiled(_body, static_argnums=(0,))``
TS_FIXTURES = {
    "TS001": ("""\
        if x.sum() > 0:
            x = x + 1
        return x
    """, """\
        return torch.where(x.sum() > 0, x + 1, x)
    """),
    "TS002": ("""\
        n = int(x.max())
        return x + n
    """, """\
        n = int(x.shape[0])
        return x + n
    """),
    "TS003": ("""\
        return x[x > 0]
    """, """\
        return torch.where(x > 0, x, 0)
    """),
    "TS004": ("""\
        return x + int(time.monotonic())
    """, """\
        return x + now
    """),
}


def _ts_source(body):
    return (textwrap.dedent(_TS_HEAD)
            + "def _body(kp, x, now):\n"
            + textwrap.indent(textwrap.dedent(body), "    ")
            + "\n\nentry = graphs.compiled(_body, static_argnums=(0,))\n")


@pytest.mark.parametrize("rule", sorted(TS_FIXTURES))
def test_tracer_safety_rule_fires_on_bad_and_not_on_twin(tmp_path, rule):
    bad, good = TS_FIXTURES[rule]
    p = _write(tmp_path, "bad.py", _ts_source(bad))
    assert rule in {f.rule for f in tracer_safety.run(str(tmp_path),
                                                      files=[p])}
    p = _write(tmp_path, "good.py", _ts_source(good))
    assert tracer_safety.run(str(tmp_path), files=[p]) == []


def test_tracer_safety_sees_the_torch_syncs_and_rng(tmp_path):
    p = _write(tmp_path, "sync.py", _ts_source("""\
        a = x.cpu()
        b = x.to("cpu")
        torch.cuda.synchronize()
        c = torch.masked_select(x, x > 0)
        d = torch.rand(3)
        e = torch.rand(3, generator=kp.gen)
        return x
    """))
    got = [(f.line, f.rule) for f in tracer_safety.run(str(tmp_path),
                                                       files=[p])]
    body = 9    # the line of ``a = x.cpu()``
    assert got == [(body, "TS003"), (body + 1, "TS003"), (body + 2, "TS003"),
                   (body + 3, "TS003"), (body + 4, "TS004")]


def test_tracer_safety_kernel_wrapper_is_clean_by_construction(tmp_path):
    """A wrapper's arm choice (``use_kernel``, the tensors' devices) and
    its ctypes launch (``data_ptr``) are not device reads; a wrapper
    reached from a captured body stays clean with no waiver."""
    p = _write(tmp_path, "wrap.py", """\
        import torch

        from dragonboat_tpu_torch import graphs, kernels


        def pick_plain(vals, idx):
            return torch.gather(vals, 1, idx.long())


        def pick(vals, idx):
            if not kernels.use_kernel(vals, idx):
                return pick_plain(vals, idx)
            G, K = vals.shape
            out = torch.empty((G, idx.shape[1]), dtype=torch.int32,
                              device=vals.device)
            if G == 0:
                return out
            with kernels.on(vals.device):
                rc = kernels.library().dbt_gather_lanes(
                    vals.data_ptr(), idx.data_ptr(), out.data_ptr(), G, K,
                    idx.shape[1], kernels.stream_ptr(vals.device))
            kernels.check_launch(rc, "gather_lanes")
            return out


        def _reset(s, mask, reset_timeout):
            if not isinstance(reset_timeout, torch.Tensor):
                reset_timeout = torch.full_like(mask, bool(reset_timeout))
            return pick(s, mask) & reset_timeout


        step = graphs.compiled(_reset, static_argnums=())
    """)
    assert tracer_safety.run(str(tmp_path), files=[p]) == []


#: case -> (captured module, rules found): a static argument of the entry
#: carried into the helpers it calls, and what breaks the carry
TS_CARRY = {
    # ``tick`` is static at the entry and passed on by name, by keyword
    # and through a recursive call: every branch on it is a host branch
    "carried": ("""\
        def _flags(x, tick, n=1):
            if isinstance(x, tuple):
                return tuple(_flags(y, tick) for y in x)
            if tick and x.dim() < n + 1:
                x = x + 1
            return x & bool(tick)


        def _body(kp, tick, x):
            return _flags(x, tick=tick)


        entry = graphs.compiled(_body, static_argnums=(0, 1))
    """, []),
    # the entry leaves ``tick`` a tensor: the helper's branch is TS001
    "tensor_at_entry": ("""\
        def _flags(x, tick):
            if tick:
                x = x + 1
            return x


        def _body(kp, tick, x):
            return _flags(x, tick)


        entry = graphs.compiled(_body, static_argnums=(0,))
    """, ["TS001"]),
    # one captured call of two passes a device value: not carried
    "tensor_at_one_site": ("""\
        def _flags(x, tick):
            return x & bool(tick)


        def _body(kp, tick, x):
            return _flags(x, tick) | _flags(x, x.any())


        entry = graphs.compiled(_body, static_argnums=(0, 1))
    """, ["TS002"]),
    # a helper passed on as a value: its calls are not seen, so nothing
    # is carried into it
    "passed_as_value": ("""\
        def _flags(x, tick):
            if tick:
                x = x + 1
            return x


        def _body(kp, tick, x):
            return torch.vmap(_flags)(x, tick)


        entry = graphs.compiled(_body, static_argnums=(0, 1))
    """, ["TS001"]),
}


@pytest.mark.parametrize("case", sorted(TS_CARRY))
def test_tracer_safety_carries_static_arguments_into_helpers(tmp_path,
                                                             case):
    body, rules = TS_CARRY[case]
    p = _write(tmp_path, "carry.py", textwrap.dedent(_TS_HEAD)
               + textwrap.dedent(body))
    assert [f.rule for f in tracer_safety.run(str(tmp_path),
                                              files=[p])] == rules


def test_tracer_safety_host_function_not_flagged(tmp_path):
    # host-side code may branch on values freely — only captured scope
    p = _write(tmp_path, "host.py", """\
        def host_only(x):
            if x.sum() > 0:
                return int(x.max())
            return 0
    """)
    assert tracer_safety.run(str(tmp_path), files=[p]) == []


# ------------------------------------------------------------- contracts

_KC_HEAD = """\
    import torch

    from dragonboat_tpu_torch import graphs

    FOLLOWER = 0
    WITNESS = 5

    CONTRACTS = {
        "St": {
            "role": "[G] i32 domain=FOLLOWER..WITNESS",
            "match": "[G, P] i32",
            "lt": "[G, CAP] i32 ring",
            "flag": "[G] bool",
            "cnt": "[G] i32",
        },
    }

"""

#: rule -> (bad body, repaired body) of ``_body(kp, s: St, idx, u)``
KC_FIXTURES = {
    "KC001": ("""\
        k = torch.arange(kp.inbox_cap, dtype=torch.int32)
        e = torch.arange(kp.msg_entries, dtype=torch.int32)
        return k + e
    """, """\
        k = torch.arange(kp.inbox_cap, dtype=torch.int32)
        e = torch.arange(kp.msg_entries, dtype=torch.int32)
        return k[:, None] + e[None, :]
    """),
    "KC002": ("""\
        return s.match.sum(dim=1)
    """, """\
        return s.match.sum(dim=1, dtype=torch.int32)
    """),
    "KC003": ("""\
        return s.flag == s.role
    """, """\
        return s.flag == (s.role == FOLLOWER)
    """),
    "KC004": ("""\
        return s.lt[:, idx]
    """, """\
        return s.lt[:, idx & (kp.log_cap - 1)]
    """),
    "KC005": ("""\
        return s._replace(role=torch.full_like(s.role, 9))
    """, """\
        return s._replace(role=torch.full_like(s.role, WITNESS))
    """),
    "KC006": ("""\
        return s._replace(match=s.flag)
    """, """\
        return mrep(s, s.flag, match=0)
    """),
}

#: KC002 in its torch spellings: (bad body, repaired body)
KC002_SPELLINGS = {
    "cumsum_no_dtype": ("""\
        return torch.cumsum(s.flag, dim=0)
    """, """\
        return torch.cumsum(s.flag, dim=0, dtype=torch.int32)
    """),
    "arange_int64_with_i32": ("""\
        lanes = torch.arange(kp.num_peers)
        return s.match + lanes[None, :]
    """, """\
        lanes = torch.arange(kp.num_peers, dtype=torch.int32)
        return s.match + lanes[None, :]
    """),
    "int_true_division": ("""\
        return s.cnt / 2
    """, """\
        return s.cnt // 2
    """),
    "python_float_with_int": ("""\
        return s.cnt * 0.5
    """, """\
        return s.cnt >> 1
    """),
    "uint32_arithmetic": ("""\
        return s.cnt.to(torch.uint32) + 1
    """, """\
        return (s.cnt.to(torch.int64) + 1) & 0xFFFFFFFF
    """),
    "bool_arithmetic": ("""\
        return s.flag + 1
    """, """\
        return s.flag.to(torch.int32) + 1
    """),
}


def _kc_source(body):
    return (textwrap.dedent(_KC_HEAD)
            + "def _body(kp, s: St, idx, u):\n"
            + textwrap.indent(textwrap.dedent(body), "    ")
            + "\n\nentry = graphs.compiled(_body, static_argnums=(0,))\n")


def _kc_rules(tmp_path, name, body):
    p = _write(tmp_path, name, _kc_source(body))
    return [f.rule for f in contracts.run(str(tmp_path), files=[p])]


@pytest.mark.parametrize("rule", sorted(KC_FIXTURES))
def test_contracts_rule_fires_on_bad_and_not_on_twin(tmp_path, rule):
    bad, good = KC_FIXTURES[rule]
    assert rule in _kc_rules(tmp_path, "bad.py", bad)
    assert _kc_rules(tmp_path, "good.py", good) == []


@pytest.mark.parametrize("spelling", sorted(KC002_SPELLINGS))
def test_contracts_kc002_torch_spellings(tmp_path, spelling):
    bad, good = KC002_SPELLINGS[spelling]
    assert _kc_rules(tmp_path, "bad.py", bad) == ["KC002"]
    assert _kc_rules(tmp_path, "good.py", good) == []


def test_contracts_leading_alignment_is_licensed(tmp_path):
    """``sel`` / ``mrep`` align a [G] mask or value on the shard axis
    (the reference's per-shard scalar under vmap); the same [G] operand
    meeting [G, P] through torch's trailing broadcast is KC001."""
    assert _kc_rules(tmp_path, "lead.py", """\
        m = sel(s.flag, s.role, 0)
        return mrep(s, s.flag, match=sel(s.flag, s.cnt, s.match))
    """) == []
    assert _kc_rules(tmp_path, "trail.py", """\
        return torch.where(s.flag, s.cnt, s.match)
    """) == ["KC001"]


# ------------------------------------------------------------- partition

#: rule -> (bad source, repaired source), each a whole fixture module
PS_FIXTURES = {
    "PS001": ("""\
        CONTRACTS = {"ShardState": {"term": "[G] i32 part=G"}}

        def bad_total(state: ShardState):
            return state.term.max(dim=0).values
    """, """\
        CONTRACTS = {
            "ShardState": {"term": "[G] i32 part=G",
                           "match": "[G, P] i32 part=G"},
            "Stats": {"total": "[] i32 part=replicated collective=declared"},
        }

        def ok_total(state: ShardState):
            per_row = state.match.max(dim=1).values
            return Stats(total=state.term.max(dim=0).values), per_row
    """),
    "PS003": ("""\
        import torch.distributed._functional_collectives as funcol

        CONTRACTS = {"ShardState": {"term": "[G] i32 part=G"}}

        def bad_mix(state: ShardState, group):
            total = funcol.all_reduce(state.term, "sum", group)
            return state.term + total
    """, """\
        import torch.distributed._functional_collectives as funcol

        CONTRACTS = {"ShardState": {"term": "[G] i32 part=G"}}

        def ok_mix(state: ShardState, group):
            total = funcol.all_reduce(state.term, "sum", group)
            return state.term + total.expand(state.term.shape)
    """),
    "PS006": ("""\
        def write_rows(state, rows, value):
            n = int(state.term.shape[0])
            if bool(state.term[rows % n]):
                return state
            return put_rows(state, rows, value)
    """, """\
        def write_rows(state, rows, value):
            n = int(state.term.shape[0])
            return put_rows(state, rows % n, value)
    """),
}


def _ps_rules(tmp_path, name, src):
    p = _write(tmp_path, name, src)
    return [f.rule for f in partition.run(str(tmp_path), files=[p],
                                          dynamic=False)]


@pytest.mark.parametrize("rule", sorted(PS_FIXTURES))
def test_partition_rule_fires_on_bad_and_not_on_twin(tmp_path, rule):
    bad, good = PS_FIXTURES[rule]
    assert _ps_rules(tmp_path, "bad.py", bad) == [rule]
    assert _ps_rules(tmp_path, "good.py", good) == []


def test_partition_ps006_defers_to_tb005_over_the_engine_files(tmp_path):
    """The reference's PS006 fixture placed in an engine file is the
    transfer pass's TB005 and not PS006: no line under two ids."""
    from dragonboat_tpu_torch.analysis import transfer

    assert not set(transfer.ENGINE_FILES) & set(
        partition.DEFAULT_PARALLEL_FILES)
    rel = transfer.ENGINE_FILES[0]
    (tmp_path / os.path.dirname(rel)).mkdir(parents=True)
    p = _write(tmp_path, rel, PORT_TRANSLATIONS[
        ("test_partition", "PS006_BAD")][1])
    assert partition.run(str(tmp_path), dynamic=False) == []
    tb = [f for f in transfer.run(str(tmp_path), files=[p], dynamic=False)
          if f.rule == "TB005"]
    assert [f.line for f in tb] == [4]


# ---------------------------------------------- held against the reference

#: the reference's fixture (test module, constant) -> its torch
#: translation, run through the reference's pass and the port's
PORT_TRANSLATIONS = {
    ("test_analysis", "BAD_TRACED"): ("tracer-safety", """\
        import time

        import numpy as np
        import torch

        from dragonboat_tpu_torch import graphs


        def _bad(x):
            if x > 0:                    # TS001: python branch on device
                x = x + 1
            while x > 0:                 # TS001: python loop on device
                x = x - 1
            y = int(x)                   # TS002: host coercion
            z = x.item()                 # TS002: host read
            w = np.asarray(x)            # TS003: host materialization
            t = time.time()              # TS004: wall clock under capture
            return helper(x)


        def helper(x):
            return float(x)              # TS002, reached through the call graph


        bad = graphs.compiled(_bad)
    """),
    ("test_analysis", "CONTRACT_FIXTURE"): ("contracts", (
        textwrap.dedent(_KC_HEAD) + "".join(
            f"def {fn}(kp, s: St, idx, u):\n"
            + textwrap.indent(textwrap.dedent(body), "    ")
            + f"\n\n{fn}_entry = graphs.compiled({fn}, static_argnums=(0,))"
              "\n\n\n"
            for fn, body in (
                ("bad_broadcast", KC_FIXTURES["KC001"][0]),
                ("bad_upcast", """\
                    x = s.match.to(torch.float32)
                    return x + s.match
                 """),
                ("bad_cmp", KC_FIXTURES["KC003"][0]),
                ("bad_ring", KC_FIXTURES["KC004"][0]),
                ("ok_ring", KC_FIXTURES["KC004"][1]),
                ("bad_domain", KC_FIXTURES["KC005"][0]),
                ("bad_store", KC_FIXTURES["KC006"][0]),
            )))),
    ("test_partition", "PS001_BAD"): ("partition", """\
        CONTRACTS = {"ShardState": {"term": "[G] i32 part=G"}}

        def bad_total(state: ShardState):
            return state.term.sum()
    """),
    ("test_partition", "PS001_DECLARED"): ("partition", """\
        CONTRACTS = {
            "ShardState": {"term": "[G] i32 part=G"},
            "Stats": {"total": "[] i32 part=replicated collective=declared"},
        }

        def ok_total(state: ShardState):
            return Stats(total=state.term.sum())
    """),
    ("test_partition", "PS003_BAD"): ("partition", PS_FIXTURES["PS003"][0]),
    ("test_partition", "PS003_OK"): ("partition", PS_FIXTURES["PS003"][1]),
    ("test_partition", "PS006_BAD"): ("partition", """\
        class Eng:
            def step_all(self):
                state, out = self._kernel_call(None, None)
                return int(state.term[0])
    """),
    ("test_partition", "PS006_OK"): ("partition", """\
        class Eng:
            def step_all(self):
                state, out = self._kernel_call(None, None)
                self.state = state
                return out
    """),
}


def _rule_counts(findings):
    return sorted(collections.Counter(f.rule for f in findings).items())


def _reference_pass(name):
    from dragonboat_tpu.analysis import contracts as ref_contracts
    from dragonboat_tpu.analysis import partition as ref_partition
    from dragonboat_tpu.analysis import tracer_safety as ref_tracer_safety

    return {
        "tracer-safety": lambda root, p: ref_tracer_safety.run(root, [p]),
        "contracts": lambda root, p: ref_contracts.run(root, [p]),
        "partition": lambda root, p: ref_partition.run(root, [p],
                                                       dynamic=False),
    }[name]


_PORT_PASS = {
    "tracer-safety": lambda root, p: tracer_safety.run(root, [p]),
    "contracts": lambda root, p: contracts.run(root, [p]),
    "partition": lambda root, p: partition.run(root, [p], dynamic=False),
}


@pytest.mark.parametrize("module,fixture", sorted(PORT_TRANSLATIONS))
def test_port_pass_finds_the_reference_rule_ids(tmp_path, module, fixture):
    name, translated = PORT_TRANSLATIONS[(module, fixture)]
    ref_src = getattr(_load_reference_tests(module), fixture)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_found = _reference_pass(name)(
        str(tmp_path / "ref"), _write(tmp_path / "ref", "fix.py", ref_src))
    port_found = _PORT_PASS[name](
        str(tmp_path / "port"),
        _write(tmp_path / "port", "fix.py", translated))
    assert _rule_counts(port_found) == _rule_counts(ref_found), (
        [f.format() for f in ref_found], [f.format() for f in port_found])


# ------------------------------------------------------------- op budget


def test_op_budget_counts_do_not_depend_on_g():
    """The gate measures at a small G because the counts are the step's
    op count, not its size: two group counts give the same counts, and
    the sync class is 0."""
    got = {}
    for groups in (2, 5):
        cfg = {e: dict(c, groups=groups)
               for e, c in op_budget.DEFAULT_CONFIG.items()}
        got[groups] = op_budget.measure_all(cfg)
    assert got[2] == got[5]
    for entry in op_budget.ENTRIES:
        assert got[2][entry]["sync"] == 0
        assert got[2][entry]["kernels"]["quorum_match"] > 0
        assert got[2][entry]["kernels"]["gather_lanes"] > 0
    # the checked-in budget holds the port as it stands
    spec = op_budget.load_budget(os.path.join(REPO, op_budget.BUDGET_FILE))
    assert op_budget.run(REPO, measured=got[2]) == []
    for entry in op_budget.ENTRIES:
        assert {c: got[2][entry][c] for c in op_budget.CLASSES} \
            == spec["budget"][entry]


def test_op_budget_fails_when_exceeded_and_reports_a_missing_file(tmp_path):
    spec = op_budget.load_budget(os.path.join(REPO, op_budget.BUDGET_FILE))
    within = {e: dict(spec["budget"][e]) for e in op_budget.ENTRIES}
    assert op_budget.run(REPO, measured=within) == []
    over = {e: dict(b) for e, b in within.items()}
    over["run_steps"]["total"] += 1
    over["serve_step"]["sync"] = 1
    found = op_budget.run(REPO, measured=over)
    assert sorted(f.rule for f in found) == ["OB001", "OB001"]
    assert any("[serve_step] sync" in f.message for f in found)
    missing = op_budget.run(str(tmp_path), measured=within)
    assert [f.rule for f in missing] == ["OB000"]


def test_op_budget_cache_is_keyed_by_sources_and_torch(tmp_path,
                                                       monkeypatch):
    import torch

    key = op_budget.source_hash(REPO, op_budget.DEFAULT_CONFIG)
    os.makedirs(tmp_path / "dragonboat_tpu_torch" / "analysis")
    op_budget._cache_store(str(tmp_path), key, {"run_steps": {"total": 1}})
    assert op_budget._cache_load(str(tmp_path), key) == {
        "run_steps": {"total": 1}}
    monkeypatch.setattr(torch, "__version__", "0.0.0-test")
    assert op_budget._cache_load(
        str(tmp_path),
        op_budget.source_hash(REPO, op_budget.DEFAULT_CONFIG)) is None
    with open(tmp_path / op_budget.CACHE_FILE, encoding="utf-8") as f:
        assert json.load(f)["source_hash"] == key
    monkeypatch.undo()
    # every module of the package is in the key, not only the step's own:
    # the counted bodies import kernels.py, devices.py, raftpb.py and more
    tree = tmp_path / "tree"
    shutil.copytree(os.path.join(REPO, op_budget.CACHE_PACKAGE),
                    tree / op_budget.CACHE_PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = op_budget.source_hash(str(tree), op_budget.DEFAULT_CONFIG)
    assert before == key
    with open(tree / op_budget.CACHE_PACKAGE / "kernels.py", "a",
              encoding="utf-8") as f:
        f.write("\n# edited\n")
    assert op_budget.source_hash(str(tree), op_budget.DEFAULT_CONFIG) \
        != before
