"""The port's capacity rungs and step sweep against the reference scripts.

``dragonboat_tpu_torch.scale_100k`` runs ``scripts/scale_100k.py``'s two
rungs on the port: phase A (the batched state at G groups x 3 and its
step loop) and phase B (G device-resident shards on one NodeHost).  Here
they run at 8 groups on the CPU through ``graphs.stand_in()``, so the
rungs' own capture assertions hold as on the card.  Each printed line
carries exactly the keys of the reference script's line, read from its
``json.dumps({...})`` literals with ``ast`` (the script is not imported).
The capacity model's prediction equals the measured tree bytes and the
reference ``capacity.predict_bytes`` at the same geometry.  Phase A's state
after its steps is held leaf for leaf against the reference ``run_steps``
in ``tests/test_torch_bench_loops.py``, whose process has already traced
that loop at this geometry and step count (a trace here would cost more
than this whole file).  The sweep's line is checked against the
reference's f-string.
"""

import ast
import dataclasses
import json
import os
import re

from dragonboat_tpu import bench_loop as ref_bl
from dragonboat_tpu import capacity as ref_capacity
from dragonboat_tpu.core import params as ref_params
from dragonboat_tpu_torch import graphs, scale_100k, sweep_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS, STEPS = 8, 3


def _script(name: str) -> ast.Module:
    with open(os.path.join(ROOT, "scripts", name)) as f:
        return ast.parse(f.read())


def _reference_keys() -> list[set]:
    """The key sets of the reference's ``json.dumps({...})`` literals, in
    source order (PHASE_A's, then PHASE_B's)."""
    out = []
    for node in ast.walk(_script("scale_100k.py")):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            out.append((node.lineno, {k.value for k in node.args[0].keys}))
    return [keys for _line, keys in sorted(out)]


def _printed(out: str, tag: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    assert len(lines) == 1, out
    return json.loads(lines[0][len(tag) + 1:])


def test_phase_a_line_bytes_and_capture(capsys):
    with graphs.stand_in():
        line, extra = scale_100k.phase_a(GROUPS, steps=STEPS, device="cpu")
        out = capsys.readouterr().out
        # the rung starts from an empty step cache: a second rung in the
        # same process counts its own capture, not a retrace
        again, _ = scale_100k.phase_a(GROUPS, steps=STEPS, device="cpu")
    assert (again["dispatch_compiles"], again["dispatch_retraces"]) == (1, 0)
    assert extra["steps"] == STEPS and extra["capture_peak_bytes"] is None
    assert len(extra["capture_s"]) == 1
    assert "SCALE graphs: captured in this process" in out
    assert _printed(out, "PHASE_A") == line
    assert set(line) == _reference_keys()[0]
    kp_ref = ref_bl.bench_params(3)
    lanes = GROUPS * 3
    ref_pred = ref_capacity.predict_bytes(kp_ref, lanes, ("ShardState", "Inbox"))
    assert line["predicted_bytes"] == line["measured_bytes"] == ref_pred
    assert (line["groups"], line["lanes"], line["platform"]) == (GROUPS, lanes, "cpu")
    assert line["dispatch_compiles"] == 1 and line["dispatch_retraces"] == 0


def test_phase_b_line_leaders_commits_and_capture(capsys):
    with graphs.stand_in():
        line, extra = scale_100k.phase_b(GROUPS, device="cpu")
    out = capsys.readouterr().out
    assert _printed(out, "PHASE_B") == line
    assert set(line) == _reference_keys()[1]
    assert line["shards"] == line["leaders"] == GROUPS
    assert line["proposals_queued"] == GROUPS  # shards 1..8 of the wave's 1000
    assert line["committed_total"] == 2 * line["shards"] + line["proposals_queued"]
    assert (line["dispatch_entry"], line["dispatch_compiles"],
            line["dispatch_retraces"]) == ("step", 1, 0)
    assert line["election_pump_rounds"] == len(extra["pump_step_s"]) <= 40
    # the engine's resident classes at its geometry, in the reference model
    kp_ref = ref_params.KernelParams(**dataclasses.asdict(extra["kp"]))
    ref_pred = ref_capacity.predict_bytes(
        kp_ref, GROUPS, ("ShardState", "HealthDigest", "InvariantDigest"))
    assert line["predicted_bytes"] == line["measured_bytes"] == ref_pred


def _sweep_pattern() -> re.Pattern:
    """The reference sweep's printed line as a regex: its f-string's
    literal parts, each formatted value a field."""
    for node in ast.walk(_script("sweep_step.py")):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "print"
                and node.args and isinstance(node.args[0], ast.JoinedStr)
                and "step_ms=" in ast.unparse(node.args[0])):
            parts = [re.escape(v.value) if isinstance(v, ast.Constant)
                     else r"\s*([0-9.,]+)\s*" for v in node.args[0].values]
            return re.compile("^" + "".join(parts) + "$")
    raise AssertionError("no step_ms line in scripts/sweep_step.py")


def test_sweep_line_fields_at_two_groups(capsys):
    rows = sweep_step.sweep(quick=True, device="cpu", groups=2, steps=STEPS)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "backend: cpu" and len(out) == 2 == len(rows) + 1
    m = _sweep_pattern().match(out[1])
    assert m, out[1]
    g, cap, k, e, b, step_ms, wps, elect_s, leaders = m.groups()
    base = sweep_step.BASE
    assert (int(g), int(cap), int(k), int(e), int(b)) == (
        2, base["cap"], base["k"], base["e"], base["b"])
    assert int(leaders) == 2 == rows[0]["leaders"]
    assert float(step_ms) > 0 and float(elect_s) >= 0
    assert int(wps.replace(",", "")) == round(rows[0]["writes_per_s"])
