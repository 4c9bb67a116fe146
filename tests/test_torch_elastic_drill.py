"""The elastic drills of ``tpudml_torch.elastic.drill`` on the CPU (gloo
ranks), with ``tests/test_elastic.py``'s assertions.

The shrink-re-plan drill: a 2-rank ZeRO-1 + accumulation job (the chain
the planner picks through ``--plan``), rank 1 hard-killed at step 13 →
shrink to world 1 → the planner consulted (ZeRO-1 infeasible on one
device, the receipts say so) → resume from the CRC-valid sharded
checkpoint under plain DP → final parameters AND loss history bit-exact
against an uninterrupted world-1 DP run from the same checkpoint. Its
report carries JAX's keys. The restart drill is marked slow, as JAX's
is; on the card it runs at world 1 (``chip_smoke.py``'s ``[elastic]``).
"""

import ast
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent


def _jax_report_keys(function: str) -> set:
    """The keys of the report dict JAX's drill function returns."""
    tree = ast.parse((REPO / "tpudml" / "elastic" / "drill.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret[-1].value.keys}


@pytest.fixture(scope="module")
def shrink(tmp_path_factory):
    from tpudml_torch.elastic.drill import run_shrink_drill

    base = tmp_path_factory.mktemp("shrink")
    return base, run_shrink_drill(str(base), timeout_s=300.0, device="cpu")


def test_shrink_replan_drill_e2e(shrink):
    base, report = shrink
    assert report["ok"], report
    assert report["bit_exact"]
    assert report["reforms"] == 1 and report["final_world"] == 1
    assert report["killed_rank_observed"] == 1
    assert report["old_plan"]["engine"] == "zero1"
    assert report["old_plan"]["accum_steps"] == 2
    assert report["new_plan"]["engine"] == "dp"
    assert report["plan_switched"] and report["chain_switched"]
    assert report["resume_step"] == 10 and report["steps_lost"] == 3
    assert [r["verdict"] for r in report["replan_receipts"]] == ["infeasible_at_world"]
    assert report["fresh_port"]
    assert report["replan_latency_s"] is not None
    assert report["post_shrink_steps_per_s"] > 0
    assert (base / "obs" / "elastic.json").exists()
    assert (base / "obs" / "trace_controller.json").exists()
    plan = json.loads((base / "plan.json").read_text())
    assert plan["version"] == 2
    assert plan["world"] == 1
    assert plan["engine_config"]["engine"] == "dp"
    assert plan["replan"]["trigger"] == "membership"
    assert plan["replan"]["old_winner"]["engine"] == "zero1"


def test_shrink_drill_report_has_jax_s_keys(shrink):
    assert set(shrink[1]) == _jax_report_keys("run_shrink_drill")


def test_obs_report_reads_the_drill_s_elastic_section(shrink):
    from tpudml_torch.tools.obs_report import report

    text = report(shrink[0] / "obs")
    assert "elastic.json (reform/re-plan)" in text
    assert "infeasible_at_world" in text and "elastic_replan" in text
    assert "zero1[data=2]" in text and "dp[data=1]" in text


@pytest.mark.slow
def test_drill_kill_reform_resume_bit_exact(tmp_path):
    """The restart drill: 2-rank gloo training, rank 1 hard-killed at step
    13 → the controller re-forms on a fresh port after seeded backoff →
    resume from the newest CRC-valid sharded checkpoint → final params
    bit-identical to an uninterrupted run, with one trace pid per rank."""
    from tpudml_torch.elastic.drill import run_drill

    report = run_drill(str(tmp_path), timeout_s=300.0, device="cpu")
    assert report["ok"], report
    assert set(report) == _jax_report_keys("run_drill")
    assert report["bit_exact"]
    assert report["reforms"] == 1
    assert report["killed_rank_observed"] == 1
    assert report["resume_step"] == 10
    assert report["steps_lost"] == 3
    assert report["fresh_port"]
    assert report["backoff_s"] > 0
    assert report["restart_latency_s"] > report["backoff_s"]
    assert report["trace_pids"] == [0, 1]
    assert (tmp_path / "obs" / "trace.json").exists()
