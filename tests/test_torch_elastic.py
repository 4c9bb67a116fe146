"""tpudml_torch.elastic against tpudml.elastic: the controller, the
re-planner and the fixture replays (``tests/test_elastic.py``'s cases).

Controller semantics (policy, fresh rendezvous port, budget, min_world,
re-plan consultation) are pinned with scripted subprocess children that
import nothing, and stub re-planners, so they run in seconds; the
committed fixtures (``tests/elastic_fixtures/``) replay through the real
planner with no process spawned, and their reports equal JAX's
``replay_fixture`` under JAX's hardware constants. The drills are in
``tests/test_torch_elastic_drill.py``.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpudml_torch.elastic.controller import ROUND_ENV, ElasticController  # noqa: E402
from tpudml_torch.launch.cluster import ClusterSpec  # noqa: E402

FIXTURES = Path(__file__).parent / "elastic_fixtures"
REPO = Path(__file__).resolve().parent.parent

PY = sys.executable

# A child whose behaviour is scripted per (rank, round) via the
# controller's env contract — no torch import, so each round costs ~0.1s.
_SCRIPTED = """
import os, sys, time
rank = int(os.environ["TPUDML_PROCESS_ID"])
rnd = int(os.environ[{round_env!r}])
{body}
"""


def _child(body: str) -> list[str]:
    return [PY, "-c", _SCRIPTED.format(round_env=ROUND_ENV, body=body)]


def test_reform_fresh_port_and_no_zombie_deadlock():
    """Rank 1 dies in round 0 while rank 0 would block for 300s (the
    zombie): containment must kill rank 0 promptly, and the re-form must
    rendezvous on a port never used by round 0 — within a wall-clock
    budget nowhere near the zombie's sleep."""
    cmd = _child(
        "if rnd == 0:\n"
        "    if rank == 1:\n"
        "        sys.exit(3)\n"
        "    time.sleep(300)\n"
        "sys.exit(0)\n"
    )
    spec = ClusterSpec(num_processes=2, timeout_s=60.0, grace_s=1.0)
    res = ElasticController(cmd, spec, max_reforms=2, sink=io.StringIO()).run()
    assert res.success and res.stop_reason == "success"
    assert res.reforms == 1 and len(res.records) == 2
    assert res.records[0].failed_rank == 1
    assert res.records[0].returncodes[1] == 3
    assert res.records[1].coordinator_port != res.records[0].coordinator_port
    assert res.records[1].world == 2  # restart policy refills the slot
    assert res.total_elapsed_s < 30.0  # nobody waited for the zombie


def test_shrink_policy_reforms_at_world_minus_one():
    cmd = _child(
        "if rnd == 0 and rank == 2:\n"
        "    sys.exit(4)\n"
        "sys.exit(0)\n"
    )
    spec = ClusterSpec(num_processes=3, timeout_s=60.0, grace_s=1.0)
    res = ElasticController(
        cmd, spec, policy="shrink", max_reforms=2, sink=io.StringIO()
    ).run()
    assert res.success
    assert [r.world for r in res.records] == [3, 2]
    assert res.final_world == 2


def test_shrink_respects_min_world():
    cmd = _child("sys.exit(7)\n")
    spec = ClusterSpec(num_processes=2, timeout_s=60.0, grace_s=1.0)
    res = ElasticController(
        cmd, spec, policy="shrink", min_world=2, max_reforms=3,
        sink=io.StringIO(),
    ).run()
    assert not res.success
    assert res.stop_reason == "below_min_world"
    assert len(res.records) == 1  # no re-form below the quorum


def test_budget_is_charged_across_rounds_and_backoff():
    """A backoff that would overrun the whole-job budget must stop the
    controller instead of sleeping through it."""
    cmd = _child("sys.exit(5)\n")
    spec = ClusterSpec(
        num_processes=2,
        timeout_s=2.0,
        grace_s=0.5,
        restart_backoff_s=30.0,
    )
    res = ElasticController(cmd, spec, max_reforms=3, sink=io.StringIO()).run()
    assert not res.success
    assert res.stop_reason == "budget_exhausted"
    assert len(res.records) == 1
    assert res.total_elapsed_s < 5.0  # it did NOT take the 30s backoff


def test_max_reforms_bounds_rounds():
    cmd = _child("sys.exit(9)\n")
    spec = ClusterSpec(num_processes=2, timeout_s=60.0, grace_s=0.5)
    res = ElasticController(cmd, spec, max_reforms=2, sink=io.StringIO()).run()
    assert not res.success
    assert res.stop_reason == "max_reforms"
    assert len(res.records) == 3
    ports = [r.coordinator_port for r in res.records]
    assert len(set(ports)) == len(ports)  # every round rendezvoused fresh


def test_bad_policy_rejected():
    with pytest.raises(ValueError):
        ElasticController([PY, "-c", "pass"], policy="resurrect")


# ------------------------------------------------------- port reservation


def test_fresh_port_reservation_is_bind_and_hold():
    """The fresh-port path must HOLD the socket it picked (not
    bind-close-return, which races any other process grabbing ephemeral
    ports between the close and the child's bind)."""
    from tpudml_torch.resilience.faults import occupy_port

    ctrl = ElasticController([PY, "-c", "pass"], ClusterSpec(num_processes=1))
    sock, port = ctrl._reserve_fresh_port(set())
    try:
        with pytest.raises(OSError):  # held: nobody else can take it
            occupy_port(port)
    finally:
        sock.close()
    occupy_port(port).close()  # released: bindable again


def test_pinned_port_collision_falls_back_to_fresh_port():
    """Regression for the coordinator-port race: a squatter on the
    pinned port must push the controller to a fresh port, not a
    crash-loop of bind failures."""
    from tpudml_torch.resilience.faults import occupy_port

    squat = occupy_port(0)
    try:
        port = squat.getsockname()[1]
        sink = io.StringIO()
        res = ElasticController(
            _child("sys.exit(0)\n"),
            ClusterSpec(num_processes=2, coordinator_port=port,
                        timeout_s=60.0, grace_s=1.0),
            sink=sink,
        ).run()
        assert res.success
        assert res.records[0].coordinator_port != port
        assert "falling back to a fresh port" in sink.getvalue()
    finally:
        squat.close()


# ---------------------------------------------------- re-plan consultation


class _StubReplanner:
    """Records consultations; returns a plain-dict decision (the
    controller accepts any object with .to_dict() or dict(...))."""

    def __init__(self):
        self.calls = []

    def replan(self, world, *, why="membership change", trigger="membership"):
        self.calls.append((world, why))
        return {
            "trigger": trigger, "why": why,
            "old_world": world + 1, "new_world": world,
            "old_key": "zero1[data=2]", "new_key": "dp[data=1]",
            "switched": True, "latency_s": 0.01,
            "receipts": [{"verdict": "infeasible_at_world"}],
            "calibration": None, "error": None,
        }


class _ExplodingReplanner:
    def replan(self, world, **_):
        raise RuntimeError("boom")


def test_shrink_consults_replanner_and_records_decision():
    cmd = _child(
        "if rnd == 0 and rank == 1:\n"
        "    sys.exit(4)\n"
        "sys.exit(0)\n"
    )
    rp = _StubReplanner()
    sink = io.StringIO()
    res = ElasticController(
        cmd, ClusterSpec(num_processes=2, timeout_s=60.0, grace_s=1.0),
        policy="shrink", min_world=1, max_reforms=2, replanner=rp, sink=sink,
    ).run()
    assert res.success
    assert [w for w, _ in rp.calls] == [1]
    assert "rank 1" in rp.calls[0][1]  # the membership why reaches the planner
    assert len(res.replans) == 1
    rep = res.replans[0]
    assert rep["round"] == 1 and rep["new_world"] == 1
    assert rep["switched"] and rep["error"] is None
    assert rep["receipts"][0]["verdict"] == "infeasible_at_world"
    assert "engine chain switched" in sink.getvalue()
    assert res.to_dict()["replans"] == res.replans


def test_restart_policy_does_not_consult_replanner():
    """World unchanged → no membership change → no re-plan."""
    cmd = _child(
        "if rnd == 0 and rank == 1:\n"
        "    sys.exit(4)\n"
        "sys.exit(0)\n"
    )
    rp = _StubReplanner()
    res = ElasticController(
        cmd, ClusterSpec(num_processes=2, timeout_s=60.0, grace_s=1.0),
        policy="restart", max_reforms=2, replanner=rp, sink=io.StringIO(),
    ).run()
    assert res.success and res.reforms == 1
    assert rp.calls == [] and res.replans == []


def test_replanner_failure_does_not_kill_recovery():
    """Fail-open: a planner crash during recovery is recorded and the
    re-form proceeds under the old plan."""
    cmd = _child(
        "if rnd == 0 and rank == 1:\n"
        "    sys.exit(4)\n"
        "sys.exit(0)\n"
    )
    sink = io.StringIO()
    res = ElasticController(
        cmd, ClusterSpec(num_processes=2, timeout_s=60.0, grace_s=1.0),
        policy="shrink", min_world=1, max_reforms=2,
        replanner=_ExplodingReplanner(), sink=sink,
    ).run()
    assert res.success and res.reforms == 1
    assert len(res.replans) == 1
    assert "RuntimeError: boom" in res.replans[0]["error"]
    assert "keeping the old plan" in sink.getvalue()


def test_reform_survives_straggler_rejoiner():
    """A rank that stalls while rejoining the re-formed gang delays but
    does not break the round (the launcher waits the gang out)."""
    cmd = _child(
        "if rnd == 0 and rank == 1:\n"
        "    sys.exit(3)\n"
        "if rnd == 1 and rank == 0:\n"
        "    time.sleep(1.5)\n"
        "sys.exit(0)\n"
    )
    res = ElasticController(
        cmd, ClusterSpec(num_processes=2, timeout_s=60.0, grace_s=1.0),
        max_reforms=2, sink=io.StringIO(),
    ).run()
    assert res.success and res.reforms == 1
    assert res.records[1].elapsed_s >= 1.0  # the straggle was real


def test_reform_straggler_hook_gates_on_round_and_rank(monkeypatch):
    from tpudml_torch.resilience import faults

    slept = []
    monkeypatch.setattr(faults.time, "sleep", lambda s: slept.append(s))
    monkeypatch.setenv("TPUDML_PROCESS_ID", "1")
    monkeypatch.setenv("TPUDML_ELASTIC_ROUND", "0")
    hook = faults.reform_straggler_hook(2.0, round=1, rank=1)
    hook(step=0)
    assert slept == []  # wrong round
    monkeypatch.setenv("TPUDML_ELASTIC_ROUND", "1")
    monkeypatch.setenv("TPUDML_PROCESS_ID", "0")
    hook(step=0)
    assert slept == []  # wrong rank
    monkeypatch.setenv("TPUDML_PROCESS_ID", "1")
    hook(step=0)
    hook(step=1)
    assert slept == [2.0]  # fired exactly once


# -------------------------------------------------- replanner + plan file


def test_real_replanner_fails_open_when_no_candidate_fits():
    """zero1-only lattice has no mesh at world 1: the re-plan records
    the error and keeps the old plan instead of raising mid-recovery."""
    from tpudml_torch.elastic.replan import Replanner

    rp = Replanner(engines=["zero1"], verify=False)
    rp.initial_plan(2)
    old_key = rp.winner_key
    rec = rp.replan(1, why="shrink to 1")
    assert rec.error is not None
    assert rp.winner_key == old_key  # plan unchanged
    assert rp.plan["world"] == 2


def test_vandalized_plan_degrades_to_replan_from_scratch(tmp_path):
    """Every plan vandal (torn write, garbage bytes, bad version) must
    make load_existing return None — never half-adopt a broken plan —
    and a fresh plan from scratch must still come out."""
    from tpudml_torch.elastic.replan import Replanner
    from tpudml_torch.resilience.faults import PLAN_VANDALS, vandalize_plan

    for kind in PLAN_VANDALS:
        path = tmp_path / f"{kind}.json"
        Replanner(engines=["dp", "zero1"], verify=False,
                  plan_path=path).initial_plan(2)
        vandalize_plan(str(path), kind)
        rp = Replanner(engines=["dp", "zero1"], verify=False)
        assert rp.load_existing(path) is None, kind
        assert rp.plan is None
        assert rp.initial_plan(2)["winner"]["candidate"]["key"]

    # Control: an intact plan file IS adopted.
    path = tmp_path / "intact.json"
    Replanner(engines=["dp", "zero1"], verify=False,
              plan_path=path).initial_plan(2)
    rp = Replanner(engines=["dp", "zero1"], verify=False)
    assert rp.load_existing(path)["world"] == 2


# ---------------------------------------------------------- fixture replay


def _without_latency(report: dict) -> dict:
    """A replay report with the re-plans' wall-clock latencies dropped."""
    out = json.loads(json.dumps(report))
    for r in out["replans"]:
        r.pop("latency_s")
    return out


@pytest.mark.parametrize("name", ["shrink_then_drift", "fresh"])
def test_fixture_replay_equals_jax(name):
    """Winners, receipts, calibration and counts equal JAX's report under
    JAX's constants (the latencies are wall clocks)."""
    from tpudml.elastic.replan import replay_fixture as jax_replay
    from tpudml.plan.score import DEFAULT_HARDWARE as JAX_HW

    from tpudml_torch.elastic.replan import replay_fixture
    from tpudml_torch.plan import Hardware

    path = FIXTURES / f"{name}.json"
    want = jax_replay(path)
    got = replay_fixture(path, hw=Hardware(**dataclasses.asdict(JAX_HW)))
    assert _without_latency(got) == _without_latency(want)


def test_fixture_replay_drift_fires_and_calibrates():
    """On the card's constants: membership re-plans produce receipts, the
    >10% drift event fires and folds the measured constants into the
    plan's calibration block."""
    from tpudml_torch.elastic.replan import replay_fixture

    rep = replay_fixture(FIXTURES / "shrink_then_drift.json")
    assert rep["ok"]
    assert rep["events"] == 3
    assert rep["drift_checks"] == 1 and rep["drift_firings"] == 1
    assert rep["plan_switches"] == 2  # 4→2 re-mesh, 2→1 chain switch
    drift_recs = [r for r in rep["replans"] if r["trigger"] == "drift"]
    assert len(drift_recs) == 1
    assert drift_recs[0]["calibration"]["comm_scale"] == pytest.approx(1.25)
    assert rep["final"]["calibration"]["comm_scale"] == pytest.approx(1.25)
    verdicts = [c["verdict"] for r in rep["replans"] for c in r["receipts"]]
    assert "infeasible_at_world" in verdicts
    assert "retained" in verdicts
    assert rep["final"]["engine_config"]["engine"] == "dp"


def test_fixture_replay_fresh_report_does_not_replan():
    from tpudml_torch.elastic.replan import replay_fixture

    rep = replay_fixture(FIXTURES / "fresh.json")
    assert rep["ok"]
    assert rep["drift_checks"] == 1 and rep["drift_firings"] == 0
    assert rep["replans"] == [] and rep["plan_switches"] == 0
    assert rep["final"]["calibration"] is None
    assert rep["final"]["winner"] == rep["initial"]["winner"]


def test_fixture_cli_replays_without_spawning():
    """``python -m tpudml_torch.elastic --drill --fixture ...``: one
    process, no job spawned, exit code is the replay verdict."""
    proc = subprocess.run(
        [PY, "-m", "tpudml_torch.elastic", "--drill",
         "--fixture", str(FIXTURES / "shrink_then_drift.json")],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.splitlines()[-1])
    assert report["ok"] and report["drift_firings"] == 1
    assert "[replay]" in proc.stderr  # narration goes to stderr


def test_fixture_version_gate():
    from tpudml_torch.elastic.replan import replay_fixture

    bad = dict(json.loads((FIXTURES / "fresh.json").read_text()), version=7)
    with pytest.raises(ValueError, match="fixture version"):
        replay_fixture(bad)


def test_drift_report_pure_half_equals_jax():
    """``obs/drift.py``'s records, report and table are JAX's."""
    from tpudml.obs import drift as jax_drift

    from tpudml_torch.obs import drift

    pairs = json.loads((FIXTURES / "shrink_then_drift.json").read_text())["events"][1]["pairs"]
    for thr in (0.10, 0.3):
        want = jax_drift.build_drift_report(jax_drift.drift_from_pairs(pairs), thr)
        got = drift.build_drift_report(drift.drift_from_pairs(pairs), thr)
        assert got == want
        assert drift.format_drift_table(got) == jax_drift.format_drift_table(want)
