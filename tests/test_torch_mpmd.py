"""``tpudml_torch.mpmd``'s topology, re-mesh bookkeeping, controller files
and the meshless fixture replay against ``tpudml.mpmd`` (the cases of
``tests/test_mpmd.py``), with no process spawned but the CLI's.

- every spec the cases build validates or fails as JAX's does (the same
  exception type and message), and its slots, row intervals, boundary
  plans, warm-up depths, shrinks and drain orders equal JAX's field by
  field;
- the capability rejections fire at the same keys with the table's
  messages;
- the wiring document, the drain markers and the common resume step
  behave as JAX's;
- both committed fixtures replay to their golden CRCs bitwise under JAX's
  planner constants (taken from ``tpudml``), twice, with JAX's event
  lines; the replay's default is the card's constants, under which
  ``steady.json`` still does and ``shrink_stage.json``'s re-plan names
  the other winner (a defined difference, pinned here);
- the quorum halt, the fresh ports per re-form, the vandalized plan and
  the version gate, and the ``--fixture`` CLI's verdicts.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import tpudml.mpmd as jm  # noqa: E402
from tpudml.capabilities import TABLE as JAX_TABLE  # noqa: E402
from tpudml.capabilities import CompositionError as JaxCompositionError  # noqa: E402

import tpudml_torch.mpmd as pm  # noqa: E402
from tpudml_torch.capabilities import TABLE, CompositionError  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "mpmd_fixtures"
PY = sys.executable

#: (stage kwargs, ...), global_batch, serve — the specs of tests/test_mpmd.py
#: and a few more shapes: dp 1..3, microbatches 1..4, 1..3 stages.
SPECS = {
    "drill": ((dict(name="trunk", dp=2, microbatches=2, dtype="bfloat16"),
               dict(name="head", dp=2, microbatches=1, dtype="float32")), 8, False),
    "hetero_4_2": ((dict(name="trunk", microbatches=4), dict(name="head", microbatches=2)),
                   8, False),
    "homog_3": ((dict(name="a", microbatches=4), dict(name="b", microbatches=4),
                 dict(name="c", microbatches=4)), 8, False),
    "three_stage": ((dict(name="s0", dp=2, microbatches=2, dtype="bfloat16"),
                     dict(name="s1", dp=2, microbatches=2, dtype="bfloat16"),
                     dict(name="s2", dp=2, microbatches=1, dtype="float32")), 8, False),
    "dp3_mb3": ((dict(name="trunk", dp=3, microbatches=3), dict(name="head", dp=1)),
                9, False),
    "quorum": ((dict(name="trunk", dp=2, microbatches=2, min_world=2),
                dict(name="head", dp=2)), 8, False),
    "wide": ((dict(name="a", dp=2, microbatches=3), dict(name="b", dp=3, microbatches=2),
              dict(name="c", dp=1, microbatches=4)), 24, False),
    "one_stage": ((dict(name="only", dp=2, microbatches=2),), 8, False),
}
BAD_SPECS = {
    "duplicate_names": ((dict(name="a"), dict(name="a")), 8, False),
    "not_divisible": ((dict(name="a", microbatches=3),), 8, False),
    "dp_rows": ((dict(name="a", dp=3, microbatches=2),), 8, False),
    "min_world": ((dict(name="a", dp=2, min_world=3),), 8, False),
    "no_stage": ((), 8, False),
    "zero_batch": ((dict(name="a"),), 0, False),
    "moe": ((dict(name="a", moe_experts=4), dict(name="b")), 8, False),
    "fused_xent": ((dict(name="a", fused_xent=True), dict(name="b")), 8, False),
    "serve": ((dict(name="trunk", dp=2, microbatches=2), dict(name="head", dp=2)), 8, True),
}


def _build(mod, case):
    stages, gb, serve = case
    return mod.PipelineSpec(stages=tuple(mod.StageSpec(**kw) for kw in stages),
                            global_batch=gb, serve=serve)


def _fields(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_layout_plans_and_warmup_are_jax_s(name):
    js, ps = _build(jm, SPECS[name]), _build(pm, SPECS[name])
    assert ps.to_dict() == js.to_dict()
    assert pm.PipelineSpec.from_dict(js.to_dict()) == ps
    assert pm.PipelineSpec.from_dict(json.loads(json.dumps(ps.to_dict()))) == ps
    assert ps.total_slots == js.total_slots
    for s, st in enumerate(ps.stages):
        assert list(ps.stage_slots(s)) == list(js.stage_slots(s))
        assert ps.rows_per_rank(s) == js.rows_per_rank(s)
        assert pm.warmup_microbatches(ps, s) == jm.warmup_microbatches(js, s)
        for i in range(st.microbatches):
            for r in range(st.dp):
                assert ps.row_interval(s, i, r) == js.row_interval(s, i, r)
    assert [ps.locate(k) for k in range(ps.total_slots)] == \
        [js.locate(k) for k in range(js.total_slots)]
    for b in range(len(ps.stages) - 1):
        assert [_fields(t) for t in pm.boundary_plan(ps, b)] == \
            [_fields(t) for t in jm.boundary_plan(js, b)]
    with pytest.raises(ValueError, match="no boundary"):
        pm.boundary_plan(ps, len(ps.stages) - 1)
    with pytest.raises(ValueError, match="no stage"):
        pm.warmup_microbatches(ps, len(ps.stages))
    with pytest.raises(ValueError, match="out of range"):
        ps.locate(ps.total_slots)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_shrinks_and_drain_orders_are_jax_s(name):
    js, ps = _build(jm, SPECS[name]), _build(pm, SPECS[name])
    for slot in range(ps.total_slots):
        assert pm.drain_order(ps, {slot}) == jm.drain_order(js, {slot})
        try:
            want = jm.replace_pipeline(js, {slot})
        except ValueError as e:
            with pytest.raises(ValueError) as ei:
                pm.replace_pipeline(ps, {slot})
            assert str(ei.value) == str(e)
            assert type(ei.value).__name__ == type(e).__name__
            continue
        shrunk, slot_map = pm.replace_pipeline(ps, {slot})
        assert shrunk.to_dict() == want[0].to_dict() and slot_map == want[1]
    with pytest.raises(ValueError, match="unknown slots"):
        pm.replace_pipeline(ps, {ps.total_slots + 5})


@pytest.mark.parametrize("name", sorted(BAD_SPECS))
def test_invalid_specs_fail_as_jax_s(name):
    with pytest.raises((ValueError, JaxCompositionError)) as want:
        _build(jm, BAD_SPECS[name])
    with pytest.raises(ValueError) as got:
        _build(pm, BAD_SPECS[name])
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, CompositionError) == isinstance(want.value, JaxCompositionError)


@pytest.mark.parametrize("key,name", [("mpmd_moe_aux_loss", "moe"),
                                      ("mpmd_fused_xent_head", "fused_xent"),
                                      ("mpmd_serve", "serve")])
def test_capability_rejections_fire_at_jax_s_keys(key, name):
    with pytest.raises(CompositionError) as ei:
        _build(pm, BAD_SPECS[name])
    assert str(ei.value) == TABLE[key].message == JAX_TABLE[key].message
    assert TABLE[key].owner == "tpudml_torch.mpmd.spec"
    cand = pm.StageSpec("x", moe_experts=4 if name == "moe" else 0,
                        fused_xent=name == "fused_xent").candidate()
    assert cand == jm.StageSpec("x", moe_experts=4 if name == "moe" else 0,
                                fused_xent=name == "fused_xent").candidate()


def test_stage_quorum_error_is_a_value_error():
    ps = _build(pm, SPECS["quorum"])
    with pytest.raises(pm.StageQuorumError, match="min_world=2"):
        pm.replace_pipeline(ps, {1})
    assert issubclass(pm.StageQuorumError, ValueError)


# ------------------------------------------------- wiring + round artifacts


def test_wiring_document_is_jax_s(tmp_path):
    kw = dict(round_no=3, coordinator_ports=[50001, 50002],
              boundary_ports={0: {0: 50003, 1: 50004}}, ctl_ports={0: 50005, 1: 50006})
    got = pm.write_wiring(tmp_path / "p.json", pipeline=_build(pm, SPECS["drill"]), **kw)
    want = jm.write_wiring(tmp_path / "j.json", pipeline=_build(jm, SPECS["drill"]), **kw)
    assert got == want
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_common_resume_step_is_the_cross_stage_intersection(tmp_path):
    def manifest(stage, step, proc, total):
        d = pm.stage_ckpt_dir(tmp_path, stage) / f"step_{step}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"manifest_p{proc}.json").write_text(json.dumps({"num_processes": total}))

    def both():
        got = pm.common_resume_step(tmp_path, 2)
        assert got == jm.common_resume_step(tmp_path, 2)
        return got

    assert both() == 0
    manifest(0, 5, 0, 2), manifest(0, 5, 1, 2)
    manifest(0, 10, 0, 2), manifest(0, 10, 1, 2)
    manifest(0, 15, 0, 2)
    manifest(1, 5, 0, 1)
    assert both() == 5
    manifest(1, 10, 0, 1)
    assert both() == 10


def test_read_drain_markers_tolerates_torn_writes(tmp_path):
    pm.drain_marker_path(tmp_path, 0, 1).write_text(json.dumps({"step": 13, "why": "peer dead"}))
    pm.drain_marker_path(tmp_path, 1, 0).write_text("{torn")
    out = pm.read_drain_markers(tmp_path)
    assert out == jm.read_drain_markers(tmp_path)
    assert out[(0, 1)]["step"] == 13 and out[(1, 0)] == {}
    assert pm.read_drain_markers(tmp_path / "missing") == {}


# ---------------------------------------------------------- fixture replay


def _golden():
    """JAX's planner constants, under which the goldens were recorded,
    taken from ``tpudml`` here: the port holds none of a TPU's numbers."""
    from tpudml.plan.score import DEFAULT_HARDWARE as JAX_HW

    from tpudml_torch.plan import Hardware

    return Hardware(**dataclasses.asdict(JAX_HW))


def test_replay_defaults_to_the_card_s_planner_constants():
    """With no ``hw`` the replay's planner scores under the port's own
    ``plan.score.DEFAULT_HARDWARE`` (the card's), not JAX's."""
    from tpudml_torch.mpmd.fixture import replay_fixture
    from tpudml_torch.plan.score import DEFAULT_HARDWARE

    assert dataclasses.asdict(DEFAULT_HARDWARE) != dataclasses.asdict(_golden())
    for name in ("steady.json", "shrink_stage.json"):
        assert (replay_fixture(FIXTURES / name)["lines"]
                == replay_fixture(FIXTURES / name, hw=DEFAULT_HARDWARE)["lines"])


@pytest.mark.parametrize("name,rounds,worlds", [("steady.json", 1, [2, 2]),
                                                ("shrink_stage.json", 2, [2, 1])])
def test_fixture_replay_matches_committed_goldens(name, rounds, worlds):
    """Under JAX's planner constants the replay is JAX's line for line and
    its CRC the golden, twice (nothing reads a clock)."""
    from tpudml.mpmd.fixture import replay_fixture as jax_replay

    from tpudml_torch.mpmd.fixture import events_crc32, replay_fixture

    a = replay_fixture(FIXTURES / name, hw=_golden())
    b = replay_fixture(FIXTURES / name, hw=_golden())
    assert a["ok"] and b["ok"]
    assert a["lines"] == b["lines"] == jax_replay(FIXTURES / name)["lines"]
    assert a["events_crc32"] == a["expect_crc32"]
    assert events_crc32(a["lines"]) == a["events_crc32"]
    assert a["rounds"] == rounds and a["final_stage_worlds"] == worlds


def test_card_constants_change_only_shrink_stage_s_replan_keys():
    """The defined difference: under the card's constants ``steady.json``
    still replays to its golden, and ``shrink_stage.json``'s one re-plan
    line names the winner without the fused head (``f0``) before and after
    the kill, where JAX's constants pick it (``f1``); every other line is
    the golden run's."""
    from tpudml_torch.mpmd.fixture import replay_fixture

    assert replay_fixture(FIXTURES / "steady.json")["ok"]
    card = replay_fixture(FIXTURES / "shrink_stage.json")
    gold = replay_fixture(FIXTURES / "shrink_stage.json", hw=_golden())
    assert not card["ok"] and card["events_crc32"] != card["expect_crc32"]
    diff = [(c, g) for c, g in zip(card["lines"], gold["lines"]) if c != g]
    assert len(card["lines"]) == len(gold["lines"]) and len(diff) == 1
    c, g = (json.loads(x) for x in diff[0])
    assert c["event"] == g["event"] == "replan"
    assert c["old_key"] == "zero1[data=4]z11a2f0s0o0t0"
    assert c["new_key"] == "zero1[data=3]z11a2f0s0o0t0"
    assert g["old_key"] == "zero1[data=4]z11a2f1s0o0t0"
    assert g["new_key"] == "zero1[data=3]z11a2f1s0o0t0"
    assert {k: v for k, v in c.items() if not k.endswith("_key")} == \
        {k: v for k, v in g.items() if not k.endswith("_key")}


def test_fixture_replay_fresh_ports_per_reform():
    from tpudml_torch.mpmd.fixture import replay_fixture

    rep = replay_fixture(FIXTURES / "shrink_stage.json", hw=_golden())
    forms = [json.loads(l) for l in rep["lines"] if json.loads(l).get("event") == "form"]
    assert len(forms) == 2
    ports = [p for f in forms for p in f["coordinator_ports"] + list(f["ctl_ports"].values())]
    assert len(ports) == len(set(ports))
    assert forms[1]["resume_step"] == 2 and forms[1]["stage_worlds"] == [2, 1]


def test_fixture_replay_quorum_halt():
    from tpudml.mpmd.fixture import replay_fixture as jax_replay

    from tpudml_torch.mpmd.fixture import replay_fixture

    fx = {
        "version": 1,
        "pipeline": _build(pm, SPECS["quorum"]).to_dict(),
        "engines": ["dp"],
        "events": [{"type": "step", "count": 1}, {"type": "kill", "slot": 0},
                   {"type": "step", "count": 5}],
    }
    rep = replay_fixture(json.loads(json.dumps(fx)), hw=_golden())
    assert rep["halted"] == "below_stage_quorum" and rep["rounds"] == 1
    assert json.loads(rep["lines"][-1]) == {"event": "halt", "reason": "below_stage_quorum"}
    assert rep["lines"] == jax_replay(json.loads(json.dumps(fx)))["lines"]


def test_fail_open_replan_on_vandalized_plan(tmp_path):
    from tpudml_torch.elastic.replan import Replanner
    from tpudml_torch.mpmd.fixture import replay_fixture
    from tpudml_torch.resilience.faults import PLAN_VANDALS, vandalize_plan

    path = tmp_path / "plan.json"
    Replanner(engines=["dp", "zero1"], verify=False, plan_path=path).initial_plan(4)
    vandalize_plan(str(path), next(iter(PLAN_VANDALS)))
    assert Replanner(engines=["dp", "zero1"], verify=False).load_existing(path) is None

    class _Boom:
        def initial_plan(self, world):
            return {"world": world}

        def replan(self, world, **kw):
            raise RuntimeError("boom")

    fx = json.loads((FIXTURES / "shrink_stage.json").read_text())
    fx.pop("expect")
    rep = replay_fixture(fx, replanner=_Boom())
    assert rep["halted"] is None and rep["rounds"] == 2
    (replan,) = [json.loads(l) for l in rep["lines"] if json.loads(l).get("event") == "replan"]
    assert replan["error"] == "RuntimeError" and replan["switched"] is False
    assert rep["final_stage_worlds"] == [2, 1]


def test_fixture_version_gate():
    from tpudml_torch.mpmd.fixture import replay_fixture

    bad = json.loads((FIXTURES / "steady.json").read_text())
    bad["version"] = 9
    with pytest.raises(ValueError, match="fixture version"):
        replay_fixture(bad)
    bad["version"] = 1
    bad["events"] = [{"type": "warp"}]
    with pytest.raises(ValueError, match="unknown fixture event"):
        replay_fixture(bad)


def _cli(*args):
    return subprocess.run([PY, "-m", "tpudml_torch.mpmd", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, TPUDML_DEVICE="cpu"))


def test_fixture_cli_replays_without_spawning(tmp_path):
    """``python -m tpudml_torch.mpmd --fixture``: one process, the verdict
    as the exit code and the last line; a wrong golden flips it. Under the
    card's constants ``shrink_stage.json``'s re-plan names another winner,
    so its replay misses the golden and exits 1 (the defined difference)."""
    proc = _cli("--fixture", str(FIXTURES / "steady.json"))
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.splitlines()[-1])
    assert report["ok"] and report["rounds"] == 1 and "lines" not in report
    assert "[replay]" in proc.stderr
    proc = _cli("--fixture", str(FIXTURES / "shrink_stage.json"))
    report = json.loads(proc.stdout.splitlines()[-1])
    assert proc.returncode == 1 and not report["ok"] and report["rounds"] == 2
    assert report["events_crc32"] != report["expect_crc32"]
    bad = json.loads((FIXTURES / "steady.json").read_text())
    bad["expect"]["events_crc32"] ^= 1
    bad_path = tmp_path / "bad.json"
    bad_path.write_text(json.dumps(bad))
    assert _cli("--fixture", str(bad_path)).returncode == 1
