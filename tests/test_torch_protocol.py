"""``tpudml_torch.analysis.protocol`` (P300–P303) against
``tpudml.analysis.protocol``, and the ``MPMDController``'s pre-launch gate
(``tests/test_protocol.py``'s pipeline cases).

- every schedule-mode fixture module of
  ``tests/analysis_fixtures/protocol/p30[0-3]_*.py`` builds JAX's ``(spec,
  schedules)``; carried into the port (``to_dict`` / ``from_dict``, each
  ``Ev`` field by field) the port's checker gives JAX's findings (rule,
  severity, message, entrypoint), and the silent twins none;
- the port's schedule model of every spec on the repo surface is JAX's,
  event for event, and ``analyze_protocol_surface()`` equals JAX's;
- every single-slot shrink of the drill's and the 3-stage spec stays
  P300/P301-clean; the committed fixture streams validate against the
  schedule model and tampered streams fire P300;
- ``traced_collective_events`` gives JAX's (op, axes, shape) tuples from
  one captured step, and they drive P302;
- the controller refuses a rejected spec with receipts (no round spawned)
  and launches a clean one with its receipt, and the obs report prints
  the gate's verdict.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tpudml.analysis import protocol as jproto  # noqa: E402
from tpudml.mpmd.fixture import replay_fixture as jax_replay  # noqa: E402

from tpudml_torch.analysis import protocol as proto  # noqa: E402
from tpudml_torch.analysis.findings import RULES, Finding  # noqa: E402
from tpudml_torch.mpmd.spec import PipelineSpec, replace_pipeline  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXDIR = REPO / "tests" / "analysis_fixtures" / "protocol"


def _fixture_names() -> list:
    return sorted(p.stem for p in FIXDIR.glob("p30[0-3]_*.py"))


def _load_fixture(name: str):
    path = FIXDIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_protofix_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_schedules(jsched: dict) -> dict:
    """JAX's schedules as the port's: every ``Ev`` field by field."""
    fields = [f.name for f in dataclasses.fields(proto.Ev)]
    assert fields == [f.name for f in dataclasses.fields(jproto.Ev)]
    return {k: [proto.Ev(**{f: getattr(e, f) for f in fields}) for e in evs]
            for k, evs in jsched.items()}


def _rows(findings) -> list:
    return [(f.rule, f.severity, f.message, f.file, f.line, f.entrypoint) for f in findings]


def test_findings_rules_and_hints_are_jax_s():
    from tpudml.analysis.findings import HINTS as JAX_HINTS
    from tpudml.analysis.findings import RULES as JAX_RULES

    from tpudml_torch.analysis.findings import HINTS

    assert RULES == JAX_RULES and HINTS == JAX_HINTS
    f = Finding("P301", "x", entrypoint="protocol:t")
    assert f.severity == "error" and f.location() == "<protocol:t>"
    assert f.format().startswith("P301 error <protocol:t> [protocol:t]: x")


@pytest.mark.parametrize("name", _fixture_names())
def test_protocol_fixture_findings_are_jax_s(name):
    mod = _load_fixture(name)
    assert mod.MODE == "schedule" and mod.EXPECT in ("fire", "silent")
    jspec, jsched = mod.build()
    want = jproto.check_schedules(jspec, jsched, entrypoint=name)
    spec = PipelineSpec.from_dict(jspec.to_dict())
    got = proto.check_schedules(spec, _port_schedules(jsched), entrypoint=name)
    assert _rows(got) == _rows(want)
    fired = [f for f in got if f.rule == mod.RULE]
    assert bool(fired) == (mod.EXPECT == "fire"), got
    if mod.EXPECT == "silent":
        assert got == []


def test_fixture_dir_covers_p300_to_p303():
    twins: dict = {}
    for name in _fixture_names():
        mod = _load_fixture(name)
        twins.setdefault(mod.RULE, set()).add(mod.EXPECT)
    assert twins == {r: {"fire", "silent"} for r in ("P300", "P301", "P302", "P303")}


def test_surface_and_schedules_are_jax_s():
    surface, jsurface = proto.protocol_surface(), jproto.protocol_surface()
    assert sorted(surface) == sorted(jsurface)
    assert {"mpmd_drill", "mpmd_3stage", "fixture:steady", "fixture:shrink_stage",
            "fixture:shrink_stage:after_kill3"} <= set(surface)
    for name, spec in surface.items():
        assert spec.to_dict() == jsurface[name].to_dict(), name
        got = proto.build_schedules(spec)
        want = _port_schedules(jproto.build_schedules(jsurface[name]))
        assert got == want, name


def test_analyze_protocol_surface_is_jax_s():
    assert _rows(proto.analyze_protocol_surface()) == _rows(jproto.analyze_protocol_surface())
    assert proto.analyze_protocol_surface() == []


def test_stage_collectives_drive_p302_as_jax_s():
    """Per-rank collective sequences (what a traced stage would give): the
    same rows fire as in JAX, and equal sequences stay silent."""
    sig_a = (("psum", ("data",), (2, 4)),)
    sig_b = (("psum", ("data",), (2, 8)),)
    for colls in ({0: sig_a, 1: sig_a}, {(0, 0): sig_a, (0, 1): sig_b, 1: sig_a}):
        spec = proto.protocol_surface()["mpmd_drill"]
        got = proto.check_schedules(spec, proto.build_schedules(spec, stage_collectives=colls))
        jspec = jproto.protocol_surface()["mpmd_drill"]
        want = jproto.check_schedules(
            jspec, jproto.build_schedules(jspec, stage_collectives=colls))
        assert _rows(got) == _rows(want)
    assert [f.rule for f in got] == ["P302"]


def test_traced_collective_events_drive_p302():
    """``traced_collective_events`` reads a stage's (op, axes, shape)
    collectives off one captured step, under JAX's names: the tuples the
    JAX-fed case above uses. The same tuples on every rank of a group stay
    silent; a rank whose step differs fires P302 once."""
    import torch
    import torch.distributed as dist

    from tpudml_torch.core import process_group

    def stage(width):
        def fn(x):
            dist.all_reduce(x)
            return x

        return proto.traced_collective_events(fn, (torch.ones(2, width),))

    with process_group(device="cpu"):
        sig_a, sig_b = stage(4), stage(8)
    assert sig_a == (("psum", ("data",), (2, 4)),)
    assert sig_b == (("psum", ("data",), (2, 8)),)
    spec = proto.protocol_surface()["mpmd_drill"]
    silent = proto.check_schedules(
        spec, proto.build_schedules(spec, stage_collectives={0: sig_a, 1: sig_a}))
    assert silent == [], silent
    mixed = proto.build_schedules(
        spec, stage_collectives={(0, 0): sig_a, (0, 1): sig_b, 1: sig_a})
    fired = [f for f in proto.check_schedules(spec, mixed) if f.rule == "P302"]
    assert len(fired) == 1, fired


@pytest.mark.parametrize("surface_name", ["mpmd_drill", "mpmd_3stage"])
def test_every_single_slot_shrink_stays_protocol_clean(surface_name):
    spec = proto.protocol_surface()[surface_name]
    assert proto.analyze_pipeline(spec) == []
    for slot in range(spec.total_slots):
        shrunk, slot_map = replace_pipeline(spec, {slot})
        findings = proto.analyze_pipeline(shrunk, entrypoint=f"{surface_name}:kill{slot}")
        assert not [f for f in findings if f.rule in ("P300", "P301")], (surface_name, slot)
        assert slot not in slot_map


def test_simulation_is_exhaustive_on_surface():
    for name, spec in sorted(proto.protocol_surface().items()):
        schedules = proto.build_schedules(spec)
        assert len(schedules) == spec.total_slots, name
        kinds = {e.kind for evs in schedules.values() for e in evs}
        if len(spec.stages) > 1:
            assert {"send", "recv"} <= kinds, (name, kinds)
        if any(st.dp > 1 for st in spec.stages):
            assert {"vote", "collective"} <= kinds, (name, kinds)


@pytest.mark.parametrize("fixture", ["steady", "shrink_stage"])
def test_committed_fixture_streams_match_schedule_model(fixture):
    path = REPO / "tests" / "mpmd_fixtures" / f"{fixture}.json"
    assert proto.validate_fixture_events(path) == []
    assert proto.validate_fixture_events(path, lines=jax_replay(path)["lines"]) == []


def test_tampered_fixture_stream_fires_p300():
    doc = json.loads((REPO / "tests" / "mpmd_fixtures" / "steady.json").read_text())
    lines = jax_replay(dict(doc))["lines"]

    def tamper(mutate):
        out = list(lines)
        for i, line in enumerate(out):
            ev = json.loads(line)
            if ev.get("event") == "transfer":
                mutate(ev)
                out[i] = json.dumps(ev, sort_keys=True, separators=(",", ":"))
                break
        return out

    cases = {
        "edge": tamper(lambda ev: ev.update(edge="s9r9->s9r9")),
        "bytes": tamper(lambda ev: ev.update(bytes=ev["bytes"] + 1)),
        "dropped": [l for l in lines
                    if json.loads(l).get("event") != "transfer"
                    or json.loads(l).get("index") != 0 or json.loads(l).get("step") != 0],
    }
    for name, tampered in cases.items():
        got = proto.validate_fixture_events(doc, lines=tampered)
        want = jproto.validate_fixture_events(doc, lines=tampered)
        assert _rows(got) == _rows(want) and any(f.rule == "P300" for f in got), name
    assert any("omitted modeled frame" in f.message
               for f in proto.validate_fixture_events(doc, lines=cases["dropped"]))


# ------------------------------------------------- controller gate


def _controller(tmp_path, checker, cmd=None):
    from tpudml_torch.launch.cluster import ClusterSpec
    from tpudml_torch.mpmd.groups import MPMDController

    return MPMDController(
        cmd or [sys.executable, "-c", "pass"],
        proto.protocol_surface()["mpmd_drill"],
        ClusterSpec(timeout_s=120.0, platform="cpu"),
        run_dir=tmp_path / "run",
        ckpt_dir=tmp_path / "ckpt",
        max_reforms=1,
        protocol_checker=checker,
        sink=open(os.devnull, "w"),
    )


def test_controller_refuses_rejected_spec(tmp_path):
    from tpudml_torch.tools.obs_report import report

    calls = []

    def reject(pipeline):
        calls.append(pipeline)
        return [Finding("P300", "injected asymmetry", entrypoint="protocol:test")]

    res = _controller(tmp_path, reject, cmd=[sys.executable, "-c", "raise SystemExit(9)"]).run()
    assert len(calls) == 1
    assert res.stop_reason == "protocol_rejected"
    assert res.records == [] and not res.success
    assert len(res.protocol) == 1 and res.protocol[0]["ok"] is False
    assert res.protocol[0]["findings"][0]["rule"] == "P300"
    assert res.to_dict()["protocol"] == res.protocol
    doc = json.loads((tmp_path / "run" / "protocol_report.json").read_text())
    assert doc["ok"] is False
    assert doc["checks"][0]["findings"][0]["severity"] == "error"
    text = report(tmp_path)
    assert "protocol gate" in text and "REJECTED at round 0" in text


def test_controller_gate_passes_clean_spec_with_receipts(tmp_path):
    from tpudml_torch.tools.obs_report import report

    res = _controller(tmp_path, None).run()  # default: analyze_pipeline
    assert res.stop_reason == "success", res.stop_reason
    assert res.success and len(res.records) == 1
    assert res.records[0].stage_worlds == [2, 2]
    assert [r["ok"] for r in res.protocol] == [True]
    assert res.protocol[0]["findings"] == []
    doc = json.loads((tmp_path / "run" / "protocol_report.json").read_text())
    assert doc["ok"] is True and len(doc["checks"]) == 1
    assert "protocol gate: 1 spec check(s)  ok=True" in report(tmp_path)
