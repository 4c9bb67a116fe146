"""tpudml_torch.plan against tpudml.plan, without building an engine.

- **byte for byte**: ``plan_to_json(make_plan(..., verify=False))`` under
  the JAX package's hardware constants is JAX's plan, for the flagship
  spec and the card's training widths at worlds 1, 2, 4 and 8, with an
  engine subset, an HBM budget and a calibration;
- **the card's constants** change the scores only: the survivors and the
  ``pruned`` records are JAX's;
- the contracts of ``tests/test_plan.py`` that need no engine:
  determinism, the JSON round trip, prune honesty, the table against the
  runtime guards both ways, the v2 schema, v1 plans, calibration, world 1
  being DP-only and the CLI's ``--format github``.

The verification step (engines in gloo jobs) is held in
``tests/test_torch_plan_verify.py``; ``--plan`` and ``--check`` in
``tests/test_torch_plan_cli.py``.
"""

import dataclasses
import json
import os
import re

import pytest

pytest.importorskip("torch")

from tpudml.plan import Calibration as JaxCalibration  # noqa: E402
from tpudml.plan import ModelSpec as JaxSpec  # noqa: E402
from tpudml.plan import make_plan as jax_make_plan  # noqa: E402
from tpudml.plan import plan_to_json as jax_plan_to_json  # noqa: E402
from tpudml.plan.score import DEFAULT_HARDWARE as JAX_HW  # noqa: E402

from tpudml_torch.capabilities import TABLE  # noqa: E402
from tpudml_torch.plan import (  # noqa: E402
    DEFAULT_HARDWARE,
    PLAN_VERSION,
    Calibration,
    Hardware,
    ModelSpec,
    enumerate_candidates,
    flagship_lm,
    load_plan,
    make_plan,
    plan_drift_findings,
    plan_to_json,
    prune,
    score_candidate,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX's constants, read from the JAX package (the port's own are the card's).
JAX_CONSTANTS = Hardware(**dataclasses.asdict(JAX_HW))
# The card's training widths (chip_smoke.py's TRAIN_MODEL, 8 rows a device).
TRAIN = dict(vocab_size=32768, embed_dim=512, num_heads=4, num_layers=6, seq_len=1024,
             per_chip_batch=8)
SPECS = {"flagship": {}, "train": TRAIN}


def _spec(name, jax=False):
    if name == "flagship":
        from tpudml.plan import flagship_lm as jax_flagship

        return jax_flagship() if jax else flagship_lm()
    return (JaxSpec if jax else ModelSpec)(**SPECS[name])


@pytest.fixture(scope="module")
def plan4():
    return make_plan(flagship_lm(), 4, verify=False)


# ---------------------------------------------------------- byte for byte


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_plan_json_is_jax_byte_for_byte(spec, world):
    want = jax_plan_to_json(jax_make_plan(_spec(spec, jax=True), world, verify=False))
    got = plan_to_json(make_plan(_spec(spec), world, verify=False, hw=JAX_CONSTANTS))
    assert got == want


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["engines", "budget", "calibration"])
def test_plan_json_is_jax_byte_for_byte_with_knobs(case, world):
    kw, jkw = {}, {}
    if case == "engines":
        kw = jkw = dict(engines=["dp", "zero1"])
    elif case == "budget":
        kw = jkw = dict(hbm_budget_bytes=4_000_000)
    else:
        replan = {"trigger": "drift", "why": "test", "old_world": world,
                  "old_winner": {}, "receipts": []}
        kw = dict(calibration=Calibration(comm_scale=1.25, source="obs/drift"),
                  replan=dict(replan))
        jkw = dict(calibration=JaxCalibration(comm_scale=1.25, source="obs/drift"),
                   replan=dict(replan))
    want = jax_plan_to_json(jax_make_plan(_spec("flagship", jax=True), world, verify=False,
                                          **jkw))
    got = plan_to_json(make_plan(flagship_lm(), world, verify=False, hw=JAX_CONSTANTS, **kw))
    assert got == want


@pytest.mark.parametrize("world", [1, 4, 8])
def test_card_constants_change_only_the_scores(world):
    """Under the card's constants the survivor set and every ``pruned``
    record are JAX's; the ranking's order and scores are the card's."""
    jax = jax_make_plan(_spec("train", jax=True), world, verify=False)
    port = make_plan(_spec("train"), world, verify=False)
    assert port["pruned"] == jax["pruned"]
    assert (sorted(e["candidate"]["key"] for e in port["ranking"])
            == sorted(e["candidate"]["key"] for e in jax["ranking"]))
    assert DEFAULT_HARDWARE != JAX_CONSTANTS


def test_default_hardware_is_the_h100_data_sheet():
    """f32 outside the tensor cores, HBM3, NVLink 4 a direction: the
    constants chip_smoke.py states for the card."""
    assert DEFAULT_HARDWARE == Hardware(flops_per_s=67e12, hbm_bytes_per_s=3.35e12,
                                        ici_bytes_per_s=4.5e11)
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "H100_BYTES_PER_S = 3.35e12" in src and "H100_F32_FLOPS = 67e12" in src


def test_world1_ties_the_fused_head_and_the_key_order_picks_f0():
    """At world 1 on the card's widths compute sets the step: f0 and f1
    tie and the key order puts the unfused head first."""
    plan = make_plan(_spec("train"), 1, verify=False)
    top = plan["ranking"][:2]
    assert [e["candidate"]["key"] for e in top] == ["dp[data=1]z00a1f0s0o0t0",
                                                    "dp[data=1]z00a1f1s0o0t0"]
    assert top[0]["score"]["per_token_s"] == top[1]["score"]["per_token_s"]


# ------------------------------------------------------ JAX's contracts


def test_plan_json_is_byte_deterministic(plan4):
    assert plan_to_json(plan4) == plan_to_json(make_plan(flagship_lm(), 4, verify=False))


def test_plan_roundtrips_through_json(plan4, tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(plan_to_json(plan4))
    assert load_plan(str(path)) == json.loads(plan_to_json(plan4))
    path.write_text(json.dumps(dict(plan4, version=99)))
    with pytest.raises(ValueError, match="version"):
        load_plan(str(path))


@pytest.mark.parametrize("world", [4, 8])
def test_prune_reports_every_dropped_candidate(world):
    cands = enumerate_candidates(world)
    survivors, dropped = prune(flagship_lm(), cands)
    assert len(survivors) + len(dropped) == len(cands)
    assert dropped
    for rec in dropped:
        assert rec.rule and rec.reason
    cap = [r for r in dropped if r.rule.startswith("capability:")]
    assert cap
    for rec in cap:
        assert rec.reason == TABLE[rec.rule.split(":", 1)[1]].message


def test_prune_drops_overlap_without_zero1():
    _, dropped = prune(flagship_lm(), enumerate_candidates(4))
    rules = {r.rule for r in dropped}
    assert "capability:zero1_overlap_needs_zero1" in rules
    assert "capability:pp_fused_xent" in rules


def test_prune_hbm_budget_drops_and_reports():
    survivors, dropped = prune(flagship_lm(), enumerate_candidates(4),
                               hbm_budget_bytes=1_000_000)
    assert not survivors
    assert {r.rule for r in dropped} >= {"hbm"}


def test_divisibility_prunes_odd_heads():
    spec = ModelSpec(vocab_size=256, embed_dim=64, num_heads=3, num_layers=2, seq_len=128,
                     per_chip_batch=4)
    _, dropped = prune(spec, enumerate_candidates(4, engines=["tp"]))
    assert any(r.rule == "divisibility" and "num_heads" in r.reason for r in dropped)


_REJECT_RE = re.compile(r"""reject\(\s*["']([a-z0-9_]+)["']""")


def _reject_keys_in_port():
    keys = {}
    for dirpath, _, files in os.walk(os.path.join(REPO, "tpudml_torch")):
        for fname in files:
            if fname.endswith(".py"):
                path = os.path.join(dirpath, fname)
                for key in _REJECT_RE.findall(open(path).read()):
                    keys.setdefault(key, []).append(os.path.relpath(path, REPO))
    return keys


def test_every_runtime_reject_key_is_in_the_table():
    used = _reject_keys_in_port()
    assert used
    assert {k: v for k, v in used.items() if k not in TABLE} == {}


def test_every_table_key_is_raised_by_some_runtime_guard():
    used = _reject_keys_in_port()
    assert [k for k in TABLE if k not in used] == []


def test_plan_v2_schema_keys_always_present(plan4):
    assert plan4["version"] == PLAN_VERSION == 2
    assert plan4["calibration"] is None and plan4["replan"] is None


def test_v1_plan_still_loads(plan4, tmp_path):
    v1 = {k: v for k, v in plan4.items() if k not in ("calibration", "replan")}
    v1["version"] = 1
    path = tmp_path / "v1_plan.json"
    path.write_text(json.dumps(v1, indent=2, sort_keys=True) + "\n")
    plan = load_plan(str(path))
    assert plan["version"] == 1
    assert plan["calibration"] is None and plan["replan"] is None
    assert plan["winner"] == plan4["winner"]


def test_calibrated_plan_is_byte_deterministic(tmp_path):
    cal = Calibration(comm_scale=1.25, source="obs/drift")
    replan = {"trigger": "drift", "why": "test", "old_world": 4, "old_winner": {},
              "receipts": []}
    a = make_plan(flagship_lm(), 4, verify=False, calibration=cal, replan=dict(replan))
    b = make_plan(flagship_lm(), 4, verify=False, calibration=cal, replan=dict(replan))
    assert plan_to_json(a) == plan_to_json(b)
    assert a["calibration"]["comm_scale"] == 1.25
    path = tmp_path / "plan.json"
    path.write_text(plan_to_json(a))
    assert load_plan(str(path)) == json.loads(plan_to_json(a))


def test_calibration_scales_the_roofline_terms():
    spec = flagship_lm()
    cand = next(c for c in enumerate_candidates(4, engines=["zero1"])
                if c.zero1 and not c.zero1_overlap)
    base = score_candidate(spec, cand)
    cal = score_candidate(spec, cand, calibration=Calibration(comm_scale=2.0))
    assert cal.comm_wire_bytes == pytest.approx(2.0 * base.comm_wire_bytes)
    assert (cal.exposed_comm_s + cal.hidden_comm_s) == pytest.approx(
        2.0 * (base.exposed_comm_s + base.hidden_comm_s))
    assert cal.step_time_s > base.step_time_s
    assert cal.compute_s == base.compute_s
    hbm = score_candidate(spec, cand, calibration=Calibration(hbm_scale=1.5))
    assert hbm.est_hbm_bytes == pytest.approx(1.5 * base.est_hbm_bytes, rel=1e-6)


def test_calibration_fit_and_roundtrip():
    records = [
        {"entrypoint": "a", "static_wire_bytes": 1.0e6, "measured_wire_bytes": 1.25e6,
         "rel_err": 0.2},
        {"entrypoint": "b", "static_wire_bytes": 4.0e5, "measured_wire_bytes": 5.0e5,
         "rel_err": 0.2},
    ]
    cal = Calibration.from_drift_records(records)
    assert cal.comm_scale == pytest.approx(1.75e6 / 1.4e6)
    assert len(cal.basis) == 2
    assert Calibration.from_dict(cal.to_dict()).comm_scale == cal.comm_scale
    want = JaxCalibration.from_drift_records(records)
    assert cal.to_dict() == want.to_dict()


def test_world1_enumeration_is_dp_only():
    cands = enumerate_candidates(1)
    assert cands and {c.engine for c in cands} == {"dp"}
    plan = make_plan(flagship_lm(), 1, engines=["dp", "zero1"], verify=False)
    assert plan["winner"]["candidate"]["engine"] == "dp"
    assert plan["winner"]["candidate"]["mesh"] == {"data": 1}


def test_plan_cli_github_format(tmp_path, capsys):
    """``--format github`` emits workflow-annotation lines
    (``::level ::message``); the file written is a loadable v2 plan."""
    from tpudml_torch.plan.__main__ import main

    out = tmp_path / "plan.json"
    rc = main(["--world", "4", "--engines", "dp,zero1", "--format", "github", "--no-verify",
               "--out", str(out)])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("::")]
    assert lines and lines[0].startswith("::notice ::PLAN[world=4]: winner ")
    assert load_plan(str(out))["version"] == PLAN_VERSION


def test_unported_planner_halves_raise_naming_item_11(plan4):
    """J118 and the drift monitor's live regimes trace through the
    analyzers (ROADMAP.md queue 1 item 11)."""
    from tpudml_torch.obs.drift import drift_records, measure_regime

    for call in (lambda: plan_drift_findings(plan4), lambda: measure_regime("task2_dp"),
                 drift_records):
        with pytest.raises(NotImplementedError, match="item 11"):
            call()
