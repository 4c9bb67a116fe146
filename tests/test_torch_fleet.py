"""The serving fleet's router (``tpudml_torch.serve.fleet``) against
``tpudml.serve.fleet``'s, on the CPU.

Every case of ``tests/test_fleet.py`` but the spawned drill (its port is
``tests/test_torch_fleet_drill.py``) runs on the port: the byte-golden
event log, run-twice determinism, drain/re-admit accounting, the original
deadline of a continuation, fixture replay and its guards, the CLI, the
replanner hook (and its failing open), the guards of ``FleetConfig``, the
trace documents and the heterogeneous int8 fleet. The port's weights are
JAX's, carried across with ``lm_params_from_tpudml``.

Parity against JAX's router on the same weights and workload, in four
arms — dense without a kill, dense with replica 1 killed, paged with
prefix sharing and the same kill, and the mixed (f32, f32, int8) fleet
under an SLO with the same kill: ``FleetReport.to_dict()`` (its event CRC,
steps, per-replica rows, latency summary; every clock a virtual one), the
canonical event log byte for byte, every token stream, and the replanner's
receipts all equal JAX's. Both committed fixtures replay to their
committed CRCs with the port's own weights.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.serve import ServeConfig as JaxServeConfig  # noqa: E402
from tpudml.serve import SLOConfig as JaxSLO  # noqa: E402
from tpudml.serve import poisson_workload as jax_poisson  # noqa: E402
from tpudml.serve.fleet import FleetConfig as JaxFleetConfig  # noqa: E402
from tpudml.serve.fleet import FleetRouter as JaxRouter  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.serve import ServeCompositionError, ServeConfig, SLOConfig  # noqa: E402
from tpudml_torch.serve import poisson_workload  # noqa: E402
from tpudml_torch.serve.fleet import (  # noqa: E402
    FLEET_FIXTURE_VERSION,
    FleetConfig,
    FleetRouter,
    replay_fleet_fixture,
)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fleet_fixtures"
V = 48
MODEL = dict(vocab_size=V, embed_dim=32, num_heads=4, num_kv_heads=2, num_layers=2,
             max_len=64)


@pytest.fixture(scope="module")
def pair():
    jm = JaxLM(**MODEL)
    params, _ = jm.init(jax.random.key(0))
    tm = TransformerLM(**MODEL, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def model(pair):
    return pair[2]


def _ecfg(cls=ServeConfig, **kw):
    base = dict(slots=2, max_len=64, prefill_chunk=8, step_time_s=0.01)
    base.update(kw)
    return cls(**base)


def _workload(n, qps, seed, fn=poisson_workload):
    requests, _ = fn(n, qps, seed, vocab_size=V, prompt_len=(4, 10), new_tokens=(4, 8))
    return requests


def _router(model, cfg, **kw):
    return FleetRouter(model, cfg, device="cpu", **kw)


# ------------------------------------------------- byte determinism


def test_golden_event_log_bytes(model):
    """The steady fixture's event log re-serializes byte-for-byte against
    the committed golden — the fleet's determinism contract."""
    fixture = json.loads((FIXTURES / "steady.json").read_text())
    w = fixture["workload"]
    requests = _workload(w["n"], w["qps"], w["seed"])
    f = fixture["fleet"]
    cfg = FleetConfig(engine=ServeConfig(**f["engine"]), replicas=f["replicas"],
                      max_queue=f["max_queue"])
    report = _router(model, cfg).run(requests)
    golden = (FIXTURES / "golden_steady_events.json").read_text()
    assert report.canonical_events() == golden


def test_run_twice_byte_identical(model):
    requests = _workload(12, 200.0, 7)
    cfg = FleetConfig(engine=_ecfg(), replicas=2, reform_after_steps=4)

    def go():
        rep = _router(model, cfg).run(requests, kills=[(4, 0)])
        return rep.canonical_events(), {rid: list(st.tokens) for rid, st in rep.requests.items()}

    assert go() == go()


# -------------------------------------------- drain/re-admit accounting


def test_drain_readmit_exact_accounting(model):
    """A mid-run kill changes WHERE requests run, never their tokens: every
    request still finishes with exactly its owed count, and the per-request
    token streams equal the uninterrupted run's."""
    requests = _workload(12, 200.0, 7)
    owed = {r.rid: r.max_new_tokens for r in requests}
    clean = _router(model, FleetConfig(engine=_ecfg(), replicas=2)).run(requests)
    assert clean.finished == len(requests)
    cfg = FleetConfig(engine=_ecfg(), replicas=2, reform_after_steps=4)
    rep = _router(model, cfg).run(requests, kills=[(4, 0)])
    assert rep.kills == 1 and rep.drains >= 1
    assert rep.finished == len(requests)
    readmitted = [st for st in rep.requests.values() if st.readmits]
    assert readmitted, "the kill must have drained someone mid-flight"
    for rid, st in rep.requests.items():
        assert len(st.tokens) == owed[rid], rid
        assert st.tokens == clean.requests[rid].tokens, rid
    assert rep.generated_tokens == sum(owed.values())
    for st in readmitted:
        assert len(st.replicas_visited) >= 2


def test_drained_request_keeps_original_deadline(model):
    """Continuations expire against the ORIGINAL arrival: a kill grants the
    victim no fresh deadline."""
    requests = _workload(6, 300.0, 5)
    cfg = FleetConfig(engine=_ecfg(deadline_s=0.06, slots=1), replicas=1,
                      reform_after_steps=2)
    rep = _router(model, cfg).run(requests, kills=[(3, 0)])
    assert rep.drains >= 1
    for st in rep.requests.values():
        assert sum(x is not None for x in (st.finished, st.rejected, st.expired)) <= 1
        assert len(st.tokens) <= st.max_new_tokens


# ----------------------------------------------------- fixture replay


@pytest.mark.parametrize("name", ["steady.json", "kill_drain.json"])
def test_fixture_replays_clean(name):
    """The committed fixtures replay to their committed CRCs and counts
    with the port's own seeded weights (the expectations do not depend on
    the weights: no fixture sets eos_token)."""
    fixture = json.loads((FIXTURES / name).read_text())
    report = replay_fleet_fixture(fixture, device="cpu")
    assert report["ok"], report["mismatches"]
    assert report["events_crc32"] == fixture["expect"]["events_crc32"]


def test_fixture_version_gate():
    fixture = json.loads((FIXTURES / "steady.json").read_text())
    fixture["version"] = FLEET_FIXTURE_VERSION + 1
    with pytest.raises(ValueError, match="fixture version"):
        replay_fleet_fixture(fixture, device="cpu")


def test_fixture_detects_drift():
    fixture = json.loads((FIXTURES / "steady.json").read_text())
    fixture["expect"]["generated_tokens"] += 1
    report = replay_fleet_fixture(fixture, device="cpu")
    assert not report["ok"]
    assert "generated_tokens" in report["mismatches"]


def test_fixture_cli_exits_zero():
    from tpudml_torch.serve.fleet.__main__ import main

    assert main(["--fixture", str(FIXTURES / "steady.json"), "--device", "cpu"]) == 0


def test_fixture_cli_process_exits_zero_on_kill_drain():
    """``python -m tpudml_torch.serve.fleet --fixture ... --device cpu`` as a
    user runs it: exit 0 and JAX's CRC on its last line."""
    out = subprocess.run(
        [sys.executable, "-m", "tpudml_torch.serve.fleet", "--fixture",
         str(FIXTURES / "kill_drain.json"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["ok"] and doc["events_crc32"] == 4164831406


# ------------------------------------------------ replan + membership


class _Replanner:
    def __init__(self):
        self.calls = []

    def replan(self, world, *, why):
        self.calls.append((world, why))
        return {"world": world}


def test_reform_consults_replanner(model):
    rp = _Replanner()
    cfg = FleetConfig(engine=_ecfg(), replicas=2, reform_after_steps=3)
    rep = _router(model, cfg, replanner=rp).run(_workload(8, 200.0, 3), kills=[(3, 1)])
    assert rp.calls and rp.calls[0][1] == "fleet-reform replica 1"
    assert rep.replans and rep.replans[0]["decision"] == {"world": 2}


def test_raising_replanner_fails_open(model):
    class Bad:
        def replan(self, world, *, why):
            raise RuntimeError("planner down")

    cfg = FleetConfig(engine=_ecfg(), replicas=2, reform_after_steps=3)
    rep = _router(model, cfg, replanner=Bad()).run(_workload(8, 200.0, 3), kills=[(3, 1)])
    assert rep.finished == 8
    assert rep.replans and "RuntimeError" in rep.replans[0]["error"]


def test_all_dead_without_reform_raises(model):
    cfg = FleetConfig(engine=_ecfg(), replicas=1)
    with pytest.raises(ValueError, match="no live replica"):
        _router(model, cfg).run(_workload(6, 200.0, 3), kills=[(1, 0)])


def test_reform_rebuilds_caches_from_the_engine_s_own_model(model):
    """A weight-quantized replica holds its own copy of the model; its
    re-form builds the fresh caches from that copy, on the engine's device,
    and keeps the engine and its decode step."""
    cfg = FleetConfig(engine=_ecfg(), replicas=1,
                      replica_engines=(_ecfg(weight_quant="int8", fused_head=True),))
    router = _router(model, cfg)
    rep = router.replicas[0]
    eng, step = rep.eng, rep.eng._decode
    assert eng.model is not model
    rep.kill(0)
    rep.reform(1)
    assert rep.eng is eng and eng._decode is step and rep.alive
    assert all(c.k.device == eng.device for c in eng.caches)
    assert not any(c.k.any() for c in eng.caches)


# -------------------------------------------------- validation guards


def test_fleet_config_validation():
    with pytest.raises(ValueError, match="step_time_s"):
        FleetConfig(engine=ServeConfig(slots=2, max_len=64, prefill_chunk=8))
    with pytest.raises(ValueError, match="replicas"):
        FleetConfig(engine=_ecfg(), replicas=0)
    with pytest.raises(ValueError, match="max_queue"):
        FleetConfig(engine=_ecfg(), max_queue=0)
    with pytest.raises(ValueError, match="reform_after_steps"):
        FleetConfig(engine=_ecfg(), reform_after_steps=0)


def test_fleet_rejects_spec():
    with pytest.raises(ServeCompositionError, match="spec"):
        FleetConfig(engine=_ecfg(spec_k=2))


def test_replica_engines_validation():
    with pytest.raises(ValueError, match="entries for"):
        FleetConfig(engine=_ecfg(), replicas=3, replica_engines=(_ecfg(), _ecfg()))
    with pytest.raises(ValueError, match="one virtual clock"):
        FleetConfig(engine=_ecfg(), replicas=2,
                    replica_engines=(_ecfg(), _ecfg(step_time_s=0.02)))
    with pytest.raises(ServeCompositionError):
        FleetConfig(engine=_ecfg(), replicas=2, replica_engines=(_ecfg(), _ecfg(spec_k=2)))
    cfg = FleetConfig(engine=_ecfg(), replicas=2)
    assert cfg.engine_for(1) is cfg.engine


# ----------------------------------------------------- trace plumbing


def test_trace_docs_merge_and_validate(model, tmp_path):
    """The trace documents merge and validate; the router's summary, as
    ``fleet.json``, renders in ``obs_report``'s fleet section."""
    from tpudml_torch.obs.tracer import merge_chrome_traces, validate_chrome_trace
    from tpudml_torch.tools.obs_report import report as obs_report

    cfg = FleetConfig(engine=_ecfg(), replicas=2, reform_after_steps=3)
    rep = _router(model, cfg).run(_workload(8, 200.0, 3), kills=[(3, 0)])
    merged = merge_chrome_traces(rep.to_trace_docs(0.01))
    validate_chrome_trace(merged)
    names = {e["name"] for e in merged["traceEvents"]}
    assert {"kill", "reform", "queue_depth"} <= names
    (tmp_path / "fleet.json").write_text(json.dumps(rep.to_dict()))
    rendered = obs_report(tmp_path)
    assert "fleet.json (serving fleet)" in rendered
    assert f"events_crc32={rep.events_crc32():08x}" in rendered


# ----------------------------------------------- heterogeneous fleets


def test_mixed_fleet_routes_cache_bound_to_int8(model):
    """One int8 + two f32 replicas under one SLO: the int8 replica's cost
    model carries a smaller param-byte term, so cache-bound head-of-line
    traffic is priced onto it first (it is the LAST index, so tie-breaking
    cannot explain the placement)."""
    slo = SLOConfig(tpot_budget_s=1.0)
    f32, i8 = _ecfg(slo=slo), _ecfg(slo=slo, weight_quant="int8")
    cfg = FleetConfig(engine=f32, replicas=3, replica_engines=(f32, f32, i8))
    assert cfg.engine_for(2).weight_quant == "int8"
    router = _router(model, cfg)
    assert router.replicas[2].eng._cost.params_bytes < router.replicas[0].eng._cost.params_bytes
    requests = _workload(6, 500.0, 3)
    rep = router.run(requests)
    assert rep.finished == len(requests)
    admits = [e for e in rep.events if e[0] == "admit"]
    assert [e[2] for e in admits[:2]] == [2, 2]
    assert rep.per_replica[2]["busy_slot_steps"] > 0


def test_mixed_fleet_run_twice_byte_identical(model):
    slo = SLOConfig(tpot_budget_s=1.0)
    cfg = FleetConfig(engine=_ecfg(slo=slo), replicas=2, reform_after_steps=4,
                      replica_engines=(_ecfg(slo=slo), _ecfg(slo=slo, weight_quant="int8")))
    requests = _workload(10, 200.0, 11)

    def go():
        rep = _router(model, cfg).run(requests, kills=[(4, 1)])
        return rep.canonical_events(), {rid: list(st.tokens) for rid, st in rep.requests.items()}

    assert go() == go()


# ------------------------------------------------ parity against JAX


def _arm(name, cls, slo_cls):
    """(FleetConfig kwargs, kills, workload args) of a parity arm, with the
    engine configs built from ``cls`` (either package's ServeConfig)."""
    if name == "no_kill":
        return dict(engine=_ecfg(cls, deadline_s=2.0), replicas=2, max_queue=8), [], (12, 200.0, 7)
    if name == "kill":
        return (dict(engine=_ecfg(cls, deadline_s=2.0), replicas=2, max_queue=8,
                     reform_after_steps=4), [(4, 1)], (12, 200.0, 7))
    if name == "paged_kill":
        paged = _ecfg(cls, deadline_s=2.0, cache_layout="paged", page_size=8,
                      prefix_sharing=True)
        return (dict(engine=paged, replicas=2, max_queue=8, reform_after_steps=4),
                [(4, 1)], (12, 200.0, 7))
    slo = slo_cls(tpot_budget_s=1.0)
    f32 = _ecfg(cls, slo=slo, fused_head=True)
    i8 = _ecfg(cls, slo=slo, fused_head=True, weight_quant="int8")
    return (dict(engine=f32, replicas=3, reform_after_steps=4, replica_engines=(f32, f32, i8)),
            [(4, 1)], (12, 300.0, 3))


ARMS = ["no_kill", "kill", "paged_kill", "mixed"]


@pytest.fixture(scope="module")
def arms(pair):
    """Each arm's (JAX report, port report, JAX receipts, port receipts)."""
    jm, params, tm = pair
    out = {}
    for name in ARMS:
        jkw, kills, wl = _arm(name, JaxServeConfig, JaxSLO)
        tkw, _, _ = _arm(name, ServeConfig, SLOConfig)
        jrp, trp = _Replanner(), _Replanner()
        jrep = JaxRouter(jm, params, JaxFleetConfig(**jkw), replanner=jrp).run(
            _workload(*wl, fn=jax_poisson), kills=kills)
        trep = _router(tm, FleetConfig(**tkw), replanner=trp).run(_workload(*wl), kills=kills)
        out[name] = (jrep, trep, jrp.calls, trp.calls)
    return out


@pytest.mark.parametrize("arm", ARMS)
def test_router_report_is_jax_s(arms, arm):
    """``to_dict()`` — the event CRC, steps, counts, per-replica rows,
    latency summary and replan receipts — and the canonical event log,
    byte for byte."""
    jrep, trep, jcalls, tcalls = arms[arm]
    assert trep.canonical_events() == jrep.canonical_events()
    assert trep.to_dict() == jrep.to_dict()
    assert trep.queue_depth == jrep.queue_depth
    assert tcalls == jcalls
    if arm != "no_kill":
        assert trep.kills == 1 and trep.drains >= 1 and trep.replans


@pytest.mark.parametrize("arm", ARMS)
def test_router_token_streams_are_jax_s(arms, arm):
    jrep, trep, *_ = arms[arm]
    assert set(trep.requests) == set(jrep.requests)
    for rid, st in trep.requests.items():
        js = jrep.requests[rid]
        assert st.tokens == js.tokens, rid
        assert st.token_times == js.token_times, rid
        assert (st.readmits, st.replicas_visited) == (js.readmits, js.replicas_visited), rid
