"""The port's flight recorder (``tpudml_torch.obs``) against ``tpudml.obs``,
on the CPU.

- the tracer writes ``tests/obs_fixtures/golden_trace.json`` byte for byte
  from JAX's golden event log, and its validator, merge and summary agree
  with JAX's on the same documents;
- ``serve_trace_events`` / ``write_serve_trace`` / ``ServeReport.
  to_trace_events`` equal JAX's conversion of the event log of the PR 11
  golden serve run (paged + spec at 2× overload on the virtual clock), a
  log the port reproduces byte for byte (``tests/test_torch_sched.py``);
- ``DataParallel(obs=True)`` on two gloo ranks (``tests/torch_dist_worker.py``'s
  ``obs`` suite) against JAX's engine on a 2-device CPU mesh: StepStats at
  rtol 1e-5, the same span names, fused and split; with obs off no span
  is allocated and no ``step_stats`` returned.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from tpudml import obs as jobs  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import GradientDescent as JaxGD  # noqa: E402
from tpudml.parallel.dp import DataParallel as JaxDP  # noqa: E402
from tpudml_torch import obs  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.obs import tracer as tracer_mod  # noqa: E402
from tpudml_torch.optim import GradientDescent  # noqa: E402
from tpudml_torch.parallel import DataParallel  # noqa: E402
from tpudml_torch.serve import ServeConfig, ServingEngine, poisson_workload  # noqa: E402

FIXTURES = Path(__file__).parent / "obs_fixtures"
CFG = dict(vocab_size=63, embed_dim=32, num_heads=4, num_layers=2, max_len=16, rope=True,
           fused_ln=True)
B, T, WORLD, LR, STEPS = 4, 16, 2, 0.1, 2
STATS_RTOL = 1e-5


def golden(mod):
    """The fixed event log behind ``golden_trace.json`` (JAX's
    ``tests/test_obs.py::golden_tracer``), recorded by ``mod``'s Tracer."""
    tr = mod.Tracer(clock=lambda: 0.0)
    tr.add_complete("train_step", cat="step", ts_us=0, dur_us=1500, tid=0)
    tr.add_complete("psum", cat="comm", ts_us=100, dur_us=300, tid=0, args={"bytes": 4096})
    tr.add_complete("checkpoint_save", cat="checkpoint", ts_us=1600, dur_us=400, tid=1,
                    args={"step": 3})
    tr.instant("sentinel_trip", cat="sentinel", ts_us=900, args={"step": 2, "consecutive": 1})
    tr.instant("launch_restart", cat="launch", ts_us=2100, args={"attempt": 1, "why": "exit 1"})
    return tr


def test_chrome_trace_matches_golden_bytes(tmp_path):
    got = obs.dump_trace(golden(obs).chrome_trace(pid=0)).encode()
    assert got == (FIXTURES / "golden_trace.json").read_bytes()
    path = golden(obs).export(tmp_path / "trace.json", pid=0)
    assert path.read_bytes() == (FIXTURES / "golden_trace.json").read_bytes()
    assert obs.TRACE_SCHEMA_VERSION == jobs.TRACE_SCHEMA_VERSION


def _malformed():
    doc = golden(jobs).chrome_trace(pid=0)
    float_ts = json.loads(json.dumps(doc))
    float_ts["traceEvents"][1]["ts"] = 0.5
    no_pid = json.loads(json.dumps(doc))
    del no_pid["traceEvents"][2]["pid"]
    bad_ph = json.loads(json.dumps(doc))
    bad_ph["traceEvents"][3]["ph"] = "B"
    return {"golden": doc, "list": [], "no_schema": {"traceEvents": [], "metadata": {}},
            "float_ts": float_ts, "no_pid": no_pid, "bad_ph": bad_ph}


def _outcome(fn, doc):
    try:
        fn(doc)
        return "ok"
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("name", list(_malformed()))
def test_validate_agrees_with_jax(name):
    doc = _malformed()[name]
    assert _outcome(obs.validate_chrome_trace, doc) == _outcome(jobs.validate_chrome_trace, doc)


def test_merge_and_summary_agree_with_jax():
    docs = [golden(obs).chrome_trace(pid=p) for p in (1, 0)]
    merged = obs.merge_chrome_traces(docs)
    assert obs.dump_trace(merged) == jobs.dump_trace(jobs.merge_chrome_traces(docs))
    assert obs.dump_trace(merged) == obs.dump_trace(obs.merge_chrome_traces(docs[::-1]))
    with pytest.raises(ValueError, match="duplicate pid"):
        obs.merge_chrome_traces([docs[0], docs[0]])
    assert golden(obs).summary() == golden(jobs).summary()


def test_ambient_tracer_and_span_sync():
    assert obs.get_tracer() is tracer_mod.NULL_TRACER
    tr = obs.Tracer()
    with obs.use_tracer(tr):
        assert obs.get_tracer() is tr
        with obs.get_tracer().span("inner", cat="test", sync=torch.ones(2)):
            pass
    assert obs.get_tracer() is tracer_mod.NULL_TRACER
    assert [(s.cat, s.name) for s in tr.events] == [("test", "inner")]
    before = tracer_mod.SPANS_ALLOCATED
    with obs.Tracer(enabled=False).span("x"):
        pass
    assert tracer_mod.SPANS_ALLOCATED == before


# ------------------------------------------------------ serve conversion


@pytest.fixture(scope="module")
def serve_run():
    """The PR 11 golden serve config on the port (its event log equals
    JAX's: ``tests/test_torch_sched.py``)."""
    cfg = dict(vocab_size=48, embed_dim=32, num_heads=4, num_layers=2, num_kv_heads=2,
               max_len=32, rope=True)
    model = TransformerLM(**cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    kw = dict(slots=1, max_len=32, prefill_chunk=4, cache_layout="paged", page_size=4,
              spec_k=2, max_queue=2, step_time_s=0.01)
    reqs, _ = poisson_workload(10, 40.0, seed=5, vocab_size=48, prompt_len=(2, 6),
                               new_tokens=(8, 8))
    return ServingEngine(model, ServeConfig(**kw), device="cpu", draft_layers=1).run(reqs)


def test_serve_trace_events_equal_jax(serve_run, tmp_path):
    events = serve_run.events
    assert {e[0] for e in events} >= {"admit", "spec", "reject"}
    for step_time_s in (0.01, None):
        want = jobs.serve_trace_events(events, step_time_s=step_time_s)
        assert obs.serve_trace_events(events, step_time_s=step_time_s) == want
        assert serve_run.to_trace_events(step_time_s) == want
    a = obs.write_serve_trace(serve_run, tmp_path / "a" / "trace.json", step_time_s=0.01, pid=0)
    b = jobs.write_serve_trace(serve_run, tmp_path / "b" / "trace.json", step_time_s=0.01,
                               pid=0)
    assert a.read_bytes() == b.read_bytes()
    doc = json.loads(a.read_text())
    obs.validate_chrome_trace(doc)
    residency = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert residency and all(e["tid"] >= 1 for e in residency)


def test_serve_trace_events_pure_conversion():
    events = [("admit", 7, 0, 0), ("spec", 7, 0, 2, 1), ("reject", 9, -1, 3),
              ("evict", 7, 0, 5), ("admit", 8, 0, 6)]
    evs = obs.serve_trace_events(events, step_time_s=0.01)
    assert evs == jobs.serve_trace_events(events, step_time_s=0.01)
    spans = {(s["name"], s["ts"], s["dur"], s["tid"]) for s in evs if s["ph"] == "X"}
    assert spans == {("slot0:rid7", 0, 50_000, 1), ("slot0:rid8", 60_000, 0, 1)}


# ----------------------------------------------------- DataParallel(obs=)


def _batches():
    seqs = synthetic_lm(4 * B, T, CFG["vocab_size"], seed=3)
    rng = np.random.default_rng(3)
    out = []
    for _ in range(STEPS):
        batch = seqs[rng.integers(0, len(seqs), size=B)]
        out.append((batch[:, :-1], batch[:, 1:]))
    return out


def _jax_obs(batches, **kw):
    mesh = make_mesh(MeshConfig({"data": WORLD}), jax.devices()[:WORLD])
    tr = jobs.Tracer()
    dp = JaxDP(JaxLM(**CFG), JaxGD(lr=LR), mesh, stacked_batches=False, obs=tr, **kw)
    ts = dp.create_state(seed_key(4))
    params = jax.tree.map(np.asarray, ts.params)
    step = dp.make_train_step()
    stats = []
    for tokens, labels in batches:
        ts, m = step(ts, tokens, labels)
        stats.append({k: float(v) for k, v in m["step_stats"].to_scalars().items()})
    events = [(e.cat, e.name, (e.args or {}).get("bytes")) for e in tr.events]
    return params, stats, events, dp.comm_stats.comm_bytes


@pytest.fixture(scope="module")
def obs_runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("obs")
    batches = _batches()
    params, fused, fused_events, _ = _jax_obs(batches)
    _, split, split_events, split_bytes = _jax_obs(batches, measure_comm=True)
    torch.save({"model": CFG, "params": lm_params_from_tpudml(params), "lr": LR,
                "batches": batches}, job / "cases.pt")
    want = {"fused": (fused, fused_events), "split": (split, split_events, split_bytes)}
    return want, torch_dist_worker.spawn("obs", job, WORLD)


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_dp_step_stats_match_jax_at_world_2(obs_runs, mode):
    want, ranks = obs_runs
    stats, events = want[mode][:2]
    for got in ranks:
        assert len(got[mode]["stats"]) == STEPS
        for g, w in zip(got[mode]["stats"], stats):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=STATS_RTOL, err_msg=k)
        assert [e[:2] for e in got[mode]["events"]] == [e[:2] for e in events]
    assert ranks[0][mode]["stats"] == ranks[1][mode]["stats"]


def test_split_step_stats_match_measured_comm(obs_runs):
    """The split step's comm-bytes leaf is its measured ring-model bytes:
    equal to its CommStats accounting and to JAX's, and its comm spans
    carry them."""
    want, ranks = obs_runs
    for got in ranks:
        split = got["split"]
        assert split["stats"][-1]["comm_bytes"] == pytest.approx(split["comm_bytes"], rel=1e-9)
        assert split["comm_bytes"] == pytest.approx(want["split"][2], rel=1e-9)
        comm = [e for e in split["events"] if e[0] == "comm"]
        assert len(comm) == STEPS and all(e[2] and e[2] > 0 for e in comm)


def test_obs_off_allocates_zero_spans(obs_runs, tmp_path):
    _, ranks = obs_runs
    for got in ranks:
        assert got["off_spans"] == 0
        assert got["off"]["stats"] == [None] * STEPS and got["off"]["events"] is None
    # and in this process, at world 1
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store",
                                         num_processes=1), device="cpu"):
        model = TransformerLM(**CFG, device="cpu", generator=torch.Generator().manual_seed(0))
        dp = DataParallel(model, GradientDescent(lr=LR), stacked_batches=False)
        ts, step = dp.create_state(), dp.make_train_step()
        before = tracer_mod.SPANS_ALLOCATED
        for tokens, labels in _batches():
            ts, m = step(ts, tokens, labels)
        assert tracer_mod.SPANS_ALLOCATED == before
        assert "step_stats" not in m and dp.tracer is None
