"""The serving slice of the PyTorch port as a whole, against ``tpudml``.

A tiny LM (V=64, d=32, H=4, kv=2, L=2, max_len=32) is initialized in JAX
and carried across with ``lm_params_from_tpudml``; every comparison runs
on the CPU, where the port's kernel wrappers run their plain versions.

- full-forward logits and decode-step logits/features: f32 at
  rtol=1e-5, atol=1e-6 (the JAX package's parity tolerances);
- the engine on the fixture prompts of tests/test_mfu_fusion.py under a
  virtual clock: token streams AND the scheduler event log identical to
  the JAX engine's, for unfused, fused-head and int8 fused-head decode;
- ``poisson_workload`` bitwise; the task CLI exits 0 on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.serve import Request as JaxRequest  # noqa: E402
from tpudml.serve import ServeConfig as JaxServeConfig  # noqa: E402
from tpudml.serve import ServingEngine as JaxEngine  # noqa: E402
from tpudml.serve import poisson_workload as jax_poisson  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from tpudml_torch.serve import poisson_workload  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=32)
TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(rope: bool):
    jm = JaxLM(**CFG, rope=rope)
    params, _ = jm.init(jax.random.key(0))
    tm = TransformerLM(**CFG, rope=rope, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def rope_pair():
    return _pair(True)


@pytest.mark.parametrize("rope", [True, False])
def test_full_forward_logits_match_jax(rope):
    jm, params, tm = _pair(rope)
    tokens = np.random.default_rng(1).integers(0, 64, (2, 12)).astype(np.int32)
    ref, _ = jax.jit(jm.apply)(params, {}, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _decode_operands(jm, params, tm):
    """Prefill a prompt into slot 0 and one into slot 1 on both sides,
    then return matched decode inputs."""
    rng = np.random.default_rng(2)
    jc = jm.init_decode_cache(2, 32)
    tc = tm.init_decode_cache(2, 32)
    prefill = jax.jit(jm.apply_prefill, static_argnums=(4,))
    for slot in (0, 1):
        chunk = rng.integers(0, 64, (1, 4)).astype(np.int32)
        jc = prefill(params, jc, jnp.asarray(chunk),
                     jnp.asarray(slot, jnp.int32), 0)
        with torch.no_grad():
            tc = tm.apply_prefill(tc, torch.from_numpy(chunk).long(), slot, 0)
    tokens = rng.integers(0, 64, 2).astype(np.int32)
    pos = np.array([4, 4], np.int32)
    return jc, tc, tokens, pos


@pytest.mark.parametrize("features", [False, True])
def test_decode_step_matches_jax(rope_pair, features):
    jm, params, tm = rope_pair
    jc, tc, tokens, pos = _decode_operands(jm, params, tm)
    jfn = jax.jit(jm.apply_decode_features if features else jm.apply_decode)
    ref, jc = jfn(params, jc, jnp.asarray(tokens), jnp.asarray(pos))
    tfn = tm.apply_decode_features if features else tm.apply_decode
    with torch.no_grad():
        got, tc = tfn(tc, torch.from_numpy(tokens).long(),
                      torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for j, t in zip(jc, tc):  # the caches hold the same K/V afterwards
        np.testing.assert_allclose(t.k.numpy(), np.asarray(j.k), **TOL)
        np.testing.assert_allclose(t.v.numpy(), np.asarray(j.v), **TOL)


_PROMPTS = [[1, 7, 3, 12, 9], [40, 2, 2, 31], [5, 19, 23, 8, 44, 17], [11, 30]]


def _serve(engine_cls, req_cls, cfg_cls, model, params, **kw):
    cfg = cfg_cls(slots=2, max_len=32, prefill_chunk=4, step_time_s=0.01, **kw)
    reqs = [req_cls(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=6)
            for i, p in enumerate(_PROMPTS)]
    if params is None:
        rep = engine_cls(model, cfg, device="cpu").run(reqs)
    else:
        rep = engine_cls(model, params, cfg).run(reqs)
    streams = {rid: st.tokens for rid, st in rep.requests.items()}
    times = {rid: (st.first_token, st.finished) for rid, st in rep.requests.items()}
    return streams, rep.events, times, rep.decode_steps


@pytest.mark.parametrize("kw", [
    {},
    {"fused_head": True},
    {"fused_head": True, "weight_quant": "int8"},
], ids=["unfused", "fused_head", "fused_head_int8"])
def test_engine_streams_and_events_match_jax(rope_pair, kw):
    jm, params, tm = rope_pair
    ref = _serve(JaxEngine, JaxRequest, JaxServeConfig, jm, params, **kw)
    got = _serve(ServingEngine, Request, ServeConfig, tm, None, **kw)
    assert got[0] == ref[0]  # token streams
    assert got[1] == ref[1]  # scheduler event log
    assert got[2] == ref[2]  # virtual-clock first-token / finish times
    assert got[3] == ref[3]  # decode steps
    assert all(len(s) == 6 for s in got[0].values())


def test_poisson_workload_bitwise():
    for qps in (4.0, float("inf")):
        a, la = poisson_workload(16, qps, 7, vocab_size=100,
                                 prompt_len=(3, 40), new_tokens=(2, 9))
        b, lb = jax_poisson(16, qps, 7, vocab_size=100,
                            prompt_len=(3, 40), new_tokens=(2, 9))
        assert la == lb
        for x, y in zip(a, b):
            assert (x.rid, x.max_new_tokens, x.arrival_time) == \
                (y.rid, y.max_new_tokens, y.arrival_time)
            assert x.prompt.dtype == y.prompt.dtype
            np.testing.assert_array_equal(x.prompt, y.prompt)


def test_not_ported_levers_raise(rope_pair):
    _, _, tm = rope_pair
    for kw in ({"cache_layout": "paged"}, {"spec_k": 2}, {"slo": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(tm, ServeConfig(slots=2, max_len=32, prefill_chunk=4,
                                          **kw), device="cpu")


def test_task_cli_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "tpudml_torch.tasks.task6_serve",
         "--device", "cpu", "--n_requests", "4", "--qps", "inf",
         "--embed_dim", "32", "--num_heads", "4", "--num_layers", "1",
         "--max_len", "64", "--prompt_len", "4", "8", "--new_tokens", "4", "8",
         "--log_dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "[serve/f32/cpu] 4 requests" in out.stdout
