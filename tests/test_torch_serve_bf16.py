"""bf16-compute serving in the PyTorch port against the JAX package's
``compute_dtype=bfloat16`` model and engine, on the CPU.

Both sides cast the embeddings, blocks and head to bf16 and keep the
LayerNorms f32 (JAX's ``_cast_params``); activations round to bf16 after
every op. They round in different places — XLA fuses elementwise ops under
``jit`` and keeps their intermediates in f32, PyTorch rounds op by op — so
values land one or two bf16 steps apart (JAX's own jitted and eager decode
logits differ as much). BF16_REL_TOL bounds that: every compared value
within BF16_REL_TOL × the largest |value| of JAX's tensor, four bf16
steps (2^-7 relative spacing) at its binade.

- decode logits (unfused: bf16 head) and the K/V the prefill wrote;
- the fused tail: the port feeds the bf16 features, widened exactly to
  f32, with the uncast f32 head into the decode head, as JAX's fused step
  does (``preferred_element_type=f32``; JAX promotes the bf16 features to
  f32 without rounding anywhere, checked here against JAX's reference head
  on f32 features). Tokens, max logit and lse against JAX's fused step;
- engine runs (unfused, fused head, paged, spec): event logs identical to
  JAX's, token streams identical up to a first divergence, which must sit
  at a near-tie of JAX's logits (top-2 gap within the tolerance).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.ops.decode_head import _reference_head, fused_decode_head  # noqa: E402
from tpudml.serve import Request as JaxRequest  # noqa: E402
from tpudml.serve import ServeConfig as JaxServeConfig  # noqa: E402
from tpudml.serve import ServingEngine as JaxEngine  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.ops import reference_head  # noqa: E402
from tpudml_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from tpudml_torch.serve.engine import make_fused_decode_step  # noqa: E402

CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2, num_layers=2,
           max_len=32, rope=True)
BF16_REL_TOL = 2.0 ** -5
_PROMPTS = [[1, 7, 3, 12, 9], [40, 2, 2, 31], [5, 19, 23, 8, 44, 17], [11, 30]]


def _pair(seed: int):
    jm = JaxLM(**CFG, compute_dtype=jnp.bfloat16)
    params, _ = jm.init(jax.random.key(seed))
    tm = TransformerLM(**CFG, compute_dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= BF16_REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def _f32(t):
    return t.float().numpy()


def _prefilled(jm, params, tm, seed):
    """Both caches after an 8-token prefill of slots 0 and 1, and matched
    decode inputs at position 8."""
    rng = np.random.default_rng(seed)
    jc, tc = jm.init_decode_cache(2, 32), tm.init_decode_cache(2, 32)
    prefill = jax.jit(jm.apply_prefill, static_argnums=(4,))
    for slot in (0, 1):
        chunk = rng.integers(0, 64, (1, 8)).astype(np.int32)
        jc = prefill(params, jc, jnp.asarray(chunk), jnp.asarray(slot, jnp.int32), 0)
        with torch.no_grad():
            tc = tm.apply_prefill(tc, torch.from_numpy(chunk).long(), slot, 0)
    tokens = rng.integers(0, 64, 2).astype(np.int32)
    pos = np.array([8, 8], np.int32)
    return jc, tc, tokens, pos


@pytest.mark.parametrize("seed", range(3))
def test_bf16_decode_logits_match_jax(seed):
    jm, params, tm = _pair(seed)
    jc, tc, tokens, pos = _prefilled(jm, params, tm, seed)
    for j, t in zip(jc, tc):
        _close(t.k.numpy(), j.k)
        _close(t.v.numpy(), j.v)
    ref, _ = jax.jit(jm.apply_decode)(params, jc, jnp.asarray(tokens), jnp.asarray(pos))
    with torch.no_grad():
        got, _ = tm.apply_decode(tc, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(pos).long())
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close(_f32(got), ref)
    feats, _ = jax.jit(jm.apply_decode_features)(params, jc, jnp.asarray(tokens),
                                                 jnp.asarray(pos))
    with torch.no_grad():
        tfeats, _ = tm.apply_decode_features(tc, torch.from_numpy(tokens).long(),
                                             torch.from_numpy(pos).long())
    assert tfeats.dtype == torch.bfloat16 and feats.dtype == jnp.bfloat16
    _close(_f32(tfeats), feats)


def test_jax_fused_head_widens_bf16_features_exactly():
    """What the port mirrors: JAX's head kernel (interpret mode) and its
    reference take bf16 features with the f32 head and equal the f32
    reference on the widened features bitwise."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((5, 32)).astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((32, 300)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(300).astype(np.float32))
    want = _reference_head(x.astype(jnp.float32), w, b)
    for got in (fused_decode_head(x, w, b, block_n=8, block_v=128, interpret=True),
                _reference_head(x, w, b)):
        for g, r in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    port = reference_head(*(torch.from_numpy(np.array(a, np.float32)) for a in (x, w, b)))
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("seed", range(3))
def test_bf16_fused_tail_matches_jax(seed):
    jm, params, tm = _pair(seed)
    jc, tc, tokens, pos = _prefilled(jm, params, tm, seed)
    cfg = JaxServeConfig(slots=2, max_len=32, prefill_chunk=4, fused_head=True)
    jeng = JaxEngine(jm, params, cfg)
    feats, _ = jax.jit(jm.apply_decode_features)(params, jc, jnp.asarray(tokens),
                                                 jnp.asarray(pos))
    jtok, jstats, _ = jeng._decode(params, jc, jnp.asarray(tokens), jnp.asarray(pos))
    ttok, tstats = make_fused_decode_step(tm)(tc, torch.from_numpy(tokens).long(),
                                              torch.from_numpy(pos).long())
    _close(tstats["max_logit"].numpy(), jstats["max_logit"])
    _close(tstats["lse"].numpy(), jstats["lse"])
    # JAX's f32 logits on its features: a token may differ at a near-tie.
    logits = np.asarray(feats, np.float32) @ np.asarray(params["head"]["kernel"]) \
        + np.asarray(params["head"]["bias"])
    top2 = np.sort(logits, axis=-1)[:, -2:]
    tol = BF16_REL_TOL * np.abs(logits).max()
    for i in range(len(tokens)):
        assert int(ttok[i]) == int(jtok[i]) or top2[i, 1] - top2[i, 0] <= tol


def _check_streams(jm, params, jrep, trep):
    """Streams equal up to a first divergence at a near-tie of JAX's
    full-forward logits."""
    for i, prompt in enumerate(_PROMPTS):
        a, b = jrep.requests[i].tokens, trep.requests[i].tokens
        assert len(a) == len(b)
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = jnp.asarray([list(prompt) + a[:k]], jnp.int32)
        row = np.asarray(jm.apply(params, {}, seq)[0][0, -1], np.float32)
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] <= BF16_REL_TOL * np.abs(row).max(), (i, k, top2)


@pytest.mark.parametrize("kw", [
    {},
    {"fused_head": True},
    {"cache_layout": "paged", "page_size": 4},
    {"spec_k": 1},
], ids=["unfused", "fused_head", "paged", "spec"])
def test_bf16_engine_runs_match_jax(kw):
    jm, params, tm = _pair(2)
    cfg = dict(slots=2, max_len=32, prefill_chunk=4, step_time_s=0.01, **kw)
    jrep = JaxEngine(jm, params, JaxServeConfig(**cfg)).run(
        [JaxRequest(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=6)
         for i, p in enumerate(_PROMPTS)])
    trep = ServingEngine(tm, ServeConfig(**cfg), device="cpu").run(
        [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=6)
         for i, p in enumerate(_PROMPTS)])
    if "spec_k" not in kw:  # spec commit counts follow the tokens
        assert trep.events == jrep.events
    _check_streams(jm, params, jrep, trep)
    assert trep.generated_tokens == jrep.generated_tokens == 24
