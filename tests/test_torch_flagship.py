"""The flagship LM step (``bench.py`` ``bench_transformer``) on the port
against ``tpudml``, on the CPU.

Config: bench.py's CPU smoke (V=256, d=64, H=4, L=2, T=128, B=4) with the
flagship's ``impl="flash"`` and RoPE, ``fused_ln`` off and on, f32 and
``compute_dtype=bfloat16`` with f32 master weights. On the CPU the JAX
model's flash attention, fused add+LN and fused head dispatch to their
reference math; the port's run the plain versions of its kernels through
the same autograd Functions the card runs. Parameters are carried across
with ``lm_params_from_tpudml``; batches come from ``synthetic_lm``.

Tolerances:
- f32: loss rtol 1e-5; every gradient rtol 1e-4 / atol 1e-6
  (``tests/test_torch_train.py``'s tolerance for the trunk: sums over T, d and the embedding rows in
  another order); the losses of three AdamW steps rtol 1e-5.
- bf16: loss rtol 1e-3; each gradient within 3e-2 of the largest
  magnitude of the f32 model's gradient (the same parameters computed in
  f32: the truth both bf16 runs approximate) and within 5e-2 of it from
  JAX's bf16 gradient. bf16 keeps 8 bits: every product, add and
  activation of the trunk rounds to 2^-8 relative, at places that differ
  between XLA's fusions and PyTorch's eager ops, and the errors of a few
  hundred such roundings compound through two blocks and the backward.
  The JAX bound is the wider one because XLA on the CPU sums the Dense
  bias gradients over the 512 rows in bf16: JAX's own bf16 bias gradients
  lie up to 4.4e-2 of the max from its f32 ones, the port's (f32 sums)
  within 1e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import AdamW as JaxAdamW  # noqa: E402
from tpudml.train import TrainState as JaxTrainState  # noqa: E402
from tpudml.train import make_lm_fused_loss_fn as jax_fused_loss_fn  # noqa: E402
from tpudml.train import make_lm_fused_train_step as jax_fused_step  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.optim import AdamW  # noqa: E402
from tpudml_torch.train import (  # noqa: E402
    TrainState, make_lm_fused_loss_fn, make_lm_fused_train_step, make_loss_fn,
    params_of,
)

CFG = dict(vocab_size=256, embed_dim=64, num_heads=4, num_layers=2, max_len=128,
           rope=True)
B, T = 4, 128
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_RTOL = 3e-2  # of max |f32 gradient|, against the f32 gradient
BF16_JAX_GRAD_RTOL = 5e-2  # of max |f32 gradient|, against JAX's bf16 gradient
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(fused_ln, dtype="f32", seed=0):
    jdt, tdt = DTYPES[dtype]
    jm = JaxLM(**CFG, impl="flash", fused_ln=fused_ln, compute_dtype=jdt)
    params, _ = jm.init(jax.random.key(seed))
    tm = TransformerLM(**CFG, impl="flash", fused_ln=fused_ln, compute_dtype=tdt,
                       device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(_to_np(params)))
    return jm, params, tm


def _batch(seed=1):
    """bench.py's batch: ``synthetic_lm(B, T, V, seed=1)`` sliced to
    (tokens, labels)."""
    seqs = synthetic_lm(B, T, CFG["vocab_size"], seed=seed)
    return seqs[:, :-1], seqs[:, 1:]


def _jax_value_and_grads(jm, params, tokens, labels):
    fn = jax.value_and_grad(jax_fused_loss_fn(jm, save_scores=True), has_aux=True)
    (loss, _), grads = jax.jit(fn)(params, {}, jnp.asarray(tokens), jnp.asarray(labels))
    return float(loss), lm_params_from_tpudml(_to_np(grads))


def _port_value_and_grads(tm, tokens, labels, fused=True):
    fn = make_lm_fused_loss_fn(tm, save_scores=True) if fused else make_loss_fn(tm)
    loss, _ = fn(torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    p = params_of(tm)
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.item(), {n: g.float() for n, g in zip(p, grads)}


@pytest.mark.parametrize("fused_ln", [False, True], ids=["plain_ln", "fused_ln"])
def test_f32_fused_loss_and_grads_match_jax(fused_ln):
    jm, params, tm = _pair(fused_ln)
    tokens, labels = _batch()
    want, wgrads = _jax_value_and_grads(jm, params, tokens, labels)
    got, grads = _port_value_and_grads(tm, tokens, labels)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert set(grads) == set(wgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), wgrads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("fused_ln", [False, True], ids=["plain_ln", "fused_ln"])
def test_bf16_fused_loss_and_grads_match_jax(fused_ln):
    jm, params, tm = _pair(fused_ln, "bf16")
    tokens, labels = _batch()
    want, wgrads = _jax_value_and_grads(jm, params, tokens, labels)
    jm32, _, _ = _pair(fused_ln)
    _, f32_grads = _jax_value_and_grads(jm32, params, tokens, labels)
    got, grads = _port_value_and_grads(tm, tokens, labels)
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)
    for name, g in grads.items():
        scale = f32_grads[name].abs().max().item()
        err_f32 = (g - f32_grads[name]).abs().max().item()
        err_jax = (g - wgrads[name]).abs().max().item()
        assert err_f32 <= BF16_GRAD_RTOL * scale, (name, err_f32 / scale)
        assert err_jax <= BF16_JAX_GRAD_RTOL * scale, (name, err_jax / scale)


def test_bf16_parameters_stay_f32_and_compute_is_bf16():
    _, _, tm = _pair(True, "bf16")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    tokens, _ = _batch()
    with torch.no_grad():
        feats = tm.apply_features(torch.from_numpy(tokens).long())
        logits = tm(torch.from_numpy(tokens).long())
    assert feats.dtype == logits.dtype == torch.bfloat16


def test_fused_and_materialized_heads_agree_on_the_port():
    """The fused head and the materialized logits + softmax_cross_entropy
    give the same loss and gradients on in-range labels (f32)."""
    _, _, tm = _pair(True)
    tokens, labels = _batch()
    fused, fgrads = _port_value_and_grads(tm, tokens, labels)
    plain, pgrads = _port_value_and_grads(tm, tokens, labels, fused=False)
    np.testing.assert_allclose(fused, plain, rtol=1e-6)
    for name, g in fgrads.items():
        torch.testing.assert_close(g, pgrads[name], rtol=1e-5, atol=1e-7)


def test_bf16_embedding_backward_sums_in_f32():
    """The defined difference of ROADMAP queue 3: JAX's ``embed_lookup``
    rounds dTable to bf16 once (its gradient is bf16-representable); the
    port gathers from the f32 table and casts, so its dTable is the f32
    sum of the same bf16 cotangents, within one bf16 rounding of JAX's."""
    jm, params, tm = _pair(True, "bf16")
    tokens, labels = _batch()
    _, wgrads = _jax_value_and_grads(jm, params, tokens, labels)
    _, grads = _port_value_and_grads(tm, tokens, labels)
    want, got = wgrads["tok_embed"], grads["tok_embed"]
    assert torch.equal(want, want.bfloat16().float())
    assert not torch.equal(got, got.bfloat16().float())
    assert (got - want).abs().max() <= BF16_JAX_GRAD_RTOL * want.abs().max()


def test_three_adamw_fused_steps_match_jax():
    """bench_transformer's optimizer (AdamW, lr 3e-4, f32) over three fused
    steps of the same batch: the three losses agree."""
    jm, params, tm = _pair(True, seed=2)
    jopt = JaxAdamW(lr=3e-4)
    jts = JaxTrainState(params=params, model_state={}, opt_state=jopt.init(params),
                        step=jnp.zeros((), jnp.int32))
    jstep = jax_fused_step(jm, jopt, save_scores=True)
    opt = AdamW(lr=3e-4)
    ts, step = TrainState.create(tm, opt), make_lm_fused_train_step(tm, opt, save_scores=True)
    tokens, labels = _batch()
    for _ in range(3):
        jts, jmetrics = jstep(jts, jnp.asarray(tokens), jnp.asarray(labels))
        ts, metrics = step(ts, tokens, labels)
        assert set(metrics) == {"loss"}
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]),
                                   rtol=1e-5)
    assert ts.step == 3 == int(jts.step)
