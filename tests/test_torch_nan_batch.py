"""A NaN batch through ResNet and the MoE LM, against ``tpudml``, on the CPU.

Both models take ``tpudml_torch.nn.layers.relu``, whose derivative is
``jax.nn.relu``'s: 0 at a NaN input, where ``F.relu``'s backward passes
the gradient. So one NaN step poisons the same gradient leaves as in JAX,
and ``GradSentinel`` names the same ``bad_leaf``:

- the small ResNet (``tests/test_resnet.py``'s ``small_resnet``) on a
  batch with NaN at ``corrupt_microbatch``'s seeded positions;
- the MoE LM (``tests/test_torch_task5.py``'s config), gather and ragged
  dispatch, with a NaN at one token of the batch (its embedding row: a
  token id cannot hold a NaN), the sequence's last so that only its own
  row carries the NaN forward.

Each leaf's gradient is NaN exactly where JAX's is (the token table
within JAX's NaN rows: the embedding's defined difference, JAX's one-hot
matmul spreading 0·NaN over rows the batch does not hold; under ragged
dispatch the experts' w1, w2 within JAX's too, whose grouped dW on the
CPU spreads one slab's NaN row over every expert); the finite rest within
``GRAD_TOL`` (rtol 1e-4, atol 1e-6); JAX's ``GradSentinel`` and the port's
skip the step and name the same leaf. The same batch with ``F.relu``
swapped in poisons other leaves than JAX's (the fault this pins; under
ragged dispatch the ReLU runs inside ``ragged_ffn``, whose backward
selects where ``hidden > 0`` as XLA computes JAX's mask product).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_resnet import small_resnet  # noqa: E402
from tpudml import resilience as jres  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import Sgd as JaxSgd  # noqa: E402
from tpudml.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from tpudml.train import resolve_aux_loss_weight as jax_aux_weight  # noqa: E402
from tpudml_torch.data import synthetic_classification, synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml, resnet_params_from_tpudml  # noqa: E402
from tpudml_torch.models import ResNet, TransformerLM  # noqa: E402
from tpudml_torch.nn import layers  # noqa: E402
from tpudml_torch.optim import Sgd  # noqa: E402
from tpudml_torch.resilience import (  # noqa: E402
    GradSentinel, corrupt_microbatch, param_leaf_names, sentinel_stats,
)
from tpudml_torch.train import local_grads, make_loss_fn  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LM_CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2, max_len=32,
              rope=True, impl="flash", fused_ln=True, moe_experts=4)
LM_B = 4


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _port_grads(model, x, y, relu=None):
    """The port's gradients by name (``relu`` swapped in for
    ``layers.relu`` when given)."""
    saved = layers.relu
    if relu is not None:
        layers.relu = relu
    try:
        grads, _ = local_grads(make_loss_fn(model), model, torch.from_numpy(x),
                               torch.from_numpy(y).long())
    finally:
        layers.relu = saved
    return {n: g.detach() for n, g in grads.items()}


def _jax_grads(model, params, state, x, y):
    fn = jax_make_loss_fn(model, aux_loss_weight=jax_aux_weight(model, None))
    (_, _), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        params, state, jnp.asarray(x), jnp.asarray(y))
    return grads


def _nan_leaves(grads: dict) -> set:
    return {n for n, g in grads.items() if bool(torch.isnan(g).any())}


def _check(got: dict, want: dict, jax_grads, jax_params, names_in_jax_order,
           ragged: bool = False):
    """Per-leaf NaN masks equal, the finite rest close; both sentinels skip
    and name the same leaf; the poisoned set is not empty."""
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n]
        if n == "tok_embed" or (ragged and n.endswith(("experts.w1", "experts.w2"))):
            # The embedding's defined difference: JAX's one-hot matmul
            # spreads 0·NaN over every row, the port's index_add writes
            # the batch's tokens' rows only. Likewise JAX's grouped dW on
            # the CPU (a one-hot-masked product over all rows) spreads a
            # NaN row of one expert's slab over every expert's dW; the
            # port's sums each expert's own slab.
            assert bool(g.isnan().any()) == bool(w.isnan().any())
            assert not bool((g.isnan() & ~w.isnan()).any())
            keep = ~w.isnan()
        else:
            assert torch.equal(g.isnan(), w.isnan()), n
            keep = ~w.isnan()
        np.testing.assert_allclose(g[keep].numpy(), w[keep].numpy(), err_msg=n, **GRAD_TOL)
    assert _nan_leaves(want)
    params = {n: torch.zeros_like(g) for n, g in got.items()}
    sent = GradSentinel(Sgd(lr=0.1))
    _, state = sent.update(got, sent.init(params), params)
    jsent = jres.GradSentinel(JaxSgd(lr=0.1))
    _, jstate = jsent.update(jax_grads, jsent.init(jax_params), jax_params)
    st, jst = sentinel_stats(state), jres.sentinel_stats(jstate)
    assert st["skips"] == jst["skips"] == 1
    jnames = jres.param_leaf_names(jax_params)
    assert names_in_jax_order[st["bad_leaf"]] == jnames[jst["bad_leaf"]]


def test_resnet_nan_batch_poisons_the_leaves_jax_poisons():
    jm = small_resnet()
    params, state = jm.init(seed_key(3))
    tm = ResNet(stage_sizes=(1, 1), width=8, device="cpu")
    tm.load_state_dict(resnet_params_from_tpudml(_np(params), _np(state)))
    x, y = synthetic_classification(8, (32, 32, 3), 10, seed=4)
    x = corrupt_microbatch(x, "nan", seed=5, frac=0.001)
    assert np.isnan(x).any()
    jgrads = _jax_grads(jm, params, state, x, y)
    want = resnet_params_from_tpudml(_np(jgrads), {})
    got = _port_grads(tm, x, y)
    _check(got, want, jgrads, params, param_leaf_names(tm))
    # F.relu passes the gradient through the NaN inputs: other leaves.
    assert _nan_leaves(_port_grads(tm, x, y, relu=torch.nn.functional.relu)) != \
        _nan_leaves(want)


@pytest.mark.parametrize("dispatch", ["gather", "ragged"])
def test_moe_lm_nan_batch_poisons_the_leaves_jax_poisons(dispatch):
    jm = JaxLM(**LM_CFG, moe_dispatch=dispatch)
    params, state = jm.init(jax.random.key(2))
    seqs = synthetic_lm(LM_B, LM_CFG["max_len"], LM_CFG["vocab_size"] - 1, seed=6)
    x, y = seqs[:, :-1].copy(), seqs[:, 1:].copy()
    bad = LM_CFG["vocab_size"] - 1  # appears once: the last token of row 0
    x[0, -1] = bad
    params = jax.tree.map(lambda a: a, params)
    params["tok_embed"] = params["tok_embed"].at[bad, 0].set(jnp.nan)
    tm = TransformerLM(**LM_CFG, moe_dispatch=dispatch, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(_np(params)))
    jgrads = _jax_grads(jm, params, state, x, y)
    want = lm_params_from_tpudml(_np(jgrads))
    got = _port_grads(tm, x, y)
    _check(got, want, jgrads, params, param_leaf_names(tm), ragged=dispatch == "ragged")
    if dispatch == "gather":  # ragged's ReLU runs inside ragged_ffn's own backward
        assert _nan_leaves(_port_grads(tm, x, y, relu=torch.nn.functional.relu)) != \
            _nan_leaves(want)
