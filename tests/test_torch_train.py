"""The training slice as a whole against ``tpudml``, on the CPU.

The JAX ``TransformerLM(V=64, d=32, H=4, L=2, max_len=16, rope=True)``
runs with ``impl`` in {full, flash} × ``fused_ln`` in {False, True}; on
the CPU its flash attention and fused add+LN dispatch to their reference
math, while the port's run through the plain versions of its kernels
(the same autograd Functions the card runs). Parameters are carried
across with ``lm_params_from_tpudml``; batches come from ``synthetic_lm``.

Tolerances (f32): loss rtol 1e-5; gradients and parameters after three
GD steps rtol 1e-4 / atol 1e-6 (the JAX package's own gradient tolerance
for the flash path in ``tests/test_flash.py``: sums over T, d and the
embedding rows taken in another order); one Adam update rtol 1e-5 /
atol 1e-7 from identical gradients and state. Parameters are not
compared after several Adam steps: Adam turns a rounding difference in
a near-zero gradient into a ±lr step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.data.datasets import synthetic_lm as jax_synthetic_lm  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.nn.losses import softmax_cross_entropy as jax_xent  # noqa: E402
from tpudml.optim import Adam as JaxAdam  # noqa: E402
from tpudml.optim import GradientDescent as JaxGD  # noqa: E402
from tpudml.train import TrainState as JaxTrainState  # noqa: E402
from tpudml.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from tpudml.train import make_train_step as jax_make_train_step  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import adam_state_from_tpudml, lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.nn.losses import softmax_cross_entropy  # noqa: E402
from tpudml_torch.optim import Adam, AdamW, GradientDescent, Sgd, make_optimizer  # noqa: E402
from tpudml_torch.train import (  # noqa: E402
    TrainState, make_loss_fn, make_train_step, make_train_step_body, params_of,
)

CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2, max_len=16,
           rope=True)
B, T = 4, 16
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
COMBOS = [("full", False), ("full", True), ("flash", False), ("flash", True)]
COMBO_IDS = [f"{i}-{'fused' if f else 'plain'}" for i, f in COMBOS]


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(impl, fused_ln, seed=0):
    """(jax model, jax params, port model with the same parameters)."""
    jm = JaxLM(**CFG, impl=impl, fused_ln=fused_ln)
    params, _ = jm.init(jax.random.key(seed))
    tm = TransformerLM(**CFG, impl=impl, fused_ln=fused_ln, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(_to_np(params)))
    return jm, params, tm


def _batches(n, seed=0):
    seqs = synthetic_lm(4 * B, T, CFG["vocab_size"], seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        batch = seqs[rng.integers(0, len(seqs), size=B)]
        yield batch[:, :-1], batch[:, 1:]


def _assert_tree_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


def test_synthetic_lm_bit_identical():
    for args in ((12, 16, 64, 0), (5, 9, 31, 3)):
        np.testing.assert_array_equal(synthetic_lm(*args), jax_synthetic_lm(*args))
    a = synthetic_lm(6, 10, 50, 2, noise=0.3)
    np.testing.assert_array_equal(a, jax_synthetic_lm(6, 10, 50, 2, noise=0.3))
    assert a.dtype == np.int32


@pytest.mark.parametrize("labels", ["in_range", "out_of_range"])
def test_softmax_cross_entropy_value_and_grad(labels):
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(3, 5, 11))).astype(np.float32)
    ids = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    if labels == "out_of_range":
        ids[0, :3] = [-4, 11, 40]  # clamped to an edge class, as JAX does
    want, want_g = jax.value_and_grad(jax_xent)(jnp.asarray(logits), jnp.asarray(ids))
    x = torch.from_numpy(logits).requires_grad_()
    got = softmax_cross_entropy(x, torch.from_numpy(ids))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl,fused_ln", COMBOS, ids=COMBO_IDS)
def test_loss_and_grads_match_jax(impl, fused_ln):
    jm, params, tm = _pair(impl, fused_ln)
    tokens, labels = next(_batches(1))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm), has_aux=True))(
        params, {}, jnp.asarray(tokens), jnp.asarray(labels))
    loss, logits = make_loss_fn(tm)(torch.from_numpy(tokens).long(),
                                    torch.from_numpy(labels).long())
    assert logits.shape == (B, T, CFG["vocab_size"])
    p = params_of(tm)
    grads = torch.autograd.grad(loss, list(p.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close({n: g.numpy() for n, g in zip(p, grads)},
                       lm_params_from_tpudml(_to_np(jgrads)), **GRAD_TOL)


@pytest.mark.parametrize("impl,fused_ln", COMBOS, ids=COMBO_IDS)
def test_three_gd_steps_match_jax(impl, fused_ln):
    jm, params, tm = _pair(impl, fused_ln, seed=1)
    jopt = JaxGD(lr=0.05)
    jts = JaxTrainState(params=params, model_state={}, opt_state=jopt.init(params),
                        step=jnp.zeros((), jnp.int32))
    jstep = jax_make_train_step(jm, jopt)
    opt = GradientDescent(lr=0.05)
    ts, step = TrainState.create(tm, opt), make_train_step(tm, opt)
    for tokens, labels in _batches(3, seed=1):
        jts, jm_ = jstep(jts, jnp.asarray(tokens), jnp.asarray(labels))
        ts, m = step(ts, tokens, labels)
        np.testing.assert_allclose(m["loss"].item(), float(jm_["loss"]), rtol=1e-5)
    assert ts.step == 3 == int(jts.step)
    _assert_tree_close({n: p.detach().numpy() for n, p in params_of(tm).items()},
                       lm_params_from_tpudml(_to_np(jts.params)), **GRAD_TOL)


def test_one_adam_update_from_carried_state_matches_jax():
    """JAX trains two Adam steps; its state and one more step's gradients
    carry across, and one update must agree."""
    jm, params, tm = _pair("flash", True, seed=2)
    jopt = JaxAdam(lr=0.01)
    jts = JaxTrainState(params=params, model_state={}, opt_state=jopt.init(params),
                        step=jnp.zeros((), jnp.int32))
    jstep = jax_make_train_step(jm, jopt)
    batches = _batches(3, seed=2)
    for _ in range(2):
        tokens, labels = next(batches)
        jts, _ = jstep(jts, jnp.asarray(tokens), jnp.asarray(labels))
    tokens, labels = next(batches)
    (_, _), jgrads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm), has_aux=True))(
        jts.params, {}, jnp.asarray(tokens), jnp.asarray(labels))
    want_p, want_s = jax.jit(jopt.update)(jgrads, jts.opt_state, jts.params)

    tm.load_state_dict(lm_params_from_tpudml(_to_np(jts.params)))
    state = adam_state_from_tpudml(_to_np(jts.opt_state))
    assert state["t"] == 2
    grads = lm_params_from_tpudml(_to_np(jgrads))
    params, state = Adam(lr=0.01).update(grads, state, params_of(tm))
    tol = dict(rtol=1e-5, atol=1e-7)
    _assert_tree_close({n: p.detach().numpy() for n, p in params.items()},
                       lm_params_from_tpudml(_to_np(want_p)), **tol)
    want_s = adam_state_from_tpudml(_to_np(want_s))
    assert state["t"] == want_s["t"] == 3
    for k in ("m", "v"):
        _assert_tree_close({n: t.numpy() for n, t in state[k].items()},
                           {n: t.numpy() for n, t in want_s[k].items()}, **tol)


def test_adamw_decay_matches_jax():
    from tpudml.optim import AdamW as JaxAdamW

    rng = np.random.default_rng(5)
    p = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    g = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    jopt = JaxAdamW(lr=0.1, weight_decay=0.5)
    want, _ = jopt.update(g, jopt.init(p), p)
    opt = AdamW(lr=0.1, weight_decay=0.5)
    tp = {"w": torch.from_numpy(p["w"].copy())}
    got, state = opt.update({"w": torch.from_numpy(g["w"])}, opt.init(tp), tp)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-6)
    assert state["t"] == 1


@pytest.mark.parametrize("name,cls", [("gd", GradientDescent), ("adam", Adam),
                                      ("ADAMW", AdamW), ("sgd", Sgd)])
def test_make_optimizer(name, cls):
    assert type(make_optimizer(name, 0.1)) is cls


@pytest.mark.parametrize("name", ["reference_adam", "adam_ref"])
def test_make_optimizer_unported_names_raise(name):
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        make_optimizer(name, 0.1)


def test_accum_steps_and_unported_model_options_raise():
    tm = TransformerLM(**CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step_body(tm, Adam(), accum_steps=2)
    with pytest.raises(NotImplementedError, match="item 3"):
        TransformerLM(**CFG, dropout=0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):  # expert parallelism
        TransformerLM(**CFG, moe_experts=4, moe_axis="expert", device="cpu")
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="item 8"):
            TransformerLM(**CFG, impl=impl, device="cpu")


def test_apply_features_matches_jax():
    jm, params, tm = _pair("flash", True)
    tokens, _ = next(_batches(1))
    want, _ = jax.jit(jm.apply_features)(params, {}, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm.apply_features(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_serving_paths_refuse_fused_ln():
    """As the JAX model's ``_serve_guard``: a fused_ln model has no serving
    path (the serving math is the unfused parity reference)."""
    tm = TransformerLM(**CFG, fused_ln=True, device="cpu")
    with pytest.raises(NotImplementedError, match="fused_ln=False"):
        tm.init_decode_cache(2)
    plain = TransformerLM(**CFG, device="cpu")
    caches = plain.init_decode_cache(2)
    tokens = torch.tensor([1, 2])
    pos = torch.tensor([0, 0])
    for call in (lambda: tm.apply_decode(caches, tokens, pos),
                 lambda: tm.apply_decode_features(caches, tokens, pos),
                 lambda: tm.apply_prefill(caches, tokens[None], 0, 0)):
        with pytest.raises(NotImplementedError, match="fused_ln=False"):
            call()
