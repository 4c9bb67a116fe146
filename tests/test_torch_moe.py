"""The port's MoE layer (``tpudml_torch.nn.moe``) against ``tpudml.nn.moe``
on the CPU, on the same parameters (the JAX init, carried across).

Every dispatch (gather, einsum, ragged with the grouped-dW backward and
with the stock one) × top_k ∈ {1, 2}: output, the aux loss and the
gradients of the input and of every parameter, at a capacity factor that
drops tokens; the drop pattern under overflow, choice priority, a tie in
the router's probabilities (lower expert index wins, as ``lax.top_k``),
``load_balancing_loss``, the aux-loss weight's resolution in
``tpudml_torch.train``, and what the port refuses (ragged dispatch under
expert parallelism, an EP layer with no group bound, serving a MoE
model). f32, rtol 1e-5 / atol 1e-6 (sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.nn.moe import MoELayer as JaxMoE  # noqa: E402
from tpudml.nn.moe import load_balancing_loss as jax_lb_loss  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.nn.moe import MoELayer, load_balancing_loss  # noqa: E402
from tpudml_torch.train import (  # noqa: E402
    DEFAULT_MOE_AUX_WEIGHT, collect_aux_losses, model_has_moe, resolve_aux_loss_weight,
)

D, E, G = 16, 4, 48  # tokens as [2, 24, D]
TOL = dict(rtol=1e-5, atol=1e-6)
ARMS = {
    "gather": dict(dispatch="gather"),
    "einsum": dict(dispatch="einsum"),
    "ragged_stock": dict(dispatch="ragged", ragged_dw="stock"),
    "ragged_grouped": dict(dispatch="ragged", ragged_dw="grouped"),
}
PARAMS = ("router.kernel", "experts.w1", "experts.b1", "experts.w2", "experts.b2")


def _tokens(seed=0):
    return np.random.default_rng(seed).normal(size=(2, G // 2, D)).astype(np.float32)


def _pair(arm, top_k, capacity_factor=0.75, seed=0):
    """(JAX layer, its params, the port's layer on the same params)."""
    jm = JaxMoE(D, E, mlp_ratio=2, capacity_factor=capacity_factor, top_k=top_k,
                **ARMS[arm])
    params, _ = jm.init(jax.random.key(seed))
    tm = MoELayer(D, E, 2, capacity_factor, top_k, **ARMS[arm])
    _load(tm, params)
    return jm, params, tm


def _load(tm, params):
    state = {f"router.kernel": params["router"]["kernel"],
             **{f"experts.{n}": params["experts"][n] for n in ("w1", "b1", "w2", "b2")}}
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})


def _jax_run(jm, params, x, dy):
    """(y, aux, grads {name: array} incl. "x") of Σ y·dy + aux."""

    def f(p, x):
        y, st = jm.apply(p, {}, x)
        return jnp.sum(y * dy) + st["aux_loss"], (y, st["aux_loss"])

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    grads = {"x": gx, "router.kernel": gp["router"]["kernel"],
             **{f"experts.{n}": gp["experts"][n] for n in ("w1", "b1", "w2", "b2")}}
    return np.asarray(y), float(aux), {k: np.asarray(v) for k, v in grads.items()}


def _port_run(tm, x, dy):
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tm(xt)
    params = dict(tm.named_parameters())
    leaves = [xt] + [params[n] for n in PARAMS]
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux, leaves)
    return (y.detach().numpy(), aux.item(),
            dict(zip(("x",) + PARAMS, (g.numpy() for g in grads))))


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_moe_layer_matches_jax(arm, top_k):
    jm, params, tm = _pair(arm, top_k)
    x = _tokens()
    dy = np.random.default_rng(1).normal(size=x.shape).astype(np.float32) / G
    wy, waux, wgrads = _jax_run(jm, params, x, dy)
    y, aux, grads = _port_run(tm, x, dy)
    np.testing.assert_allclose(y, wy, **TOL)
    np.testing.assert_allclose(aux, waux, **TOL)
    assert set(grads) == set(wgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, wgrads[name], err_msg=name, **TOL)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("arm", ["gather", "einsum"])
def test_capacity_overflow_drops_the_same_tokens(arm, top_k):
    """At capacity factor 0.25 most (token, choice) pairs overflow: the
    rows whose every choice was dropped are zero in both, and the kept
    rows agree."""
    jm, params, tm = _pair(arm, top_k, capacity_factor=0.25, seed=3)
    x = _tokens(seed=4)
    wy = np.asarray(jm.apply(params, {}, jnp.asarray(x))[0]).reshape(G, D)
    with torch.no_grad():
        y = tm(torch.from_numpy(x))[0].numpy().reshape(G, D)
    dropped = ~wy.any(axis=-1)
    assert 0 < dropped.sum() < G  # capacity E·C = 4·3 (k=1) or 4·6 (k=2) < G·k
    np.testing.assert_array_equal(~y.any(axis=-1), dropped)
    np.testing.assert_allclose(y, wy, **TOL)


def test_choice_priority_drops_second_choices_first():
    """top_k=2 at capacity factor 0.75 (18 slots an expert for 96 pairs):
    choice 0 claims slots for all tokens, in token order, before choice 1
    sees what is left, so a second choice is kept only where every first
    choice of its expert was; slots are dense and in that order. The
    outputs equal JAX's."""
    jm, params, tm = _pair("gather", 2, capacity_factor=0.75, seed=5)
    x = _tokens(seed=6)
    tokens = torch.from_numpy(x).reshape(G, D)
    cap = tm._capacity(G)
    _, _, topi = tm._route(tokens)
    flat_dst, kept, _ = tm._assign_slots(topi, cap)
    assert 0 < (kept == 0).sum() and (kept[:, 1] == 0).any()
    for e in range(E):
        slots = []
        for j in range(2):
            rows = (topi[:, j] == e).nonzero().flatten().tolist()
            want_kept = rows[:max(0, cap - len(slots))]
            got_kept = [r for r in rows if kept[r, j]]
            assert got_kept == want_kept, (e, j)
            slots += [flat_dst[r, j].item() - e * cap for r in got_kept]
        assert slots == list(range(len(slots)))
    assert (flat_dst[kept == 0] == E * cap).all()
    wy = np.asarray(jm.apply(params, {}, jnp.asarray(x))[0])
    with torch.no_grad():
        y = tm(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(y, wy, **TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_top_k_ties_go_to_the_lower_expert(top_k):
    """A zero router makes every probability 1/E: JAX's lax.top_k picks
    experts 0..k-1 for every token, and so must the port."""
    jm, params, tm = _pair("gather", top_k, capacity_factor=8.0)
    params = jax.tree.map(lambda a: a, params)
    params["router"]["kernel"] = jnp.zeros((D, E), jnp.float32)
    _load(tm, params)
    x = _tokens(seed=7)
    _, topv, topi = tm._route(torch.from_numpy(x).reshape(G, D))
    assert (topi == torch.arange(top_k)).all()
    assert torch.allclose(topv, torch.full_like(topv, 1 / E))
    wy = np.asarray(jm.apply(params, {}, jnp.asarray(x))[0])
    with torch.no_grad():
        y = tm(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(y, wy, **TOL)


def test_load_balancing_loss_matches_jax():
    jm, params, _ = _pair("gather", 1)
    x = _tokens(seed=8)
    want = float(jax_lb_loss(params, jnp.asarray(x), E))
    got = load_balancing_loss({"router": {"kernel": torch.from_numpy(
        np.array(params["router"]["kernel"]))}}, torch.from_numpy(x), E)
    np.testing.assert_allclose(got.item(), want, **TOL)


def test_moe_layer_rejects_what_is_not_ported_or_invalid():
    # Expert parallelism is ported: ragged dispatch refuses it as JAX's
    # does, and an EP layer needs its process group bound.
    with pytest.raises(ValueError, match="single-shard"):
        MoELayer(D, E, dispatch="ragged", axis_name="expert")
    with pytest.raises(RuntimeError, match="bind its process group"):
        MoELayer(D, E, axis_name="expert")(torch.from_numpy(_tokens()))
    with pytest.raises(ValueError, match="top_k"):
        MoELayer(D, E, top_k=E + 1)
    with pytest.raises(ValueError, match="dispatch"):
        MoELayer(D, E, dispatch="scatter")
    with pytest.raises(ValueError, match="ragged_dw"):
        MoELayer(D, E, ragged_dw="fast")


def _lm(**kw):
    return TransformerLM(vocab_size=32, embed_dim=D, num_heads=2, num_layers=2,
                         max_len=8, device="cpu", **kw)


def test_model_has_moe_finds_a_moe_layer_in_any_container():
    """As ``tpudml.train.model_has_moe``: a bare MoELayer, or one inside any
    module, turns the aux weight on; a dense container does not."""
    bare = MoELayer(D, E)
    wrapped = torch.nn.Sequential(torch.nn.Linear(D, D), MoELayer(D, E))
    assert model_has_moe(bare) and model_has_moe(wrapped)
    assert not model_has_moe(torch.nn.Sequential(torch.nn.Linear(D, D)))
    assert resolve_aux_loss_weight(wrapped, None) == DEFAULT_MOE_AUX_WEIGHT


def test_aux_loss_is_recorded_per_forward_and_absent_for_dense_models():
    dense, moe = _lm(), _lm(moe_experts=E, moe_dispatch="ragged")
    tokens = torch.arange(16).reshape(2, 8) % 32
    dense(tokens)
    assert dense.aux_loss is None
    assert not model_has_moe(dense) and model_has_moe(moe)
    assert resolve_aux_loss_weight(dense, None) == 0.0
    assert resolve_aux_loss_weight(moe, None) == DEFAULT_MOE_AUX_WEIGHT == 1e-2
    assert resolve_aux_loss_weight(moe, 0.5) == 0.5
    assert collect_aux_losses(dense).item() == 0.0
    moe(tokens)
    first = moe.aux_loss
    moe(tokens.flip(0))
    assert moe.aux_loss is not first  # this forward's value
    (g,) = torch.autograd.grad(collect_aux_losses(moe), [moe.block0.moe.router.kernel])
    assert g.abs().sum() > 0  # differentiable to the router


def test_serving_a_moe_model_raises():
    with pytest.raises(NotImplementedError, match="MoE"):
        _lm(moe_experts=E).init_decode_cache(2)
