"""The lab models' layers and models against ``tpudml``, on the CPU:
``MaxPool`` and ``AvgPool`` (windows with planted ties), ``LeNet`` and
``ForwardMLP`` (logits and gradients from JAX's parameters, carried with
``sequential_params_from_tpudml``, on inputs that are not symmetric in H
and W).

JAX's LeNet runs NHWC and flattens its [N, 5, 5, 16] activations in
(H, W, C) order, the row order of ``layer7``'s [400, 120] kernel; the
port's convs run NCHW-indexed, and its ``layer6`` must flatten in JAX's
order. Only JAX's weights carried across catch a wrong order, which
``test_lenet_flatten_order_is_jaxs`` shows by flattening the other way.

Tolerances (f32): pooled values bitwise (a max, or a window sum of at
most 9 terms then one division, in JAX's order); pooled gradients rtol
1e-6 (a max's gradient goes to the first maximum of each window in
row-major order in both, and overlapping windows add cotangents); logits
rtol 1e-5 / atol 1e-6; gradients ``GRAD_TOL`` (rtol 1e-4, atol 1e-6),
the f32 contract of the port's training tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.models import ForwardMLP as JaxMLP  # noqa: E402
from tpudml.models import LeNet as JaxLeNet  # noqa: E402
from tpudml.nn import AvgPool as JaxAvgPool  # noqa: E402
from tpudml.nn import MaxPool as JaxMaxPool  # noqa: E402
from tpudml.nn.losses import softmax_cross_entropy as jax_xent  # noqa: E402
from tpudml_torch.interop import sequential_params_from_tpudml  # noqa: E402
from tpudml_torch.models import ForwardMLP, LeNet  # noqa: E402
from tpudml_torch.nn import AvgPool, Flatten, MaxPool, Sequential  # noqa: E402
from tpudml_torch.nn.losses import softmax_cross_entropy  # noqa: E402
from tpudml_torch.train import params_of  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tiny tensors (several test
    workers share the machine's cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _tied(shape, seed):
    """NHWC values in {0, 0.5, 1, 1.5}: most windows hold tied maxima."""
    return (np.random.default_rng(seed).integers(0, 4, size=shape) / 2).astype(np.float32)


@pytest.mark.parametrize("window,stride", [(2, None), (3, 2), (2, 1), (3, 3)])
@pytest.mark.parametrize("pool", ["max", "avg"])
def test_pools_match_jax_with_tied_windows(pool, window, stride):
    x = _tied((2, 9, 7, 3), seed=window * 10 + (stride or 0))
    jp = (JaxMaxPool if pool == "max" else JaxAvgPool)(window, stride)
    tp = (MaxPool if pool == "max" else AvgPool)(window, stride)
    jy, vjp = jax.vjp(lambda a: jp.apply({}, {}, a)[0], jnp.asarray(x))
    ct = np.random.default_rng(1).normal(size=jy.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()  # NCHW-indexed view
    ty = tp(tx)
    ty.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(ty.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy))
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jdx),
                               rtol=1e-6, atol=0)


def test_max_pool_gradient_goes_to_the_first_maximum():
    """A 2x2 window of four equal values: the whole cotangent lands on its
    top-left element, in JAX and in the port."""
    x = np.ones((1, 2, 2, 1), np.float32)
    (jdx,) = jax.grad(lambda a: JaxMaxPool(2).apply({}, {}, a)[0].sum(),
                      argnums=(0,))(jnp.asarray(x))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    MaxPool(2)(tx).sum().backward()
    want = np.array([[1, 0], [0, 0]], np.float32)
    np.testing.assert_array_equal(np.asarray(jdx)[0, :, :, 0], want)
    np.testing.assert_array_equal(tx.grad[0, 0].numpy(), want)


def _lenet_pair(seed, in_channels=1, num_classes=10):
    jm = JaxLeNet(num_classes, in_channels)
    params, _ = jm.init(jax.random.key(seed))
    tm = LeNet(num_classes, in_channels, device="cpu")
    tm.load_state_dict(sequential_params_from_tpudml(_np(params)))
    return jm, params, tm


def _images(n, c, seed):
    # Rows and columns of different content: not symmetric in H and W.
    x = np.random.default_rng(seed).random((n, 28, 28, c), dtype=np.float32)
    assert not np.allclose(x, x.transpose(0, 2, 1, 3))
    return x


def _logits_and_grads_match(jm, params, tm, x, y):
    def jloss(p):
        logits = jm.apply(p, {}, jnp.asarray(x), train=True)[0]
        return jax_xent(logits, jnp.asarray(y)), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = tm(torch.from_numpy(x))
    loss = softmax_cross_entropy(logits, torch.from_numpy(y).long())
    p = params_of(tm)
    grads = torch.autograd.grad(loss, list(p.values()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **LOGIT_TOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = sequential_params_from_tpudml(_np(jg))
    assert set(p) == set(want)
    for (name, g) in zip(p, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("in_channels,seed", [(1, 0), (3, 1)])
def test_lenet_logits_and_grads_match_jax(in_channels, seed):
    jm, params, tm = _lenet_pair(seed, in_channels)
    assert [n for n, _ in tm.named_parameters()] == [
        f"layer{i}.{k}" for i in (0, 3, 7, 9) for k in ("kernel", "bias")]
    x = _images(6, in_channels, seed)
    y = np.random.default_rng(seed).integers(0, 10, size=6).astype(np.int32)
    _logits_and_grads_match(jm, params, tm, x, y)


def test_lenet_flatten_order_is_jaxs():
    """The same weights with a (C, H, W) flatten give other logits: the
    trap the parity test above would catch."""
    jm, params, tm = _lenet_pair(2)
    x = _images(3, 1, 2)
    want = np.asarray(jm.apply(params, {}, jnp.asarray(x))[0])
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want, **LOGIT_TOL)
        tm.layer6 = Flatten()  # NCHW-indexed view flattened as (C, H, W)
        wrong = tm(torch.from_numpy(x)).numpy()
    assert np.abs(wrong - want).max() > 1e-3


def test_mlp_logits_and_grads_match_jax():
    jm = JaxMLP()
    params, _ = jm.init(jax.random.key(3))
    tm = ForwardMLP(device="cpu")
    assert isinstance(tm, Sequential)
    tm.load_state_dict(sequential_params_from_tpudml(_np(params)))
    x = _images(5, 1, 3)
    y = np.random.default_rng(3).integers(0, 10, size=5).astype(np.int32)
    _logits_and_grads_match(jm, params, tm, x, y)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot be shown")


def test_lab_models_need_the_card_unless_asked(no_card):
    for build in (LeNet, ForwardMLP):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
