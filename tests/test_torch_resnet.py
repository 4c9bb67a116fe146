"""The north-star slice against ``tpudml``, on the CPU: ``Conv2D``,
``BatchNorm``, the ResNets, ``Sgd``, ``train_loop``/``evaluate``, the
data, the task CLI config and ``tasks.north_star``.

The JAX models are ``small_resnet`` of ``tests/test_resnet.py``
(``stage_sizes (1, 1)``, width 8: stem, both block kinds' projection
shortcut, head), its bottleneck twin and its ImageNet-stem twin (7x7/s2
stem, SAME max-pool, run at an odd 33x33 input). Parameters and BatchNorm
state carry across with ``resnet_params_from_tpudml`` (conv kernels HWIO
-> OIHW); inputs are numpy arrays from seeded generators and
``synthetic_classification``.

Tolerances:
- f32 logits, BatchNorm state and eval logits: rtol 1e-5 / atol 1e-6
  (the f32 contract); ``Conv2D`` the same;
- step-1 gradients (against JAX's jitted gradient, what its train step
  runs), and parameters, BN buffers and momentum after SGD steps:
  ``GRAD_TOL`` rtol 1e-4 / atol 1e-6 (sums over the batch and the conv
  windows in another order, through every BatchNorm's backward);
  per-step losses rtol 1e-5. ReLU is discontinuous in its gradient: an
  input that rounds to the other side of 0 in one f32 implementation
  moves a gradient by that element's share (~1e-3 of a BatchNorm
  parameter's gradient), and a few such flips carry an SGD trajectory
  past GRAD_TOL for any two f32 implementations alike (JAX's jitted and
  eager steps drift as far apart, and each lies as far from an f64 run).
  So, as the MoE tests do for top-1 routing, the step and trajectory
  tests record every ReLU's sign mask on both sides (``relu_masks``)
  and assert them equal before holding the numbers to GRAD_TOL; their
  seeds are ones where no input lies that close to 0.
- bf16 (both sides bf16 compute over f32 masters; JAX op by op): logits within
  ``BF16_LOGIT_REL`` = 1e-2 of max |JAX logit| (bf16 keeps 8 bits; the
  two sides round the convs' f32 sums at other points); step-1 gradients
  within ``BF16_GRAD_REL`` = 0.2 of max |JAX bf16 gradient| per parameter
  (at width 8 and 8 images a BatchNorm parameter's gradient is a sum of
  a few hundred bf16 products that mostly cancel: JAX's own bf16
  gradients lie up to 1.7x max |g| from its f32 ones, the two bf16 runs
  at most 0.13 apart), and each no farther from the f32 gradient than
  ``BF16_VS_F32`` = 1.5x JAX's bf16 gradient is, plus 0.02 of max.
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

from tpudml.core.config import build_parser as jax_build_parser  # noqa: E402
from tpudml.core.config import config_from_args as jax_config_from_args  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.data import DataLoader as JaxLoader  # noqa: E402
from tpudml.data.datasets import load_cifar10 as jax_load_cifar10  # noqa: E402
from tpudml.data.datasets import load_dataset as jax_load_dataset  # noqa: E402
from tpudml.data.datasets import synthetic_classification as jax_synth  # noqa: E402
from tpudml.models import ResNet18 as JaxResNet18  # noqa: E402
from tpudml.models import ResNet50 as JaxResNet50  # noqa: E402
from tpudml.nn.layers import BatchNorm as JaxBatchNorm  # noqa: E402
from tpudml.nn.layers import Conv2D as JaxConv2D  # noqa: E402
from tpudml.optim import Sgd as JaxSgd  # noqa: E402
from tpudml.train import TrainState as JaxTrainState  # noqa: E402
from tpudml.train import evaluate as jax_evaluate  # noqa: E402
from tpudml.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from tpudml.train import make_train_step as jax_make_train_step  # noqa: E402
from tpudml.train import train_loop as jax_train_loop  # noqa: E402
from tasks.north_star import reference_defaults as jax_reference_defaults  # noqa: E402
from tpudml_torch.core import build_parser, config_from_args  # noqa: E402
from tpudml_torch.data import (  # noqa: E402
    DataLoader, load_cifar10, load_dataset, synthetic_classification,
)
from tpudml_torch.interop import resnet_params_from_tpudml, sgd_state_from_tpudml  # noqa: E402
from tpudml_torch.models import ResNet, ResNet18, ResNet50  # noqa: E402
from tpudml_torch.nn import BatchNorm, Conv2D  # noqa: E402
from tpudml_torch.nn.layers import same_padding  # noqa: E402
from tpudml_torch.optim import GradientDescent, Sgd  # noqa: E402
from tpudml_torch.tasks import common, north_star  # noqa: E402
from tpudml_torch.train import (  # noqa: E402
    TrainState, evaluate, make_loss_fn, make_train_step, params_of, train_loop,
)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
BF16_LOGIT_REL = 1e-2
BF16_GRAD_REL = 0.2
BF16_VS_F32 = (1.5, 0.02)
VARIANTS = {"basic": dict(), "bottleneck": dict(block="bottleneck"),
            "imagenet": dict(stem="imagenet")}
SIZE = {"basic": 32, "bottleneck": 32, "imagenet": 33}
# (variant, seed, carried) of the SGD trajectories; seeds without a ReLU
# input within f32 rounding of 0 (module docstring).
TRAJECTORIES = [("basic", 20, False), ("bottleneck", 10, False), ("imagenet", 10, False),
                ("basic", 20, True)]


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _pair(variant, dtype=torch.float32, seed=0):
    """(JAX model, params, state, port model holding the same values)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = small_resnet(compute_dtype=jdt, **VARIANTS[variant])
    params, state = jm.init(seed_key(seed))
    tm = ResNet(stage_sizes=(1, 1), width=8, compute_dtype=dtype, device="cpu",
                **VARIANTS[variant])
    tm.load_state_dict(resnet_params_from_tpudml(_np(params), _np(state)))
    return jm, params, state, tm


def _images(variant, n=8, seed=0):
    s = SIZE[variant]
    return synthetic_classification(n, (s, s, 3), 10, seed=seed)


def _close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].float().numpy(), want[name].float().numpy(),
                                   err_msg=name, **tol)


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.fixture
def relu_masks(monkeypatch):
    """(JAX masks, port masks): each ReLU's ``x > 0`` as the two models
    call ``jax.nn.relu`` and ``tpudml_torch.nn.layers.relu``, in call
    order, NHWC (JAX's through an ordered debug callback, so also under
    ``jit``). ``check()`` asserts them equal."""
    from tpudml_torch.nn import layers

    jax_masks, port_masks = [], []
    jax_relu, port_relu = jax.nn.relu, layers.relu

    def jrelu(x):
        jax.debug.callback(lambda v: jax_masks.append(np.asarray(v) > 0), x, ordered=True)
        return jax_relu(x)

    def trelu(x, *args, **kw):
        port_masks.append((x.detach() > 0).permute(0, 2, 3, 1).numpy())
        return port_relu(x, *args, **kw)

    monkeypatch.setattr(jax.nn, "relu", jrelu)
    monkeypatch.setattr(layers, "relu", trelu)

    class Masks:
        @staticmethod
        def reset():
            jax.effects_barrier()
            jax_masks.clear()
            port_masks.clear()

        @staticmethod
        def check():
            jax.effects_barrier()
            assert len(jax_masks) == len(port_masks) > 0
            flips = [int((a != b).sum()) for a, b in zip(jax_masks, port_masks)]
            assert not any(flips), f"ReLU signs differ from JAX's: {flips}"

    return Masks


# ------------------------------------------------------------------ layers


def _conv_state(params) -> dict:
    """A JAX Conv2D's params as the port's: kernel HWIO -> OIHW."""
    out = {"kernel": torch.from_numpy(np.asarray(params["kernel"]).transpose(3, 2, 0, 1).copy())}
    if "bias" in params:
        out["bias"] = torch.from_numpy(np.array(params["bias"]))
    return out


@pytest.mark.parametrize("n", [7, 32, 33])
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_same_matches_jax(stride, k, n):
    """XLA's SAME padding, asymmetric at stride 2 (e.g. (0, 1) for k = 3
    over 32): a symmetric pad gives the right shapes and other numbers."""
    jc = JaxConv2D(3, 5, k, stride, "SAME")
    params, _ = jc.init(seed_key(k * 100 + n))
    x = np.random.default_rng(n).standard_normal((2, n, n, 3)).astype(np.float32)
    want, _ = jc.apply(params, {}, jnp.asarray(x))
    tc = Conv2D(3, 5, k, stride, "SAME")
    tc.load_state_dict(_conv_state(params))
    with torch.no_grad():
        got = tc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("padding", [0, 2, "VALID"])
def test_conv2d_int_and_valid_padding_match_jax(padding):
    jc = JaxConv2D(3, 4, 3, 2, padding, use_bias=False)
    params, _ = jc.init(seed_key(1))
    x = np.random.default_rng(1).standard_normal((2, 9, 9, 3)).astype(np.float32)
    want, _ = jc.apply(params, {}, jnp.asarray(x))
    tc = Conv2D(3, 4, 3, 2, padding, use_bias=False)
    tc.load_state_dict(_conv_state(params))
    with torch.no_grad():
        got = tc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_same_padding_is_xlas():
    assert same_padding(32, 3, 2) == (0, 1)
    assert same_padding(224, 7, 2) == (2, 3)
    assert same_padding(32, 3, 1) == (1, 1)
    assert same_padding(32, 1, 2) == (0, 0)
    assert same_padding(33, 3, 2) == (1, 1)


def test_conv2d_keeps_channels_last():
    tc = Conv2D(3, 4, 3, 2, "SAME")
    assert tc.kernel.is_contiguous(memory_format=torch.channels_last)
    x = torch.rand(2, 32, 32, 3).permute(0, 3, 1, 2)
    assert tc(x).is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batchnorm_matches_jax(dtype):
    """Train mode (batch statistics, running update m·state + (1 − m)·batch
    with the biased variance) then eval mode (the running statistics), on
    a moderate input where both sides' f32 statistics are accurate; a bf16
    output may differ by one bf16 step (2^-8 relative)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = (2.0 + 1.5 * np.random.default_rng(3).standard_normal((8, 6, 6, 4))).astype(np.float32)
    jb = JaxBatchNorm(4)
    params = {"scale": jnp.linspace(0.5, 2.0, 4), "bias": jnp.linspace(-1.0, 1.0, 4)}
    state = {"mean": jnp.full((4,), 0.3), "var": jnp.full((4,), 2.0)}
    jy, jstate = jb.apply(params, state, jnp.asarray(x).astype(jdt), train=True)
    jy_eval, _ = jb.apply(params, jstate, jnp.asarray(x).astype(jdt), train=False)
    tb = BatchNorm(4)
    tb.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in {**params, **state}.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    y = tb(xt)
    assert y.dtype == dtype
    _close({"mean": tb.mean, "var": tb.var},
           {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}, **F32_TOL)
    tb.eval()
    y_eval = tb(xt)
    tol = F32_TOL if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-6)
    for got, want in ((y, jy), (y_eval, jy_eval)):
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).float().numpy(),
                                   np.asarray(want.astype(jnp.float32)), **tol)


def test_batchnorm_bf16_single_pass_and_f32_two_pass():
    """A large-mean input (channels at 1000–4500, rare +4 steps; every
    value exact in bf16): the f32 path's two-pass variance is the exact
    one, as JAX's f32 path (to its sequential f32 sums, rtol 1e-4); the
    bf16 path's single pass E[x²] − m² cancels away every variance bit,
    goes negative where the clamp keeps rsqrt(var + eps) finite, as in
    JAX, whose outputs agree in their largest value."""
    rng = np.random.default_rng(0)
    n, c, h, w = 16, 8, 16, 16
    x = np.full((n, c, h, w), 1000.0, np.float32)
    x[rng.random(x.shape) < 0.002] += 4
    x *= (1 + np.arange(c) * 0.5)[None, :, None, None]
    x = torch.from_numpy(x).bfloat16().float().numpy()
    exact = x.astype(np.float64).transpose(1, 0, 2, 3).reshape(c, -1).var(1)
    runs = {}
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tb = BatchNorm(c, momentum=0.0)  # the running var is the batch's
        with torch.no_grad():
            y = tb(torch.from_numpy(x).to(dtype)).float()
        jb = JaxBatchNorm(c, momentum=0.0)
        params, state = jb.init(None)
        jy, jstate = jb.apply(params, state, jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt),
                              train=True)
        runs[dtype] = (tb.var.numpy(), y, np.asarray(jstate["var"]),
                       np.asarray(jy.astype(jnp.float32)))
    var, y, jvar, jy = runs[torch.float32]
    np.testing.assert_allclose(var, exact, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(jvar, exact, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), jy, rtol=1e-3, atol=1e-3)
    var, y, jvar, jy = runs[torch.bfloat16]
    xf = torch.from_numpy(x)
    mean = xf.mean((0, 2, 3))
    single = xf.square().mean((0, 2, 3)) - mean.square()
    assert (single < -1e-5).any(), single  # unclamped, rsqrt(var + eps) would be NaN
    np.testing.assert_array_equal(var, single.clamp_min(0.0).numpy())
    assert np.abs(var - exact).max() > 0.1  # the single pass, not the two-pass
    assert (jvar >= 0).all() and (var >= 0).all()
    assert torch.isfinite(y).all() and np.isfinite(jy).all()
    assert y.abs().max().item() == np.abs(jy).max()


# ------------------------------------------------------------------ the model


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    """f32 train-mode logits and new BatchNorm state, then eval-mode logits
    from that state."""
    jm, params, state, tm = _pair(variant)
    x, _ = _images(variant, n=4)
    apply = jax.jit(jm.apply, static_argnames="train")
    jl, jstate = apply(params, state, jnp.asarray(x), train=True)
    logits = tm(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (4, 10)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), **F32_TOL)
    want = resnet_params_from_tpudml(_np(params), _np(jstate))
    _close(dict(tm.named_buffers()), {k: want[k] for k, _ in tm.named_buffers()}, **F32_TOL)
    jl_eval, _ = apply(params, jstate, jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl_eval), **F32_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step1_grads_match_jax(variant, relu_masks):
    jm, params, state, tm = _pair(variant)
    x, y = _images(variant)
    (jloss, _), jg = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm), has_aux=True))(
        params, state, jnp.asarray(x), jnp.asarray(y))
    tm.eval()  # the loss function puts the model in training mode
    loss, _ = make_loss_fn(tm)(torch.from_numpy(x), torch.from_numpy(y).long())
    assert tm.training
    grads = torch.autograd.grad(loss, list(params_of(tm).values()))
    relu_masks.check()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _close(dict(zip(params_of(tm), grads)), resnet_params_from_tpudml(_np(jg), {}), **GRAD_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_matches_jax(variant):
    """bf16 compute over f32 masters: logits, and step-1 gradients against
    JAX's bf16 ones and against the f32 ones (module docstring). JAX runs
    op by op here, rounding to bf16 where its code's ops do, as the port
    does; under ``jit`` XLA fuses elementwise chains and keeps their
    intermediates in f32, which rounds elsewhere."""
    jm, params, state, tm = _pair(variant, torch.bfloat16)
    jm32 = small_resnet(**VARIANTS[variant])
    x, y = _images(variant)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    (_, (_, jl)), jg = jax.value_and_grad(jax_make_loss_fn(jm), has_aux=True)(
        params, state, xj, yj)
    _, g32 = jax.value_and_grad(jax_make_loss_fn(jm32), has_aux=True)(params, state, xj, yj)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    loss, logits = make_loss_fn(tm)(torch.from_numpy(x), torch.from_numpy(y).long())
    assert logits.dtype == torch.float32
    assert _rel(logits.detach(), torch.from_numpy(np.array(jl))) <= BF16_LOGIT_REL
    grads = dict(zip(params_of(tm), torch.autograd.grad(loss, list(params_of(tm).values()))))
    want = resnet_params_from_tpudml(_np(jg), {})
    f32 = resnet_params_from_tpudml(_np(g32), {})
    mult, slack = BF16_VS_F32
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        assert _rel(g, want[name]) <= BF16_GRAD_REL, name
        assert _rel(g, f32[name]) <= mult * _rel(want[name], f32[name]) + slack, name


@pytest.mark.parametrize("variant,seed,carried", TRAJECTORIES)
def test_sgd_momentum_trajectory_matches_jax(variant, seed, carried, relu_masks):
    """Four steps of SGD lr 0.05 momentum 0.9 through ``make_train_step`` on
    numpy float images: per-step losses, every ReLU's signs, then
    parameters, BatchNorm buffers and momentum. ``carried``: JAX trains
    two steps first and its parameters, state and momentum
    (``sgd_state_from_tpudml``) carry across."""
    jm = small_resnet(**VARIANTS[variant])
    opt = JaxSgd(lr=0.05, momentum=0.9)
    step = jax_make_train_step(jm, opt)
    ts = JaxTrainState.create(jm, opt, seed_key(seed))
    batches = [_images(variant, seed=seed + i) for i in range(6 if carried else 4)]
    if carried:
        for x, y in batches[:2]:
            ts, _ = step(ts, jnp.asarray(x), jnp.asarray(y))
        batches = batches[2:]
        relu_masks.reset()
    tm = ResNet(stage_sizes=(1, 1), width=8, device="cpu", **VARIANTS[variant])
    tm.load_state_dict(resnet_params_from_tpudml(_np(ts.params), _np(ts.model_state)))
    topt = Sgd(lr=0.05, momentum=0.9)
    tstep = make_train_step(tm, topt)
    tts = TrainState.create(tm, topt)
    if carried:
        tts.opt_state = sgd_state_from_tpudml(_np(ts.opt_state))
    for x, y in batches:
        ts, m = step(ts, jnp.asarray(x), jnp.asarray(y))
        tts, tmetrics = tstep(tts, x, y)
        np.testing.assert_allclose(tmetrics["loss"].item(), float(m["loss"]), rtol=LOSS_RTOL)
    assert tts.step == 4
    relu_masks.check()
    _close(tm.state_dict(), resnet_params_from_tpudml(_np(ts.params), _np(ts.model_state)),
           **GRAD_TOL)
    _close(tts.opt_state, sgd_state_from_tpudml(_np(ts.opt_state)), **GRAD_TOL)


def test_sgd_without_momentum_is_gradient_descent():
    params = {"w": torch.tensor([1.0, -2.0]), "b": torch.tensor([0.5])}
    grads = {"w": torch.tensor([0.5, 0.25]), "b": torch.tensor([-1.0])}
    opt = Sgd(lr=0.1)
    assert opt.init(params) == ()
    want = {n: p.clone() for n, p in params.items()}
    GradientDescent(lr=0.1).update(grads, (), want)
    opt.update(grads, (), params)
    for name in params:
        assert torch.equal(params[name], want[name])
    assert sgd_state_from_tpudml(()) == ()


@pytest.mark.parametrize("model", ["resnet18", "resnet50"])
def test_parameter_counts_on_meta(model):
    """ResNet-18 (11.17M) and -50 (23.5M): the JAX count, nothing allocated."""
    jax_ctor, ctor = {"resnet18": (JaxResNet18, ResNet18),
                      "resnet50": (JaxResNet50, ResNet50)}[model]
    jparams, jstate = jax.eval_shape(jax_ctor().init, seed_key(0))
    with torch.device("meta"):
        tm = ctor(device="meta")
    assert all(p.is_meta for p in tm.parameters())
    want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in tm.parameters()) == want
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    flat = resnet_params_from_tpudml(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jparams),
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jstate))
    assert shapes == {k: tuple(v.shape) for k, v in flat.items()}


# ------------------------------------------------------------------ host side


def test_train_loop_and_evaluate_match_jax():
    """One epoch of ``train_loop`` (its default step) over a DataLoader of
    24 synthetic images in batches of 8, then ``evaluate`` on 16 more: the
    final loss and parameters as JAX's ``train_loop``, the same accuracy,
    and the model's mode restored."""
    jm = small_resnet()
    jts = JaxTrainState.create(jm, JaxSgd(lr=0.05, momentum=0.9), seed_key(2))
    train = synthetic_classification(24, (32, 32, 3), 10, seed=7)
    test = synthetic_classification(16, (32, 32, 3), 10, seed=8)
    from tpudml.data.datasets import ArrayDataset as JaxDataset

    from tpudml_torch.data import ArrayDataset

    tm = ResNet(stage_sizes=(1, 1), width=8, device="cpu")
    tm.load_state_dict(resnet_params_from_tpudml(_np(jts.params), _np(jts.model_state)))
    jts, jmetrics = jax_train_loop(jm, JaxSgd(lr=0.05, momentum=0.9),
                                   JaxLoader(JaxDataset(*train), 8), 1, seed_key(2),
                                   log_every=0, state=jts)
    ts, metrics = train_loop(tm, Sgd(lr=0.05, momentum=0.9), DataLoader(ArrayDataset(*train), 8),
                             1, log_every=0)
    assert metrics["steps"] == jmetrics["steps"] == 3 and ts.step == 3
    np.testing.assert_allclose(metrics["loss"], jmetrics["loss"], rtol=LOSS_RTOL)
    _close(tm.state_dict(), resnet_params_from_tpudml(_np(jts.params), _np(jts.model_state)),
           **GRAD_TOL)
    acc = evaluate(tm, ts, DataLoader(ArrayDataset(*test), 8, drop_remainder=False))
    assert tm.training
    assert acc == jax_evaluate(jm, jts, JaxLoader(JaxDataset(*test), 8, drop_remainder=False))
    with pytest.raises(ValueError, match="engine"):
        train_loop(tm, Sgd(lr=0.05), [], 1, step_fn=lambda *a: a, accum_steps=2)
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        train_loop(tm, Sgd(lr=0.05), DataLoader(ArrayDataset(*train), 8), 1, accum_steps=3,
                   log_every=0)


@pytest.mark.parametrize("args", [
    dict(n=64, shape=(32, 32, 3), num_classes=10, seed=2, proto_seed=101),
    dict(n=33, shape=(28, 28, 1), num_classes=10, seed=0, proto_seed=100),
    dict(n=17, shape=(5, 3), num_classes=4, seed=9, noise=0.8),
])
def test_synthetic_classification_is_jaxs_bitwise(args):
    for got, want in zip(synthetic_classification(**args), jax_synth(**args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("split", ["train", "test"])
def test_cifar10_synthetic_fallback_is_jaxs_bitwise(tmp_path, split):
    """No batches under ``data_dir``: the synthetic set (seeds 2 / 3,
    prototypes 101), cut to 48 images, and ``load_dataset``'s synthetic
    set, f32 and u8; ``load_dataset("mnist")`` falls back to JAX's
    synthetic MNIST (``tests/test_torch_mnist_native.py`` reads IDX)."""
    got = load_cifar10(str(tmp_path), split, synthetic_size=48)
    want = jax_load_cifar10(str(tmp_path), split, synthetic_size=48)
    assert got.name == want.name == f"cifar10-synthetic-{split}"
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    for storage in ("f32", "u8"):
        got = load_dataset("synthetic", str(tmp_path), split, storage=storage,
                           synthetic_size=40)
        want = jax_load_dataset("synthetic", str(tmp_path), split, storage=storage,
                                synthetic_size=40)
        assert got.name == want.name and got.scale == want.scale
        np.testing.assert_array_equal(got.images, want.images)
    with pytest.raises(FileNotFoundError):
        load_cifar10(str(tmp_path), split, synthetic_fallback=False)
    got = load_dataset("mnist", str(tmp_path), split, synthetic_size=40)
    want = jax_load_dataset("mnist", str(tmp_path), split, synthetic_size=40)
    assert got.name == want.name == f"mnist-synthetic-{split}"
    np.testing.assert_array_equal(got.images, want.images)


def test_cifar10_pickle_batches_match_jax(tmp_path):
    """The pickle reader on a tiny fake of the batch files: u8 storage with
    batch-time scale, and f32."""
    import pickle

    rng = np.random.default_rng(0)
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 3))}, f)
    for split in ("train", "test"):
        for storage in ("u8", "f32"):
            got = load_cifar10(str(tmp_path), split, storage=storage)
            want = jax_load_cifar10(str(tmp_path), split, storage=storage)
            assert got.name == want.name and got.scale == want.scale
            np.testing.assert_array_equal(got.images, want.images)
            np.testing.assert_array_equal(got.labels, want.labels)
            np.testing.assert_array_equal(got[np.arange(3)][0], want[np.arange(3)][0])


# ------------------------------------------------------------------ the CLI


@pytest.mark.parametrize("argv", [
    [],
    ["--epochs", "2", "--lr", "0.05", "--batch_size", "16", "--seed", "3",
     "--mode", "sampling", "--no-shuffle", "--dataset", "synthetic"],
    ["--n_devices", "2", "--rank", "1", "--master_addr", "h", "--master_port", "29500",
     "--optimizer", "adam", "--bottleneck_rank", "1", "--measure_comm"],
])
def test_config_from_args_matches_jax(argv, monkeypatch):
    """Same flags, defaults (north star's reference defaults) and aliases;
    JAX's mesh block aside."""
    for var in ("TPUDML_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "TPUDML_NUM_PROCESSES", "TPUDML_PROCESS_ID", "TPUDML_BOTTLENECK_RANK"):
        monkeypatch.delenv(var, raising=False)
    want = jax_config_from_args(jax_build_parser(jax_reference_defaults()).parse_args(argv))
    got = config_from_args(build_parser(north_star.reference_defaults()).parse_args(argv))
    want_d, got_d = vars(want), vars(got)
    assert set(want_d) - set(got_d) == {"mesh"}
    for name, value in got_d.items():
        if name == "dist":
            for f in ("coordinator_address", "num_processes", "process_id", "explicit_world"):
                assert getattr(value, f) == getattr(want.dist, f), f
        elif name == "data":
            assert vars(value) == vars(want.data)
        else:
            assert value == want_d[name], name
    assert got.fingerprint() == want.fingerprint().replace(", 'mesh': {'axes': {'data': -1}}",
                                                           "")


@pytest.mark.parametrize("flag,item", [
    (["--zero1"], "item 7"), (["--zero1", "--sentinel"], "item 7"),
    (["--plan", "p.json", "--obs"], "item 10"), (["--zero1", "--profile"], "item 7"),
    (["--plan", "p.json", "--ckpt_dir", "ck"], "item 10"), (["--plan", "p.json"], "item 10"),
])
def test_unported_flags_parse_and_raise(flag, item):
    """``--plan`` still raises, also beside the host flags (``--sentinel``,
    ``--obs``, ``--profile``, ``--ckpt_dir``), which parse and are ported;
    ``--zero1`` (item 7, ported since) parses into ``cfg.zero1`` beside
    them."""
    args = build_parser().parse_args(flag)
    if item == "item 7":
        cfg = config_from_args(args)
        assert cfg.zero1 and cfg.sentinel == ("--sentinel" in flag)
        assert cfg.profile == ("--profile" in flag)
        return
    with pytest.raises(NotImplementedError, match=item):
        config_from_args(args)


def test_task_common_world_and_checkpointing(tmp_path):
    cfg = config_from_args(build_parser().parse_args([]))
    assert common.select_devices(cfg) == 1
    cfg.dist.num_processes, cfg.dist.explicit_world = 2, True
    with pytest.raises(ValueError, match="--n_devices 2"):
        common.select_devices(cfg)
    assert common.setup_checkpointing(cfg, "ts") == ("ts", [], None)
    cfg.ckpt_dir, cfg.ckpt_every, cfg.resume = str(tmp_path), 5, True
    ts, hooks, mgr = common.setup_checkpointing(cfg, "ts")
    assert ts == "ts" and len(hooks) == 1 and mgr.directory == str(tmp_path)  # nothing saved
    common.final_checkpoint(None, ts)


def test_north_star_entry_on_cpu(tmp_path, monkeypatch, capsys):
    """``tasks.north_star`` at ResNet-18 width (bf16 over f32 masters, SGD
    0.1 / 0.9, DataParallel at world 1 over gloo) for one epoch on a
    16-image CIFAR split in batches of 4: four steps, the JAX entry's
    printout and metrics."""
    def splits(cfg):
        assert cfg.data.dataset == "cifar10"
        return (load_cifar10(cfg.data.data_dir, "train", synthetic_size=16),
                load_cifar10(cfg.data.data_dir, "test", synthetic_size=16))

    monkeypatch.setattr(north_star, "load_splits", splits)
    for var in ("TPUDML_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    metrics = north_star.main(["--device", "cpu", "--epochs", "1", "--batch_size", "4",
                               "--log_every", "2", "--data_dir", str(tmp_path / "none"),
                               "--log_dir", str(tmp_path / "logs")])
    out = capsys.readouterr().out
    assert metrics["steps"] == 4 and metrics["world"] == 1
    assert np.isfinite(metrics["loss"]) and 0.0 <= metrics["test_accuracy"] <= 1.0
    assert metrics["imgs_per_sec_per_chip"] > 0
    assert "epoch 0 iter 4: loss" in out
    assert f"Test accuracy: {metrics['test_accuracy'] * 100:.2f}% |" in out
    assert not torch.distributed.is_initialized()


def test_north_star_asks_for_the_card(tmp_path):
    """Without ``--device cpu`` the entry asks for the card, and raises on
    a machine without one, before it loads any data."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        north_star.main(["--epochs", "1", "--log_dir", str(tmp_path / "logs")])
    with pytest.raises(RuntimeError, match="cuda"):
        ResNet18()
