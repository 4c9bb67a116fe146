"""The port's fused linear cross-entropy (``tpudml_torch.ops.xent_kernel``)
against ``tpudml.ops.xent_kernel.linear_cross_entropy`` run through its
Pallas kernels in interpret mode (``interpret=True, save_s=True``), on the
CPU, where the port runs the plain versions of kernels 10–13. Inputs come
from numpy seeds.

Tolerances: f32 loss, dx, dW, db at rtol 1e-5 / atol 1e-6 (sums of d or V
terms in another order). bf16 operands: loss at rtol 1e-5 (the f32
scores of bf16 operands are exact products on both sides) and each
gradient within 1e-2 of its largest magnitude: both sides round dlog and
the stored gradient to bf16 (2^-8 relative), so a sum taken in another
order may land one bf16 step away.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.ops import xent_kernel as jxk  # noqa: E402
from tpudml_torch.ops import xent_kernel as txk  # noqa: E402
from tpudml_torch.ops import (  # noqa: E402
    linear_cross_entropy, xent_dw, xent_dx, xent_forward, xent_forward_save,
)

SHAPES = [(16, 32, 64, 8, 64), (24, 16, 100, 8, 128)]
SHAPE_IDS = ["n16-d32-v64", "n24-d16-v100-ragged"]
F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_GRAD_RTOL = 1e-2


def _inputs(n, d, v, seed=0, bad_labels=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = (0.1 * rng.normal(size=(d, v))).astype(np.float32)
    b = (0.1 * rng.normal(size=(v,))).astype(np.float32)
    y = rng.integers(0, v, size=(n,)).astype(np.int32)
    if bad_labels:
        y[0], y[1] = -1, v
    return x, w, b, y


def _jax_value_and_grads(x, w, b, y, bn, bv, bias, dtype):
    args = [jnp.asarray(a, dtype) for a in (x, w, b)]

    def f(x, w, b):
        return jxk.linear_cross_entropy(x, w, jnp.asarray(y), b if bias else None,
                                        block_n=bn, block_v=bv, interpret=True,
                                        save_s=True)

    argnums = (0, 1, 2) if bias else (0, 1)
    loss, grads = jax.value_and_grad(f, argnums=argnums)(*args)
    return float(loss), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_value_and_grads(x, w, b, y, bias, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (x, w, b)]
    loss = linear_cross_entropy(leaves[0], leaves[1], torch.from_numpy(y),
                                leaves[2] if bias else None, save_s=True)
    loss.backward()
    used = leaves if bias else leaves[:2]
    return loss.item(), [t.grad.float().numpy() for t in used]


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("n,d,v,bn,bv", SHAPES, ids=SHAPE_IDS)
def test_f32_loss_and_grads_match_pallas_interpret(n, d, v, bn, bv, bias):
    x, w, b, y = _inputs(n, d, v)
    want, wgrads = _jax_value_and_grads(x, w, b, y, bn, bv, bias, jnp.float32)
    got, grads = _port_value_and_grads(x, w, b, y, bias, torch.float32)
    np.testing.assert_allclose(got, want, **F32_TOL)
    for name, g, r in zip(("dx", "dw", "db"), grads, wgrads):
        np.testing.assert_allclose(g, r, err_msg=name, **F32_TOL)


@pytest.mark.parametrize("n,d,v,bn,bv", SHAPES, ids=SHAPE_IDS)
def test_bf16_loss_and_grads_match_pallas_interpret(n, d, v, bn, bv):
    x, w, b, y = _inputs(n, d, v, seed=1)
    want, wgrads = _jax_value_and_grads(x, w, b, y, bn, bv, True, jnp.bfloat16)
    got, grads = _port_value_and_grads(x, w, b, y, True, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, g, r in zip(("dx", "dw", "db"), grads, wgrads):
        scale = np.abs(r).max()
        assert np.abs(g - r).max() <= BF16_GRAD_RTOL * scale, name


def test_out_of_range_labels_give_loss_lse():
    """Labels −1 and V contribute lse (picked 0, zero one-hot), as the
    Pallas kernel does: not clamped to an edge class."""
    n, d, v = 16, 32, 64
    x, w, b, y = _inputs(n, d, v, bad_labels=True)
    want, wgrads = _jax_value_and_grads(x, w, b, y, 8, 64, True, jnp.float32)
    got, grads = _port_value_and_grads(x, w, b, y, True, torch.float32)
    np.testing.assert_allclose(got, want, **F32_TOL)
    for g, r in zip(grads, wgrads):
        np.testing.assert_allclose(g, r, **F32_TOL)
    lse, picked = xent_forward(*(torch.from_numpy(a) for a in (x, w, b, y)))
    assert picked[0].item() == picked[1].item() == 0.0
    s = torch.from_numpy(x @ w + b)
    np.testing.assert_allclose(lse[:2].numpy(), torch.logsumexp(s[:2], -1).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("n,v,bn,bv", [
    (8192, 32768, 256, 2048),      # the flagship: 1 GiB of scores, saved
    (16384, 32768, 256, 2048),     # 2 GiB exactly: still saved
    (16385, 32768, 256, 2048),     # one row over: lean
    (131072, 32768, 256, 2048),    # long context, 16 GiB: lean
    (100, 1000, 8, 128),
])
def test_auto_save_s_resolves_as_jax(n, v, bn, bv):
    assert txk._padded_dims(n, v, bn, bv) == jxk._padded_dims(n, v, bn, bv)
    assert txk._auto_save_s(n, v, bn, bv) == jxk._auto_save_s(n, v, bn, bv)


def test_lean_mode_raises():
    x, w, b, y = (torch.from_numpy(a) for a in _inputs(16, 32, 64))
    with pytest.raises(NotImplementedError, match="kernels 14 and 15"):
        linear_cross_entropy(x, w, y, b, save_s=False)
    big_w = torch.zeros((8, 65536))  # N_pad·V_pad·4 = 8448·65536·4 > 2 GiB
    with pytest.raises(NotImplementedError, match="kernels 14 and 15"):
        linear_cross_entropy(torch.zeros((8200, 8)), big_w,
                             torch.zeros(8200, dtype=torch.int32))


def test_no_grad_path_equals_grad_path():
    x, w, b, y = _inputs(24, 16, 100, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    with_grad = linear_cross_entropy(leaves[0], leaves[1], torch.from_numpy(y), leaves[2])
    assert with_grad.requires_grad
    with torch.no_grad():
        no_grad = linear_cross_entropy(leaves[0], leaves[1], torch.from_numpy(y), leaves[2])
    plain = linear_cross_entropy(*(torch.from_numpy(a) for a in (x, w)),
                                 torch.from_numpy(y), torch.from_numpy(b))
    assert not no_grad.requires_grad and not plain.requires_grad
    assert no_grad.item() == with_grad.item() == plain.item()


def test_batched_shapes_flatten():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 16)).astype(np.float32)
    w = (0.1 * rng.normal(size=(16, 32))).astype(np.float32)
    y = rng.integers(0, 32, size=(2, 8)).astype(np.int32)
    want = jxk.linear_cross_entropy(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y),
                                    interpret=True, save_s=True)
    got = linear_cross_entropy(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(want), **F32_TOL)
    with pytest.raises(ValueError, match="labels"):
        linear_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(y[:, :4]))


def test_kernel_functions_on_cpu_are_the_plain_versions():
    """The four kernel wrappers on CPU tensors: forward stats of the saved
    and unsaved forward agree, and the backward pieces reproduce the
    autograd gradients of the materialized loss."""
    x, w, b, y = (torch.from_numpy(a) for a in _inputs(24, 16, 100, seed=5))
    lse, picked, s = xent_forward_save(x, w, b, y)
    assert torch.equal(torch.stack(xent_forward(x, w, b, y)), torch.stack((lse, picked)))
    dx = xent_dx(s, w, y, lse, 1.0 / 24)
    dw, db = xent_dw(s, x, y, lse, 1.0 / 24)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    logits = leaves[0] @ leaves[1] + leaves[2]
    torch.nn.functional.cross_entropy(logits, y.long()).backward()
    for got, leaf in zip((dx, dw, db), leaves):
        torch.testing.assert_close(got, leaf.grad, **F32_TOL)
