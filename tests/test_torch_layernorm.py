"""The port's fused residual add + LayerNorm and plain fused LayerNorm
(plain versions of kernels 8, 9 and 6, 7 on the CPU) against the JAX
package's Pallas kernels in interpret mode
(``fused_add_layernorm(..., interpret=True, block_n=8)``,
``fused_layernorm(..., interpret=True, block_n=8)``).

Covers s, y and the gradients of x, r, γ, β, with and without a
downstream use of s (without one, the autograd Function gets no ds and
merges nothing), for N a multiple and not a multiple of the JAX tile of
8 rows, and at d = 1100, wider than the card's register instances. Tolerances: rtol 1e-5 / atol 1e-6 on s, y and dx (the JAX
package's f32 parity tolerance); rtol 1e-5 / atol 1e-5 on dγ/dβ, which
sum over all N rows in another order. bf16 rows (``fused_layernorm``):
y and dx, which both sides round to bf16 after f32 arithmetic in another
order, within 1e-2 of their largest magnitude (a value may land one bf16
step, 2^-8 relative, away); dγ/dβ stay f32 (COL_TOL).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.ops.layernorm_kernel import fused_add_layernorm as jax_add_ln  # noqa: E402
from tpudml.ops.layernorm_kernel import fused_layernorm as jax_ln  # noqa: E402
from tpudml_torch.ops import (  # noqa: E402
    add_layernorm_backward_reference, add_layernorm_forward, fused_add_layernorm,
    fused_layernorm, layernorm_backward, layernorm_forward,
)

ROW_TOL = dict(rtol=1e-5, atol=1e-6)
COL_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(lead, d=48, seed=0):
    rng = np.random.default_rng(seed)
    x, r, w1, w2 = (rng.normal(size=(*lead, d)).astype(np.float32) for _ in range(4))
    scale = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=d)).astype(np.float32)
    return x, r, scale, bias, w1, w2


# d = 1100: past the 1024 columns the card's kernels hold in registers.
@pytest.mark.parametrize("lead,d", [((2, 8), 48), ((3, 7), 48), ((3,), 1100)],
                         ids=["N16", "N21", "N3-d1100"])
@pytest.mark.parametrize("use_s", [True, False], ids=["s_used", "s_unused"])
def test_fused_add_layernorm_matches_pallas(lead, d, use_s):
    x, r, scale, bias, w1, w2 = _inputs(lead, d=d)

    def jloss(x, r, g, b):
        s, y = jax_add_ln(x, r, g, b, interpret=True, block_n=8)
        out = jnp.sum(y * w1) + (jnp.sum(s * w2) if use_s else 0.0)
        return out, (s, y)

    (_, (want_s, want_y)), want_g = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (x, r, scale, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, r, scale, bias)]
    s, y = fused_add_layernorm(*leaves)
    loss = (y * torch.from_numpy(w1)).sum()
    if use_s:
        loss = loss + (s * torch.from_numpy(w2)).sum()
    loss.backward()
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(want_s), **ROW_TOL)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **ROW_TOL)
    for name, leaf, g, tol in zip(("dx", "dr", "dscale", "dbias"), leaves, want_g,
                                  (ROW_TOL, ROW_TOL, COL_TOL, COL_TOL)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), err_msg=name, **tol)


def test_forward_statistics_and_backward_without_ds():
    """mean/rstd are the single-pass clamped f32 statistics; ds=None is the
    same as ds=0."""
    x, r, scale, bias, dy, _ = _inputs((21,), d=40, seed=3)
    xt, rt, gt, bt, dyt = map(torch.from_numpy, (x, r, scale, bias, dy))
    s, y, mean, rstd = add_layernorm_forward(xt, rt, gt, bt)
    sf = (x + r).astype(np.float32)
    m = sf.mean(-1)
    np.testing.assert_allclose(mean.numpy(), m, **ROW_TOL)
    var = np.maximum((sf * sf).mean(-1) - m * m, 0.0)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(var + 1e-5), rtol=1e-5)
    a = add_layernorm_backward_reference(s, gt, dyt, None, mean, rstd)
    b = add_layernorm_backward_reference(s, gt, dyt, torch.zeros_like(s), mean, rstd)
    for u, w in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), w.numpy())


def test_fused_add_layernorm_checks_shapes():
    x, r, scale, bias, _, _ = map(torch.from_numpy, _inputs((4,), d=8))
    with pytest.raises(ValueError, match="!="):
        fused_add_layernorm(x, r[:2], scale, bias)
    with pytest.raises(ValueError, match="scale/bias"):
        fused_add_layernorm(x, r, scale[:4], bias)


@pytest.mark.parametrize("lead,d", [((2, 8), 48), ((3, 7), 48), ((5,), 48), ((3,), 1100)],
                         ids=["N16", "N21", "N5", "N3-d1100"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_layernorm_matches_pallas(lead, d, dtype):
    """y and the gradients of x, γ, β through the plain LayerNorm op, over
    leading shapes, widths and row dtypes (γ, β f32)."""
    jdt, tdt = DTYPES[dtype]
    x, _, scale, bias, w1, _ = _inputs(lead, d=d, seed=5)

    def jloss(x, g, b):
        y = jax_ln(x, g, b, interpret=True, block_n=8)
        return jnp.sum(y.astype(jnp.float32) * w1), y

    (_, want_y), want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(),
              *(torch.from_numpy(a).requires_grad_() for a in (scale, bias))]
    y = fused_layernorm(*leaves)
    assert y.dtype == tdt and y.shape == leaves[0].shape
    (y.float() * torch.from_numpy(w1)).sum().backward()
    pairs = [("y", y.detach(), want_y)] + [
        (name, leaf.grad, g) for name, leaf, g in zip(("dx", "dscale", "dbias"), leaves, want_g)]
    for name, got, want in pairs:
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        if name in ("dscale", "dbias"):
            np.testing.assert_allclose(got, want, err_msg=name, **COL_TOL)
        elif dtype == "f32":
            np.testing.assert_allclose(got, want, err_msg=name, **ROW_TOL)
        else:
            assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max(), name


def test_layernorm_kernel_functions_on_cpu():
    """The plain LayerNorm's forward is add+LN's with a zero residual, and
    its backward is add+LN's with no ds."""
    x, _, scale, bias, dy, _ = _inputs((21,), d=40, seed=6)
    xt, gt, bt, dyt = map(torch.from_numpy, (x, scale, bias, dy))
    y, mean, rstd = layernorm_forward(xt, gt, bt)
    _, ay, amean, arstd = add_layernorm_forward(xt, torch.zeros_like(xt), gt, bt)
    for u, w in ((y, ay), (mean, amean), (rstd, arstd)):
        np.testing.assert_array_equal(u.numpy(), w.numpy())
    got = layernorm_backward(xt, gt, dyt, mean, rstd)
    want = add_layernorm_backward_reference(xt, gt, dyt, None, mean, rstd)
    for u, w in zip(got, want):
        np.testing.assert_array_equal(u.numpy(), w.numpy())


def test_fused_layernorm_checks_shapes():
    x, _, scale, bias, _, _ = map(torch.from_numpy, _inputs((4,), d=8))
    with pytest.raises(ValueError, match="scale/bias"):
        fused_layernorm(x, scale[:4], bias)
    with pytest.raises(ValueError, match="scale/bias"):
        fused_layernorm(x, scale, bias[None])
