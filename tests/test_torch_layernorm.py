"""The port's fused residual add + LayerNorm (plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode
(``fused_add_layernorm(..., interpret=True, block_n=8)``).

Covers s, y and the gradients of x, r, γ, β, with and without a
downstream use of s (without one, the autograd Function gets no ds and
merges nothing), for N a multiple and not a multiple of the JAX tile of
8 rows. Tolerances: rtol 1e-5 / atol 1e-6 on s, y and dx (the JAX
package's f32 parity tolerance); rtol 1e-5 / atol 1e-5 on dγ/dβ, which
sum over all N rows in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.ops.layernorm_kernel import fused_add_layernorm as jax_add_ln  # noqa: E402
from tpudml_torch.ops import (  # noqa: E402
    add_layernorm_backward_reference, add_layernorm_forward, fused_add_layernorm,
)

ROW_TOL = dict(rtol=1e-5, atol=1e-6)
COL_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(lead, d=48, seed=0):
    rng = np.random.default_rng(seed)
    x, r, w1, w2 = (rng.normal(size=(*lead, d)).astype(np.float32) for _ in range(4))
    scale = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=d)).astype(np.float32)
    return x, r, scale, bias, w1, w2


@pytest.mark.parametrize("lead", [(2, 8), (3, 7)], ids=["N16", "N21"])
@pytest.mark.parametrize("use_s", [True, False], ids=["s_used", "s_unused"])
def test_fused_add_layernorm_matches_pallas(lead, use_s):
    x, r, scale, bias, w1, w2 = _inputs(lead)

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
