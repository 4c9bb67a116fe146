"""The port's fused attention junction (``tpudml_torch.ops.junction_kernel``,
the plain versions of its kernels on the CPU) against ``tpudml``'s
``reference_attn_junction``: values and every input's gradient, f32,
rtol 1e-5 / atol 1e-6 for values and rtol 1e-4 / atol 1e-6 for gradients
(sums over T and d in another order, as ``tests/test_torch_train.py``).
The JAX fused unit's own gradient test fails in ``tpudml`` (ROADMAP.md
queue 3), so the reference function is the oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.ops.junction_kernel import reference_attn_junction as jax_reference  # noqa: E402
from tpudml_torch.ops import KERNELS, reset_launch_counts  # noqa: E402
from tpudml_torch.ops.junction_kernel import (  # noqa: E402
    fused_attn_junction, reference_attn_junction,
)

VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
NAMES = ("q", "k", "v", "r", "wo", "bo", "scale", "bias")


def _inputs(b, t, h, dh, seed):
    rng = np.random.default_rng(seed)
    d = h * dh
    shapes = dict(q=(b, t, h, dh), k=(b, t, h, dh), v=(b, t, h, dh), r=(b, t, d),
                  wo=(d, d), bo=(d,), scale=(d,), bias=(d,))
    x = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    x["wo"] /= np.sqrt(d)
    x["scale"] = 1.0 + 0.1 * x["scale"]
    return x, rng.standard_normal((b, t, d)).astype(np.float32)


def _jax(x, gs, gy, causal):
    def f(*args):
        s, y = jax_reference(*args, causal=causal)
        return jnp.sum(s * gs) + jnp.sum(y * gy), (s, y)

    (_, (s, y)), grads = jax.value_and_grad(f, argnums=tuple(range(8)), has_aux=True)(
        *(jnp.asarray(x[n]) for n in NAMES))
    return np.asarray(s), np.asarray(y), [np.asarray(g) for g in grads]


def _torch(fn, x, gs, gy, causal):
    args = [torch.tensor(x[n], requires_grad=True) for n in NAMES]
    s, y = fn(*args, causal=causal)
    (s * torch.from_numpy(gs)).sum().add((y * torch.from_numpy(gy)).sum()).backward()
    return s.detach().numpy(), y.detach().numpy(), [a.grad.numpy() for a in args]


@pytest.mark.parametrize("fn", [fused_attn_junction, reference_attn_junction],
                         ids=["fused", "reference"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [(2, 16, 4, 8), (1, 13, 2, 16)], ids=["B2T16", "T13"])
def test_junction_matches_jax_reference(fn, causal, shape):
    x, gy = _inputs(*shape, seed=sum(shape))
    gs = np.random.default_rng(1).standard_normal(gy.shape).astype(np.float32)
    want_s, want_y, want_g = _jax(x, gs, gy, causal)
    s, y, grads = _torch(fn, x, gs, gy, causal)
    np.testing.assert_allclose(s, want_s, **VAL_TOL)
    np.testing.assert_allclose(y, want_y, **VAL_TOL)
    for name, g, w in zip(NAMES, grads, want_g):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


def test_junction_counts_no_launch_on_the_cpu_and_checks_shapes():
    x, _ = _inputs(1, 8, 2, 4, seed=0)
    args = [torch.from_numpy(x[n]) for n in NAMES]
    reset_launch_counts()
    fused_attn_junction(*args)
    assert all(k.launches == 0 for k in KERNELS)  # plain versions on CPU tensors
    with pytest.raises(ValueError, match="r "):
        fused_attn_junction(*args[:3], args[3][:, :4], *args[4:])
    with pytest.raises(ValueError, match="wo "):
        fused_attn_junction(*args[:4], args[4][:4], *args[5:])
