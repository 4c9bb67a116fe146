"""The port's flash backward (plain version on the CPU) against the JAX
package's Pallas dQ and dK/dV kernels in interpret mode.

- ``flash_block_grads`` (external lse/Δ) against JAX ``flash_block_grads``
  with the same statistics: causal, non-causal and ``k_shift=1``;
  T = 32 and 27 (a padded tail in the JAX tiles); several JAX tilings.
- ``flash_attention`` value and gradients (the autograd Function: the
  forward saves (q, k, v, o, lse), the backward takes Δ in plain PyTorch
  and calls ``flash_block_grads``) against JAX ``flash_attention``.

Tolerances are JAX's own for these kernels (``tests/test_flash.py``):
rtol 2e-5 / atol 2e-6 on values, rtol 5e-4 / atol 1e-5 on gradients.
The lse handed to the per-block grads comes from a k_shift=0 forward, so
every row has a finite lse (the case the ring composition produces); the
port gives masked entries p = 0 for any lse.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.ops import attention_kernel as jfa  # noqa: E402
from tpudml_torch.nn.attention import dot_product_attention  # noqa: E402
from tpudml_torch.ops import (  # noqa: E402
    flash_attention, flash_block_grads, flash_block_grads_reference, flash_dkdv,
    flash_dq, flash_forward_lse,
)
from tpudml_torch.ops.attention_kernel import NEG_INF  # noqa: E402

B, H, D = 2, 4, 8
VAL_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def _arrays(t, n=4, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, t, H, D)).astype(np.float32) for _ in range(n)]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("t,causal,k_shift,block_q,block_k", [
    (32, False, 0, 8, 8), (32, True, 0, 16, 4), (32, True, 1, 8, 8),
    (27, False, 0, 16, 4), (27, True, 0, 8, 8), (27, True, 1, 16, 4),
])
def test_flash_block_grads_matches_pallas(t, causal, k_shift, block_q, block_k):
    q, k, v, do = _arrays(t)
    _, lse = jfa.flash_forward_lse(*map(jnp.asarray, (q, k, v)), causal=causal,
                                   block_q=8, block_k=8, interpret=True)
    delta = np.random.default_rng(3).normal(size=(B, H, t)).astype(np.float32)
    want = jfa.flash_block_grads(
        *map(jnp.asarray, (q, k, v, do, lse, delta)), causal=causal,
        k_shift=k_shift, block_q=block_q, block_k=block_k, interpret=True)
    got = flash_block_grads(*_t(q, k, v, do, lse, delta), causal=causal,
                            k_shift=k_shift)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("t,causal,block_q,block_k", [
    (32, False, 8, 8), (32, True, 16, 4), (27, False, 16, 4), (27, True, 8, 8),
])
def test_flash_attention_value_and_grads_match_pallas(t, causal, block_q, block_k):
    q, k, v, w = _arrays(t, seed=7)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, interpret=True)
        return jnp.sum(o * jnp.asarray(w)), o

    (_, want_o), want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    o = flash_attention(*leaves, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), **VAL_TOL)
    for name, x, g in zip(("dq", "dk", "dv"), leaves, want_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), err_msg=name, **GRAD_TOL)


def test_flash_attention_grads_match_plain_attention_autograd():
    """The Function's gradients equal autograd through the plain masked
    softmax attention, including through a GQA repeat."""
    q, k, v, w = _arrays(20, seed=2)
    wt = torch.from_numpy(w)
    kv = [torch.from_numpy(x[:, :, :2]).requires_grad_() for x in (k, v)]
    kv_ref = [x.detach().clone().requires_grad_() for x in kv]
    qa = torch.from_numpy(q).requires_grad_()
    qb = qa.detach().clone().requires_grad_()
    rep = [torch.repeat_interleave(x, 2, dim=2) for x in kv]
    (flash_attention(qa, *rep, causal=True) * wt).sum().backward()
    rep = [torch.repeat_interleave(x, 2, dim=2) for x in kv_ref]
    (dot_product_attention(qb, *rep, causal=True) * wt).sum().backward()
    for a, b in zip([qa, *kv], [qb, *kv_ref]):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **GRAD_TOL)


def test_flash_block_grads_checks_shapes():
    q, k, v, do = _t(*_arrays(8))
    lse = torch.zeros(B, H, 8)
    with pytest.raises(ValueError, match="lse"):
        flash_block_grads(q, k, v, do, lse[:, :, :4], lse)
    with pytest.raises(ValueError, match="do"):
        flash_block_grads(q, k, v, do[:, :4], lse, lse)
    with pytest.raises(ValueError, match="k_shift"):
        flash_block_grads(q, k, v, do, lse, lse, k_shift=-1)
    dq, dk, dv = flash_block_grads_reference(q, k, v, do, lse, lse, causal=True)
    assert dq.shape == dk.shape == dv.shape == q.shape


def test_dq_and_dkdv_entry_points_split_block_grads():
    """flash_dq and flash_dkdv (one kernel each on the card) are the two
    halves of flash_block_grads."""
    q, k, v, do = _t(*_arrays(19, seed=4))
    lse = torch.from_numpy(np.random.default_rng(5).normal(size=(B, H, 19)).astype(np.float32))
    delta = lse.flip(-1).contiguous()
    for causal, k_shift in ((False, 0), (True, 1)):
        dq, dk, dv = flash_block_grads(q, k, v, do, lse, delta, causal=causal,
                                       k_shift=k_shift)
        np.testing.assert_array_equal(
            flash_dq(q, k, v, do, lse, delta, causal=causal, k_shift=k_shift).numpy(),
            dq.numpy())
        for a, b in zip(flash_dkdv(q, k, v, do, lse, delta, causal=causal,
                                   k_shift=k_shift), (dk, dv)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_row_that_sees_no_key_gets_no_gradient():
    """A defined difference from the TPU kernel: with k_shift=1 the first
    row sees no key and its own forward gives it lse = NEG_INF. The port
    gives masked entries p = 0 whatever the lse, so that row contributes
    nothing; the TPU kernel computes exp(NEG_INF − NEG_INF) = 1 on the
    masked entries of the tiles it visits. Merged statistics (ring CP)
    never hand such a row to the kernel."""
    q, k, v, do = _t(*_arrays(16, seed=6))
    o, lse = flash_forward_lse(q, k, v, causal=True, k_shift=1)
    assert (lse[..., 0] == NEG_INF).all()
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = flash_block_grads(q, k, v, do, lse, delta, causal=True, k_shift=1)
    assert (dq[:, 0] == 0).all()
    # Row 0 adds nothing to dK/dV: the same grads without it.
    keep = slice(1, None)
    _, dk1, dv1 = flash_block_grads_reference(
        q, k, v, torch.cat([torch.zeros_like(do[:, :1]), do[:, keep]], 1), lse, delta,
        causal=True, k_shift=1)
    np.testing.assert_array_equal(dk.numpy(), dk1.numpy())
    np.testing.assert_array_equal(dv.numpy(), dv1.numpy())
