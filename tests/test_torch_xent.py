"""The port's fused linear cross-entropy (``tpudml_torch.ops.xent_kernel``)
against ``tpudml.ops.xent_kernel.linear_cross_entropy`` run through its
Pallas kernels in interpret mode (``interpret=True``, ``save_s`` True for
the saved-scores mode, False for the lean one), on the CPU, where the port
runs the plain versions of kernels 10–15. Inputs come from numpy seeds.

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
    linear_cross_entropy, xent_dw, xent_dw_lean, xent_dx, xent_dx_lean, xent_forward,
    xent_forward_save,
)

# d = 12: not a multiple of the card's 8-deep contraction stage; d = 1032:
# past one 512-column chunk of the card's lean kernels (a cluster of 3).
SHAPES = [(16, 32, 64, 8, 64), (24, 16, 100, 8, 128), (16, 12, 64, 8, 64),
          (8, 1032, 64, 8, 64)]
SHAPE_IDS = ["n16-d32-v64", "n24-d16-v100-ragged", "n16-d12-v64", "n8-d1032-v64"]
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


def _jax_value_and_grads(x, w, b, y, bn, bv, bias, dtype, save_s=True):
    args = [jnp.asarray(a, dtype) for a in (x, w, b)]

    def f(x, w, b):
        return jxk.linear_cross_entropy(x, w, jnp.asarray(y), b if bias else None,
                                        block_n=bn, block_v=bv, interpret=True,
                                        save_s=save_s)

    argnums = (0, 1, 2) if bias else (0, 1)
    loss, grads = jax.value_and_grad(f, argnums=argnums)(*args)
    return float(loss), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_value_and_grads(x, w, b, y, bias, dtype, save_s=True):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (x, w, b)]
    loss = linear_cross_entropy(leaves[0], leaves[1], torch.from_numpy(y),
                                leaves[2] if bias else None, save_s=save_s)
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


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("n,d,v,bn,bv", SHAPES, ids=SHAPE_IDS)
def test_lean_f32_loss_and_grads_match_pallas_interpret(n, d, v, bn, bv, bias):
    """The lean mode (kernel 10 forward, 14 and 15 backward) against JAX's
    lean Pallas kernels in interpret mode."""
    x, w, b, y = _inputs(n, d, v, seed=6)
    want, wgrads = _jax_value_and_grads(x, w, b, y, bn, bv, bias, jnp.float32,
                                        save_s=False)
    got, grads = _port_value_and_grads(x, w, b, y, bias, torch.float32, save_s=False)
    np.testing.assert_allclose(got, want, **F32_TOL)
    for name, g, r in zip(("dx", "dw", "db"), grads, wgrads):
        np.testing.assert_allclose(g, r, err_msg=name, **F32_TOL)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("n,d,v,bn,bv", SHAPES, ids=SHAPE_IDS)
def test_lean_bf16_loss_and_grads_match_pallas_interpret(n, d, v, bn, bv, bias):
    x, w, b, y = _inputs(n, d, v, seed=7)
    want, wgrads = _jax_value_and_grads(x, w, b, y, bn, bv, bias, jnp.bfloat16,
                                        save_s=False)
    got, grads = _port_value_and_grads(x, w, b, y, bias, torch.bfloat16, save_s=False)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, g, r in zip(("dx", "dw", "db"), grads, wgrads):
        assert g.dtype == np.float32  # compared in f32, stored in bf16
        assert np.abs(g - r).max() <= BF16_GRAD_RTOL * np.abs(r).max(), name


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_lean_kernel_functions_match_jax_fused_backward(dtype):
    """The plain versions of kernels 14 and 15, called as the card's
    wrappers are (g = 1, 1/N inside), against JAX's ``_fused_backward``
    (the lean Pallas kernels in interpret mode) on a ragged shape."""
    n, d, v = 24, 16, 100
    x, w, b, y = _inputs(n, d, v, seed=8, bad_labels=True)
    jx, jw, jb = (jnp.asarray(a, dtype) for a in (x, w, b))
    jlse, _ = jxk._fused_forward(jx, jw, jb, jnp.asarray(y), 8, 128, True)
    wdx, wdw, wdb = jxk._fused_backward(jx, jw, jb, jnp.asarray(y), jlse,
                                        jnp.float32(1.0), 8, 128, True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx, tw, tb = (torch.from_numpy(a).to(tdt) for a in (x, w, b))
    lse = torch.from_numpy(np.array(jlse))
    dx = xent_dx_lean(tx, tw, tb, torch.from_numpy(y), lse, 1.0 / n)
    dw, db = xent_dw_lean(tx, tw, tb, torch.from_numpy(y), lse, 1.0 / n)
    assert dx.dtype == dw.dtype == tdt and db.dtype == torch.float32
    # JAX's db comes back in the bias dtype; the wrapper's stays f32 (the
    # autograd Function casts it).
    for name, g, r in (("dx", dx, wdx), ("dw", dw, wdw), ("db", db.to(tdt), wdb)):
        g, r = g.float().numpy(), np.asarray(r.astype(jnp.float32))
        if dtype == jnp.float32:
            np.testing.assert_allclose(g, r, err_msg=name, **F32_TOL)
        else:
            assert np.abs(g - r).max() <= BF16_GRAD_RTOL * np.abs(r).max(), name


def test_lean_out_of_range_labels_and_padded_rows():
    """JAX's padded-row and padded-column cases in the lean mode: 10 rows
    (8-row tiles pad them to 16), V = 100 (padded to 128), labels in
    [V, V_pad), beyond, and negative. Loss and gradients equal JAX's lean
    mode and the port's saved-scores mode."""
    n, d, v = 10, 16, 100
    x, w, _, _ = _inputs(n, d, v, seed=9)
    y = np.array([0, 5, 99, 100, 110, 127, 3000, -7, 1, 2], np.int32)
    b = np.zeros(v, np.float32)
    want, wgrads = _jax_value_and_grads(x, w, b, y, 8, 128, False, jnp.float32,
                                        save_s=False)
    got, grads = _port_value_and_grads(x, w, b, y, False, torch.float32, save_s=False)
    saved, sgrads = _port_value_and_grads(x, w, b, y, False, torch.float32, save_s=True)
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, saved, **F32_TOL)
    for g, r, s in zip(grads, wgrads, sgrads):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, r, **F32_TOL)
        np.testing.assert_allclose(g, s, **F32_TOL)


def test_auto_mode_reaches_lean(monkeypatch):
    """save_s=None resolves to the lean backward once the padded f32 score
    residual exceeds the auto budget: shown at a tiny shape with the budget
    lowered (in both packages) below its 24·128·4 bytes."""
    calls = []
    real = txk.xent_dx_lean

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(txk, "xent_dx_lean", counting)
    n, d, v = 24, 16, 100
    x, w, b, y = _inputs(n, d, v, seed=10)
    for mod in (txk, jxk):
        monkeypatch.setattr(mod, "SAVE_S_AUTO_MAX_BYTES", 24 * 128 * 4 - 1)
    assert not txk._auto_save_s(n, v, 256, 2048)
    assert jxk._auto_save_s(n, v, 256, 2048) is False
    want, wgrads = _jax_value_and_grads(x, w, b, y, 256, 2048, True, jnp.float32,
                                        save_s=False)
    got, grads = _port_value_and_grads(x, w, b, y, True, torch.float32, save_s=None)
    assert calls == [(n, d)]
    np.testing.assert_allclose(got, want, **F32_TOL)
    for g, r in zip(grads, wgrads):
        np.testing.assert_allclose(g, r, **F32_TOL)


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


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_lean_and_saved_gradients_agree(bias):
    """Within the port: the lean backward (recomputed scores) and the
    saved-scores one give the same loss and gradients (f32 scores either
    way; only the order of the d-term sums differs)."""
    x, w, b, y = _inputs(40, 24, 130, seed=11)
    lean, lgrads = _port_value_and_grads(x, w, b, y, bias, torch.float32, save_s=False)
    saved, sgrads = _port_value_and_grads(x, w, b, y, bias, torch.float32, save_s=True)
    assert lean == saved
    for g, r in zip(lgrads, sgrads):
        np.testing.assert_allclose(g, r, **F32_TOL)


@pytest.mark.parametrize("d,cluster,s_passes", [
    (1, 1, 1), (12, 1, 1), (512, 1, 1), (513, 2, 1), (1024, 2, 1), (1025, 3, 1),
    (2048, 4, 1), (4096, 8, 1), (4097, 8, 2), (8192, 8, 2), (40000, 8, 10),
])
def test_lean_plan_computes_the_scores_once_up_to_4096(d, cluster, s_passes):
    """The lean kernels' cut of d (``lean_plan``, the host's mirror of
    csrc/xent_lean.cu ``lean_chunks``; a card-only test holds the two
    equal): one 512-column chunk a block, the chunks of a tile in one
    cluster of up to 8 blocks, so the scores of a tile are computed once
    for every d up to 4096 and once per 4096 columns beyond; the clusters
    cover every column of d and no cluster is empty."""
    plan = txk.lean_plan(d)
    assert plan == {"chunk": 512, "cluster": cluster, "s_passes": s_passes}
    chunks = -(-d // plan["chunk"])
    assert plan["cluster"] * plan["s_passes"] >= chunks
    assert plan["cluster"] * (plan["s_passes"] - 1) < chunks


def test_lean_plan_rejects_an_empty_width():
    with pytest.raises(ValueError):
        txk.lean_plan(0)
