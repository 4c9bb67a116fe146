"""The port's CUDA kernels against their plain versions, on the card.

Card-only (``cuda`` marker; each test skips from a fixture on a machine
without one). The file imports no jax, so it runs on the card's machine,
which has none: ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
The CPU parity tests of the same ops against ``tpudml`` live in the
other ``tests/test_torch_*.py`` files.

Tolerances, with their reasons:
- flash forward O/lse and the decode head's max/lse: rtol 1e-5 / atol
  1e-5 (f32 sums in another order); greedy tokens exact;
- flash dQ/dK/dV: rtol 5e-4 / atol 1e-5, the JAX package's own gradient
  tolerance for the flash backward (f32 sums over up to T keys or rows
  taken in another order than the plain version's matmuls);
- add+LN s, y, mean, rstd, dx: rtol 1e-5 / atol 1e-5 (row sums of d
  terms in another order; ``rsqrtf`` is within 2 ulp);
- add+LN dγ, dβ: rtol 1e-4 / atol 1e-4 (sums over all N rows, in block
  order on the card, in one reduction on the plain side).
- the bf16 twins: what is stored in bf16 (O, dQ, dK, dV; y, dx) within
  2e-2 of the plain output's largest magnitude (both round to bf16,
  2^-8 relative, after f32 sums in another order that may land a value,
  or a rounded p or ds feeding it, one bf16 step away); what stays f32
  (lse; s, mean, rstd, dγ, dβ) at the f32 tolerances above;
- the xent kernels: lse, picked and the saved scores rtol 1e-5 / atol
  1e-5 (d-term f32 dots in another order); dX, dW, db within 1e-4 of the
  plain output's largest magnitude in f32 (sums over V or N terms) and
  2e-2 in bf16 (stored in bf16, dlog rounded to bf16 on both sides).
"""

import pytest

torch = pytest.importorskip("torch")

from tpudml_torch.nn.attention import dot_product_attention  # noqa: E402
from tpudml_torch.ops import (  # noqa: E402
    ADD_LN_BACKWARD_BF16, ADD_LN_FORWARD_BF16, FLASH_DKDV, FLASH_DKDV_BF16,
    FLASH_DQ, FLASH_DQ_BF16, FLASH_FORWARD_BF16, XENT_DW, XENT_DX, XENT_FORWARD,
    XENT_FORWARD_SAVE, add_layernorm_backward, add_layernorm_backward_reference,
    add_layernorm_forward, add_layernorm_forward_reference, flash_attention,
    flash_block_grads, flash_block_grads_reference, flash_forward_lse,
    flash_forward_lse_reference, fused_add_layernorm, fused_decode_head,
    fused_decode_head_int8, linear_cross_entropy, reference_head, xent_dw,
    xent_dw_reference, xent_dx, xent_dx_reference, xent_forward,
    xent_forward_reference, xent_forward_save, xent_forward_save_reference,
)
from tpudml_torch.serve.fleet import quant as tquant  # noqa: E402

GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
ROW_TOL = dict(rtol=1e-5, atol=1e-5)
COL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 2e-2  # of the plain output's max |value|, for what is stored in bf16
XENT_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _close_to_max(got, want, rel):
    """max |got − want| <= rel · max |want| (in f32)."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(*shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device)


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card(cuda_device):
    """The forward kernel against its plain version, with a strided
    (sliced) K/V block as the prefill window passes it."""
    q = _randn(2, 128, 8, 64, seed=0, device=cuda_device)
    k, v = (_randn(2, 256, 8, 64, seed=i, device=cuda_device) for i in (1, 2))
    kb, vb = k[:, 128:], v[:, 128:]  # non-contiguous over the batch axis
    for causal in (False, True):
        o, lse = flash_forward_lse(q, kb, vb, causal=causal)
        ro, rl = flash_forward_lse_reference(q, kb, vb, causal=causal)
        torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        flash_forward_lse(q.double(), kb.double(), vb.double())


@pytest.mark.cuda
def test_head_kernels_match_plain_on_card(cuda_device):
    x = _randn(8, 64, seed=9, device=cuda_device)
    w = _randn(64, 1000, seed=10, device=cuda_device)
    b = _randn(1000, seed=11, device=cuda_device)
    tok, mx, lse = fused_decode_head(x, w, b)
    rt, rm, rl = reference_head(x, w, b)
    assert torch.equal(tok, rt)
    torch.testing.assert_close(mx, rm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-5)
    wq, scale = tquant._quant_kernel(w)
    tok8, _, _ = fused_decode_head_int8(x, wq, scale, b)
    rt8, _, _ = reference_head(x, tquant._dequant_kernel(wq, scale), b)
    assert torch.equal(tok8, rt8)
    with pytest.raises(ValueError):  # a non-contiguous weight is refused
        fused_decode_head(x, w.t().contiguous().t(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,causal,k_shift", [
    (2, 256, 4, 128, True, 0),
    (2, 200, 4, 64, False, 0),
    (1, 77, 2, 32, True, 0),
    (1, 130, 2, 64, True, 1),
])
def test_flash_block_grads_kernel_matches_plain(cuda_device, b, t, h, d, causal, k_shift):
    q, k, v, do = (_randn(b, t, h, d, seed=i, device=cuda_device) for i in range(4))
    _, lse = flash_forward_lse(q, k, v, causal=causal)  # rows that all see a key
    delta = _randn(b, h, t, seed=9, device=cuda_device)
    before = (FLASH_DQ.launches, FLASH_DKDV.launches)
    got = flash_block_grads(q, k, v, do, lse, delta, causal=causal, k_shift=k_shift)
    want = flash_block_grads_reference(q, k, v, do, lse, delta, causal=causal,
                                       k_shift=k_shift)
    torch.cuda.synchronize()
    assert (FLASH_DQ.launches, FLASH_DKDV.launches) == (before[0] + 1, before[1] + 1)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, **GRAD_TOL)


@pytest.mark.cuda
def test_flash_block_grads_strided_and_deterministic(cuda_device):
    """K/V as non-contiguous slices (strides passed through), and two runs
    bitwise equal (no atomics)."""
    q, do = (_randn(2, 128, 4, 64, seed=i, device=cuda_device) for i in range(2))
    kv = _randn(2, 256, 4, 64, seed=5, device=cuda_device)
    k, v = kv[:, :128], kv[:, 128:]
    _, lse = flash_forward_lse(q, k, v, causal=True)
    delta = _randn(2, 4, 128, seed=6, device=cuda_device)
    a = flash_block_grads(q, k, v, do, lse, delta, causal=True)
    b = flash_block_grads(q, k, v, do, lse, delta, causal=True)
    want = flash_block_grads_reference(q, k, v, do, lse, delta, causal=True)
    for x, y, w in zip(a, b, want):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, w, **GRAD_TOL)


@pytest.mark.cuda
def test_flash_attention_autograd_matches_plain(cuda_device):
    q, k, v, w = (_randn(2, 192, 4, 64, seed=i, device=cuda_device) for i in range(4))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    (flash_attention(*qkv, causal=True) * w).sum().backward()
    (dot_product_attention(*ref, causal=True) * w).sum().backward()
    for a, b in zip(qkv, ref):
        torch.testing.assert_close(a.grad, b.grad, **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(8192, 512), (1000, 512), (37, 96)])
def test_add_layernorm_kernels_match_plain(cuda_device, n, d):
    x, r, dy, ds = (_randn(n, d, seed=i, device=cuda_device) for i in range(4))
    scale = 1.0 + 0.1 * _randn(d, seed=7, device=cuda_device)
    bias = 0.1 * _randn(d, seed=8, device=cuda_device)
    got = add_layernorm_forward(x, r, scale, bias)
    want = add_layernorm_forward_reference(x, r, scale, bias)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **ROW_TOL)
    s, _, mean, rstd = want
    for dsv in (ds, None):
        dx, dg, db = add_layernorm_backward(s, scale, dy, dsv, mean, rstd)
        rdx, rdg, rdb = add_layernorm_backward_reference(s, scale, dy, dsv, mean, rstd)
        torch.testing.assert_close(dx, rdx, **ROW_TOL)
        torch.testing.assert_close(dg, rdg, **COL_TOL)
        torch.testing.assert_close(db, rdb, **COL_TOL)
        again = add_layernorm_backward(s, scale, dy, dsv, mean, rstd)
        assert all(torch.equal(a, b) for a, b in zip((dx, dg, db), again))


@pytest.mark.cuda
def test_fused_add_layernorm_autograd_on_card(cuda_device):
    """Grads through the Function with and without a downstream use of s."""
    x, r, w1, w2 = (_randn(4, 33, 64, seed=i, device=cuda_device) for i in range(4))
    scale = 1.0 + 0.1 * _randn(64, seed=7, device=cuda_device)
    bias = 0.1 * _randn(64, seed=8, device=cuda_device)
    for use_s in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, r, scale, bias)]
        s, y = fused_add_layernorm(*leaves)
        loss = (y * w1).sum() + ((s * w2).sum() if use_s else 0.0)
        loss.backward()
        cpu = [t.detach().cpu().clone().requires_grad_() for t in (x, r, scale, bias)]
        s2, y2 = fused_add_layernorm(*cpu)
        loss2 = (y2 * w1.cpu()).sum() + ((s2 * w2.cpu()).sum() if use_s else 0.0)
        loss2.backward()
        for a, b in zip(leaves, cpu):
            torch.testing.assert_close(a.grad.cpu(), b.grad, **COL_TOL)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    q = _randn(1, 8, 1, 48, seed=0, device=cuda_device)  # head dim 48
    lse = torch.zeros(1, 1, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_block_grads(q, q, q, q, lse, lse)
    x = _randn(4, 2048, seed=0, device=cuda_device)
    g = torch.ones(2048, device=cuda_device)
    with pytest.raises(ValueError, match="width"):
        add_layernorm_forward(x, x, g, g)
    with pytest.raises(TypeError):
        add_layernorm_forward(x.double()[:, :8], x.double()[:, :8], g[:8], g[:8])


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,causal", [(2, 256, 4, 128, True), (1, 77, 2, 64, False)])
def test_bf16_flash_kernels_match_plain(cuda_device, b, t, h, d, causal):
    q, k, v, do = (_randn(b, t, h, d, seed=i, device=cuda_device).bfloat16()
                   for i in range(4))
    before = FLASH_FORWARD_BF16.launches
    o, lse = flash_forward_lse(q, k, v, causal=causal)
    ro, rlse = flash_forward_lse_reference(q, k, v, causal=causal)
    assert FLASH_FORWARD_BF16.launches == before + 1 and o.dtype == torch.bfloat16
    _close_to_max(o, ro, BF16_REL)
    torch.testing.assert_close(lse, rlse, **ROW_TOL)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    before = (FLASH_DQ_BF16.launches, FLASH_DKDV_BF16.launches)
    got = flash_block_grads(q, k, v, do, rlse, delta, causal=causal)
    want = flash_block_grads_reference(q, k, v, do, rlse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (FLASH_DQ_BF16.launches, FLASH_DKDV_BF16.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    for g_, w in zip(got, want):
        assert g_.dtype == torch.bfloat16
        _close_to_max(g_, w, BF16_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(8192, 512), (1000, 512), (37, 96)])
def test_bf16_add_layernorm_kernels_match_plain(cuda_device, n, d):
    x, r, dy, ds = (_randn(n, d, seed=i, device=cuda_device).bfloat16() for i in range(4))
    scale = 1.0 + 0.1 * _randn(d, seed=7, device=cuda_device)
    bias = 0.1 * _randn(d, seed=8, device=cuda_device)
    before = (ADD_LN_FORWARD_BF16.launches, ADD_LN_BACKWARD_BF16.launches)
    s, y, mean, rstd = add_layernorm_forward(x, r, scale, bias)
    rs, ry, rmean, rrstd = add_layernorm_forward_reference(x, r, scale, bias)
    assert torch.equal(s, rs)  # one rounding of the same f32 sum
    _close_to_max(y, ry, BF16_REL)
    torch.testing.assert_close(mean, rmean, **ROW_TOL)
    torch.testing.assert_close(rstd, rrstd, **ROW_TOL)
    for dsv in (ds, None):
        dx, dg, db = add_layernorm_backward(rs, scale, dy, dsv, rmean, rrstd)
        rdx, rdg, rdb = add_layernorm_backward_reference(rs, scale, dy, dsv, rmean, rrstd)
        assert dx.dtype == torch.bfloat16 and dg.dtype == torch.float32
        _close_to_max(dx, rdx, BF16_REL)
        torch.testing.assert_close(dg, rdg, **COL_TOL)
        torch.testing.assert_close(db, rdb, **COL_TOL)
    assert (ADD_LN_FORWARD_BF16.launches, ADD_LN_BACKWARD_BF16.launches) == (
        before[0] + 1, before[1] + 2)


def _xent_inputs(n, d, v, dtype, device, seed=0):
    x = _randn(n, d, seed=seed, device=device).to(dtype)
    w = (0.05 * _randn(d, v, seed=seed + 1, device=device)).to(dtype)
    b = (0.1 * _randn(v, seed=seed + 2, device=device)).to(dtype)
    g = torch.Generator().manual_seed(seed + 3)
    y = torch.randint(0, v, (n,), generator=g, dtype=torch.int32)
    y[0], y[-1] = -1, v  # out of range: loss = lse, no pull-up
    return x, w, b, y.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d,v", [(1000, 64, 1000), (256, 512, 4096), (37, 8, 130)])
def test_xent_kernels_match_plain(cuda_device, dtype, n, d, v):
    x, w, b, y = _xent_inputs(n, d, v, dtype, cuda_device)
    before = [k.launches for k in (XENT_FORWARD, XENT_FORWARD_SAVE, XENT_DX, XENT_DW)]
    lse0, picked0 = xent_forward(x, w, b, y)
    lse, picked, s = xent_forward_save(x, w, b, y)
    rlse, rpicked, rs = xent_forward_save_reference(x, w, b, y)
    for got in (lse0, lse):
        torch.testing.assert_close(got, rlse, **ROW_TOL)
    for got in (picked0, picked):
        torch.testing.assert_close(got, rpicked, **ROW_TOL)
    assert picked[0].item() == picked[-1].item() == 0.0
    torch.testing.assert_close(s, rs, **ROW_TOL)
    dx = xent_dx(rs, w, y, rlse, 1.0 / n)
    dw, db = xent_dw(rs, x, y, rlse, 1.0 / n)
    torch.cuda.synchronize()
    assert [k.launches for k in (XENT_FORWARD, XENT_FORWARD_SAVE, XENT_DX, XENT_DW)] == [
        c + 1 for c in before]
    rel = XENT_GRAD_REL[dtype]
    _close_to_max(dx, xent_dx_reference(rs, w, y, rlse, 1.0 / n), rel)
    rdw, rdb = xent_dw_reference(rs, x, y, rlse, 1.0 / n)
    _close_to_max(dw, rdw, rel)
    _close_to_max(db, rdb, XENT_GRAD_REL[torch.float32])
    assert dx.dtype == dw.dtype == dtype and db.dtype == torch.float32
    again = (xent_dx(rs, w, y, rlse, 1.0 / n), *xent_dw(rs, x, y, rlse, 1.0 / n))
    assert all(torch.equal(a, c) for a, c in zip((dx, dw, db), again))


@pytest.mark.cuda
def test_linear_cross_entropy_autograd_on_card(cuda_device):
    """The grad path runs kernels 11, 12, 13 and matches the CPU plain
    path; the no-grad path runs kernel 10."""
    x, w, b, y = _xent_inputs(500, 64, 700, torch.float32, cuda_device, seed=4)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    before = [k.launches for k in (XENT_FORWARD, XENT_FORWARD_SAVE, XENT_DX, XENT_DW)]
    loss = linear_cross_entropy(*leaves[:2], y, leaves[2], save_s=True)
    loss.backward()
    with torch.no_grad():
        loss0 = linear_cross_entropy(x, w, y, b)
    assert [k.launches for k in (XENT_FORWARD, XENT_FORWARD_SAVE, XENT_DX, XENT_DW)] == [
        before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1]
    cpu = [t.detach().cpu().clone().requires_grad_() for t in (x, w, b)]
    want = linear_cross_entropy(*cpu[:2], y.cpu(), cpu[2], save_s=True)
    want.backward()
    torch.testing.assert_close(loss.cpu(), want, **ROW_TOL)
    torch.testing.assert_close(loss0.cpu(), want.detach(), **ROW_TOL)
    for a, c in zip(leaves, cpu):
        _close_to_max(a.grad.cpu(), c.grad, 1e-4)


@pytest.mark.cuda
def test_xent_kernels_reject_what_they_do_not_take(cuda_device):
    x, w, b, y = _xent_inputs(16, 12, 64, torch.float32, cuda_device)  # d % 8 != 0
    with pytest.raises(ValueError, match="multiple of 8"):
        xent_forward(x, w, b, y)
    x, w, b, y = _xent_inputs(16, 16, 64, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        xent_forward(x.double(), w.double(), b.double(), y)
    with pytest.raises(TypeError):
        xent_forward(x, w.bfloat16(), b, y)
    with pytest.raises(TypeError):
        xent_forward(x, w, b, y.long())
