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
  2e-2 in bf16 (stored in bf16, dlog rounded to bf16 on both sides); the
  lean kernels 14 and 15 the same (their recomputed scores are d-term
  f32 dots in another order too);
- the plain LayerNorm kernels 6 and 7: as add+LN's (no residual, no ds);
- the flash forward, dQ and dK/dV at any head dim from 1 to 256: the
  tolerances above, f32 or bf16; a repeat call bitwise equal;
- the widths past the register and shared-memory instances (LayerNorm
  d = 1025 to 40000, f32 and bf16, every wide instance, N = 1, a
  misaligned base, a bitwise repeat; xent d = 12, 1032, 2048; the decode
  head d = 8192): the tolerances above;
- the xent forward (kernels 10, 11) at its tile and slice edges (N = 1,
  65, 8193; V = 1 to 32769; d = 1 to 4096): the xent tolerances above,
  and a repeat bitwise equal;
- the grouped dW (kernel 16), f32 and bf16 inputs: within 1e-5 of the
  plain output's largest magnitude (both accumulate the same products in
  f32, over up to M rows in another order; a slab cut into chunks sums
  their partials in chunk order), and bitwise equal on a repeat.
The small ResNet (stage_sizes (1, 1), width 8) in f32 with TF32 off for
matmuls and cuDNN: the card's logits, BatchNorm statistics and step-1
gradients within 1e-4 of the CPU run's largest magnitude, the CPU run
replaying the card's ReLU masks (an input that rounds to the other side
of 0 would move a gradient by its share).
The flagship step through ``DataParallel`` on a one-rank NCCL group
equals the single-card step bitwise where that step repeats itself
bitwise (else the flagship's bf16 loss tolerance and AdamW's ±lr a step).
A lab entry run in a process of its own (task1) computes LeNet's f32
convolutions within 1e-5 of f64 (TF32 would miss it about 100 times).
The heterogeneous MPMD pipeline (two stage threads on the card) equals
its single-program reference at rtol 1e-5 / atol 1e-6; the re-mesh drill
with four stage processes on the card is bitwise its uninterrupted
reference.
The serving fleet at a small width: a killed replica's continuations give
the single engine's streams, apart from a near-tie of the plain logits
(top-2 gap under 1e-5), with kernel 1 launched exactly as the admitted
prompts need; an adopted KV handoff (f32 and int8 caches) skips kernel 1
on its pages and serves the local prefill's stream bitwise; the drill's
two replica processes share the card and match their reference's CRCs.
Past the old grid-y edges (8,388,480 rows of kernels 10–12, and kernel 13
with 129 row ranges there; B·H = 65535 of the flash kernels) the
tolerances are those above, the plain versions taken in row or batch
chunks.
"""

import ctypes

import pytest

torch = pytest.importorskip("torch")

from tpudml_torch.nn.attention import dot_product_attention  # noqa: E402
from tpudml_torch.ops import (  # noqa: E402
    ADD_LN_BACKWARD_BF16, ADD_LN_FORWARD_BF16, FLASH_DKDV, FLASH_DKDV_BF16,
    FLASH_DQ, FLASH_DQ_BF16, FLASH_FORWARD_BF16, LN_BACKWARD, LN_BACKWARD_BF16,
    LN_FORWARD, LN_FORWARD_BF16, XENT_DW, XENT_DW_LEAN, XENT_DX, XENT_DX_LEAN,
    XENT_FORWARD, XENT_FORWARD_SAVE, add_layernorm_backward,
    add_layernorm_backward_reference, add_layernorm_forward,
    add_layernorm_forward_reference, flash_attention, flash_block_grads,
    flash_block_grads_reference, flash_forward_lse, flash_forward_lse_reference,
    fused_add_layernorm, fused_decode_head, fused_decode_head_int8, fused_layernorm,
    DECODE_HEAD, DECODE_HEAD_INT8, FLASH_FORWARD, GROUPED_DW, GROUPED_DW_BF16, flash_dkdv, flash_dkdv_reference, flash_dq,
    flash_dq_reference, grouped_dw, grouped_dw_plan, grouped_dw_plan_built,
    grouped_dw_reference, ragged_ffn,
    layernorm_backward, layernorm_backward_reference, layernorm_forward,
    fwd_plan, fwd_plan_built,
    layernorm_forward_reference, lean_plan, lean_plan_built, linear_cross_entropy,
    reference_head, saved_plan, saved_plan_built, xent_dw,
    xent_dw_lean, xent_dw_lean_reference, xent_dw_reference, xent_dx, xent_dx_lean,
    xent_dx_lean_reference, xent_dx_reference, xent_forward, xent_forward_reference,
    xent_forward_save, xent_forward_save_reference,
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


# d = 1100 and 4096: past the 1024 columns a warp holds in registers (the
# kernels' wide instances).
@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(8192, 512), (1000, 512), (37, 96), (300, 1100), (77, 4096)])
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
    q = _randn(1, 8, 1, 264, seed=0, device=cuda_device)  # past the forward's 256
    with pytest.raises(ValueError, match="head dim"):
        flash_forward_lse(q, q, q)
    q = _randn(1, 8, 1, 264, seed=0, device=cuda_device)  # past the backward's 256
    lse = torch.zeros(1, 1, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_block_grads(q, q, q, q, lse, lse)
    x = _randn(4, 2048, seed=0, device=cuda_device)[:, :0]  # no columns
    g = torch.ones(0, device=cuda_device)
    with pytest.raises(ValueError, match="width"):
        add_layernorm_forward(x, x, g, g)
    x = _randn(4, 2048, seed=0, device=cuda_device)
    g = torch.ones(2048, device=cuda_device)
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
@pytest.mark.parametrize("n,d", [(8192, 512), (1000, 512), (37, 96), (300, 1100), (77, 4096)])
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


# d = 12: a ragged edge of the forward's 8-deep contraction stage; 1032 and
# 2048: past one 512-column chunk of the lean kernels (clusters of 3, 4).
_XENT_WIDE = [(300, 12, 700), (256, 1032, 1000), (96, 2048, 500)]
# The saved-scores kernels' cut (saved_plan): one 512-column chunk of d
# (12, 512), 3 and 4 chunks (1025, 2048; s read once per chunk); V % 4 != 0
# (1001: s rows by scalar loads) and V % 8 == 2 (1002: bf16 W rows by scalar
# loads); N just past 65536 and past 131072 (dW's two and three row ranges).
_SAVED_SHAPES = [(1000, 12, 1000), (1000, 512, 1000), (1000, 1025, 1000), (1000, 2048, 1000),
                 (1000, 512, 1001), (1000, 512, 1002), (65_600, 64, 100), (140_000, 64, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d,v", [(1000, 64, 1000), (256, 512, 4096), (37, 8, 130),
                                   *_XENT_WIDE, *_SAVED_SHAPES])
def test_xent_kernels_match_plain(cuda_device, dtype, n, d, v):
    """Kernels 10–13 against their plain versions (12 and 13 on the plain
    forward's scores): labels −1 and V, ragged rows and vocabulary, every
    cut of d of the backward kernels, misaligned vocabulary rows, dW's row
    ranges; each launches once, and a repeat of 12 and 13 is bitwise
    equal."""
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


# The forward's tile and slice edges (fwd_plan): one row, 65 rows and one
# row past 64 row tiles; V = 1, one column short of and past a 128-column
# f32 step (127 and 129: ragged, scalar score stores and W rows), one
# column past 32768 (a last step of one column); d = 1, 12 (under one
# contraction stage), 520 (past the bf16 x row's 16-byte rows: ragged
# stage), 1032, 2048, 4096 (many stages a step).
_FWD_ROWS = [1, 65, 8193]
_FWD_VOCAB = [1, 127, 129, 32769]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 12, 520, 1032, 2048, 4096])
def test_xent_forward_kernels_at_tile_and_slice_edges(cuda_device, dtype, d):
    """Kernels 10 and 11 against their plain versions at every (N, V) of
    _FWD_ROWS × _FWD_VOCAB, labels −1 and V: lse, picked and the saved
    scores at ROW_TOL, an out-of-range label picks nothing, and a second
    call on the same input is bitwise equal. W is drawn at an LM head's
    scale, 1/√d, so that the scores stay O(1) at every d (at the other
    tests' 0.05 and d = 4096 they reach |s| ≈ 13, and two f32 sums of 4096
    terms in different orders differ by more than atol 1e-5 where s is
    near 0, in either dtype)."""
    for n in _FWD_ROWS:
        for v in _FWD_VOCAB:
            x, w, b, y = _xent_inputs(n, d, v, dtype, cuda_device, seed=n + v)
            w = (w.float() * (20 / d ** 0.5)).to(dtype)  # 0.05 · 20 = 1: W ~ N(0, 1/d)
            got = xent_forward(x, w, b, y)
            saved = xent_forward_save(x, w, b, y)
            rlse, rpicked, rs = xent_forward_save_reference(x, w, b, y)
            for lse, picked in (got, saved[:2]):
                torch.testing.assert_close(lse, rlse, **ROW_TOL, msg=f"lse {n} {v}")
                torch.testing.assert_close(picked, rpicked, **ROW_TOL, msg=f"picked {n} {v}")
                assert picked[0].item() == picked[-1].item() == 0.0
            torch.testing.assert_close(saved[2], rs, **ROW_TOL, msg=f"scores {n} {v}")
            for a, c in zip((*got, *saved), (*xent_forward(x, w, b, y),
                                              *xent_forward_save(x, w, b, y))):
                assert torch.equal(a, c), (n, v)


@pytest.mark.cuda
def test_fwd_plan_is_the_kernels_choice(cuda_device):
    """The host's ``fwd_plan`` is the cut the built kernels 10 and 11 make
    (and size their partials with), in both dtypes."""
    for n in (1, 65, 1000, 8192, 8193, 32768, 4096, 8_388_609):
        for v in (1, 127, 129, 1000, 8192, 32768, 32769, 1_000_000):
            for dtype in (torch.float32, torch.bfloat16):
                assert fwd_plan_built(n, 512, v, dtype) == fwd_plan(n, 512, v, dtype), (n, v)


@pytest.mark.cuda
def test_saved_plan_is_the_kernels_choice(cuda_device):
    """The host's ``saved_plan`` is the cut the built kernels 12 and 13
    make, in both dtypes."""
    for n, d, v in [(1, 1, 1), (1000, 12, 1000), (8192, 512, 32768), (32768, 513, 100),
                    (65_537, 2048, 8192), (8_388_609, 8, 128), (4096, 40000, 7)]:
        for dtype in (torch.float32, torch.bfloat16):
            assert saved_plan_built(n, d, v, dtype) == saved_plan(n, d, v, dtype), (n, d, v)


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
    """A width that is no multiple of 8 runs (the ragged edge is masked in
    the kernel); a dtype the kernels do not take raises."""
    x, w, b, y = _xent_inputs(16, 12, 64, torch.float32, cuda_device)  # d % 8 != 0
    for got, want in zip(xent_forward(x, w, b, y), xent_forward_reference(x, w, b, y)):
        torch.testing.assert_close(got, want, **ROW_TOL)
    x, w, b, y = _xent_inputs(16, 16, 64, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        xent_forward(x.double(), w.double(), b.double(), y)
    with pytest.raises(TypeError):
        xent_forward(x, w.bfloat16(), b, y)
    with pytest.raises(TypeError):
        xent_forward(x, w, b, y.long())


# The lean kernels' cut of d (lean_plan): one 512-column chunk (12, 512),
# clusters of 2, 3 and 4 blocks (1024, 1025, 2048), two score passes past
# 4096 (4100); V % 4 != 0 (1001: W rows copied by scalar loads; d = 1025
# does the same for x rows); N just past 65536 (dW's two row ranges).
_LEAN_WIDTHS = [(1000, 12, 1000), (1000, 512, 1000), (1000, 1024, 1000), (1000, 1025, 1000),
                (1000, 2048, 1000), (64, 4100, 300), (1000, 512, 1001), (65_600, 64, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d,v", [(1000, 64, 1000), (256, 512, 4096), (37, 8, 130),
                                   (70, 264, 300), (50, 1024, 200), (2_097_184, 8, 40),
                                   (140_000, 64, 100), *_XENT_WIDE, *_LEAN_WIDTHS])
def test_xent_lean_kernels_match_plain(cuda_device, dtype, n, d, v):
    """Kernels 14 and 15 against their plain versions: ragged rows and
    vocab, labels −1 and V, every kind of cut of d (_LEAN_WIDTHS), 65537
    row tiles of dX (more than a grid's y extent of 65535 holds), and dW's
    row ranges of 65536 (2, 3 and 33 of them); a repeat is bitwise equal."""
    x, w, b, y = _xent_inputs(n, d, v, dtype, cuda_device, seed=5)
    lse, _ = xent_forward_reference(x, w, b, y)
    before = (XENT_DX_LEAN.launches, XENT_DW_LEAN.launches)
    dx = xent_dx_lean(x, w, b, y, lse, 1.0 / n)
    dw, db = xent_dw_lean(x, w, b, y, lse, 1.0 / n)
    torch.cuda.synchronize()
    assert (XENT_DX_LEAN.launches, XENT_DW_LEAN.launches) == (before[0] + 1, before[1] + 1)
    assert dx.dtype == dw.dtype == dtype and db.dtype == torch.float32
    rel = XENT_GRAD_REL[dtype]
    _close_to_max(dx, xent_dx_lean_reference(x, w, b, y, lse, 1.0 / n), rel)
    rdw, rdb = xent_dw_lean_reference(x, w, b, y, lse, 1.0 / n)
    _close_to_max(dw, rdw, rel)
    _close_to_max(db, rdb, XENT_GRAD_REL[torch.float32])
    again = (xent_dx_lean(x, w, b, y, lse, 1.0 / n), *xent_dw_lean(x, w, b, y, lse, 1.0 / n))
    assert all(torch.equal(a, c) for a, c in zip((dx, dw, db), again))


@pytest.mark.cuda
def test_lean_plan_is_the_kernels_choice(cuda_device):
    """The host's ``lean_plan`` is the cut of d the built kernels make."""
    for d in (1, 12, 512, 513, 1024, 1025, 2048, 4096, 4097, 8192, 40000):
        assert lean_plan_built(d) == lean_plan(d), d


@pytest.mark.cuda
def test_linear_cross_entropy_lean_autograd_on_card(cuda_device):
    """The lean grad path runs kernels 10, 14 and 15 (not 11–13) and
    matches the CPU plain path."""
    x, w, b, y = _xent_inputs(500, 64, 700, torch.float32, cuda_device, seed=6)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    kernels = (XENT_FORWARD, XENT_FORWARD_SAVE, XENT_DX, XENT_DW, XENT_DX_LEAN, XENT_DW_LEAN)
    before = [k.launches for k in kernels]
    loss = linear_cross_entropy(*leaves[:2], y, leaves[2], save_s=False)
    loss.backward()
    assert [k.launches - c for k, c in zip(kernels, before)] == [1, 0, 0, 0, 1, 1]
    cpu = [t.detach().cpu().clone().requires_grad_() for t in (x, w, b)]
    want = linear_cross_entropy(*cpu[:2], y.cpu(), cpu[2], save_s=False)
    want.backward()
    torch.testing.assert_close(loss.cpu(), want, **ROW_TOL)
    for a, c in zip(leaves, cpu):
        _close_to_max(a.grad.cpu(), c.grad, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d", [(8192, 512), (1000, 512), (37, 96), (300, 1100), (77, 4096)])
def test_layernorm_kernels_match_plain(cuda_device, dtype, n, d):
    x, dy = (_randn(n, d, seed=i, device=cuda_device).to(dtype) for i in (10, 11))
    scale = 1.0 + 0.1 * _randn(d, seed=12, device=cuda_device)
    bias = 0.1 * _randn(d, seed=13, device=cuda_device)
    fwd, bwd = ((LN_FORWARD, LN_BACKWARD) if dtype == torch.float32
                else (LN_FORWARD_BF16, LN_BACKWARD_BF16))
    before = (fwd.launches, bwd.launches)
    y, mean, rstd = layernorm_forward(x, scale, bias)
    ry, rmean, rrstd = layernorm_forward_reference(x, scale, bias)
    dx, dg, db = layernorm_backward(x, scale, dy, rmean, rrstd)
    rdx, rdg, rdb = layernorm_backward_reference(x, scale, dy, rmean, rrstd)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    assert y.dtype == dx.dtype == dtype and dg.dtype == torch.float32
    torch.testing.assert_close(mean, rmean, **ROW_TOL)
    torch.testing.assert_close(rstd, rrstd, **ROW_TOL)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ry, **ROW_TOL)
        torch.testing.assert_close(dx, rdx, **ROW_TOL)
    else:
        _close_to_max(y, ry, BF16_REL)
        _close_to_max(dx, rdx, BF16_REL)
    torch.testing.assert_close(dg, rdg, **COL_TOL)
    torch.testing.assert_close(db, rdb, **COL_TOL)
    again = layernorm_backward(x, scale, dy, rmean, rrstd)
    assert all(torch.equal(a, c) for a, c in zip((dx, dg, db), again))


# Past the narrow instances: the register instances (vector, and scalar for
# a ragged width or a base 4 or 2 bytes off 16), N = 1 and N below the
# backward's block count, and the looped ones (d = 12000 staged, 20000
# shared, 40000 device for the backward).
WIDE_LN_CASES = [(1, 1025, 0), (100, 2048, 0), (300, 1025, 0), (300, 1100, 0),
                 (300, 2048, 0), (300, 4100, 0), (300, 8192, 0), (300, 4096, 1),
                 (40, 12000, 0), (20, 20000, 0), (10, 40000, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d,offset", WIDE_LN_CASES,
                         ids=[f"N{n}-d{d}" + (f"-base+{o}" if o else "")
                              for n, d, o in WIDE_LN_CASES])
def test_wide_layernorm_kernels_match_plain(cuda_device, dtype, n, d, offset):
    """Kernels 6–9 at widths past 1024, f32 and bf16 rows, with and without
    ds, against their plain versions; each backward bitwise equal on a
    repeat (no atomics, a fixed block count for the shape)."""
    def rows(seed):
        buf = _randn(n * d + offset, seed=seed, device=cuda_device).to(dtype)
        return buf[offset:].view(n, d)

    x, r, dy, ds = (rows(i) for i in range(4))
    scale = 1.0 + 0.1 * _randn(d, seed=7, device=cuda_device)
    bias = 0.1 * _randn(d, seed=8, device=cuda_device)

    def close(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **ROW_TOL)
        else:
            _close_to_max(got, want, BF16_REL)

    s, y, mean, rstd = add_layernorm_forward(x, r, scale, bias)
    rs, ry, rmean, rrstd = add_layernorm_forward_reference(x, r, scale, bias)
    assert torch.equal(s, rs)  # one rounding of the same f32 sum
    close(y, ry)
    torch.testing.assert_close(mean, rmean, **ROW_TOL)
    torch.testing.assert_close(rstd, rrstd, **ROW_TOL)
    for dsv in (ds, None):
        got = add_layernorm_backward(rs, scale, dy, dsv, rmean, rrstd)
        rdx, rdg, rdb = add_layernorm_backward_reference(rs, scale, dy, dsv, rmean, rrstd)
        close(got[0], rdx)
        torch.testing.assert_close(got[1], rdg, **COL_TOL)
        torch.testing.assert_close(got[2], rdb, **COL_TOL)
        again = add_layernorm_backward(rs, scale, dy, dsv, rmean, rrstd)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    ly, lmean, lrstd = layernorm_forward(x, scale, bias)
    rly, _, _ = layernorm_forward_reference(x, scale, bias)
    close(ly, rly)
    got = layernorm_backward(x, scale, dy, lmean, lrstd)
    rlx, rlg, rlb = layernorm_backward_reference(x, scale, dy, lmean, lrstd)
    close(got[0], rlx)
    torch.testing.assert_close(got[1], rlg, **COL_TOL)
    torch.testing.assert_close(got[2], rlb, **COL_TOL)
    again = layernorm_backward(x, scale, dy, lmean, lrstd)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_layernorm_plan_is_the_kernels_choice(cuda_device):
    """The wrapper's launch plan names the instance and block that the
    kernels' own dispatch picks, for every width class, dtype and
    alignment."""
    from tpudml_torch.ops import layernorm_kernel as lk

    lib = lk._LIB.load()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for backward in (False, True):
        for d in (1025, 1536, 4096, 4100, 8192, 8200, 12000, 16384, 16400, 20000, 28928,
                  28929, 40000, 57856, 57857, 120000):
            for itemsize in (2, 4):
                for aligned in (False, True):
                    threads = ctypes.c_int(0)
                    kind = lib.add_ln_wide_plan(int(backward), d, itemsize,
                                                int(aligned and d % (16 // itemsize) == 0),
                                                ctypes.byref(threads))
                    plan = lk.layernorm_plan(1000, d, itemsize, aligned, sms, backward)
                    assert (lk._WIDE_KINDS[kind], threads.value) == (
                        plan.instance, plan.threads), (backward, d, itemsize, aligned)


@pytest.mark.cuda
def test_fused_layernorm_autograd_on_card(cuda_device):
    x, w1 = (_randn(4, 33, 64, seed=i, device=cuda_device) for i in (14, 15))
    scale = 1.0 + 0.1 * _randn(64, seed=16, device=cuda_device)
    bias = 0.1 * _randn(64, seed=17, device=cuda_device)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    (fused_layernorm(*leaves) * w1).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
    (torch.nn.functional.layer_norm(ref[0], (64,), ref[1], ref[2], 1e-5) * w1).sum().backward()
    for a, c in zip(leaves, ref):
        torch.testing.assert_close(a.grad, c.grad, **COL_TOL)


@pytest.mark.cuda
def test_xent_kernels_10_to_12_past_the_grid_y_edge(cuda_device):
    """Kernels 10, 11 and 12 at N = 8,388,609 rows (65,537 row tiles of 128,
    past the 8,388,480 that grid y held), and kernel 13 there (129 row
    ranges of dW): against their plain versions in row chunks, the plain
    dW and db summed over the chunks (d = 8, V = 128 keep x at 268 MB and
    the scores at 4.3 GB)."""
    n, d, v = 8_388_609, 8, 128
    x, w, b, y = _xent_inputs(n, d, v, torch.float32, cuda_device, seed=21)
    lse0, picked0 = xent_forward(x, w, b, y)
    lse, picked, s = xent_forward_save(x, w, b, y)
    dx = xent_dx(s, w, y, lse, 1.0 / n)
    dw, db = xent_dw(s, x, y, lse, 1.0 / n)
    torch.cuda.synchronize()
    rdw = torch.zeros_like(dw)
    rdb = torch.zeros_like(db)
    step = 1 << 21
    for r in (slice(i, i + step) for i in range(0, n, step)):
        rlse, rpicked, rs = xent_forward_save_reference(x[r], w, b, y[r])
        for got in (lse0[r], lse[r]):
            torch.testing.assert_close(got, rlse, **ROW_TOL)
        for got in (picked0[r], picked[r]):
            torch.testing.assert_close(got, rpicked, **ROW_TOL)
        torch.testing.assert_close(s[r], rs, **ROW_TOL)
        _close_to_max(dx[r], xent_dx_reference(rs, w, y[r], rlse, 1.0 / n), 1e-4)
        pw, pb = xent_dw_reference(rs, x[r], y[r], rlse, 1.0 / n)
        rdw += pw
        rdb += pb
    _close_to_max(dw, rdw, 1e-4)
    _close_to_max(db, rdb, 1e-4)


@pytest.mark.cuda
def test_flash_kernels_past_the_grid_y_edge(cuda_device):
    """The flash forward, dQ and dK/dV at B·H = 65,537 (past the 65,535
    that grid y held): B = 65,537, H = 1, T = 16, D = 32, causal, against
    their plain versions."""
    b, t, h, d = 65_537, 16, 1, 32
    q, k, v, do = (_randn(b, t, h, d, seed=30 + i, device=cuda_device) for i in range(4))
    o, lse = flash_forward_lse(q, k, v, causal=True)
    ro, rlse = flash_forward_lse_reference(q, k, v, causal=True)
    torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    delta = (do * ro).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta)
    torch.testing.assert_close(flash_dq(*args, causal=True),
                               flash_dq_reference(*args, causal=True), **GRAD_TOL)
    for got, want in zip(flash_dkdv(*args, causal=True),
                         flash_dkdv_reference(*args, causal=True)):
        torch.testing.assert_close(got, want, **GRAD_TOL)


@pytest.mark.cuda
def test_xent_lean_dw_at_two_million_rows_d1024(cuda_device):
    """Kernel 15 at N = 2,097,184, d = 1024, V = 256 (33 row ranges, N·d >
    2³¹): dW and db within 1e-4 of max of the plain version summed over row
    chunks."""
    n, d, v = 2_097_184, 1024, 256
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((n, d), generator=gen, device=cuda_device)
    w = (torch.rand((d, v), generator=gen, device=cuda_device) * 2 - 1) / d ** 0.5
    b = (torch.rand((v,), generator=gen, device=cuda_device) * 2 - 1) / d ** 0.5
    y = torch.randint(0, v, (n,), generator=gen, dtype=torch.int32, device=cuda_device)
    step = 262_144
    rows = [slice(i, i + step) for i in range(0, n, step)]
    lse = torch.cat([xent_forward_reference(x[r], w, b, y[r])[0] for r in rows])
    dw, db = xent_dw_lean(x, w, b, y, lse, 1.0 / n)
    rdw = torch.zeros_like(dw)
    rdb = torch.zeros_like(db)
    for r in rows:
        pw, pb = xent_dw_lean_reference(x[r], w, b, y[r], lse[r], 1.0 / n)
        rdw += pw
        rdb += pb
    _close_to_max(dw, rdw, 1e-4)
    _close_to_max(db, rdb, 1e-4)


GROUP_SETS = {  # sizes of 8 groups over M = 300 rows (the rest: tail rows)
    "uneven": [3, 41, 2, 77, 29, 5, 52, 15],
    "empty": [60, 0, 30, 0, 84, 0, 60, 0],
    "collapsed": [280, 0, 0, 0, 0, 0, 0, 0],
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("groups", sorted(GROUP_SETS))
@pytest.mark.parametrize("k,n", [(64, 96), (130, 257), (1, 12), (12, 130)])
def test_grouped_dw_kernel_matches_plain(cuda_device, dtype, groups, k, n):
    """Kernel 16 against its plain version: uneven, empty and collapsed
    groups, tail rows past Σ group_sizes, tile edges in k and n (k or n no
    multiple of 8: the instance without 16-byte copies); bitwise equal on a
    repeat; the twin of x's dtype launches once."""
    m = 300
    x = _randn(m, k, seed=40, device=cuda_device).to(dtype)
    g = _randn(m, n, seed=41, device=cuda_device).to(dtype)
    gs = torch.tensor(GROUP_SETS[groups], dtype=torch.int32, device=cuda_device)
    kernel = GROUPED_DW if dtype == torch.float32 else GROUPED_DW_BF16
    before = kernel.launches
    dw = grouped_dw(x, g, gs)
    again = grouped_dw(x, g, gs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert dw.dtype == torch.float32 and dw.shape == (8, k, n)
    assert torch.equal(dw, again)
    want = grouped_dw_reference(x, g, gs)
    _close_to_max(dw, want, 1e-5)
    for e, size in enumerate(GROUP_SETS[groups]):
        if size == 0:
            assert not dw[e].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_dw_kernel_at_the_moe_step_shape(cuda_device, dtype):
    """M = 8192 rows, k = 512, n = 2048, E = 8 with int64 sizes that skew
    toward one expert and leave 100 tail rows."""
    m, k, n = 8192, 512, 2048
    x = _randn(m, k, seed=42, device=cuda_device).to(dtype)
    g = _randn(m, n, seed=43, device=cuda_device).to(dtype)
    gs = torch.tensor([4000, 1500, 0, 900, 700, 500, 392, 400], device=cuda_device)
    dw = grouped_dw(x, g, gs)
    _close_to_max(dw, grouped_dw_reference(x, g, gs), 1e-5)
    assert torch.equal(dw, grouped_dw(x, g, gs))


def _sizes_e64():
    sizes = [0] * 64
    sizes[3], sizes[17], sizes[40], sizes[63] = 1000, 700, 1200, 50
    return sizes


# (M, k, n, group sizes, sizes dtype) of the row split's cases: a slab of
# several chunks (R = 256 there: 4000 rows in 16 chunks of 250, edges
# mid-slab) beside short ones; the same without 16-byte copies; chunks
# longer than 1024 rows (R = 1216: 19000 rows in 16 chunks of 1187); R at
# the bf16 cap (M = 65536: 2048 rows, 60000 in 30 chunks; f32's R 8000);
# M = 0; E = 64, mostly empty; sizes summing past M (clamped); int64
# sizes; negative sizes, whose slabs overlap (R doubles until the list
# fits).
SPLIT_CASES = {
    "multi_chunk": (5000, 64, 96, [4000, 3, 0, 900], torch.int32),
    "multi_chunk_ragged": (3000, 130, 257, [2900, 50], torch.int32),
    "long_chunks": (20000, 512, 1024, [19000, 1000], torch.int32),
    "capped_rows": (65536, 512, 2048, [0, 60000, 0, 0], torch.int32),
    "m0": (0, 64, 96, [0, 0, 0], torch.int32),
    "e64_mostly_empty": (3000, 64, 96, _sizes_e64(), torch.int32),
    "past_m": (2000, 64, 96, [1500, 800, 400], torch.int32),
    "int64": (2500, 64, 96, [1300, 0, 1100], torch.int64),
    "negative": (2000, 64, 96, [2000, -2000, 2000], torch.int32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_grouped_dw_row_split(cuda_device, dtype, case):
    """Kernel 16's row split: slabs cut into chunks whose partials the last
    block to arrive sums in chunk order. Against the plain version within
    1e-5 of max, zeros for empty groups, bitwise equal on a repeat."""
    m, k, n, sizes, size_dtype = SPLIT_CASES[case]
    x = _randn(m, k, seed=46, device=cuda_device).to(dtype)
    g = _randn(m, n, seed=47, device=cuda_device).to(dtype)
    gs = torch.tensor(sizes, dtype=size_dtype, device=cuda_device)
    kernel = GROUPED_DW if dtype == torch.float32 else GROUPED_DW_BF16
    before = kernel.launches
    dw = grouped_dw(x, g, gs)
    again = grouped_dw(x, g, gs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(dw, again)
    want = grouped_dw_reference(x, g, gs)
    if want.abs().max() > 0:
        _close_to_max(dw, want, 1e-5)
    for e in range(len(sizes)):
        if not want[e].any():
            assert not dw[e].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_dw_collapsed_slab_at_the_moe_step_shape(cuda_device, dtype):
    """Every routed row in one expert: 8000 rows at k = 512, n = 2048, E = 8
    (the chunks of one slab summed in order, the tensor cores' sums folded
    once a stage in bf16), within 1e-5 of max; bitwise equal on a repeat."""
    m, k, n = 8192, 512, 2048
    x = _randn(m, k, seed=48, device=cuda_device).to(dtype)
    g = _randn(m, n, seed=49, device=cuda_device).to(dtype)
    gs = torch.tensor([0, 0, 0, 8000, 0, 0, 0, 0], dtype=torch.int32, device=cuda_device)
    dw = grouped_dw(x, g, gs)
    _close_to_max(dw, grouped_dw_reference(x, g, gs), 1e-5)
    assert torch.equal(dw, grouped_dw(x, g, gs))


@pytest.mark.cuda
def test_grouped_dw_plan_is_the_kernels_choice(cuda_device):
    """``grouped_dw_plan`` (which the CPU tests check) is the cut the built
    kernel makes, at the MoE step's shapes and the card tests' cases."""
    shapes = [(8192, 512, 2048, 8), (8192, 2048, 512, 4), (300, 64, 96, 8),
              (65536, 4096, 4096, 8)]
    shapes += [(m, k, n, len(sizes)) for m, k, n, sizes, _ in SPLIT_CASES.values()]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            assert grouped_dw_plan_built(*shape, dtype) == grouped_dw_plan(*shape, dtype), shape


@pytest.mark.cuda
def test_grouped_dw_rejects_what_it_does_not_take(cuda_device):
    x = _randn(16, 8, seed=44, device=cuda_device)
    g = _randn(16, 4, seed=45, device=cuda_device)
    gs = torch.tensor([8, 8], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="row-aligned"):
        grouped_dw(x, g[:15], gs)
    with pytest.raises(ValueError, match="integer"):
        grouped_dw(x, g, gs.float())
    with pytest.raises(TypeError):
        grouped_dw(x, g.bfloat16(), gs)
    with pytest.raises(TypeError):
        grouped_dw(x.double(), g.double(), gs)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_dw(x.t().contiguous().t(), g, gs)
    with pytest.raises(ValueError, match="one device"):
        grouped_dw(x, g, gs.cpu())


@pytest.mark.cuda
def test_ragged_ffn_autograd_on_card(cuda_device):
    """ragged_ffn's backward launches kernel 16 twice (dW1, dW2) and
    matches the CPU plain path."""
    p, d, h, e = 200, 32, 64, 4
    gs = torch.tensor([70, 0, 90, 40], dtype=torch.int32)
    eids = torch.repeat_interleave(torch.arange(e), gs)
    onehot = torch.nn.functional.one_hot(eids, e).float()
    leaves = [_randn(*s, seed=50 + i, device="cpu") for i, s in
              enumerate(((p, d), (e, d, h), (e, h), (e, h, d), (e, d)))]
    dout = _randn(p, d, seed=56, device="cpu")
    grads = {}
    for dev in ("cpu", cuda_device):
        ins = [t.to(dev).requires_grad_() for t in leaves]
        before = GROUPED_DW.launches
        out = ragged_ffn(*ins, onehot.to(dev), gs.to(dev))
        grads[str(dev)] = (out, *torch.autograd.grad(out, ins, dout.to(dev)))
        if dev != "cpu":
            assert GROUPED_DW.launches == before + 2
    for a, c in zip(grads["cpu"], grads[str(cuda_device)]):
        _close_to_max(c.cpu(), a, 1e-5)


# Head dims inside and between the kernels' compiled widths (32, 64, 128,
# 256 forward; 32, 64, 128 dK/dV): the next larger instance runs with the
# columns past D zero. Cases: causal with T not a multiple of the 64-row
# tile, non-causal at odd T, k_shift = 1 (row 0 sees no key), and q, k, v
# (and dO) sliced one element into a wider buffer, which no 16-byte copy
# can stage (the kernels' scalar loads).
_FLASH_SHAPES = [(2, 200, 3, True, 0, False), (1, 77, 2, False, 0, False),
                 (1, 130, 2, True, 1, False), (2, 100, 2, True, 0, True)]


def _flash_operands(b, t, h, d, n, dtype, sliced, device, seed=0):
    xs = []
    for i in range(n):
        x = _randn(b, t, h, d + 1, seed=seed + i, device=device).to(dtype)
        xs.append(x[..., 1:] if sliced else x[..., :d].contiguous())
    return xs


def _check_stored(got, want, dtype, tol):
    if dtype == torch.bfloat16:
        assert got.dtype == torch.bfloat16
        _close_to_max(got, want, BF16_REL)
    else:
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 48, 64, 80, 128, 256])
def test_flash_forward_any_head_dim(cuda_device, dtype, d):
    kernel = FLASH_FORWARD if dtype == torch.float32 else FLASH_FORWARD_BF16
    for b, t, h, causal, k_shift, sliced in _FLASH_SHAPES:
        q, k, v = _flash_operands(b, t, h, d, 3, dtype, sliced, cuda_device)
        before = kernel.launches
        o, lse = flash_forward_lse(q, k, v, causal=causal, k_shift=k_shift)
        o2, lse2 = flash_forward_lse(q, k, v, causal=causal, k_shift=k_shift)
        ro, rlse = flash_forward_lse_reference(q, k, v, causal=causal, k_shift=k_shift)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        _check_stored(o, ro, dtype, ROW_TOL)
        torch.testing.assert_close(lse, rlse, **ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 48, 64, 80, 128, 200, 256])
def test_flash_backward_any_head_dim(cuda_device, dtype, d):
    """dK/dV (kernel 3) and dQ (kernel 2), each launched twice: bitwise
    equal, and against its plain version."""
    kernel = FLASH_DKDV if dtype == torch.float32 else FLASH_DKDV_BF16
    dq_kernel = FLASH_DQ if dtype == torch.float32 else FLASH_DQ_BF16
    for b, t, h, causal, k_shift, sliced in _FLASH_SHAPES:
        q, k, v, do = _flash_operands(b, t, h, d, 4, dtype, sliced, cuda_device, seed=4)
        o, lse = flash_forward_lse_reference(q, k, v, causal=causal)  # finite lse
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        before = kernel.launches, dq_kernel.launches
        dk, dv = flash_dkdv(*args, causal=causal, k_shift=k_shift)
        dk2, dv2 = flash_dkdv(*args, causal=causal, k_shift=k_shift)
        rdk, rdv = flash_dkdv_reference(*args, causal=causal, k_shift=k_shift)
        dq = flash_dq(*args, causal=causal, k_shift=k_shift)
        dq2 = flash_dq(*args, causal=causal, k_shift=k_shift)
        rdq = flash_dq_reference(*args, causal=causal, k_shift=k_shift)
        torch.cuda.synchronize()
        assert (kernel.launches, dq_kernel.launches) == (before[0] + 2, before[1] + 2)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2) and torch.equal(dq, dq2)
        for got, want in ((dk, rdk), (dv, rdv), (dq, rdq)):
            assert got.shape == want.shape
            _check_stored(got, want, dtype, GRAD_TOL)


@pytest.mark.cuda
def test_flash_backward_past_its_head_dims_names_the_roadmap(cuda_device):
    """D = 256 runs in both directions, through flash_block_grads and the
    autograd Function; D = 257 is refused in both, naming the domain."""
    q = _randn(1, 8, 1, 256, seed=0, device=cuda_device)
    _, lse = flash_forward_lse(q, q, q, causal=True)
    for got, want in zip(flash_block_grads(q, q, q, q, lse, lse),
                         flash_block_grads_reference(q, q, q, q, lse, lse)):
        torch.testing.assert_close(got, want, **GRAD_TOL)
    leaf = q.clone().requires_grad_()
    flash_attention(leaf, leaf, leaf, causal=True).sum().backward()
    ref = q.clone().requires_grad_()
    dot_product_attention(ref, ref, ref, causal=True).sum().backward()
    torch.testing.assert_close(leaf.grad, ref.grad, **GRAD_TOL)
    q = _randn(1, 8, 1, 257, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="1 to 256"):
        flash_block_grads(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="1 to 256"):
        flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match="1 to 256"):
        flash_forward_lse(q, q, q, causal=True)


@pytest.mark.cuda
def test_decode_head_walks_a_wide_row_in_chunks(cuda_device):
    """d = 8192, past the 6400 columns one 8-row group fits in the x stage:
    one launch of the chunked instance for 20 rows (three groups), f32 and
    int8 weights, each row as the plain version gives it."""
    x = _randn(20, 8192, seed=15, device=cuda_device)
    w = 0.05 * _randn(8192, 1000, seed=16, device=cuda_device)
    b = _randn(1000, seed=17, device=cuda_device)
    before = DECODE_HEAD.launches
    tok, mx, lse = fused_decode_head(x, w, b)
    rt, rm, rl = reference_head(x, w, b)
    torch.cuda.synchronize()
    assert DECODE_HEAD.launches == before + 1
    assert torch.equal(tok, rt)
    torch.testing.assert_close(mx, rm, **ROW_TOL)
    torch.testing.assert_close(lse, rl, **ROW_TOL)
    wq, scale = tquant._quant_kernel(w)
    tok8, mx8, lse8 = fused_decode_head_int8(x, wq, scale, b)
    rt8, rm8, rl8 = reference_head(x, tquant._dequant_kernel(wq, scale), b)
    assert torch.equal(tok8, rt8)
    torch.testing.assert_close(mx8, rm8, **ROW_TOL)
    torch.testing.assert_close(lse8, rl8, **ROW_TOL)


@pytest.mark.cuda
def test_decode_head_splits_a_batch_past_its_stage(cuda_device):
    """200 slots at d = 512: one launch, the kernel walking 25 8-row groups,
    each row as the plain version gives it."""
    x = _randn(200, 512, seed=12, device=cuda_device)
    w = _randn(512, 1000, seed=13, device=cuda_device)
    b = _randn(1000, seed=14, device=cuda_device)
    before = DECODE_HEAD.launches
    tok, mx, lse = fused_decode_head(x, w, b)
    rt, rm, rl = reference_head(x, w, b)
    torch.cuda.synchronize()
    assert DECODE_HEAD.launches == before + 1
    assert torch.equal(tok, rt)
    torch.testing.assert_close(mx, rm, **ROW_TOL)
    torch.testing.assert_close(lse, rl, **ROW_TOL)


TIE_GAP = 1e-5  # plain top-2 logit gap under which the kernel's pick may differ


def _head_case(b, d, v, seed, device):
    x = _randn(b, d, seed=seed, device=device)
    w = _randn(d, v, seed=seed + 1, device=device) / d ** 0.5
    bias = 0.1 * _randn(v, seed=seed + 2, device=device)
    return x, w, bias


def _check_head(got, x, wf, bias):
    """Tokens equal to the plain version's but at a plain top-2 gap under
    TIE_GAP; max and lse at ROW_TOL."""
    tok, mx, lse = got
    rt, rm, rl = reference_head(x, wf, bias)
    logits = x @ wf + bias
    gap = (torch.topk(logits, 2, dim=-1).values if wf.shape[1] > 1
           else torch.full((x.shape[0], 2), float("inf"), device=x.device))
    differ = tok != rt
    assert bool(((gap[:, 0] - gap[:, 1]) < TIE_GAP)[differ].all()), (tok[differ], rt[differ])
    torch.testing.assert_close(mx, rm, **ROW_TOL)
    torch.testing.assert_close(lse, rl, **ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,v", [(b, 512, v) for b in (1, 8, 9, 200)
                                   for v in (1, 3, 1000, 1001, 32768 + 5)]
                         + [(9, d, v) for d in (1, 3, 6401, 8192) for v in (1001, 32768 + 5)])
def test_decode_head_edges(cuda_device, b, d, v):
    """Kernels 4 and 5 at the edges of their plan: V = 1 and 3 (under one
    tile), 1000 (int8's unaligned instance; f32 aligned), 1001 and 32773
    (both unaligned, a ragged last tile), B = 1 to 200 (25 row groups in
    one launch), d = 1 and 3 (warps with no rows), 6401 and 8192 (x staged
    in chunks). One launch a call, and a second call bitwise equal."""
    x, w, bias = _head_case(b, d, v, seed=b + d + v, device=cuda_device)
    wq, scale = tquant._quant_kernel(w)
    for kernel, fn, weights, wf in (
        (DECODE_HEAD, fused_decode_head, (w,), w),
        (DECODE_HEAD_INT8, fused_decode_head_int8, (wq, scale),
         tquant._dequant_kernel(wq, scale)),
    ):
        before = kernel.launches
        got = fn(x, *weights, bias)
        again = fn(x, *weights, bias)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        _check_head(got, x, wf, bias)
        for a, b_ in zip(got, again):
            assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", ["one_thread", "one_tile", "across_tiles", "flat"])
def test_decode_head_ties_pick_first_occurrence(cuda_device, case, int8):
    """Exact ties at d = 512 (every column's sum split over the block's
    warps): two columns of one thread's 16-byte load (1 and 2 in f32, 3 and
    12 in int8), two of one tile held by different lanes (5, 100), of
    different tiles (7, 300, 32770), and a flat row. The tied columns are
    copies of one column, lifted by +20 in the bias over every other logit
    of each row; equal columns give equal sums in the kernel (same products,
    same order), so the first occurrence wins in every row, as
    ``torch.argmax`` decides."""
    b, d, v = 9, 512, 32773
    x, w, bias = _head_case(b, d, v, seed=40, device=cuda_device)
    cols = {"one_thread": (12, 3) if int8 else (2, 1), "one_tile": (100, 5),
            "across_tiles": (32770, 300, 7), "flat": ()}[case]
    if case == "flat":
        w.zero_()
        bias.fill_(0.25)
    else:
        w[:, list(cols)] = w[:, cols[0]][:, None]
        bias[list(cols)] = bias[cols[0]] + 20.0
    wq, scale = tquant._quant_kernel(w)
    fn, weights = ((fused_decode_head_int8, (wq, scale)) if int8
                   else (fused_decode_head, (w,)))
    tok, mx, lse = fn(x, *weights, bias)
    wf = tquant._dequant_kernel(wq, scale) if int8 else w
    _, rm, rl = reference_head(x, wf, bias)
    assert tok.tolist() == [min(cols) if cols else 0] * b
    torch.testing.assert_close(mx, rm, **ROW_TOL)
    torch.testing.assert_close(lse, rl, **ROW_TOL)


@pytest.mark.cuda
def test_head_plan_is_the_kernels_choice(cuda_device):
    """``head_plan`` (the wrapper's buffer size) against the built kernel's
    ``decode_head_plan`` at every shape the edge tests take."""
    from tpudml_torch.ops import head_plan, head_plan_built

    for b in (1, 8, 9, 200):
        for d in (1, 3, 512, 6401, 8192):
            for v in (1, 3, 1000, 1001, 32768, 32773):
                for int8 in (False, True):
                    assert head_plan_built(b, d, v, int8) == head_plan(b, d, v, int8)


@pytest.mark.cuda
def test_dp_world1_nccl_step_equals_the_single_card_step(cuda_device, tmp_path):
    """The flagship step (bench.py's config: V=32768, d=512, H=4, L=6,
    T=1024, B=8, bf16 over f32 masters, the fused head with saved scores,
    flash attention, fused add+LN) through ``DataParallel`` on a one-rank
    NCCL group, against the single-card step from the same weights:
    bitwise equal where the single-card step repeats itself bitwise (at
    world 1 the mean over one rank is exact), else within 4 times the gap
    between two single-card runs, in losses and in parameters."""
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.optim import AdamW
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.train import TrainState, make_lm_fused_train_step

    cfg = dict(vocab_size=32768, embed_dim=512, num_heads=4, num_layers=6, max_len=1024,
               rope=True, fused_ln=True, compute_dtype=torch.bfloat16, device=cuda_device)
    batch = synthetic_lm(8, 1024, 32768, seed=1)
    steps, lr = 2, 3e-4

    def model(impl):
        return TransformerLM(**cfg, impl=impl, generator=torch.Generator().manual_seed(3))

    def run(m, step, ts):
        losses = [step(ts, batch[:, :-1], batch[:, 1:])[1]["loss"].item() for _ in range(steps)]
        return losses, {n: p.detach().clone() for n, p in m.named_parameters()}

    singles = []
    for _ in range(2):
        m = model("flash")
        opt = AdamW(lr=lr)
        singles.append(run(m, make_lm_fused_train_step(m, opt, save_scores=True),
                           TrainState.create(m, opt)))
        del m
    (want, want_p), (again, again_p) = singles
    repeats = want == again and all(torch.equal(want_p[n], again_p[n]) for n in want_p)
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cuda"):
        assert torch.distributed.get_backend() == "nccl"
        m = model("full")
        dp = DataParallel(m, AdamW(lr=lr), fused_xent=True, save_scores=True, flash_attn=True)
        got, got_p = run(m, dp.make_train_step(), dp.create_state())
    if repeats:
        assert got == want
        for n in want_p:
            assert torch.equal(got_p[n], want_p[n]), n
    else:
        def gaps(losses, params):
            return (max(abs(a - b) for a, b in zip(losses, want)),
                    max((params[n] - want_p[n]).abs().max().item() for n in params))

        (ldiff, worst), (lgap, pgap) = gaps(got, got_p), gaps(again, again_p)
        assert ldiff <= 4 * lgap and worst <= 4 * pgap, (ldiff, worst, lgap, pgap)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 2])
def test_ep_world1_nccl_step_equals_the_single_card_step(cuda_device, tmp_path, top_k):
    """A small MoE LM (flash attention, fused add+LN, RoPE, 4 experts,
    gather dispatch, f32, Adam) through ``ExpertParallel`` on a one-rank
    NCCL group, against the single-card step from the same weights: the
    path launches the flash and add+LN kernels, and its losses and
    parameters are bitwise equal where the single-card step repeats
    itself bitwise (÷ 1 and the mean over one rank are exact), else
    within 4 times the gap between two single-card runs."""
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam
    from tpudml_torch.parallel import ExpertParallel
    from tpudml_torch.train import TrainState, make_train_step

    cfg = dict(vocab_size=256, embed_dim=128, num_heads=4, num_layers=2, max_len=128,
               rope=True, impl="flash", fused_ln=True, moe_experts=4, moe_top_k=top_k,
               device=cuda_device)
    seqs = synthetic_lm(16, 128, 256, seed=0)
    batches = [seqs[i:i + 4] for i in range(0, 12, 4)]

    def model(**kw):
        return TransformerLM(**cfg, **kw, generator=torch.Generator().manual_seed(3))

    def run(m, step, ts):
        losses = [step(ts, b[:, :-1], b[:, 1:])[1]["loss"].item() for b in batches]
        return losses, {n: p.detach().clone() for n, p in m.named_parameters()}

    singles = []
    for _ in range(2):
        m = model()
        opt = Adam(lr=1e-3)
        singles.append(run(m, make_train_step(m, opt), TrainState.create(m, opt)))
    (want, want_p), (again, again_p) = singles
    repeats = want == again and all(torch.equal(want_p[n], again_p[n]) for n in want_p)
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cuda"):
        assert torch.distributed.get_backend() == "nccl"
        m = model(moe_axis="expert")
        ep = ExpertParallel(m, Adam(lr=1e-3))
        reset_launch_counts()
        got, got_p = run(m, ep.make_train_step(), ep.create_state())
        launches = {k.name: k.launches for k in KERNELS}
    for name, per_step in (("flash_forward_lse", 2), ("flash_dq", 2), ("flash_dkdv", 2),
                           ("add_layernorm_fwd", 4), ("add_layernorm_bwd", 4)):
        assert launches.pop(name) == 3 * per_step, name
    assert not any(launches.values()), launches
    if repeats:
        assert got == want
        for n in want_p:
            assert torch.equal(got_p[n], want_p[n]), n
    else:
        def gaps(losses, params):
            return (max(abs(a - b) for a, b in zip(losses, want)),
                    max((params[n] - want_p[n]).abs().max().item() for n in params))

        (ldiff, worst), (lgap, pgap) = gaps(got, got_p), gaps(again, again_p)
        assert ldiff <= 4 * lgap and worst <= 4 * pgap, (ldiff, worst, lgap, pgap)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [{}, {"block": "bottleneck"}, {"stem": "imagenet"}],
                         ids=["basic", "bottleneck", "imagenet"])
def test_small_resnet_f32_on_card_matches_cpu(cuda_device, variant):
    """The north star's model, small: f32 train-mode logits, BN statistics
    after the forward and step-1 gradients, card against CPU."""
    from tpudml_torch.data import synthetic_classification
    from tpudml_torch.models import ResNet
    from tpudml_torch.nn import layers
    from tpudml_torch.train import make_loss_fn, params_of

    torch.backends.cudnn.allow_tf32 = False
    x, y = synthetic_classification(8, (33, 33, 3), 10, seed=0)
    relu = layers.relu

    def run(device, replay=None):
        m = ResNet(stage_sizes=(1, 1), width=8, device=device, **variant,
                   generator=torch.Generator().manual_seed(1))
        masks, given = [], None if replay is None else iter(replay)

        def patched(t, *args, **kw):
            if given is not None:
                return t * next(given).to(t.device)
            masks.append(t.detach() > 0)
            return relu(t, *args, **kw)

        layers.relu = patched
        try:
            loss, logits = make_loss_fn(m)(torch.from_numpy(x).to(device),
                                           torch.from_numpy(y).long().to(device))
            grads = torch.autograd.grad(loss, list(params_of(m).values()))
        finally:
            layers.relu = relu
        out = {"logits": logits.detach(), **dict(m.named_buffers()),
               **{f"grad:{n}": g for n, g in zip(params_of(m), grads)}}
        return {k: v.detach().cpu() for k, v in out.items()}, masks

    card, masks = run(cuda_device)
    cpu, _ = run("cpu", replay=masks)
    assert set(card) == set(cpu)
    for name, want in cpu.items():
        _close_to_max(card[name], want, 1e-4)


def _repeat_or_gap(got, want, again):
    """``got`` (losses, params) equals ``want`` bitwise where the single-card
    run repeats itself (``want`` == ``again``), else lies within 4 times the
    gap between the two single-card runs."""
    (gl, gp), (wl, wp), (al, ap) = got, want, again
    if wl == al and all(torch.equal(wp[n], ap[n]) for n in wp):
        assert gl == wl
        for n in wp:
            assert torch.equal(gp[n], wp[n]), n
        return
    lgap = max(abs(a - b) for a, b in zip(al, wl))
    pgap = max((ap[n].float() - wp[n].float()).abs().max().item() for n in wp)
    ldiff = max(abs(a - b) for a, b in zip(gl, wl))
    worst = max((gp[n].float() - wp[n].float()).abs().max().item() for n in wp)
    assert ldiff <= 4 * lgap and worst <= 4 * pgap, (ldiff, worst, lgap, pgap)


@pytest.mark.cuda
def test_lenet_world1_dp_step_equals_the_single_card_step(cuda_device, tmp_path):
    """task2's step (LeNet, SGD 0.01 momentum 0.9, 32 images) through
    ``DataParallel`` on a one-rank NCCL group against the single-card step
    from the same weights, three steps: bitwise where the single-card step
    repeats itself, else within 4 times its run-to-run gap."""
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.data import synthetic_classification
    from tpudml_torch.models import LeNet
    from tpudml_torch.optim import Sgd
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.train import TrainState, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    batches = [synthetic_classification(32, (28, 28, 1), 10, seed=i) for i in range(3)]

    def model():
        return LeNet(device=cuda_device, generator=torch.Generator().manual_seed(0))

    def run(m, step, ts, stacked):
        losses = [step(ts, x[None] if stacked else x, y[None] if stacked else y)[1]["loss"]
                  .item() for x, y in batches]
        return losses, {n: p.detach().clone() for n, p in m.named_parameters()}

    singles = []
    for _ in range(2):
        m = model()
        opt = Sgd(lr=0.01, momentum=0.9)
        singles.append(run(m, make_train_step(m, opt), TrainState.create(m, opt), False))
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cuda"):
        assert torch.distributed.get_backend() == "nccl"
        m = model()
        dp = DataParallel(m, Sgd(lr=0.01, momentum=0.9), stacked_batches=True)
        got = run(m, dp.make_train_step(), dp.create_state(), True)
    _repeat_or_gap(got, *singles)


@pytest.mark.cuda
def test_fused_trunk_dropout_step_kernels_match_plain(cuda_device):
    """The dropout LM (0.1, RoPE, f32) on the flash kernels and the fused
    add+LN kernels against the plain model (dense attention, unfused LN)
    from the same weights and the same dropout keys, so the same masks
    (drawn on the card from each key's path): step-1 gradients within
    1e-4 of each parameter's largest plain magnitude, three steps' losses
    within 1e-3, and the kernels launched 3 × (2, 2, 2, 4, 4)."""
    from tpudml_torch.core.prng import seed_key
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam
    from tpudml_torch.train import TrainState, make_loss_fn, make_train_step, params_of

    cfg = dict(vocab_size=256, embed_dim=128, num_heads=4, num_layers=2, max_len=128,
               rope=True, dropout=0.1, device=cuda_device)
    seqs = synthetic_lm(12, 128, 256, seed=0)
    batches = [seqs[i:i + 4] for i in range(0, 12, 4)]
    root = seed_key(0xD0)

    def model(**kw):
        return TransformerLM(**cfg, **kw, generator=torch.Generator().manual_seed(2))

    kernel, plain = model(impl="flash", fused_ln=True), model(impl="full", fused_ln=False)
    x = torch.from_numpy(batches[0][:, :-1]).long().to(cuda_device)
    y = torch.from_numpy(batches[0][:, 1:]).long().to(cuda_device)
    grads = {}
    for name, m in (("kernel", kernel), ("plain", plain)):
        loss, _ = make_loss_fn(m)(x, y, key=root.fold_in(0))
        grads[name] = dict(zip(params_of(m), torch.autograd.grad(loss, list(
            params_of(m).values()))))
    for n, want in grads["plain"].items():
        _close_to_max(grads["kernel"][n], want, 1e-4)
    losses = {}
    reset_launch_counts()
    for name, m in (("kernel", kernel), ("plain", plain)):
        opt = Adam(lr=1e-3)
        ts, step = TrainState.create(m, opt), make_train_step(m, opt, rng_root=root)
        losses[name] = [step(ts, b[:, :-1], b[:, 1:])[1]["loss"].item() for b in batches]
        if name == "kernel":
            launches = {k.name: k.launches for k in KERNELS}
    assert max(abs(a - b) for a, b in zip(losses["kernel"], losses["plain"])) <= 1e-3
    for name, per_step in (("flash_forward_lse", 2), ("flash_dq", 2), ("flash_dkdv", 2),
                           ("add_layernorm_fwd", 4), ("add_layernorm_bwd", 4)):
        assert launches.pop(name) == 3 * per_step, name
    assert not any(launches.values()), launches


@pytest.mark.cuda
def test_prefetch_to_device_from_pinned_memory(cuda_device):
    """Batches copied ahead on a side stream from pinned host buffers arrive
    in order with their values, on the card, for numpy arrays and for
    tensors already pinned."""
    import numpy as np

    from tpudml_torch.data import prefetch_to_device

    rng = np.random.default_rng(0)
    items = [(rng.random((64, 28, 28, 1), dtype=np.float32),
              torch.arange(i, i + 64, dtype=torch.int32).pin_memory()) for i in range(6)]
    out = []
    for x, y in prefetch_to_device(iter(items), size=3, device=cuda_device):
        assert x.device.type == y.device.type == "cuda"
        out.append((x * 2, y + 1))  # consumed on the default stream
    torch.cuda.synchronize()
    assert len(out) == 6
    for (x, y), (wx, wy) in zip(out, items):
        assert torch.equal(x.cpu(), torch.from_numpy(wx) * 2)
        assert torch.equal(y.cpu(), wy + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_prefill_flash_window_matches_plain(cuda_device, dtype):
    """The paged prefill's window attention: K/V written through a
    non-contiguous page table, read back with ``read_row_prefix`` and
    GQA-repeated, through ``chunk_flash_window`` (start/C + 1 launches of
    kernel 1 or its bf16 twin) against the plain causal attention at the
    chunk's offset. f32 at the flash tolerance; bf16 within BF16_REL."""
    from tpudml_torch.nn.attention import chunk_flash_window
    from tpudml_torch.serve.paged import init_pool, read_row_prefix, write_chunk

    c, h, kvh, d, p, start = 64, 8, 2, 64, 16, 192
    pool = init_pool(40, p, kvh, d, "f32", cuda_device)
    row = (torch.randperm(39, generator=torch.Generator().manual_seed(3))[:16] + 1).to(cuda_device)
    for s0 in range(0, start + c, c):
        write_chunk(pool, _randn(1, c, kvh, d, seed=s0, device=cuda_device),
                    _randn(1, c, kvh, d, seed=s0 + 1, device=cuda_device), row, s0)
    q = _randn(1, c, h, d, seed=7, device=cuda_device).to(dtype)
    k, v = read_row_prefix(pool, row, start + c, dtype)
    k, v = (torch.repeat_interleave(a, h // kvh, dim=2) for a in (k, v))
    kernel = FLASH_FORWARD if dtype == torch.float32 else FLASH_FORWARD_BF16
    before = kernel.launches
    o = chunk_flash_window(q, k, v, start)
    assert kernel.launches - before == start // c + 1
    ref = dot_product_attention(q, k, v, causal=True, q_offset=start)
    assert o.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)
    else:
        _close_to_max(o, ref, BF16_REL)


@pytest.mark.cuda
def test_paged_engine_streams_match_dense_on_card(cuda_device):
    """A paged engine (page 8, prefill chunks of 16 through the flash
    kernel) serves the same seeded workload as the dense engine: the same
    token streams, event log and flash launches."""
    import math

    from tpudml_torch.models import TransformerLM
    from tpudml_torch.serve import ServeConfig, ServingEngine, poisson_workload

    model = TransformerLM(vocab_size=256, embed_dim=128, num_heads=4, num_kv_heads=2,
                          num_layers=2, max_len=128, rope=True, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    reqs, _ = poisson_workload(8, math.inf, 3, vocab_size=256, prompt_len=(4, 60),
                               new_tokens=(4, 20))
    reps, flash = {}, {}
    for layout in ("dense", "paged"):
        cfg = ServeConfig(slots=3, max_len=128, prefill_chunk=16, cache_layout=layout,
                          page_size=8, step_time_s=0.01)
        before = FLASH_FORWARD.launches
        reps[layout] = ServingEngine(model, cfg, device="cuda").run(reqs)
        flash[layout] = FLASH_FORWARD.launches - before
    assert reps["paged"].events == reps["dense"].events
    for rid, st in reps["dense"].requests.items():
        assert reps["paged"].requests[rid].tokens == st.tokens
    assert flash["paged"] == flash["dense"] > 0


@pytest.mark.cuda
def test_resume_at_the_training_config_is_bitwise(cuda_device, tmp_path):
    """task5 ``--parallel dp`` at the training config (V=32768, d=512, H=4,
    L=6, T=1024, B=8; flash, fused add+LN, RoPE, Adam): a run resumed from
    the step-2 checkpoint of a 4-step run ends with the same losses and
    the same state (parameters, Adam moments, step) bitwise."""
    import json
    import shutil

    import numpy as np

    from tpudml_torch.tasks import task5_longcontext as task5

    flags = ["--parallel", "dp", "--vocab", "32768", "--embed_dim", "512", "--num_heads", "4",
             "--num_layers", "6", "--seq_len", "1024", "--batch_size", "8", "--attn", "flash",
             "--fused_ln", "--rope", "--lr", "1e-3", "--steps", "4", "--ckpt_every", "2",
             "--log_every", "1", "--device", "cuda"]

    def losses(log_dir):
        recs = [json.loads(line) for f in log_dir.rglob("metrics.jsonl")
                for line in f.read_text().splitlines()]
        return {r["step"]: r["value"] for r in recs if r["tag"] == "Train Loss"}

    def leaves(step_dir):
        with np.load(step_dir / "leaves.npz") as data:
            return [data[k] for k in sorted(data.files)]

    task5.main(flags + ["--ckpt_dir", str(tmp_path / "ref"), "--log_dir", str(tmp_path / "a")])
    shutil.copytree(tmp_path / "ref" / "step_2", tmp_path / "run" / "step_2")
    task5.main(flags + ["--ckpt_dir", str(tmp_path / "run"), "--resume",
                        "--log_dir", str(tmp_path / "b")])
    want, got = losses(tmp_path / "a"), losses(tmp_path / "b")
    assert sorted(got) == [3, 4] and all(got[i] == want[i] for i in got)
    a, b = leaves(tmp_path / "ref" / "step_4"), leaves(tmp_path / "run" / "step_4")
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _same_nans_and_close(got, want, tol=None, rel=None):
    """NaN exactly where ``want`` has it; the finite rest within ``tol``
    (rtol/atol) or ``rel`` of ``want``'s largest finite magnitude."""
    assert torch.equal(got.isnan(), want.isnan()), (
        int(got.isnan().sum()), int(want.isnan().sum()))
    keep = ~want.isnan()
    if rel is None:
        torch.testing.assert_close(got[keep], want[keep], **tol)
    else:
        _close_to_max(got[keep], want[keep], rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,d,causal,k_shift", [
    (8, 1024, 4, 128, True, 0),    # the training shape
    (2, 200, 2, 64, True, 1),      # rows 0 sees no key
    (1, 77, 2, 32, False, 0),
])
def test_flash_forward_keeps_nan(cuda_device, dtype, b, t, h, d, causal, k_shift):
    """Kernel 1 writes NaN wherever its plain version does: NaN query rows
    (their own rows), NaN key rows (every row that sees them), in one
    head each; the finite rest at the forward's tolerances, and a row
    that sees no key keeps out 0 and lse −1e30."""
    q, k, v = (_randn(b, t, h, d, seed=s, device=cuda_device).to(dtype) for s in (11, 12, 13))
    g = torch.Generator().manual_seed(14)
    rows = torch.randperm(t, generator=g)[: max(t // 16, 2)].to(cuda_device)
    half = rows.numel() // 2
    q[:, rows[:half], 0, :] = float("nan")
    k[:, rows[half:], h - 1, 3] = float("nan")
    o, lse = flash_forward_lse(q, k, v, causal=causal, k_shift=k_shift)
    ro, rl = flash_forward_lse_reference(q, k, v, causal=causal, k_shift=k_shift)
    assert o.isnan().any() and lse.isnan().any()
    if dtype == torch.float32:
        _same_nans_and_close(o, ro, tol=dict(rtol=1e-5, atol=1e-5))
    else:
        _same_nans_and_close(o, ro, rel=BF16_REL)
    _same_nans_and_close(lse, rl, tol=dict(rtol=1e-5, atol=1e-5))
    if k_shift:
        assert torch.equal(o[:, :k_shift], torch.zeros_like(o[:, :k_shift]))
        assert bool((lse[:, :, :k_shift] == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("poison", ["x_rows", "w_col", "all_row"])
@pytest.mark.parametrize("n,d,v", [(8192, 512, 32768), (1000, 64, 1000), (65, 520, 129),
                                   (37, 8, 1)])
def test_xent_forward_keeps_nan(cuda_device, dtype, poison, n, d, v):
    """Kernels 10 and 11 keep NaN as their plain versions do: NaN in some
    rows of x (those rows' lse, picked and scores), in one column of W
    (every row's lse, that column's scores and picks), or a whole row of
    x NaN (its lse through the merge of vocabulary lanes that saw no
    finite score: V = 1 leaves most lanes empty); the finite rest at the
    xent tolerances. (They keep it as they are: their max drops a NaN
    score, but the sum of exp(s − max) it feeds does not.)"""
    x, w, b, y = _xent_inputs(n, d, v, dtype, cuda_device)
    g = torch.Generator().manual_seed(21)
    if poison == "x_rows":
        rows = torch.randperm(n, generator=g)[: max(n // 50, 1)].to(cuda_device)
        x[rows, d // 2] = float("nan")
    elif poison == "w_col":
        w[:, v // 2] = float("nan")
    else:
        x[n // 2] = float("nan")
    lse0, picked0 = xent_forward(x, w, b, y)
    lse, picked, s = xent_forward_save(x, w, b, y)
    rlse, rpicked, rs = xent_forward_save_reference(x, w, b, y)
    assert rlse.isnan().any()
    for got in (lse0, lse):
        _same_nans_and_close(got, rlse, tol=ROW_TOL)
    for got in (picked0, picked):
        _same_nans_and_close(got, rpicked, tol=ROW_TOL)
    _same_nans_and_close(s, rs, tol=ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("save_s", [False, True], ids=["lean", "saved"])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d,v", [(1000, 64, 1000), (256, 512, 4096), (300, 1032, 700)])
def test_vocab_sharded_head_kernels_compose(cuda_device, n, d, v, dtype, shards, save_s):
    """The vocab-sharded head's halves on the card (kernels 10 or 11
    forward, 12 and 13 or 14 and 15 backward, one launch each a shard):
    labels shifted below each shard's first column (negative ones pick
    nothing; −1 and V among them), the lse merged over the shards; the
    loss at the xent row tolerance of the plain unsharded head, dX (summed
    over the shards), dW (concatenated) and db within the xent gradient
    tolerances of the plain version's, as the unsharded kernels are."""
    from tpudml_torch.ops import sharded_xent_in_one_process

    x, w, b, y = _xent_inputs(n, d, v, dtype, cuda_device)
    kernels = ((XENT_FORWARD_SAVE, XENT_DX, XENT_DW) if save_s else
               (XENT_FORWARD, XENT_DX_LEAN, XENT_DW_LEAN))
    before = [k.launches for k in kernels]
    loss, dx, dw, db = sharded_xent_in_one_process(x, w, b, y, shards, save_s)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [c + shards for c in before]
    rlse, rpicked, rs = xent_forward_save_reference(x, w, b, y)
    torch.testing.assert_close(loss, (rlse - rpicked).mean(), **ROW_TOL)
    rel = XENT_GRAD_REL[dtype]
    _close_to_max(dx, xent_dx_reference(rs, w, y, rlse, 1.0 / n), rel)
    rdw, rdb = xent_dw_reference(rs, x, y, rlse, 1.0 / n)
    _close_to_max(dw, rdw, rel)
    _close_to_max(db, rdb, XENT_GRAD_REL[torch.float32])
    assert dw.dtype == dtype and db.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [["--parallel", "fsdp", "--fused_xent"],
                                   ["--parallel", "tp", "--fused_xent", "--fused_xent_lean"]],
                         ids=["fsdp_saved", "tp_lean"])
def test_sharded_head_world1_nccl_steps_equal_the_single_card_step(cuda_device, tmp_path, flags):
    """task5 ``--parallel fsdp|tp`` with the vocab-sharded head on a one-rank
    NCCL group (kernels 10–15 on the one shard, the merge and dX's
    all-reduce over one rank) against the single-card fused step from the
    same seed, through the entry point at a small width: every loss and
    parameter bitwise equal where the single-card step repeats itself."""
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.tasks import task5_longcontext as task5

    common = ["--vocab", "4096", "--embed_dim", "256", "--num_heads", "4", "--num_layers",
              "2", "--seq_len", "256", "--batch_size", "4", "--steps", "3", "--log_every", "0",
              "--attn", "flash", "--fused_ln", "--rope", "--device", "cuda",
              "--log_dir", str(tmp_path)]

    def run(argv):
        args = task5.parse_args(argv)
        losses, last = [], {}

        def hook(step, train_state, metrics):
            losses.append(float(metrics["loss"]))
            last["model"] = train_state.model

        task5.run(args, hooks=[hook])
        eng = args._sharded
        params = (eng.gather_params() if eng is not None else
                  {n: p.detach().clone() for n, p in last["model"].named_parameters()})
        return losses, params

    head = [f for f in flags if f.startswith("--fused")]
    (want, want_p), (again, again_p) = run(common + head), run(common + head)
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cuda"):
        assert torch.distributed.get_backend() == "nccl"
        got, got_p = run(common + flags)
    if want == again and all(torch.equal(want_p[n], again_p[n]) for n in want_p):
        assert got == want
        for n in want_p:
            assert torch.equal(got_p[n], want_p[n]), n
    else:
        assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-3


# --------------------------------------------------------------- pipelines

PP_CFG = dict(vocab_size=512, embed_dim=128, num_heads=4, max_len=128, rope=True)
# Kernel launches a step at one stage, M = 4 (kernels 1–3, 8, 9): GPipe runs
# the head's ln_f once on the whole batch, 1F1B once a micro-batch; remat
# repeats the block's forward; interleaved's first chunk runs its forward
# twice (the forward unit and the backward's recompute).
PP_PER_STEP = {
    "gpipe": {"flash_forward_lse": 4, "flash_dq": 4, "flash_dkdv": 4,
              "add_layernorm_fwd": 5, "add_layernorm_bwd": 5},
    "gpipe_remat": {"flash_forward_lse": 8, "flash_dq": 4, "flash_dkdv": 4,
                    "add_layernorm_fwd": 9, "add_layernorm_bwd": 5},
    "1f1b": {"flash_forward_lse": 4, "flash_dq": 4, "flash_dkdv": 4,
             "add_layernorm_fwd": 8, "add_layernorm_bwd": 8},
    "interleaved": {"flash_forward_lse": 12, "flash_dq": 8, "flash_dkdv": 8,
                    "add_layernorm_fwd": 16, "add_layernorm_bwd": 12},
}


def _pipe(kind, m, device):
    from tpudml_torch.models import TransformerBlock, TransformerEmbed, TransformerHead
    from tpudml_torch.optim import Adam
    from tpudml_torch.parallel import GPipe, Interleaved1F1B, OneFOneB

    d, h, v, t = (PP_CFG[k] for k in ("embed_dim", "num_heads", "vocab_size", "max_len"))
    g = torch.Generator().manual_seed(0)
    kw = dict(optimizer=Adam(lr=1e-3), device=device,
              prologue=TransformerEmbed(v, d, t, use_pos_embed=False, generator=g),
              epilogue=TransformerHead(d, v, fused_ln=True, generator=g))

    def block(gen):
        return TransformerBlock(d, h, impl="flash", rope=True, fused_ln=True, generator=gen)

    if kind == "interleaved":
        return Interleaved1F1B(block, m, v_chunks=2, **kw)
    if kind == "1f1b":
        return OneFOneB(block, m, **kw)
    return GPipe(block, m, remat=kind == "gpipe_remat", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gpipe", "1f1b"])
def test_one_stage_pipeline_on_the_card_is_the_one_block_lm(cuda_device, tmp_path, kind):
    """A one-stage pipeline at one micro-batch on a one-rank NCCL group
    runs the same kernels on the same rows as ``TransformerLM(num_layers=1)``
    (flash attention, fused add+LN, the head's ln_f through kernel 8):
    three Adam steps bitwise equal where the single-card step repeats
    itself, else within 1e-3 in every loss."""
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.interop import lm_params_from_pipeline
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.optim import Adam
    from tpudml_torch.train import TrainState, make_train_step

    seqs = synthetic_lm(8, PP_CFG["max_len"], PP_CFG["vocab_size"], seed=1)
    x, y = seqs[:, :-1], seqs[:, 1:]
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cuda"):
        assert torch.distributed.get_backend() == "nccl"
        pipe = _pipe(kind, 1, cuda_device)
        ts, step = pipe.create_state(0), pipe.make_train_step()
        init = lm_params_from_pipeline({n: t.clone() for n, t in pipe.gather_params().items()})
        got = [step(ts, x, y)[1]["loss"].item() for _ in range(3)]
        got_p = lm_params_from_pipeline(pipe.gather_params())

    def single():
        lm = TransformerLM(**PP_CFG, num_layers=1, impl="flash", fused_ln=True,
                           device=cuda_device)
        lm.load_state_dict(init)
        opt = Adam(lr=1e-3)
        st, lm_step = TrainState.create(lm, opt), make_train_step(lm, opt)
        losses = [lm_step(st, x, y)[1]["loss"].item() for _ in range(3)]
        return losses, {n: p.detach().clone() for n, p in lm.named_parameters()}

    (want, want_p), (again, again_p) = single(), single()
    if want == again and all(torch.equal(want_p[n], again_p[n]) for n in want_p):
        assert got == want
        for n in want_p:
            assert torch.equal(got_p[n], want_p[n]), n
    else:
        assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(PP_PER_STEP))
def test_pipeline_launch_counts_on_the_card(cuda_device, tmp_path, kind):
    """One stage, M = 4, two steps: kernels 1–3, 8 and 9 launch exactly
    PP_PER_STEP a step, and nothing else does."""
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.ops import KERNELS, reset_launch_counts

    seqs = synthetic_lm(8, PP_CFG["max_len"], PP_CFG["vocab_size"], seed=1)
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cuda"):
        pipe = _pipe(kind, 4, cuda_device)
        ts, step = pipe.create_state(0), pipe.make_train_step()
        reset_launch_counts()
        for _ in range(2):
            ts, m = step(ts, seqs[:, :-1], seqs[:, 1:])
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in KERNELS if k.launches}
    assert launches == {k: 2 * n for k, n in PP_PER_STEP[kind].items()}
    assert torch.isfinite(m["loss"]).item()


# ------------------------------------------------- context parallel, TP serving


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "striped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ring_in_one_process_matches_flash_attention(cuda_device, dtype, layout):
    """W = 2 ranks' ring ticks in one process (each rank's K/V block taken
    by index) through kernels 1–3: the merged output and dq, dk, dv held
    against ``flash_attention`` over the whole sequence (the flash
    tolerances; bf16 within 2e-2 of the largest magnitude); the causal
    contiguous ring folds 3 blocks a direction, the striped one 4, two of
    them with ``k_shift = 1``."""
    from unittest import mock

    import tpudml_torch.ops as ops
    from tpudml_torch.parallel.cp import (
        _stripe_time, _unstripe_time, ring_attention_in_one_process,
    )

    b, t, h, d, w = 2, 256, 4, 64, 2
    q, k, v, do = (_randn(b, t, h, d, seed=s, device=cuda_device).to(dtype) for s in range(4))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    want = flash_attention(qr, kr, vr, causal=True)
    want.backward(do)
    lay = (lambda x: _stripe_time(x, w)) if layout == "striped" else (lambda x: x)
    back = (lambda x: _unstripe_time(x, w)) if layout == "striped" else (lambda x: x)
    shards = [list(lay(x).chunk(w, dim=1)) for x in (q, k, v, do)]
    shifts = []
    real = ops.flash_forward_lse

    def spy(*a, **kw):
        shifts.append(kw.get("k_shift", 0))
        return real(*a, **kw)

    with mock.patch.object(ops, "flash_forward_lse", spy):
        (outs, _, dqs, dks, dvs), folds = ring_attention_in_one_process(
            *shards, causal=True, layout=layout)
    assert folds == ((3, 3) if layout == "contiguous" else (4, 4))
    assert shifts.count(1) == (0 if layout == "contiguous" else 1)
    for got, ref, rtol in ((outs, want, 1e-5), (dqs, qr.grad, 5e-4), (dks, kr.grad, 5e-4),
                           (dvs, vr.grad, 5e-4)):
        got, ref = back(torch.cat(got, dim=1)).float(), ref.float()
        if dtype == torch.bfloat16:
            assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
        else:
            torch.testing.assert_close(got, ref, rtol=rtol, atol=1e-5)


def _task5_losses_params(task5, argv):
    args = task5.parse_args(argv)
    losses, last = [], {}

    def hook(step, train_state, metrics):
        losses.append(float(metrics["loss"]))
        last["model"] = train_state.model

    task5.run(args, hooks=[hook])
    return losses, {n: p.detach().clone() for n, p in last["model"].named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_cp_world1_nccl_step_equals_the_single_card_flash_step(cuda_device, tmp_path, layout):
    """task5 ``--parallel cp --attn ring`` on a one-rank NCCL group (one
    diagonal fold through kernels 1–3, its merge of one block exact) equals
    ``--parallel single --attn flash`` from the same seed, every loss and
    parameter bitwise where the single-card step repeats itself."""
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.tasks import task5_longcontext as task5

    common = ["--vocab", "512", "--embed_dim", "128", "--num_heads", "4", "--num_layers", "2",
              "--seq_len", "128", "--batch_size", "4", "--steps", "3", "--log_every", "0",
              "--fused_ln", "--rope", "--device", "cuda", "--log_dir", str(tmp_path)]
    want, want_p = _task5_losses_params(task5, common + ["--attn", "flash"])
    again, again_p = _task5_losses_params(task5, common + ["--attn", "flash"])
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cuda"):
        assert torch.distributed.get_backend() == "nccl"
        got, got_p = _task5_losses_params(task5, common + [
            "--parallel", "cp", "--attn", "ring", "--cp_layout", layout])
    if want == again and all(torch.equal(want_p[n], again_p[n]) for n in want_p):
        assert got == want
        for n in want_p:
            assert torch.equal(got_p[n], want_p[n]), n
    else:
        assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_tp_serving_world1_equals_the_dense_engine(cuda_device, tmp_path, kind):
    """``ServingEngine(mesh={"model": 1})`` on a one-rank NCCL group serves
    the dense engine's streams and event log (virtual clock), and launches
    kernel 1 exactly as often as the prefill needs."""
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.serve import ServeConfig, ServingEngine, poisson_workload

    model = TransformerLM(vocab_size=1024, embed_dim=128, num_heads=8, num_kv_heads=2,
                          num_layers=2, max_len=256, rope=True, device=cuda_device,
                          generator=torch.Generator().manual_seed(0))
    requests, _ = poisson_workload(6, float("inf"), 0, vocab_size=1024, prompt_len=(16, 100),
                                   new_tokens=(4, 12))
    cfg = ServeConfig(slots=4, max_len=256, prefill_chunk=32, cache_kind=kind,
                      step_time_s=0.01)
    dense = ServingEngine(model, cfg, device="cuda").run(requests)
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cuda"):
        eng = ServingEngine(model, cfg, device="cuda", mesh={"model": 1})
        reset_launch_counts()
        tp = eng.run(requests)
        launches = {k.name: k.launches for k in KERNELS if k.launches}
    need = sum(2 * c * (c + 1) // 2 for c in (-(-(len(r.prompt) - 1) // 32) for r in requests))
    assert launches == {"flash_forward_lse": need}
    assert tp.events == dense.events
    # TP adds the row-parallel bias after the sum ((h + a·W) + b, JAX's
    # order), the dense step inside the projection (h + (a·W + b)): a
    # stream may part only at a near-tie of the plain logits, in f32 within
    # 1e-5; with the int8 cache a last-bit difference can move a cached
    # element to the neighbouring code, and each int8 run's logits lie
    # within 0.25 of the f32 ones (tests/test_serve.py), so within 0.5.
    gap_bound = 0.5 if kind == "int8" else 1e-5
    for req in requests:
        a, b = tp.requests[req.rid].tokens, dense.requests[req.rid].tokens
        if a != b:
            i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = torch.tensor(list(req.prompt) + a[:i], device=cuda_device)
            with torch.inference_mode():
                top2 = model(seq[None])[0, -1].topk(2).values
            assert (top2[0] - top2[1]).item() < gap_bound


# The planner's verification step at world 1 on the card (a small width:
# V=2048, d=128, H=2, L=2, T=256, 4 rows).
PLAN_SMALL = dict(vocab_size=2048, embed_dim=128, num_heads=2, num_layers=2, seq_len=256,
                  per_chip_batch=4)


@pytest.mark.cuda
def test_plan_verifies_a_fused_dp_candidate_at_world1(cuda_device, tmp_path):
    """``verify_candidate`` of ``dp[data=1]`` with the fused head on a
    one-rank NCCL group: no finding, launches kernels 1–3 once a layer and
    11–13 once, and the engine's step equals the single-card fused step
    (``train.make_lm_fused_train_step``) on the same model and rows
    bitwise."""
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import make_optimizer
    from tpudml_torch.parallel.dp import _use_flash
    from tpudml_torch.plan import ModelSpec, build_candidate, verify_candidate
    from tpudml_torch.plan.emit import _batch, _model
    from tpudml_torch.plan.space import Candidate
    from tpudml_torch.train import TrainState, make_lm_fused_train_step

    spec = ModelSpec(**PLAN_SMALL)
    cand = Candidate(engine="dp", mesh=(("data", 1),), zero1=False, zero1_overlap=False,
                     accum_steps=1, fused_xent=True, sentinel=False, obs=False)
    reset_launch_counts()
    v = verify_candidate(spec, cand, device="cuda")
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    assert v["ok"] and v["findings"] == [], v
    assert v["predicted"]["comm_wire_bytes"] == 0.0  # one rank moves nothing
    assert v["predicted"]["peak_hbm_bytes"] > 0
    assert launches == {"flash_forward_lse": 2, "flash_dq": 2, "flash_dkdv": 2,
                        "xent_fwd_save": 1, "xent_dx_s": 1, "xent_dw_s": 1}
    x, y = _batch(spec, 1)
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cuda"):
        eng, ts, step, _ = build_candidate(spec, cand, "cuda")
        ts, m = step(ts, x, y)
        got = (m["loss"].item(), {n: p.detach().clone() for n, p in eng.model.named_parameters()})
    single = _model(spec, cuda_device)
    _use_flash(single)  # what DataParallel(flash_attn=True) does to the model
    opt = make_optimizer("adamw", 3e-4)
    ts1, m1 = make_lm_fused_train_step(single, opt)(TrainState.create(single, opt), x, y)
    assert got[0] == m1["loss"].item()
    for n, p in single.named_parameters():
        assert torch.equal(got[1][n], p), n


@pytest.mark.cuda
def test_elastic_restart_drill_at_world1_on_the_card(cuda_device, tmp_path):
    """``run_drill`` with one NCCL rank, killed at step 13: it re-forms on a
    fresh port, resumes from step 10, and ends bitwise equal (parameter
    CRC) to the uninterrupted run."""
    from tpudml_torch.elastic.drill import run_drill

    report = run_drill(str(tmp_path), world=1, kill_rank=0, device="cuda", timeout_s=300.0)
    assert report["ok"], report
    assert report["bit_exact"] and report["reforms"] == 1
    assert report["resume_step"] == 10 and report["steps_lost"] == 3
    assert report["fresh_port"] and report["trace_pids"] == [0]


# An entry point run alone (not under chip_smoke.py's global flags) computes
# its f32 convolutions in f32: every convolution's first forward, recorded
# in the entry's own process, against the same convolution in f64.
TF32_CONV_REL = 1e-5  # chip_smoke.py's: TF32 keeps 10 bits and misses it ~100x

_CONV_PROBE = r"""
import json, sys, tempfile
import torch
import torch.nn.functional as F

real = F.conv2d
calls = {}

def record(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    out = real(x, w, b, stride, padding, dilation, groups)
    key = tuple(w.shape)
    if key not in calls and x.dtype == torch.float32 and x.is_cuda:
        calls[key] = [t.detach().clone() if t is not None else None for t in (x, w, b, out)] \
            + [stride, padding, dilation, groups]
    return out

F.conv2d = record
from tpudml_torch.tasks import task1
with tempfile.TemporaryDirectory() as tmp:
    task1.main(["--device", "cuda", "--dataset", "synthetic", "--epochs", "1",
                "--log_every", "0", "--log_dir", tmp])
errs = {}
with torch.no_grad():
    for key, (x, w, b, out, stride, padding, dilation, groups) in calls.items():
        want = real(x.double(), w.double(), None if b is None else b.double(), stride,
                    padding, dilation, groups)
        errs[str(key)] = float((out.double() - want).abs().max() / want.abs().max())
print(json.dumps({"errs": errs, "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                  "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}))
"""


@pytest.mark.cuda
def test_lab_entry_alone_computes_its_convolutions_in_f32(cuda_device, tmp_path):
    """task1 in a process of its own (PyTorch's default allows TF32 in
    cuDNN): LeNet's two convolutions, as the entry ran them, within
    TF32_CONV_REL of f64 on the same inputs, and TF32 off afterwards."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _CONV_PROBE], cwd=repo, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    print(rep)
    assert len(rep["errs"]) == 2, rep
    assert not rep["cudnn_allow_tf32"] and not rep["matmul_allow_tf32"]
    for key, err in rep["errs"].items():
        assert err <= TF32_CONV_REL, (key, err)


@pytest.mark.cuda
def test_hetero_mpmd_pipeline_on_the_card_matches_its_reference(cuda_device):
    """Two ``StageWorker`` threads on the card over ``channel_pair`` (a
    bf16 trunk with 2 microbatches feeding an f32 head with 1, global
    batch 8, JAX's test widths), 5 steps, against ``reference_step_fn`` on
    the card: losses and parameters at rtol 1e-5 / atol 1e-6."""
    import numpy as np

    from tpudml_torch.comm.p2p import channel_pair
    from tpudml_torch.mpmd import PipelineSpec, StageSpec
    from tpudml_torch.mpmd import runtime as rt

    spec = PipelineSpec(stages=(StageSpec("trunk", microbatches=2, dtype="bfloat16"),
                                StageSpec("head", microbatches=1, dtype="float32")),
                        global_batch=8)
    kw = dict(feature_dim=8, hidden=(16,), classes=4, seed=0, lr=0.1, momentum=0.9,
              device="cuda")
    batch_for = rt.make_batch_fn(8, 8, 4, 0)
    a, b = channel_pair("s0r0->s1r0", timeout_s=60.0)
    trunk = rt.StageWorker(spec, 0, 0, program=rt.StageProgram(spec, 0, **kw),
                           batch_for=batch_for, down_channels={"s0r0->s1r0": a})
    head = rt.StageWorker(spec, 1, 0, program=rt.StageProgram(spec, 1, **kw),
                          batch_for=batch_for, up_features=16,
                          up_channels={"s0r0->s1r0": b})
    losses = rt.run_stage_threads({"t": trunk, "h": head}, range(5), timeout_s=120)
    a.close(), b.close()
    params, mom, step_fn = rt.reference_step_fn(spec, **kw)
    ref = []
    for k in range(5):
        x, y = batch_for(k)
        params, mom, loss, _ = step_fn(params, mom, x, y)
        ref.append(float(loss))
    np.testing.assert_allclose(losses["h"], ref, rtol=1e-5, atol=1e-6)
    for want, worker in ((params[0], trunk), (params[1], head)):
        for wl, gl in zip(want, worker.program.params):
            for key in ("w", "b"):
                assert gl[key].is_cuda
                torch.testing.assert_close(gl[key], wl[key], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_mpmd_remesh_drill_with_four_stage_processes_on_the_card(cuda_device, tmp_path):
    """The [2, 2] drill with its four stage processes on the one card (each
    stage group sums over gloo): stage 1 rank 1 killed at step 13, the
    groups re-form [2, 1] in place on fresh ports, resume from step 10,
    and every survivor's CRC equals the uninterrupted reference's."""
    from tpudml_torch.mpmd.drill import run_mpmd_drill

    rep = run_mpmd_drill(str(tmp_path), device="cuda", timeout_s=300.0)
    assert rep["ok"], rep
    assert rep["bit_exact"] and rep["in_place"] and rep["final_stage_worlds"] == [2, 1]
    assert rep["resume_step"] == 10 and rep["steps_lost"] == 3 and rep["fresh_ports"]


# The serving fleet on the card at a small width (V=1024, d=128, H=8, kv 2,
# L=2, RoPE; 4 slots, max_len 256, chunks of 32).
FLEET_SMALL = dict(vocab_size=1024, embed_dim=128, num_heads=8, num_kv_heads=2, num_layers=2,
                   max_len=256, rope=True)


def _small_lm(device):
    from tpudml_torch.models import TransformerLM

    return TransformerLM(**FLEET_SMALL, device=device, generator=torch.Generator().manual_seed(0))


def _near_tie(model, prompt, a, b, bound=1e-5):
    """Two greedy streams agree, or part where the plain logits' top-2 gap
    is under ``bound``."""
    if a == b:
        return True
    i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
    seq = torch.tensor(list(prompt) + a[:i], device=model.device)
    with torch.inference_mode():
        top2 = model(seq[None])[0, -1].topk(2).values
    return (top2[0] - top2[1]).item() < bound


@pytest.mark.cuda
def test_fleet_router_kill_arm_on_the_card_matches_its_single_engine(cuda_device):
    """Two dense replicas, replica 1 killed at step 4 and re-formed: every
    finished stream is the single engine's on the same requests (apart from
    a near-tie of the plain logits: a continuation re-prefills through
    kernel 1 what the uninterrupted run wrote a decode step at a time), the
    drains are the victim's tenants, and kernel 1 launches exactly what the
    admitted prompts (continuations too) need, no other kernel."""
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.serve import ServeConfig, ServingEngine, poisson_workload
    from tpudml_torch.serve.fleet import FleetConfig, FleetRouter

    model = _small_lm(cuda_device)
    requests, _ = poisson_workload(10, 300.0, 3, vocab_size=1024, prompt_len=(16, 100),
                                   new_tokens=(4, 12))
    ecfg = ServeConfig(slots=4, max_len=256, prefill_chunk=32, step_time_s=0.01)
    single = ServingEngine(model, ecfg, device="cuda").run(requests)
    router = FleetRouter(model, FleetConfig(engine=ecfg, replicas=2, reform_after_steps=3),
                         device="cuda")
    reset_launch_counts()
    rep = router.run(requests, kills=[(4, 1)])
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    assert rep.kills == 1 and rep.drains >= 1 and rep.finished == len(requests)
    base = {r.rid: len(r.prompt) for r in requests}
    done = {rid: 0 for rid in base}
    live, need = {}, 0
    for kind, rid, _, _, step in rep.events:
        if kind == "admit":
            c = -(-(base[rid] + done[rid] - 1) // 32)
            need += 2 * c * (c + 1) // 2
            live[rid] = step
        elif kind == "drain":
            done[rid] += step - live.pop(rid)
    assert launches == {"flash_forward_lse": need}
    for req in requests:
        assert _near_tie(model, req.prompt, rep.requests[req.rid].tokens,
                         single.requests[req.rid].tokens), req.rid


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_handoff_skips_kernel_1_on_the_adopted_prefix(cuda_device, tmp_path, kind):
    """A 97-token prompt hands off 3 pages of 32; the adopting engine's
    prefill launches kernel 1 no time where a local prefill launches it
    2·(1+2+3) times, and its stream is bitwise the local one's."""
    import numpy as np

    from tpudml_torch.ops import FLASH_FORWARD, reset_launch_counts
    from tpudml_torch.serve import Request, ServeConfig, ServingEngine
    from tpudml_torch.serve.fleet import adopt_handoff, write_handoff

    model = _small_lm(cuda_device)
    cfg = ServeConfig(slots=4, max_len=256, prefill_chunk=32, cache_kind=kind,
                      cache_layout="paged", page_size=32, prefix_sharing=True)
    prompt = np.random.default_rng(5).integers(0, 1024, 97).astype(np.int32)
    req = [Request(rid=0, prompt=prompt, max_new_tokens=12)]
    reset_launch_counts()
    assert write_handoff(model, cfg, prompt, tmp_path, device="cuda")["n_pages"] == 3
    assert FLASH_FORWARD.launches == 12
    eng = ServingEngine(model, cfg, device="cuda")
    assert adopt_handoff(eng, tmp_path) == 3
    reset_launch_counts()
    adopted = eng.run(req).requests[0]
    assert FLASH_FORWARD.launches == 0 and adopted.shared_pages == 3
    reset_launch_counts()
    local = ServingEngine(model, cfg, device="cuda").run(req).requests[0]
    assert FLASH_FORWARD.launches == 12
    assert adopted.tokens == local.tokens


@pytest.mark.cuda
def test_fleet_drill_at_world_2_on_one_card(cuda_device, tmp_path):
    """Two replica processes share the card under the elastic controller;
    rank 1 SIGKILLs itself mid-serve, the round re-forms, and both ranks'
    token CRCs equal the uninterrupted in-process reference's."""
    from tpudml_torch.serve.fleet import run_fleet_drill

    rep = run_fleet_drill(tmp_path, world=2, requests=8, kill_rank=1, device="cuda",
                          timeout_s=240.0)
    assert rep["ok"], rep
    assert rep["reforms"] >= 1 and rep["crc_ok"]
    assert all(r["match"] for r in rep["ranks"].values())


# The analyzers on the card (the graph pass's capture at world 1 on NCCL).

# Launches of one flagship step at L=2 (flash bf16 fwd, dQ, dK/dV a layer;
# add+LN 2L junctions a direction; the fused head saving its scores).
ANALYSIS_SMALL = dict(vocab_size=1024, embed_dim=128, num_heads=4, num_layers=2, max_len=256,
                      rope=True)
ANALYSIS_PER_STEP = {"flash_forward_lse_bf16": 2, "flash_dq_bf16": 2, "flash_dkdv_bf16": 2,
                     "add_layernorm_fwd_bf16": 4, "add_layernorm_bwd_bf16": 4,
                     "xent_fwd_save": 1, "xent_dx_s": 1, "xent_dw_s": 1}


@pytest.mark.cuda
def test_strict_analysis_cli_on_the_card(cuda_device):
    """``python -m tpudml_torch.analysis --strict`` with the card as the
    device: exit 0, no finding outside the allowlist, no stale entry."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = {k: v for k, v in os.environ.items() if k != "TPUDML_DEVICE"}
    proc = subprocess.run([sys.executable, "-m", "tpudml_torch.analysis", "--strict"],
                          cwd=Path(__file__).resolve().parent.parent, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "\n0 finding(s)" in proc.stdout
    assert "stale allowlist" not in proc.stdout


@pytest.mark.cuda
def test_flagship_capture_names_every_launch_on_the_card(cuda_device):
    """One captured bf16 flagship step names each kernel launch, its
    backward's (on autograd's device thread) among them, exactly as the
    launch counters count them."""
    import threading

    from tpudml_torch.analysis import analyze_capture, capture
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS
    from tpudml_torch.optim import AdamW
    from tpudml_torch.train import TrainState, make_lm_fused_train_step

    m = TransformerLM(**ANALYSIS_SMALL, impl="flash", fused_ln=True, compute_dtype=torch.bfloat16,
                      device="cuda", generator=torch.Generator().manual_seed(3))
    opt = AdamW(lr=3e-4)
    step = make_lm_fused_train_step(m, opt, save_scores=True)
    rows = torch.randint(0, 1024, (2, 257), generator=torch.Generator().manual_seed(1)).cuda()
    ts, _ = step(TrainState.create(m, opt), rows[:, :-1], rows[:, 1:])
    before = {k.name: k.launches for k in KERNELS}
    cap = capture(step, (ts, rows[:, :-1], rows[:, 1:]), name="flagship")
    deltas = {k.name: k.launches - before[k.name] for k in KERNELS if k.launches > before[k.name]}
    assert cap.error is None
    assert dict(cap.launches) == ANALYSIS_PER_STEP == deltas
    main = threading.get_ident()
    backward = {e.name for e in cap.events if e.kind == "launch" and e.thread != main}
    assert any(e.kind == "op" and e.thread != main for e in cap.events)
    assert {"flash_dq_bf16", "flash_dkdv_bf16", "add_layernorm_bwd_bf16", "xent_dx_s",
            "xent_dw_s"} <= backward
    rules = {f.rule for f in analyze_capture(cap, "flagship", expects_donation=True)}
    assert rules == {"J104", "J111"}


def _entrypoint_names():
    from tpudml_torch.analysis import ENTRYPOINTS

    return list(ENTRYPOINTS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", _entrypoint_names())
def test_entrypoint_findings_are_the_same_on_card_and_cpu(cuda_device, name):
    """Each registry entry at world 1: the same rules, at the same files,
    on the card (NCCL) as on the CPU (gloo)."""
    from tpudml_torch.analysis import analyze_entrypoint

    def rules(device):
        return sorted({(f.rule, f.file) for f in analyze_entrypoint(name, device=device)})

    assert rules("cuda") == rules("cpu")
