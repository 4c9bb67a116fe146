"""Flash attention, both directions: the port of
``tpudml/ops/attention_kernel.py`` (Pallas ``_fwd_kernel``, ``_dq_kernel``,
``_dkdv_kernel``).

- :func:`flash_forward_lse` — forward with the row log-sum-exp
  (``tpudml_torch/csrc/flash_fwd.cu``);
- :func:`flash_block_grads` — the backward with external statistics
  (lse, Δ): :func:`flash_dq` (``tpudml_torch/csrc/flash_bwd.cu``) and
  :func:`flash_dkdv` (``tpudml_torch/csrc/flash_dkdv.cu``), one kernel
  each;
- :func:`flash_attention` — a ``torch.autograd.Function`` over the two:
  its forward saves (q, k, v, o, lse), its backward takes
  Δ = rowsum(dO ⊙ O) in plain PyTorch and launches dQ and dK/dV.

Each op launches its hand-written CUDA kernel for CUDA tensors and runs
its plain PyTorch version (``*_reference``) for CPU tensors. It never
falls back: a CUDA input the kernel does not take (dtype, rank, layout,
head dim) raises. Every kernel has an f32 and a bf16 twin (its own
``Kernel`` and launch counter, ``*_bf16``), chosen by q's dtype. As the
TPU kernels do, the bf16 twins sum in f32, round p and ds to the operand
dtype before the products they feed, and store O, dQ, dK, dV in bf16; lse
and Δ stay f32. The plain versions round at the same places. All three
kernels run the bf16 products on the tensor cores and the f32 ones
register-tiled on the CUDA cores (no TF32).

Head dims (:func:`flash_head_dim_ok`): every kernel takes any D from 1 to
256. Each runs the next larger of its compiled widths (32, 64, 128, 256)
with the columns past D zero-filled on load and never stored; nothing is
padded or copied outside the kernels. The softmax scale is 1/√D of the
true D everywhere.

Semantics match the TPU kernel: q, k, v are [B, T, H, D] with the same T;
``causal`` masks by LOCAL positions ``q_pos >= k_pos + k_shift`` (the
aligned diagonal block of a window; ``k_shift=1`` makes it strict). A row
that sees no key at all (only possible with ``k_shift > 0``) returns
out = 0 and lse = ``NEG_INF``, so it carries zero weight when blocks are
merged by their log-sum-exp. The backward gives masked entries p = 0
whatever the lse (the TPU kernel computes exp(NEG_INF − lse), which is 0
for any lse a forward produced for a row that sees a key).
"""

from __future__ import annotations

import contextlib
import math

import torch

from tpudml_torch.markers import kernel_op
from tpudml_torch.ops.cuda_lib import (
    F, I, LL, P, STORAGE_DTYPES, CudaLibrary, Kernel, check_cuda_operand, ptr,
    storage_twin,
)

NEG_INF = -1e30  # large-finite mask value: avoids inf-inf -> NaN in softmax

MAX_HEAD_DIM = 256  # the widest compiled instance of every flash kernel
_FWD_ARGS = [P] * 5 + [I] * 4 + [LL] * 9 + [I, I, F, P]
_LIB = CudaLibrary("flash_fwd.cu", {
    "flash_fwd_f32": _FWD_ARGS, "flash_fwd_bf16": _FWD_ARGS,
})
_DQ_ARGS = [P] * 7 + [I] * 4 + [LL] * 12 + [I, I, F, P]
_DKDV_ARGS = [P] * 8 + [I] * 4 + [LL] * 12 + [I, I, F, P]
_BWD_LIB = CudaLibrary("flash_bwd.cu", {
    "flash_dq_f32": _DQ_ARGS, "flash_dq_bf16": _DQ_ARGS,
})
_DKDV_LIB = CudaLibrary("flash_dkdv.cu", {
    "flash_dkdv_f32": _DKDV_ARGS, "flash_dkdv_bf16": _DKDV_ARGS,
})
_FWD_AT = "tpudml/ops/attention_kernel.py:93"
_DQ_AT = "tpudml/ops/attention_kernel.py:177"
_DKDV_AT = "tpudml/ops/attention_kernel.py:217"
FLASH_FORWARD = Kernel("flash_forward_lse", _LIB, "flash_fwd_f32", replaces=_FWD_AT)
FLASH_FORWARD_BF16 = Kernel("flash_forward_lse_bf16", _LIB, "flash_fwd_bf16",
                            replaces=_FWD_AT)
FLASH_DQ = Kernel("flash_dq", _BWD_LIB, "flash_dq_f32", replaces=_DQ_AT)
FLASH_DQ_BF16 = Kernel("flash_dq_bf16", _BWD_LIB, "flash_dq_bf16", replaces=_DQ_AT)
FLASH_DKDV = Kernel("flash_dkdv", _DKDV_LIB, "flash_dkdv_f32", replaces=_DKDV_AT)
FLASH_DKDV_BF16 = Kernel("flash_dkdv_bf16", _DKDV_LIB, "flash_dkdv_bf16",
                         replaces=_DKDV_AT)


def flash_head_dim_ok(d: int) -> bool:
    """Whether the flash kernels (forward and backward) take head dim
    ``d``: 1 to 256."""
    return 1 <= d <= MAX_HEAD_DIM


def _check_head_dim(d: int) -> None:
    if not flash_head_dim_ok(d):
        raise ValueError(f"flash kernel head dim must be 1 to {MAX_HEAD_DIM}, got {d}")


def _visible(t: int, causal: bool, k_shift: int, device) -> torch.Tensor:
    """[T, T] bool: query row i sees key j."""
    pos = torch.arange(t, device=device)
    if causal:
        return pos[:, None] >= pos[None, :] + k_shift
    return torch.ones(t, t, dtype=torch.bool, device=device)


def _check_qkv(q, k, v, k_shift):
    if not (q.shape == k.shape == v.shape):
        raise ValueError(
            f"q, k, v must share [B, T, H, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k_shift < 0:
        raise ValueError(f"k_shift must be >= 0, got {k_shift}")


def _check_cuda_operands(named) -> None:
    """Raise unless every (name, tensor) is what the flash kernels take:
    CUDA [B,T,H,D] of one dtype (f32 or bf16) with unit stride on D, a
    head dim the kernels take (:func:`flash_head_dim_ok`), all on one
    device."""
    dtype = named[0][1].dtype
    if dtype not in STORAGE_DTYPES:
        raise TypeError(f"flash kernels take {STORAGE_DTYPES}, got {dtype}")
    for name, x in named:
        check_cuda_operand(name, x, dtype, 4, contiguous=False)
    _check_head_dim(named[0][1].shape[-1])
    if len({x.device for _, x in named}) != 1:
        raise ValueError(f"{', '.join(n for n, _ in named)} must be on one device")


def _on(device: torch.device):
    """The context that makes ``device`` the current card (none if it is:
    the switch costs more than a small launch)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _strides(*xs) -> list:
    return [LL(x.stride(i)) for x in xs for i in (0, 1, 2)]


def flash_forward_lse_reference(q, k, v, *, causal: bool = False,
                                k_shift: int = 0):
    """Plain PyTorch version: materialized f32 scores, same masks and
    statistics as the kernel, p rounded to v's dtype before P·V. Returns
    (out [B,T,H,D], lse [B,H,T] f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    visible = _visible(q.shape[1], causal, k_shift, q.device)
    s = torch.where(visible, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)  # [B, H, T, 1]
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = pv / den.transpose(1, 2)
    lse = (m + torch.log(den))[..., 0]
    seen = visible.any(dim=-1)  # [T]: rows with at least one visible key
    out = torch.where(seen[None, :, None, None], out, 0.0)
    lse = torch.where(seen, lse, NEG_INF)
    return out.to(q.dtype), lse


@kernel_op
def flash_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = False, k_shift: int = 0):
    """Flash forward that also returns the row log-sum-exp.

    Returns (out [B,T,H,D], lse [B,H,T] f32). CUDA tensors run the kernel
    (f32 or bf16, head dim 1 to 256, unit stride along D; the batch, time
    and head strides are passed through, so slices of a cache window need
    no copy); CPU tensors run :func:`flash_forward_lse_reference`."""
    _check_qkv(q, k, v, k_shift)
    if not q.is_cuda:
        return flash_forward_lse_reference(q, k, v, causal=causal,
                                           k_shift=k_shift)
    _check_cuda_operands((("q", q), ("k", k), ("v", v)))
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with _on(q.device):
        storage_twin(q, FLASH_FORWARD, FLASH_FORWARD_BF16).launch(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), I(b), I(t), I(h),
            I(d), *_strides(q, k, v), I(int(causal)), I(k_shift),
            F(1.0 / math.sqrt(d)),
        )
    return out, lse


# -------------------------------------------------------------- backward


def _bwd_terms(q, k, v, do, lse, delta, causal, k_shift):
    """f32 (p, ds) [B,H,T,T] of the plain backward: p = exp(s − lse) on
    visible entries (0 elsewhere), ds = p ⊙ (dO·Vᵀ − Δ)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    visible = _visible(q.shape[1], causal, k_shift, q.device)
    p = torch.where(visible, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.float()[..., None])


def _rounded(p, like):
    """f32 ``p`` rounded to ``like``'s dtype (the identity in f32)."""
    return p.to(like.dtype).float()


def _dq_from(ds, k, scale):
    return torch.einsum("bhqk,bkhd->bqhd", _rounded(ds, k), k.float()) * scale


def _dkdv_from(p, ds, q, do, scale):
    dk = torch.einsum("bhqk,bqhd->bkhd", _rounded(ds, q), q.float()) * scale
    return dk, torch.einsum("bhqk,bqhd->bkhd", _rounded(p, do), do.float())


def flash_dq_reference(q, k, v, do, lse, delta, *, causal: bool = False,
                       k_shift: int = 0):
    """Plain version of :func:`flash_dq`: dq = scale·ds·K."""
    _, ds = _bwd_terms(q, k, v, do, lse, delta, causal, k_shift)
    return _dq_from(ds, k, 1.0 / math.sqrt(q.shape[-1])).to(q.dtype)


def flash_dkdv_reference(q, k, v, do, lse, delta, *, causal: bool = False,
                         k_shift: int = 0):
    """Plain version of :func:`flash_dkdv`: dk = scale·dsᵀ·Q, dv = pᵀ·dO."""
    p, ds = _bwd_terms(q, k, v, do, lse, delta, causal, k_shift)
    dk, dv = _dkdv_from(p, ds, q, do, 1.0 / math.sqrt(q.shape[-1]))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_block_grads_reference(q, k, v, do, lse, delta, *,
                                causal: bool = False, k_shift: int = 0):
    """Plain version of :func:`flash_block_grads`: materialized f32
    scores, p = exp(s − lse) on visible entries (0 elsewhere), then
    ds = p ⊙ (dO·Vᵀ − Δ), dq = scale·ds·K, dk = scale·dsᵀ·Q, dv = pᵀ·dO."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _bwd_terms(q, k, v, do, lse, delta, causal, k_shift)
    dk, dv = _dkdv_from(p, ds, q, do, scale)
    return (_dq_from(ds, k, scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _check_bwd(q, k, v, do, lse, delta, k_shift) -> None:
    _check_qkv(q, k, v, k_shift)
    b, t, h, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, t):
            raise ValueError(f"{name} must be [B, H, T] = {(b, h, t)}, got {tuple(x.shape)}")
    if q.is_cuda:
        _check_cuda_operands((("q", q), ("k", k), ("v", v), ("do", do)))
        for name, x in (("lse", lse), ("delta", delta)):
            check_cuda_operand(name, x, torch.float32, 3)
            if x.device != q.device:
                raise ValueError(f"{name} must be on {q.device}")


def _bwd_args(q, k, v, do, lse, delta, causal, k_shift, scale):
    b, t, h, d = q.shape
    return ((ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta)),
            (I(b), I(t), I(h), I(d), *_strides(q, k, v, do), I(int(causal)),
             I(k_shift), F(scale)))


@kernel_op
def flash_dq(q, k, v, do, lse, delta, *, causal: bool = False,
             k_shift: int = 0) -> torch.Tensor:
    """dq [B,T,H,D] of :func:`flash_block_grads`: the dQ kernel for CUDA
    tensors, :func:`flash_dq_reference` for CPU tensors."""
    _check_bwd(q, k, v, do, lse, delta, k_shift)
    if not q.is_cuda:
        return flash_dq_reference(q, k, v, do, lse, delta, causal=causal,
                                  k_shift=k_shift)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    common, args = _bwd_args(q, k, v, do, lse, delta, causal, k_shift,
                             1.0 / math.sqrt(q.shape[-1]))
    with _on(q.device):
        storage_twin(q, FLASH_DQ, FLASH_DQ_BF16).launch(*common, ptr(dq), *args)
    return dq


@kernel_op
def flash_dkdv(q, k, v, do, lse, delta, *, causal: bool = False,
               k_shift: int = 0):
    """(dk, dv) [B,T,H,D] of :func:`flash_block_grads`: the dK/dV kernel
    for CUDA tensors, :func:`flash_dkdv_reference` for CPU tensors."""
    _check_bwd(q, k, v, do, lse, delta, k_shift)
    if not q.is_cuda:
        return flash_dkdv_reference(q, k, v, do, lse, delta, causal=causal,
                                    k_shift=k_shift)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    common, args = _bwd_args(q, k, v, do, lse, delta, causal, k_shift,
                             1.0 / math.sqrt(q.shape[-1]))
    with _on(q.device):
        storage_twin(q, FLASH_DKDV, FLASH_DKDV_BF16).launch(
            *common, ptr(dk), ptr(dv), *args)
    return dk, dv


def flash_block_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, *, causal: bool = False,
                      k_shift: int = 0):
    """Per-block flash backward with EXTERNAL softmax statistics: the
    counterpart of JAX's ``flash_block_grads``.

    ``lse``/``delta`` [B,H,T] f32 come from the (possibly globally merged)
    attention, delta = rowsum(dO ⊙ O); returns (dq, dk, dv) [B,T,H,D],
    this block's exact contributions. CUDA tensors run the dQ and dK/dV
    kernels (f32 or bf16, head dim 1 to 256, unit stride along D; batch,
    time and head strides passed through; lse/delta contiguous); CPU
    tensors run their plain versions."""
    dq = flash_dq(q, k, v, do, lse, delta, causal=causal, k_shift=k_shift)
    dk, dv = flash_dkdv(q, k, v, do, lse, delta, causal=causal, k_shift=k_shift)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_forward_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # Δ = rowsum(dO ⊙ O) in f32, outside the kernels (as JAX does).
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = flash_block_grads(q, k, v, do, lse, delta,
                                       causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """Differentiable flash attention over [B, T, H, D]; the same function
    as ``dot_product_attention``. Forward: :func:`flash_forward_lse`
    (saves q, k, v, o, lse); backward: Δ in plain PyTorch, then
    :func:`flash_block_grads` (the dQ and dK/dV kernels on the card). On
    the card the head dim is 1 to 256 in both directions."""
    return _FlashAttention.apply(q, k, v, causal)
