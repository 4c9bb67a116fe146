"""Flash-attention forward with the row log-sum-exp: the port of
``tpudml/ops/attention_kernel.py`` ``flash_forward_lse`` (Pallas
``_fwd_kernel``).

``flash_forward_lse`` launches the hand-written CUDA kernel
(``tpudml_torch/csrc/flash_fwd.cu``) for CUDA tensors and runs the plain
PyTorch version :func:`flash_forward_lse_reference` for CPU tensors. It
never falls back: a CUDA input the kernel does not take (dtype, rank,
layout, head dim) raises.

Semantics match the TPU kernel: q, k, v are [B, T, H, D] with the same T;
``causal`` masks by LOCAL positions ``q_pos >= k_pos + k_shift`` (the
aligned diagonal block of a window; ``k_shift=1`` makes it strict). A row
that sees no key at all (only possible with ``k_shift > 0``) returns
out = 0 and lse = ``NEG_INF``, so it carries zero weight when blocks are
merged by their log-sum-exp.
"""

from __future__ import annotations

import math

import torch

from tpudml_torch.ops.cuda_lib import (
    F, I, LL, P, CudaLibrary, Kernel, check_cuda_operand, ptr,
)

NEG_INF = -1e30  # large-finite mask value: avoids inf-inf -> NaN in softmax

HEAD_DIMS = (32, 64, 128)  # head dims the kernel is instantiated for

_LIB = CudaLibrary("flash_fwd.cu", {
    "flash_fwd_f32": [P] * 5 + [I] * 4 + [LL] * 9 + [I, I, F, P],
})
FLASH_FORWARD = Kernel(
    "flash_forward_lse", _LIB, "flash_fwd_f32",
    replaces="tpudml/ops/attention_kernel.py:93",
)


def flash_forward_lse_reference(q, k, v, *, causal: bool = False,
                                k_shift: int = 0):
    """Plain PyTorch version: materialized f32 scores, same masks and
    statistics as the kernel. Returns (out [B,T,H,D], lse [B,H,T] f32)."""
    t = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(t, device=q.device)
    if causal:
        visible = pos[:, None] >= pos[None, :] + k_shift
    else:
        visible = torch.ones(t, t, dtype=torch.bool, device=q.device)
    s = torch.where(visible, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)  # [B, H, T, 1]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / den.transpose(1, 2)
    lse = (m + torch.log(den))[..., 0]
    seen = visible.any(dim=-1)  # [T]: rows with at least one visible key
    out = torch.where(seen[None, :, None, None], out, 0.0)
    lse = torch.where(seen, lse, NEG_INF)
    return out.to(q.dtype), lse


def flash_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = False, k_shift: int = 0):
    """Flash forward that also returns the row log-sum-exp.

    Returns (out [B,T,H,D], lse [B,H,T] f32). CUDA tensors run the kernel
    (f32, head dim in ``HEAD_DIMS``, unit stride along D; the batch, time
    and head strides are passed through, so slices of a cache window need
    no copy); CPU tensors run :func:`flash_forward_lse_reference`."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(
            f"q, k, v must share [B, T, H, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k_shift < 0:
        raise ValueError(f"k_shift must be >= 0, got {k_shift}")
    if not q.is_cuda:
        return flash_forward_lse_reference(q, k, v, causal=causal,
                                           k_shift=k_shift)
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(name, x, torch.float32, 4, contiguous=False)
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel head dim must be one of {HEAD_DIMS}, got {d}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = [LL(x.stride(i)) for x in (q, k, v) for i in (0, 1, 2)]
    with torch.cuda.device(q.device):
        FLASH_FORWARD.launch(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), I(b), I(t), I(h),
            I(d), *strides, I(int(causal)), I(k_shift),
            F(1.0 / math.sqrt(d)),
        )
    return out, lse
