"""Fused greedy decode head: the port of ``tpudml/ops/decode_head.py``.

``fused_decode_head`` returns the greedy pick and step statistics of
``x @ w + bias`` — (tokens [B] int32, max_logit [B] f32, lse [B] f32) —
and ``fused_decode_head_int8`` the same over int8 codes [d, V] with f32
per-output-channel scales [V] (``serve/fleet/quant.py`` layout). For CUDA
tensors both launch the two-pass CUDA kernel in
``tpudml_torch/csrc/decode_head.cu``, which never writes the [B, V] logits
to device memory; for CPU tensors they run the plain version
:func:`reference_head` (materialized logits, ``torch.argmax``'s
first-occurrence pick). A CUDA input the kernel does not take raises.
"""

from __future__ import annotations

import torch

from tpudml_torch.ops.cuda_lib import (
    I, P, CudaLibrary, Kernel, check_cuda_operand, ptr,
)
from tpudml_torch.ops.tiling import round_up

_ROWS = [I, I, I] + [P] * 7  # B, d, V, scratch x3, outputs x3, stream
_LIB = CudaLibrary("decode_head.cu", {
    "decode_head_f32": [P, P, P] + _ROWS,
    "decode_head_int8": [P, P, P, P] + _ROWS,
    "decode_head_tile_width": [],
})
DECODE_HEAD = Kernel(
    "fused_decode_head", _LIB, "decode_head_f32",
    replaces="tpudml/ops/decode_head.py:86",
)
DECODE_HEAD_INT8 = Kernel(
    "fused_decode_head_int8", _LIB, "decode_head_int8",
    replaces="tpudml/ops/decode_head.py:99",
)

# x is staged in shared memory, rows padded to the kernel's 8-row group.
_MAX_X_SMEM = 200 * 1024


def reference_head(x, w, b):
    """Plain version: materialized f32 logits, same statistics."""
    logits = x.float() @ w.float() + b.float()
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    return torch.argmax(logits, dim=-1).to(torch.int32), m, lse


def reference_head_int8(x, wq, scale, b):
    from tpudml_torch.serve.fleet.quant import _dequant_kernel

    return reference_head(x, _dequant_kernel(wq, scale), b)


def _launch(kernel, x, weights, b, v):
    n, d = x.shape
    if round_up(n, 8) * d * 4 > _MAX_X_SMEM:
        raise ValueError(f"decode head kernel takes B·d up to {_MAX_X_SMEM} bytes "
                         f"of x; got B={n}, d={d}")
    tile = kernel.library.load().decode_head_tile_width()
    n_tiles = -(-v // tile)
    dev = x.device
    tile_max = torch.empty((n_tiles, n), dtype=torch.float32, device=dev)
    tile_idx = torch.empty((n_tiles, n), dtype=torch.int32, device=dev)
    tile_sum = torch.empty((n_tiles, n), dtype=torch.float32, device=dev)
    tok = torch.empty(n, dtype=torch.int32, device=dev)
    mx = torch.empty(n, dtype=torch.float32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        kernel.launch(
            ptr(x), *(ptr(w) for w in weights), ptr(b), I(n), I(d), I(v),
            ptr(tile_max), ptr(tile_idx), ptr(tile_sum), ptr(tok), ptr(mx),
            ptr(lse),
        )
    return tok, mx, lse


def _check_rows(x, b, d, v):
    check_cuda_operand("x", x, torch.float32, 2)
    check_cuda_operand("bias", b, torch.float32, 1)
    if b.shape != (v,):
        raise ValueError(f"bias {tuple(b.shape)} must be ({v},)")
    if x.shape[1] != d:
        raise ValueError(f"x feature dim {x.shape[1]} != weight rows {d}")


def fused_decode_head(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None):
    """Greedy pick + step statistics of ``x @ w [+ bias]`` (module
    docstring). ``x`` [..., d] flattens to [B, d]; ``w`` is [d, V]."""
    d, v = w.shape
    xn = x.reshape(-1, x.shape[-1])
    b = torch.zeros(v, dtype=w.dtype, device=w.device) if bias is None else bias
    if not xn.is_cuda:
        return reference_head(xn, w, b)
    check_cuda_operand("w", w, torch.float32, 2)
    _check_rows(xn, b, d, v)
    return _launch(DECODE_HEAD, xn, (w,), b, v)


def fused_decode_head_int8(x: torch.Tensor, wq: torch.Tensor,
                           scale: torch.Tensor,
                           bias: torch.Tensor | None = None):
    """:func:`fused_decode_head` over the quantized head: int8 codes
    ``wq`` [d, V] and f32 per-output-channel ``scale`` [V], dequantized
    per weight as ``float(q) * scale`` inside the kernel."""
    d, v = wq.shape
    if tuple(scale.shape) != (v,):
        raise ValueError(f"scale {tuple(scale.shape)} must be ({v},)")
    xn = x.reshape(-1, x.shape[-1])
    b = (torch.zeros(v, dtype=torch.float32, device=wq.device)
         if bias is None else bias)
    if not xn.is_cuda:
        return reference_head_int8(xn, wq, scale, b)
    check_cuda_operand("wq", wq, torch.int8, 2)
    check_cuda_operand("scale", scale, torch.float32, 1)
    _check_rows(xn, b, d, v)
    return _launch(DECODE_HEAD_INT8, xn, (wq, scale), b, v)
