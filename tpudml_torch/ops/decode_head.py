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

The kernel stages x in shared memory, so a batch whose rows do not fit
at once is split into row groups that do (:func:`row_groups`), one launch
each. That is exact: a row's token, max and lse depend on that row alone.
A width whose one 8-row group does not fit (d > 6400) takes the whole
batch in one launch: the kernel then stages each 8-row group in chunks of
d and keeps its dot products in registers across them (the same sums in
the same order). Any d >= 1.
"""

from __future__ import annotations

import torch

from tpudml_torch.ops.cuda_lib import (
    I, P, CudaLibrary, Kernel, check_cuda_operand, ptr,
)

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
_GROUP = 8  # rows the kernel accumulates per pass over W


def row_groups(n: int, d: int) -> list[tuple[int, int]]:
    """[start, stop) row ranges covering [0, n) in order, one launch each.
    Each holds as many rows as fit x's shared-memory stage
    (``round_up(rows, 8)·d·4`` bytes), all but the last full. Where one
    8-row group does not fit, the kernel walks d in chunks instead and the
    whole batch is one range."""
    per = _MAX_X_SMEM // (d * 4) // _GROUP * _GROUP
    if per == 0:  # the kernel's chunked instance: any number of rows
        per = max(n, 1)
    return [(i, min(i + per, n)) for i in range(0, n, per)]


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
    groups = row_groups(n, d)
    tile = kernel.library.load().decode_head_tile_width()
    n_tiles = -(-v // tile)
    dev = x.device
    rows = groups[0][1] - groups[0][0] if groups else 0
    tile_max = torch.empty((n_tiles, rows), dtype=torch.float32, device=dev)
    tile_idx = torch.empty((n_tiles, rows), dtype=torch.int32, device=dev)
    tile_sum = torch.empty((n_tiles, rows), dtype=torch.float32, device=dev)
    tok = torch.empty(n, dtype=torch.int32, device=dev)
    mx = torch.empty(n, dtype=torch.float32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    # Row groups are addressed by byte offset (x contiguous; every operand
    # 4 bytes an element): no slice is made, one group or many.
    x_p, tok_p, mx_p, lse_p = (t.data_ptr() for t in (x, tok, mx, lse))
    with torch.cuda.device(dev):
        for start, stop in groups:
            kernel.launch(
                P(x_p + 4 * d * start), *(ptr(w) for w in weights), ptr(b),
                I(stop - start), I(d), I(v), ptr(tile_max), ptr(tile_idx),
                ptr(tile_sum), P(tok_p + 4 * start), P(mx_p + 4 * start),
                P(lse_p + 4 * start),
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
