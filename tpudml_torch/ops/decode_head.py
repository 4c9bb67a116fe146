"""Fused greedy decode head: the port of ``tpudml/ops/decode_head.py``.

``fused_decode_head`` returns the greedy pick and step statistics of
``x @ w + bias`` — (tokens [B] int32, max_logit [B] f32, lse [B] f32) —
and ``fused_decode_head_int8`` the same over int8 codes [d, V] with f32
per-output-channel scales [V] (``serve/fleet/quant.py`` layout). For CUDA
tensors both launch the CUDA kernel in ``tpudml_torch/csrc/decode_head.cu``
once a call: it never writes the [B, V] logits to device memory, and its
last block to finish merges the vocabulary tiles' statistics. For CPU
tensors they run the plain version :func:`reference_head` (materialized
logits, ``torch.argmax``'s first-occurrence pick). A CUDA input the kernel
does not take raises.

Any B, d >= 1 and V >= 1 run in that one launch: the kernel stages x in
shared memory a chunk of d at a time, streams W through a ring of
``cp.async`` copies, and walks the batch in 8-row groups itself
(:func:`head_plan` gives its cut). A call allocates one int32
buffer (tokens, max, lse, then the tiles' statistics) and reuses one
arrival counter a stream, which every launch leaves at 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpudml_torch.markers import kernel_op, marked
from tpudml_torch.ops.cuda_lib import (
    I, P, CudaLibrary, Kernel, check_cuda_operand, ptr,
)

# The fused tails run as regions under JAX's jit names
# (tpudml/ops/decode_head.py:208, :223), which J110 and J119 skip.
FUSED_HEAD_MARKER = "_fused_decode_head"
FUSED_HEAD_INT8_MARKER = "_fused_decode_head_int8"

_ROWS = [I, I, I, P, P]  # B, d, V, out buffer, arrival counter (then the stream)
_LIB = CudaLibrary("decode_head.cu", {
    "decode_head_f32": [P, P, P] + _ROWS + [P],
    "decode_head_int8": [P, P, P, P] + _ROWS + [P],
    "decode_head_plan": [I, I, I, I, P],
})
DECODE_HEAD = Kernel(
    "fused_decode_head", _LIB, "decode_head_f32",
    replaces="tpudml/ops/decode_head.py:86",
)
DECODE_HEAD_INT8 = Kernel(
    "fused_decode_head_int8", _LIB, "decode_head_int8",
    replaces="tpudml/ops/decode_head.py:99",
)

TILE = 128  # vocab columns a block
GROUP = 8  # rows of x a pass over W serves
STEP_LOADS = 4  # 16-byte copies a thread a step
RING_STEPS = 4  # steps in a thread's ring of W copies in shared memory
# (columns a 16-byte copy holds, warps a block, most rows of d a warp
# stages at a time), f32 and int8. A warp copies 32 / (TILE / columns) rows
# of W at once: one in f32, four in int8.
LAYOUT = {False: (4, 8, 128), True: (16, 4, 256)}


class HeadPlan(NamedTuple):
    tiles: int  # blocks, one a vocab tile of TILE columns
    aligned: bool  # V a multiple of the load's columns: 16-byte loads
    warps: int  # warps a block, each owning a slice of d
    slice: int  # rows of d a warp owns
    chunk: int  # rows of d a warp stages at a time
    smem_bytes: int  # a block's rings of W copies and x chunks
    groups: int  # 8-row groups of x the kernel walks
    scratch: int  # int32 words of a call's buffer


@functools.lru_cache(maxsize=256)
def head_plan(b: int, d: int, v: int, int8: bool = False) -> HeadPlan:
    """How the kernel cuts (B, d, V) (``decode_head.cu`` ``plan_of``; a
    card-only check holds the two equal). A W that does not start on 16
    bytes also takes the unaligned instance, whatever ``aligned`` says."""
    vec, warps, chunk_max = LAYOUT[int8]
    step = 32 // (TILE // vec) * STEP_LOADS
    tiles = -(-v // TILE)
    slice_ = -(-d // warps)
    chunk = min(-(-slice_ // step) * step, chunk_max)
    ring = 16 * RING_STEPS * STEP_LOADS * 32 * warps
    return HeadPlan(tiles=tiles, aligned=v % vec == 0, warps=warps, slice=slice_,
                    chunk=chunk, smem_bytes=ring + 4 * warps * GROUP * chunk,
                    groups=-(-b // GROUP), scratch=3 * b * (tiles + 1))


def head_plan_built(b: int, d: int, v: int, int8: bool = False) -> HeadPlan:
    """:func:`head_plan` as the built kernel decides it (needs nvcc)."""
    out = (ctypes.c_int * 8)()
    _LIB.call("decode_head_plan", I(b), I(d), I(v), I(int(int8)), ctypes.cast(out, P))
    return HeadPlan(out[0], bool(out[1]), *out[2:])


def reference_head(x, w, b):
    """Plain version: materialized f32 logits, same statistics."""
    logits = x.float() @ w.float() + b.float()
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    return torch.argmax(logits, dim=-1).to(torch.int32), m, lse


def reference_head_int8(x, wq, scale, b):
    from tpudml_torch.serve.fleet.quant import _dequant_kernel

    return reference_head(x, _dequant_kernel(wq, scale), b)


_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counter(dev: torch.device, stream: int) -> torch.Tensor:
    """The arrival counter of ``stream``: zeroed once, left at 0 by every
    launch (launches on one stream never overlap)."""
    c = _COUNTERS.get((dev.index, stream))
    if c is None:
        c = _COUNTERS[dev.index, stream] = torch.zeros(1, dtype=torch.int32, device=dev)
    return c


def _launch(kernel, x, weights, b, v):
    n, d = x.shape
    dev = x.device
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, device=dev), torch.empty(0, device=dev))
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(kernel, x, weights, b, v)
    plan = head_plan(n, d, v, kernel is DECODE_HEAD_INT8)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(plan.scratch, dtype=torch.int32, device=dev)
    kernel.launch(ptr(x), *(ptr(w) for w in weights), ptr(b), I(n), I(d), I(v),
                  ptr(out), ptr(_counter(dev, stream)), stream=stream)
    stats = out[n:3 * n].view(torch.float32)
    return out[:n], stats[:n], stats[n:]


def _check_rows(x, b, d, v):
    check_cuda_operand("x", x, torch.float32, 2)
    check_cuda_operand("bias", b, torch.float32, 1)
    if b.shape != (v,):
        raise ValueError(f"bias {tuple(b.shape)} must be ({v},)")
    if x.shape[1] != d:
        raise ValueError(f"x feature dim {x.shape[1]} != weight rows {d}")


@marked(FUSED_HEAD_MARKER)
@kernel_op
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


@marked(FUSED_HEAD_INT8_MARKER)
@kernel_op
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
