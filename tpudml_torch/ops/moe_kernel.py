"""Grouped weight gradient of the dropless MoE FFN: the port of
``tpudml/ops/moe_kernel.py`` (Pallas ``_grouped_dw_kernel``, ``grouped_dw``,
``ragged_ffn``).

Rows are sorted by expert, so expert ``e`` owns the contiguous row slab
``[offsets[e], offsets[e+1])`` with ``offsets = [0, cumsum(group_sizes)]``.

- :func:`grouped_dw` is ``dW[e] = x[slab e]ᵀ · g[slab e]`` in f32: kernel 16
  (``tpudml_torch/csrc/grouped_dw.cu``, f32 and bf16 twins) for CUDA
  tensors, :func:`grouped_dw_reference` (one matmul per slab) for CPU
  tensors. The kernel reads ``group_sizes`` on the device; the wrapper never
  copies them to the host. A CUDA input the kernel does not take raises:
  nothing falls back. The kernel cuts each slab into chunks of at most
  ``R`` rows and the grid into (chunk slot, dW tile) blocks from (M, k, n,
  E) alone (:func:`grouped_dw_plan`; the chunk list it implies:
  :func:`grouped_dw_chunks`).
- :func:`ragged_matmul` is the counterpart of ``lax.ragged_dot``
  (``out[slab e] = x[slab e] @ w[e]``, zero rows past the last slab). JAX
  has no Pallas kernel for it, so it is plain PyTorch: one ``torch.matmul``
  per slab, which needs the slab lengths on the host.
- :func:`ragged_ffn` is the expert FFN ``relu(x @ w1[e] + b1[e]) @ w2[e] +
  b2[e]`` over the sorted rows as a ``torch.autograd.Function`` whose
  backward takes dW1 and dW2 from :func:`grouped_dw`, db from ``onehotᵀ @
  cotangent`` in f32, and dh and dx from :func:`ragged_matmul` on the
  transposed weights. Its forward copies ``group_sizes`` to the host once
  (the slab lengths :func:`ragged_matmul` needs) and keeps them for the
  backward: one device-to-host copy per MoE layer and step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from tpudml_torch.ops.cuda_lib import (
    I, P, STORAGE_DTYPES, CudaLibrary, Kernel, check_cuda_operand, ptr, storage_twin,
)

_LIB = CudaLibrary("grouped_dw.cu", {
    "grouped_dw_f32": [P] * 5 + [I] * 4 + [P],
    "grouped_dw_bf16": [P] * 5 + [I] * 4 + [P],
    "grouped_dw_plan": [I] * 5 + [P],
})
GROUPED_DW = Kernel("grouped_dw", _LIB, "grouped_dw_f32",
                    replaces="tpudml/ops/moe_kernel.py:105")
GROUPED_DW_BF16 = Kernel("grouped_dw_bf16", _LIB, "grouped_dw_bf16",
                         replaces="tpudml/ops/moe_kernel.py:105")


# How kernel 16 cuts its work (csrc/grouped_dw.cu `plan_gdw`): a block owns a
# GDW_TILE[dtype] tile of one dW[e] (rows of k, columns of n) over one chunk
# of at most R rows of e's slab, GDW_STAGE_ROWS rows a ring stage. R makes
# one slab of all M rows about GDW_FILL_ELEMS elements of dW work (4 waves
# of 128×128 tiles, one block on each of the H100's 132 SMs), at least
# GDW_MIN_ROWS, a multiple of GDW_ROW_UNIT, and in bf16 at most
# GDW_MAX_ROWS (the tensor cores' f32 sums truncate: a chunk is one chain).
GDW_TILE = {torch.float32: (128, 128), torch.bfloat16: (128, 256)}
GDW_MAX_ROWS = {torch.float32: None, torch.bfloat16: 2048}
GDW_STAGE_ROWS = 64
GDW_FILL_ELEMS = 4 * 132 * 128 * 128
GDW_MIN_ROWS = 256
GDW_ROW_UNIT = 64


def grouped_dw_plan(m: int, k: int, n: int, e: int, dtype: torch.dtype) -> dict:
    """Kernel 16's cut of (M, k, n, E) in ``dtype``: ``rows`` (R, the most
    rows a chunk holds), ``tile`` (rows, columns of dW a block),
    ``stage_rows``, ``slots`` (⌊M / R⌋ + E: the chunk list never holds more,
    since each slab of len rows has at most ⌊len / R⌋ + 1 chunks),
    ``blocks`` (slots × tiles of one dW[e]: the grid) and
    ``workspace_bytes`` (an f32 partial tile for each slot and tile, then E
    × tiles int32 arrival counters). At the MoE step's M = 8192 and k·n =
    512·2048, R = 1024 in both dtypes: a balanced slab of E = 8 stays one
    chunk."""
    if m < 0 or k < 1 or n < 1 or e < 1:
        raise ValueError(f"grouped_dw wants M >= 0 and k, n, E >= 1, got {m}, {k}, {n}, {e}")
    tj, tc = GDW_TILE[dtype]
    tiles = -(-k // tj) * -(-n // tc)
    fill = -(-m * tiles * tj * tc // GDW_FILL_ELEMS)
    rows = max(GDW_MIN_ROWS, -(-fill // GDW_ROW_UNIT) * GDW_ROW_UNIT)
    if GDW_MAX_ROWS[dtype] is not None:
        rows = min(rows, GDW_MAX_ROWS[dtype])
    slots = m // rows + e
    return {"rows": rows, "tile": (tj, tc), "stage_rows": GDW_STAGE_ROWS, "slots": slots,
            "blocks": slots * tiles,
            "workspace_bytes": 4 * (slots * tiles * tj * tc + e * tiles)}


@functools.lru_cache(maxsize=256)
def _plan_built(m: int, k: int, n: int, e: int, bf16: bool) -> tuple:
    out = (ctypes.c_longlong * 7)()
    _LIB.call("grouped_dw_plan", I(m), I(k), I(n), I(e), I(int(bf16)), ctypes.cast(out, P))
    return tuple(out)


def grouped_dw_plan_built(m: int, k: int, n: int, e: int, dtype: torch.dtype) -> dict:
    """:func:`grouped_dw_plan` as the built kernel decides it
    (``grouped_dw_plan`` of csrc/grouped_dw.cu; needs nvcc: a card-only test
    holds the two equal). :func:`grouped_dw` sizes its workspace with it;
    the C call is cached (the plan depends on its arguments alone: one
    ctypes call less in each launch of a host-bound MoE step)."""
    out = _plan_built(m, k, n, e, dtype == torch.bfloat16)
    return {"rows": out[0], "tile": (out[1], out[2]), "stage_rows": out[3], "slots": out[4],
            "blocks": out[5], "workspace_bytes": out[6]}


def _chunks_of(length: int, rows: int) -> int:
    return -(-length // rows) if length > 0 else 1


def grouped_dw_chunks(sizes: Sequence[int], m: int, plan: dict) -> list[tuple[int, int, int]]:
    """The chunk list kernel 16 walks, as ``(expert, lo, hi)`` row ranges in
    slot order: each slab cut into ⌈len / R⌉ chunks of equal length (one
    empty chunk for an empty slab, which writes its zeros). Negative sizes
    make slabs overlap; R then doubles until the list fits ``slots``."""
    slabs = _slabs(sizes, m)
    rows = plan["rows"]
    while sum(_chunks_of(hi - lo, rows) for lo, hi in slabs) > plan["slots"]:
        rows *= 2
    out = []
    for e, (lo, hi) in enumerate(slabs):
        count = _chunks_of(hi - lo, rows)
        out += [(e, lo + i * (hi - lo) // count, lo + (i + 1) * (hi - lo) // count)
                for i in range(count)]
    return out


def _check_operands(x, g, group_sizes) -> None:
    """The JAX wrapper's checks (``tpudml/ops/moe_kernel.py:212-220``)."""
    if x.dim() != 2 or g.dim() != 2 or x.shape[0] != g.shape[0]:
        raise ValueError(
            f"grouped_dw wants row-aligned 2-D operands, got {tuple(x.shape)} "
            f"and {tuple(g.shape)}")
    if group_sizes.dim() != 1 or group_sizes.dtype.is_floating_point or \
            group_sizes.dtype.is_complex or group_sizes.dtype == torch.bool:
        raise ValueError(
            f"group_sizes must be a 1-D integer array, got "
            f"{tuple(group_sizes.shape)} {group_sizes.dtype}")


def _slabs(sizes: Sequence[int], m: int) -> list[tuple[int, int]]:
    """(start, end) row range of each group, clamped to [0, m]."""
    out, start = [], 0
    for s in sizes:
        end = start + int(s)
        lo = min(max(start, 0), m)
        out.append((lo, min(max(end, lo), m)))
        start = end
    return out


def grouped_dw_reference(x, g, group_sizes):
    """Plain version of :func:`grouped_dw`: per group ``x[slab].float().T @
    g[slab].float()``, zeros for an empty group; [E, k, n] f32."""
    _check_operands(x, g, group_sizes)
    m, k = x.shape
    n = g.shape[1]
    dw = torch.zeros((group_sizes.shape[0], k, n), dtype=torch.float32, device=x.device)
    for e, (lo, hi) in enumerate(_slabs(group_sizes.tolist(), m)):
        if hi > lo:
            dw[e] = x[lo:hi].float().T @ g[lo:hi].float()
    return dw


def grouped_dw(x, g, group_sizes):
    """Per-group ``x[slab]ᵀ @ g[slab]`` over contiguous row slabs.

    ``x [m, k]`` and ``g [m, n]`` hold rows sorted by group; ``group_sizes
    [E]`` (int) gives each group's slab length (rows beyond
    ``sum(group_sizes)`` are ignored). Returns ``dW [E, k, n]`` in f32 with
    f32 accumulation: kernel 16 (the f32 or bf16 twin, by x's dtype) for
    CUDA tensors, :func:`grouped_dw_reference` for CPU tensors. The
    kernel's workspace (partials of slabs longer than one chunk, arrival
    counters) is allocated here, :func:`grouped_dw_plan_built`'s bytes."""
    _check_operands(x, g, group_sizes)
    if not x.is_cuda:
        return grouped_dw_reference(x, g, group_sizes)
    if x.dtype not in STORAGE_DTYPES:
        raise TypeError(f"grouped_dw takes {STORAGE_DTYPES}, got {x.dtype}")
    kernel = storage_twin(x, GROUPED_DW, GROUPED_DW_BF16)
    check_cuda_operand("x", x, x.dtype, 2)
    check_cuda_operand("g", g, x.dtype, 2)
    if len({t.device for t in (x, g, group_sizes)}) != 1:
        raise ValueError("x, g, group_sizes must be on one device")
    m, k = x.shape
    n = g.shape[1]
    e = group_sizes.shape[0]
    dw = torch.empty((e, k, n), dtype=torch.float32, device=x.device)
    if dw.numel() == 0:
        return dw
    sizes = group_sizes.to(torch.int32).contiguous()  # on the device: no host copy
    with torch.cuda.device(x.device):
        plan = grouped_dw_plan_built(m, k, n, e, x.dtype)
        ws = torch.empty(plan["workspace_bytes"], dtype=torch.uint8, device=x.device)
        kernel.launch(ptr(x), ptr(g), ptr(sizes), ptr(dw), ptr(ws), I(m), I(k), I(n), I(e))
    return dw


def ragged_matmul(x, w, sizes: Sequence[int]):
    """``lax.ragged_dot``: ``out[slab e] = x[slab e] @ w[e]`` for x [m, k]
    sorted by group, w [E, k, n] and the groups' slab lengths ``sizes`` on
    the host; rows past the last slab are zero. Differentiable through
    autograd (the stock A/B arm)."""
    m = x.shape[0]
    slabs = _slabs(sizes, m)
    parts = [x[lo:hi] @ w[e] for e, (lo, hi) in enumerate(slabs)]
    tail = m - (slabs[-1][1] if slabs else 0)
    if tail:
        parts.append(x.new_zeros((tail, w.shape[-1])))
    return torch.cat(parts)


def _ffn_forward(x, w1, b1, w2, b2, onehot, sizes):
    hidden = F.relu(ragged_matmul(x, w1, sizes) + onehot @ b1)
    return ragged_matmul(hidden, w2, sizes) + onehot @ b2, hidden


class _RaggedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, onehot, group_sizes):
        sizes = group_sizes.tolist()  # the one host copy of the layer
        out, hidden = _ffn_forward(x, w1, b1, w2, b2, onehot, sizes)
        ctx.save_for_backward(x, w1, w2, onehot, group_sizes, hidden)
        ctx.sizes = sizes
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w1, w2, onehot, group_sizes, hidden = ctx.saved_tensors
        sizes, ct = ctx.sizes, dout.dtype
        dout = dout.contiguous()
        dw2 = grouped_dw(hidden, dout, group_sizes).to(w2.dtype)
        db2 = (onehot.T.float() @ dout.float()).to(ct)
        dh = ragged_matmul(dout, w2.transpose(1, 2), sizes)
        # relu's derivative as XLA computes JAX's dh·(hidden > 0): a select,
        # so a NaN row of hidden passes 0, not 0·NaN.
        dpre = torch.where(hidden > 0, dh, torch.zeros((), dtype=ct, device=dh.device))
        dw1 = grouped_dw(x, dpre, group_sizes).to(w1.dtype)
        db1 = (onehot.T.float() @ dpre.float()).to(ct)
        dx = ragged_matmul(dpre, w1.transpose(1, 2), sizes)
        return (dx.to(x.dtype), dw1, db1.to(w1.dtype), dw2, db2.to(w2.dtype),
                None, None)


def ragged_ffn(x, w1, b1, w2, b2, onehot, group_sizes):
    """Expert FFN ``relu(x @ w1[e] + b1[e]) @ w2[e] + b2[e]`` over rows
    sorted by expert (module docstring). ``onehot [P, E]`` is the sorted
    rows' expert one-hot (it carries the biases); it and ``group_sizes``
    get no gradient."""
    return _RaggedFFN.apply(x, w1, b1, w2, b2, onehot, group_sizes)
