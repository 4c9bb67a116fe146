"""Fused linear cross-entropy: the port of ``tpudml/ops/xent_kernel.py``
``linear_cross_entropy`` (Pallas ``_fwd_kernel``, ``_fwd_kernel_save``,
``_dx_s_kernel``, ``_dw_s_kernel``, ``_dx_kernel``, ``_dw_kernel``).

The LM head's ``x @ W + b`` and the mean softmax cross-entropy against
integer labels, without the [N, V] logits ever being a tensor of the
caller. Two backward modes, as in JAX:

- saved scores: the forward kernel writes the f32 scores once for the
  backward (1 GiB at N = 8192, V = 32768) and reduces them to per-row
  (lse, picked); the two backward kernels read each score once per
  512-column chunk of d, turn it into dlogits and contract it with W (dX)
  and x (dW, db) (:func:`saved_plan`);
- lean: the forward keeps only lse (O(N + parameters) residuals), and the
  two backward kernels recompute the scores tile by tile from x, W and b
  before contracting dlogits, so nothing of size N·V exists in either
  direction (the 131k-token regime, where the scores alone are 16 GiB).

CUDA sources: ``tpudml_torch/csrc/xent.cu`` (the forward kernels 10, 11,
which cut the vocabulary into slices: :func:`fwd_plan`),
``tpudml_torch/csrc/xent_saved.cu`` (the saved-scores backward 12, 13) and
``tpudml_torch/csrc/xent_lean.cu`` (the lean backward 14, 15); the two
backward pairs share ``csrc/xent_grad.cuh``. The kernels take any width
d >= 1: a ragged contraction edge is masked inside them (W is never
padded); the backward kernels give each 512-column chunk of d a block, the
lean ones in one thread-block cluster (:func:`lean_plan`).

- :func:`xent_forward` / :func:`xent_forward_save` launch kernel 10 / 11
  for CUDA tensors; :func:`xent_dx` / :func:`xent_dw` launch kernels 12
  and 13, :func:`xent_dx_lean` / :func:`xent_dw_lean` kernels 14 and 15;
  each has a plain PyTorch version (``*_reference``), which CPU tensors
  run. A CUDA input the kernels do not take raises: nothing falls back.
- :func:`sharded_linear_cross_entropy` is the vocab-sharded head over a
  process group: each rank runs kernels 10–15 on its [d, V/W] shard with
  the labels shifted below its first column, and the shards merge their
  (lse, picked) (comment above :func:`sharded_xent_forward`); its halves
  :func:`sharded_xent_forward` / :func:`sharded_xent_backward` are public so
  that one card can check their composition
  (:func:`sharded_xent_in_one_process`).
- :func:`linear_cross_entropy` is the JAX package's entry point. When a
  gradient is needed it runs a ``torch.autograd.Function``: saved scores
  (kernel 11 forward; kernels 12 and 13 backward) or lean (kernel 10
  forward; kernels 14 and 15 backward), as ``save_s`` resolves (JAX's
  ``_auto_save_s``: saved scores while the padded f32 residual fits
  ``SAVE_S_AUTO_MAX_BYTES``, lean beyond). Under ``torch.no_grad()``, or
  when no input requires grad, it runs kernel 10 alone, as JAX runs the
  ``custom_vjp`` primal outside differentiation.

Semantics, as in the JAX package:
- scores are f32 whatever the operand dtype; loss = mean(lse − picked);
- a label outside [0, V) gives picked = 0 (loss = lse) and a zero one-hot:
  it is NOT clamped to an edge class as ``softmax_cross_entropy`` does;
- dlog = (exp(s − lse) − onehot)·(1/N) is rounded to the operand dtype
  before each backward product; 1/N is applied inside the kernels and the
  cotangent g multiplies outside (``_scale_cotangents``);
- dX is stored in x's dtype and dW in W's; db is summed in f32 from the
  unrounded dlog, then cast to the bias dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from tpudml_torch.markers import kernel_op, marked
from tpudml_torch.ops.cuda_lib import (
    F, I, P, STORAGE_DTYPES, CudaLibrary, Kernel, check_cuda_operand, ptr,
)
from tpudml_torch.ops.tiling import round_up

# The unsharded and the vocab-sharded head run as regions under JAX's jit
# names (tpudml/ops/xent_kernel.py:545, :719), which the graph pass's J107
# keys on.
FUSED_XENT_MARKER = "_fused_xent_unsharded"
SHARDED_XENT_MARKER = "_fused_xent_sharded"

_LIB = CudaLibrary("xent.cu", {
    "xent_fwd": [P] * 7 + [I] * 4 + [P],
    "xent_fwd_save": [P] * 8 + [I] * 4 + [P],
    "xent_fwd_plan": [I] * 4 + [P],
})
_SAVED_LIB = CudaLibrary("xent_saved.cu", {
    "xent_dx_s": [P] * 5 + [I] * 3 + [F, I, P],
    "xent_dw_s": [P] * 8 + [I] * 3 + [F, I, P],
    "xent_saved_plan": [I] * 4 + [P],
})
_LEAN_LIB = CudaLibrary("xent_lean.cu", {
    "xent_dx_lean": [P] * 6 + [I] * 3 + [F, I, P],
    "xent_dw_lean": [P] * 9 + [I] * 3 + [F, I, P],
    "xent_dw_lean_range_rows": [],
    "xent_lean_plan": [I, P],
})
XENT_FORWARD = Kernel("xent_fwd", _LIB, "xent_fwd",
                      replaces="tpudml/ops/xent_kernel.py:105")
XENT_FORWARD_SAVE = Kernel("xent_fwd_save", _LIB, "xent_fwd_save",
                           replaces="tpudml/ops/xent_kernel.py:111")
XENT_DX = Kernel("xent_dx_s", _SAVED_LIB, "xent_dx_s",
                 replaces="tpudml/ops/xent_kernel.py:175")
XENT_DW = Kernel("xent_dw_s", _SAVED_LIB, "xent_dw_s",
                 replaces="tpudml/ops/xent_kernel.py:199")
XENT_DX_LEAN = Kernel("xent_dx_lean", _LEAN_LIB, "xent_dx_lean",
                      replaces="tpudml/ops/xent_kernel.py:327")
XENT_DW_LEAN = Kernel("xent_dw_lean", _LEAN_LIB, "xent_dw_lean",
                      replaces="tpudml/ops/xent_kernel.py:356")

# The save_s=None threshold and the tiling rule, copied from the JAX
# package so that the same (N, V) resolves to the same mode.
SAVE_S_AUTO_MAX_BYTES = 2 * 1024**3

# How kernels 14 and 15 cut a width d (csrc/xent_lean.cu `lean_chunks`): a
# block owns LEAN_CHUNK columns of d; the chunks of one row (dX) or
# vocabulary (dW) tile form a thread-block cluster of up to LEAN_CLUSTER_MAX
# blocks that compute the scores once between them.
LEAN_CHUNK = 512
LEAN_CLUSTER_MAX = 8


def lean_plan(d: int) -> dict:
    """The lean kernels' cut of width ``d``: ``chunk`` columns a block,
    ``cluster`` blocks a cluster, and ``s_passes``, how many times the
    scores of one tile are computed (1 up to 8 chunks, d <= 4096)."""
    if d < 1:
        raise ValueError(f"d must be >= 1, got {d}")
    chunks = -(-d // LEAN_CHUNK)
    cluster = min(chunks, LEAN_CLUSTER_MAX)
    return {"chunk": LEAN_CHUNK, "cluster": cluster, "s_passes": -(-chunks // cluster)}


def lean_plan_built(d: int) -> dict:
    """:func:`lean_plan` as the built kernels decide it (``xent_lean_plan``
    of csrc/xent_lean.cu; needs nvcc: a card-only test holds the two equal)."""
    out = (ctypes.c_int * 3)()
    _LEAN_LIB.call("xent_lean_plan", I(d), ctypes.cast(out, P))
    return {"chunk": out[0], "cluster": out[1], "s_passes": out[2]}


# How kernels 10 and 11 cut their work (csrc/xent.cu `plan_fwd`): a block
# owns FWD_ROWS rows and walks a slice of the vocabulary FWD_COLS columns a
# step; the steps are cut into equal slices so that the grid fills
# FWD_FILL_SMS SMs (the H100's), one block an SM.
FWD_ROWS = 128
FWD_COLS = {torch.float32: 128, torch.bfloat16: 256}
FWD_FILL_SMS = 132
FWD_MAX_SLICES = 1024


def fwd_plan(n: int, d: int, v: int, dtype: torch.dtype) -> dict:
    """The forward kernels' cut of (N, d, V) in ``dtype``: ``rows`` a
    block, ``cols`` vocabulary columns a step, ``steps`` of them, cut into
    ``slices`` of ``slice_steps`` steps (the last may hold fewer), and
    ``blocks`` = row tiles × slices; the partials scratch is ``partials``
    = (3, slices, N) f32. The slice count takes the fewest step times over
    the grid's waves, a step added for each block's ring fill and merge,
    and the fewest slices among equals (at N = 8192: 2 slices, 128
    blocks). d does not enter the cut: every step contracts all of d."""
    if n < 1 or d < 1 or v < 1:
        raise ValueError(f"N, d, V must be >= 1, got {n}, {d}, {v}")
    cols = FWD_COLS[dtype]
    row_tiles, steps = -(-n // FWD_ROWS), -(-v // cols)
    best = None
    for s in range(1, min(steps, FWD_MAX_SLICES) + 1):
        per = -(-steps // s)
        if -(-steps // per) != s:  # no equal cut into s slices
            continue
        cost = -(-row_tiles * s // FWD_FILL_SMS) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, s, per)
    _, slices, per = best
    return {"rows": FWD_ROWS, "cols": cols, "steps": steps, "slices": slices,
            "slice_steps": per, "blocks": row_tiles * slices, "partials": (3, slices, n)}


def fwd_plan_built(n: int, d: int, v: int, dtype: torch.dtype) -> dict:
    """:func:`fwd_plan` as the built kernels decide it (``xent_fwd_plan``
    of csrc/xent.cu; needs nvcc: a card-only test holds the two equal).
    The forward wrappers size their partials scratch with it."""
    out = (ctypes.c_longlong * 6)()
    _LIB.call("xent_fwd_plan", I(n), I(d), I(v), I(int(dtype == torch.bfloat16)),
              ctypes.cast(out, P))
    keys = ("rows", "cols", "steps", "slices", "slice_steps", "blocks")
    plan = dict(zip(keys, out))
    plan["partials"] = (3, plan["slices"], n)
    return plan


# How kernels 12 and 13 cut their work (csrc/xent_saved.cu `Saved`): rows a
# dX block and vocabulary columns a dW block, by dtype; a block owns one
# SAVED_CHUNK-column chunk of d; dW sums its rows in ranges of SAVED_RANGE.
SAVED_TILE = {torch.float32: 32, torch.bfloat16: 64}
SAVED_CHUNK = 512
SAVED_RANGE = 65536


def saved_plan(n: int, d: int, v: int, dtype: torch.dtype) -> dict:
    """The saved-scores kernels' cut of (N, d, V) in ``dtype``: ``dx_rows``
    rows a dX block, ``dw_cols`` vocabulary columns a dW block, ``chunk``
    columns of d a block, ``s_reads`` (chunks of d: how many times each
    kernel reads the scores), ``range_rows`` and ``ranges`` of dW's row
    sum, and the block counts ``dx_blocks``, ``dw_blocks``."""
    if n < 1 or d < 1 or v < 1:
        raise ValueError(f"N, d, V must be >= 1, got {n}, {d}, {v}")
    tile = SAVED_TILE[dtype]
    chunks = -(-d // SAVED_CHUNK)
    ranges = -(-n // SAVED_RANGE)
    return {"dx_rows": tile, "dw_cols": tile, "chunk": SAVED_CHUNK, "s_reads": chunks,
            "range_rows": SAVED_RANGE, "ranges": ranges, "dx_blocks": -(-n // tile) * chunks,
            "dw_blocks": -(-v // tile) * chunks * ranges}


def saved_plan_built(n: int, d: int, v: int, dtype: torch.dtype) -> dict:
    """:func:`saved_plan` as the built kernels decide it (``xent_saved_plan``
    of csrc/xent_saved.cu; needs nvcc: a card-only test holds the two
    equal). :func:`xent_dw` sizes its range scratch with it."""
    out = (ctypes.c_longlong * 8)()
    _SAVED_LIB.call("xent_saved_plan", I(n), I(d), I(v), I(int(dtype == torch.bfloat16)),
                    ctypes.cast(out, P))
    keys = ("dx_rows", "dw_cols", "chunk", "s_reads", "range_rows", "ranges", "dx_blocks",
            "dw_blocks")
    return dict(zip(keys, out))


def _padded_dims(n: int, v: int, block_n: int, block_v: int):
    """The JAX kernels' tiling rule: clamp blocks to the rounded-up
    problem (rows to 8, vocab to 128), pad the problem to a block
    multiple. Returns (block_n, block_v, n_pad, v_pad)."""
    block_n = min(block_n, round_up(n, 8))
    block_v = min(block_v, round_up(v, 128))
    return block_n, block_v, round_up(n, block_n), round_up(v, block_v)


def _auto_save_s(n: int, v: int, block_n: int, block_v: int) -> bool:
    """save_s=None resolution: saved scores iff the padded f32 score
    residual fits the auto budget."""
    _, _, n_pad, v_pad = _padded_dims(n, v, block_n, block_v)
    return n_pad * v_pad * 4 <= SAVE_S_AUTO_MAX_BYTES


# ------------------------------------------------------------ plain versions


def _scores(x, w, b):
    """f32 s = x·W + b [N, V] (bf16 products are exact in f32)."""
    return x.float() @ w.float() + b.float()


def _stats(s, labels):
    """(lse, picked) [N] f32 of the scores, the kernels' label rule."""
    v = s.shape[1]
    m = s.amax(dim=-1)
    lse = m + torch.log(torch.exp(s - m[:, None]).sum(dim=-1))
    ids = labels.long()
    valid = (ids >= 0) & (ids < v)
    picked = s.gather(1, ids.clamp(0, v - 1)[:, None])[:, 0]
    return lse, torch.where(valid, picked, 0.0)


def xent_forward_reference(x, w, b, labels):
    """Plain version of :func:`xent_forward`: (lse [N], picked [N]) f32
    over the materialized scores."""
    return _stats(_scores(x, w, b), labels)


def xent_forward_save_reference(x, w, b, labels):
    """Plain version of :func:`xent_forward_save`: (lse, picked, s [N, V]
    f32)."""
    s = _scores(x, w, b)
    lse, picked = _stats(s, labels)
    return lse, picked, s


def _dlog(s, labels, lse, inv_n: float):
    """f32 dlogits (exp(s − lse) − onehot)·inv_n; out-of-range labels
    pick no column."""
    p = torch.exp(s - lse[:, None])
    cols = torch.arange(s.shape[1], device=s.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    return (p - onehot) * inv_n


def xent_dx_reference(s, w, labels, lse, inv_n: float):
    """Plain version of :func:`xent_dx`: dx [N, d] in w's dtype."""
    dlog = _dlog(s, labels, lse, inv_n).to(w.dtype).float()
    return (dlog @ w.float().T).to(w.dtype)


def xent_dw_reference(s, x, labels, lse, inv_n: float):
    """Plain version of :func:`xent_dw`: (dw [d, V] in x's dtype, db [V]
    f32 from the unrounded dlog)."""
    dlog = _dlog(s, labels, lse, inv_n)
    dw = x.float().T @ dlog.to(x.dtype).float()
    return dw.to(x.dtype), dlog.sum(dim=0)


def xent_dx_lean_reference(x, w, b, labels, lse, inv_n: float):
    """Plain version of :func:`xent_dx_lean`: the scores recomputed from
    x, W and b, then :func:`xent_dx_reference`."""
    return xent_dx_reference(_scores(x, w, b), w, labels, lse, inv_n)


def xent_dw_lean_reference(x, w, b, labels, lse, inv_n: float):
    """Plain version of :func:`xent_dw_lean`: the scores recomputed from
    x, W and b, then :func:`xent_dw_reference`."""
    return xent_dw_reference(_scores(x, w, b), x, labels, lse, inv_n)


# ------------------------------------------------------------------ kernels


def _check_forward_operands(x, w, b, labels) -> None:
    n, d = x.shape
    v = w.shape[1]
    if x.dtype not in STORAGE_DTYPES:
        raise TypeError(f"xent kernels take {STORAGE_DTYPES}, got {x.dtype}")
    check_cuda_operand("x", x, x.dtype, 2)
    check_cuda_operand("w", w, x.dtype, 2)
    check_cuda_operand("bias", b, x.dtype, 1)
    check_cuda_operand("labels", labels, torch.int32, 1)
    _check_dims(n, d, v)
    if w.shape[0] != d or b.shape != (v,) or labels.shape != (n,):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, bias "
                         f"{tuple(b.shape)}, labels {tuple(labels.shape)} disagree")
    if len({t.device for t in (x, w, b, labels)}) != 1:
        raise ValueError("x, w, bias, labels must be on one device")


def _check_dims(n: int, d: int, v: int) -> None:
    if n < 1 or d < 1 or v < 1:
        raise ValueError(f"xent kernels need N, d, V >= 1, got N={n}, d={d}, V={v}")


def _ptr_or_null(t) -> P:
    return P(None) if t is None else ptr(t)


def _is_bf16(x) -> I:
    return I(int(x.dtype == torch.bfloat16))


def _range_scratch(ranges: int, d: int, v: int, device):
    """dW's rows come in fixed ranges; beyond one, each range's f32
    partials of dW and db go to this scratch ([ranges, d, V], [ranges,
    V]), which a second pass sums in range order; (None, None) otherwise."""
    if ranges == 1:
        return None, None
    return (torch.empty((ranges, d, v), dtype=torch.float32, device=device),
            torch.empty((ranges, v), dtype=torch.float32, device=device))


def _forward_launch(kernel: Kernel, x, w, b, labels, s=None):
    n, d = x.shape
    v = w.shape[1]
    part = torch.empty(fwd_plan_built(n, d, v, x.dtype)["partials"], dtype=torch.float32,
                       device=x.device)
    lse = torch.empty((n,), dtype=torch.float32, device=x.device)
    picked = torch.empty_like(lse)
    saved = () if s is None else (ptr(s),)
    with torch.cuda.device(x.device):
        kernel.launch(ptr(x), ptr(w), ptr(b), ptr(labels), *saved, ptr(part),
                      ptr(lse), ptr(picked), I(n), I(d), I(v), _is_bf16(x))
    return lse, picked


@kernel_op
def xent_forward(x, w, b, labels):
    """(lse [N], picked [N]) f32 of s = x·W + b for x [N, d], w [d, V],
    b [V] (one dtype: f32 or bf16) and int32 labels [N]: kernel 10 for
    CUDA tensors, :func:`xent_forward_reference` for CPU tensors."""
    if not x.is_cuda:
        return xent_forward_reference(x, w, b, labels)
    _check_forward_operands(x, w, b, labels)
    return _forward_launch(XENT_FORWARD, x, w, b, labels)


@kernel_op
def xent_forward_save(x, w, b, labels):
    """As :func:`xent_forward`, also returning the f32 scores s [N, V]
    (kernel 11 on the card)."""
    if not x.is_cuda:
        return xent_forward_save_reference(x, w, b, labels)
    _check_forward_operands(x, w, b, labels)
    s = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    lse, picked = _forward_launch(XENT_FORWARD_SAVE, x, w, b, labels, s)
    return lse, picked, s


def _check_backward_operands(s, operand, labels, lse, rows: bool) -> None:
    n, v = s.shape
    if operand.dtype not in STORAGE_DTYPES:
        raise TypeError(f"xent kernels take {STORAGE_DTYPES}, got {operand.dtype}")
    check_cuda_operand("s", s, torch.float32, 2)
    check_cuda_operand("operand", operand, operand.dtype, 2)
    check_cuda_operand("labels", labels, torch.int32, 1)
    check_cuda_operand("lse", lse, torch.float32, 1)
    d = operand.shape[1] if rows else operand.shape[0]
    want = (n, d) if rows else (d, v)
    _check_dims(n, d, v)
    if tuple(operand.shape) != want or labels.shape != (n,) or lse.shape != (n,):
        raise ValueError(f"shapes s {tuple(s.shape)}, operand {tuple(operand.shape)}, "
                         f"labels {tuple(labels.shape)}, lse {tuple(lse.shape)} disagree")
    if len({t.device for t in (s, operand, labels, lse)}) != 1:
        raise ValueError("s, operand, labels, lse must be on one device")


@kernel_op
def xent_dx(s, w, labels, lse, inv_n: float):
    """dx [N, d] = dlog·Wᵀ in w's dtype from the saved f32 scores s [N, V]
    (contiguous, unpadded): kernel 12 for CUDA tensors,
    :func:`xent_dx_reference` for CPU ones."""
    if not s.is_cuda:
        return xent_dx_reference(s, w, labels, lse, inv_n)
    _check_backward_operands(s, w, labels, lse, rows=False)
    n, v = s.shape
    d = w.shape[0]
    dx = torch.empty((n, d), dtype=w.dtype, device=s.device)
    with torch.cuda.device(s.device):
        XENT_DX.launch(ptr(s), ptr(w), ptr(labels), ptr(lse), ptr(dx), I(n),
                       I(d), I(v), F(inv_n), _is_bf16(w))
    return dx


@kernel_op
def xent_dw(s, x, labels, lse, inv_n: float):
    """(dw [d, V] = xᵀ·dlog in x's dtype, db [V] f32) from the saved f32
    scores: kernel 13 for CUDA tensors, :func:`xent_dw_reference` for CPU
    ones."""
    if not s.is_cuda:
        return xent_dw_reference(s, x, labels, lse, inv_n)
    _check_backward_operands(s, x, labels, lse, rows=True)
    n, v = s.shape
    d = x.shape[1]
    dw = torch.empty((d, v), dtype=x.dtype, device=s.device)
    db = torch.empty((v,), dtype=torch.float32, device=s.device)
    part, db_part = _range_scratch(saved_plan_built(n, d, v, x.dtype)["ranges"], d, v,
                                   s.device)
    with torch.cuda.device(s.device):
        XENT_DW.launch(ptr(s), ptr(x), ptr(labels), ptr(lse), ptr(dw), ptr(db),
                       _ptr_or_null(part), _ptr_or_null(db_part), I(n), I(d), I(v),
                       F(inv_n), _is_bf16(x))
    return dw, db


def _check_lean_operands(x, w, b, labels, lse) -> None:
    _check_forward_operands(x, w, b, labels)
    check_cuda_operand("lse", lse, torch.float32, 1)
    if lse.shape != labels.shape or lse.device != x.device:
        raise ValueError(f"lse {tuple(lse.shape)} on {lse.device} does not match "
                         f"labels {tuple(labels.shape)} on {x.device}")


@kernel_op
def xent_dx_lean(x, w, b, labels, lse, inv_n: float):
    """dx [N, d] in x's dtype, recomputing the scores from x [N, d], w
    [d, V], b [V] (one dtype) and int32 labels [N] with the forward's lse
    [N] f32: kernel 14 for CUDA tensors, :func:`xent_dx_lean_reference`
    for CPU ones."""
    if not x.is_cuda:
        return xent_dx_lean_reference(x, w, b, labels, lse, inv_n)
    _check_lean_operands(x, w, b, labels, lse)
    n, d = x.shape
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        XENT_DX_LEAN.launch(ptr(x), ptr(w), ptr(b), ptr(labels), ptr(lse), ptr(dx),
                            I(n), I(d), I(w.shape[1]), F(inv_n), _is_bf16(x))
    return dx


@kernel_op
def xent_dw_lean(x, w, b, labels, lse, inv_n: float):
    """(dw [d, V] in w's dtype, db [V] f32) from the same operands as
    :func:`xent_dx_lean`: kernel 15 for CUDA tensors,
    :func:`xent_dw_lean_reference` for CPU ones."""
    if not x.is_cuda:
        return xent_dw_lean_reference(x, w, b, labels, lse, inv_n)
    _check_lean_operands(x, w, b, labels, lse)
    n, d = x.shape
    v = w.shape[1]
    dw = torch.empty_like(w)
    db = torch.empty((v,), dtype=torch.float32, device=x.device)
    ranges = -(-n // XENT_DW_LEAN.library.load().xent_dw_lean_range_rows())
    part, db_part = _range_scratch(ranges, d, v, x.device)
    with torch.cuda.device(x.device):
        XENT_DW_LEAN.launch(ptr(x), ptr(w), ptr(b), ptr(labels), ptr(lse), ptr(dw),
                            ptr(db), _ptr_or_null(part), _ptr_or_null(db_part), I(n),
                            I(d), I(v), F(inv_n), _is_bf16(x))
    return dw, db


# ---------------------------------------------------------------- autograd


def _scale_cotangents(g, dx, dw, db, dtypes):
    """1/N is scaled inside the kernels; the cotangent g multiplies here,
    each gradient cast back to its input's dtype (None stays None)."""
    gf = g.float()
    return tuple(None if t is None else (t.float() * gf).to(dt)
                 for t, dt in zip((dx, dw, db), dtypes))


class _LinearXentSaved(torch.autograd.Function):
    """Saved-scores mode: kernel 11 forward, kernels 12 and 13 backward."""

    @staticmethod
    def forward(ctx, x, w, b, labels):
        lse, picked, s = xent_forward_save(x, w, b, labels)
        ctx.save_for_backward(x, w, labels, lse, s)
        ctx.dtypes = (x.dtype, w.dtype, b.dtype)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse, s = ctx.saved_tensors
        inv_n = 1.0 / x.shape[0]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = xent_dx(s, w, labels, lse, inv_n)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = xent_dw(s, x, labels, lse, inv_n)
        return (*_scale_cotangents(g, dx, dw, db, ctx.dtypes), None)


class _LinearXentLean(torch.autograd.Function):
    """Lean mode: kernel 10 forward, saving x, W, b, labels and lse
    (O(N + parameters)); kernels 14 and 15 recompute the scores in the
    backward."""

    @staticmethod
    def forward(ctx, x, w, b, labels):
        lse, picked = xent_forward(x, w, b, labels)
        ctx.save_for_backward(x, w, b, labels, lse)
        ctx.dtypes = (x.dtype, w.dtype, b.dtype)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, lse = ctx.saved_tensors
        inv_n = 1.0 / x.shape[0]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = xent_dx_lean(x, w, b, labels, lse, inv_n)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = xent_dw_lean(x, w, b, labels, lse, inv_n)
        return (*_scale_cotangents(g, dx, dw, db, ctx.dtypes), None)


@marked(FUSED_XENT_MARKER)
def linear_cross_entropy(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                         bias: torch.Tensor | None = None, *,
                         block_n: int = 256, block_v: int = 2048,
                         save_s: bool | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy of ``x @ w [+ bias]`` against integer
    ``labels`` (module docstring). ``x`` [..., d] flattens to [N, d] and
    ``labels`` [...] to [N]; ``w`` is the full [d, V] head. ``block_n`` and
    ``block_v`` are the JAX kernels' tiles: here they only decide
    ``save_s=None`` (``_auto_save_s``: saved scores while their padded f32
    residual fits ``SAVE_S_AUTO_MAX_BYTES``, the lean backward beyond); the
    card's kernels tile for themselves. ``save_s=False`` forces the lean
    O(N) backward whatever the size."""
    d = x.shape[-1]
    v = w.shape[-1]
    xn = x.reshape(-1, d)
    ln = labels.reshape(-1)
    if xn.shape[0] != ln.shape[0]:
        raise ValueError(f"{tuple(x.shape)} rows != {tuple(labels.shape)} labels")
    if save_s is None:
        save_s = _auto_save_s(xn.shape[0], v, block_n, block_v)
    b = torch.zeros((v,), dtype=w.dtype, device=w.device) if bias is None else bias
    ln = ln.to(torch.int32)
    if xn.is_cuda:
        xn, w, b, ln = (t.contiguous() for t in (xn, w, b, ln))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xn, w, b)):
        mode = _LinearXentSaved if save_s else _LinearXentLean
        return mode.apply(xn, w, b, ln)
    lse, picked = xent_forward(xn, w, b, ln)
    return (lse - picked).mean()


# ------------------------------------------------------- the vocab-sharded head
#
# Each rank of a group holds a [d, V/W] shard of W (and its slice of the
# bias) and the same rows x. The forward runs kernel 11 (saved scores) or
# 10 (lean) on the shard with the labels shifted by shard·V/W: a label
# outside the shard, negative ones included, picks nothing, the kernels'
# own rule. The shards' (lse, picked) merge into the global ones (one pmax
# and one sum for lse, one sum for picked). p = exp(s − lse_global) is this
# shard's slice of the global softmax, so the backward kernels (12 and 13,
# or 14 and 15) run unchanged on the shard with the merged lse and give dW
# and db of the shard with no collective; dX is the shard's partial sum,
# all-reduced over the group before it goes back to the trunk. The loss is
# replicated and each rank differentiates it with cotangent 1, so no factor
# is restored: JAX's psum of the cotangent makes up for shard_map's
# transpose convention, which the port does not have.


def sharded_xent_forward(x, w, b, labels, shard: int, save_s: bool):
    """One vocab shard's forward: kernel 11 (``save_s``) or 10 on ``w``
    [d, V_local] and ``b`` [V_local] with int32 ``labels`` shifted by
    ``shard``·V_local. Returns (the shifted labels, lse_local [N],
    picked_local [N], the f32 scores [N, V_local] or None)."""
    ln = labels - shard * w.shape[1]
    if save_s:
        lse, picked, s = xent_forward_save(x, w, b, ln)
        return ln, lse, picked, s
    lse, picked = xent_forward(x, w, b, ln)
    return ln, lse, picked, None


def sharded_xent_backward(x, w, b, ln, lse, s, inv_n: float, need_dx: bool = True,
                          need_dw: bool = True):
    """One vocab shard's backward from the MERGED lse: (dx [N, d], this
    shard's partial sum over its vocabulary; dw [d, V_local]; db [V_local]
    f32), kernels 12 and 13 from the saved scores ``s`` or 14 and 15
    (``s`` None); a gradient not needed is None."""
    dx = dw = db = None
    if s is not None:
        if need_dx:
            dx = xent_dx(s, w, ln, lse, inv_n)
        if need_dw:
            dw, db = xent_dw(s, x, ln, lse, inv_n)
    else:
        if need_dx:
            dx = xent_dx_lean(x, w, b, ln, lse, inv_n)
        if need_dw:
            dw, db = xent_dw_lean(x, w, b, ln, lse, inv_n)
    return dx, dw, db


def sharded_xent_in_one_process(x, w, b, labels, shards: int, save_s: bool):
    """The vocab-sharded head's halves over ``shards`` equal shards of ``w``
    in ONE process, as one card can run them: each shard's
    :func:`sharded_xent_forward` on its contiguous columns, the lse merged
    by ``torch.logsumexp`` over the stacked shards and picked summed, each
    shard's :func:`sharded_xent_backward` with the merged lse. Returns
    (loss, dx summed over the shards in f32, dw and db concatenated)."""
    vl = w.shape[1] // shards
    parts = []
    for k in range(shards):
        ws, bs = w[:, k * vl:(k + 1) * vl].contiguous(), b[k * vl:(k + 1) * vl].contiguous()
        parts.append((ws, bs, *sharded_xent_forward(x, ws, bs, labels, k, save_s)))
    lse = torch.logsumexp(torch.stack([p[3] for p in parts]), dim=0)
    loss = (lse - torch.stack([p[4] for p in parts]).sum(dim=0)).mean()
    dx, dws, dbs = 0.0, [], []
    for ws, bs, ln, _, _, s in parts:
        gx, gw, gb = sharded_xent_backward(x, ws, bs, ln, lse, s, 1.0 / x.shape[0])
        dx = dx + gx.float()
        dws.append(gw)
        dbs.append(gb)
    return loss, dx, torch.cat(dws, dim=1), torch.cat(dbs)


class _ShardedLinearXent(torch.autograd.Function):
    """The vocab-sharded head (comment above): the kernels on this rank's
    shard, the statistics merged over ``group``; dX all-reduced over it
    (``reduce_dx``) or left as the shard's partial."""

    @staticmethod
    def forward(ctx, x, w, b, labels, group, save_s: bool, reduce_dx: bool):
        from tpudml_torch.comm.collectives import plogsumexp, psum_tree

        ln, lse_loc, picked_loc, s = sharded_xent_forward(x, w, b, labels,
                                                          dist.get_rank(group), save_s)
        lse = plogsumexp(lse_loc, group)
        picked = psum_tree(picked_loc, group)
        ctx.save_for_backward(x, w, b, ln, lse, s)
        ctx.group, ctx.reduce_dx = group, reduce_dx
        ctx.dtypes = (x.dtype, w.dtype, b.dtype)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, b, ln, lse, s = ctx.saved_tensors
        dx, dw, db = sharded_xent_backward(
            x, w, b, ln, lse, s, 1.0 / x.shape[0], ctx.needs_input_grad[0],
            ctx.needs_input_grad[1] or ctx.needs_input_grad[2])
        dx, dw, db = _scale_cotangents(g, dx, dw, db, ctx.dtypes)
        if dx is not None and ctx.reduce_dx:
            dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=ctx.group)
        return dx, dw, db, None, None, None, None


def sharded_xent_reference(x, w, b, labels, group, reduce_dx: bool = True):
    """Plain version of the vocab-sharded head (JAX's ``_sharded_reference``):
    this shard's f32 scores, the same merge, autograd; dX summed over the
    group (``reduce_dx``) or the shard's partial."""
    from tpudml_torch.comm.collectives import _ReplicatedSum, plogsumexp, sum_cotangent

    if reduce_dx:
        x = sum_cotangent(x, group)
    v_local = w.shape[1]
    ln = labels.long() - dist.get_rank(group) * v_local
    logits = _scores(x, w, b)
    lse = plogsumexp(torch.logsumexp(logits, dim=-1), group)
    valid = (ln >= 0) & (ln < v_local)
    picked = logits.gather(1, ln.clamp(0, v_local - 1)[:, None])[:, 0]
    picked = _ReplicatedSum.apply(torch.where(valid, picked, 0.0), group)
    return (lse - picked).mean()


@marked(SHARDED_XENT_MARKER)
def sharded_linear_cross_entropy(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                                 bias: torch.Tensor | None = None, *, group,
                                 block_n: int = 256, block_v: int = 2048,
                                 save_s: bool | None = None,
                                 reduce_dx: bool = True) -> torch.Tensor:
    """Vocab-sharded :func:`linear_cross_entropy` over the process group
    ``group`` (JAX's ``axis_name``): ``w`` is this rank's [d, V/W] shard,
    the one of rank ``dist.get_rank(group)``, ``bias`` its [V/W] slice,
    ``labels`` GLOBAL ids; every rank holds the same ``x`` rows. Returns
    the replicated global mean loss, equal to the unsharded call on the
    concatenated W. ``save_s=None`` resolves on the LOCAL vocabulary
    (``_auto_save_s(N, V/W, ...)``: each shard keeps 1/W of the scores).
    dW and db are this shard's; dX is summed over the group, or left as
    the shard's partial with ``reduce_dx=False`` (for a caller that sums it
    into token shards itself, as the 1-D FSDP head reduce-scatters it).
    CUDA tensors run kernels 10–15 on the shard; CPU tensors run the plain
    version :func:`sharded_xent_reference`."""
    d = x.shape[-1]
    v_local = w.shape[-1]
    xn = x.reshape(-1, d)
    ln = labels.reshape(-1)
    if xn.shape[0] != ln.shape[0]:
        raise ValueError(f"{tuple(x.shape)} rows != {tuple(labels.shape)} labels")
    if save_s is None:
        save_s = _auto_save_s(xn.shape[0], v_local, block_n, block_v)
    b = torch.zeros((v_local,), dtype=w.dtype, device=w.device) if bias is None else bias
    ln = ln.to(torch.int32)
    if not xn.is_cuda:
        return sharded_xent_reference(xn, w, b, ln, group, reduce_dx)
    xn, w, b, ln = (t.contiguous() for t in (xn, w, b, ln))
    return _ShardedLinearXent.apply(xn, w, b, ln, group, bool(save_s), reduce_dx)
