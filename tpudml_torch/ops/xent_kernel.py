"""Fused linear cross-entropy: the port of ``tpudml/ops/xent_kernel.py``
``linear_cross_entropy`` (Pallas ``_fwd_kernel``, ``_fwd_kernel_save``,
``_dx_s_kernel``, ``_dw_s_kernel``, ``_dx_kernel``, ``_dw_kernel``).

The LM head's ``x @ W + b`` and the mean softmax cross-entropy against
integer labels, without the [N, V] logits ever being a tensor of the
caller. Two backward modes, as in JAX:

- saved scores: the forward kernel writes the f32 scores once for the
  backward (1 GiB at N = 8192, V = 32768) and reduces them to per-row
  (lse, picked); the two backward kernels build dlogits from those scores
  while staging them and contract it with W (dX) and x (dW, db);
- lean: the forward keeps only lse (O(N + parameters) residuals), and the
  two backward kernels recompute the scores tile by tile from x, W and b
  before contracting dlogits, so nothing of size N·V exists in either
  direction (the 131k-token regime, where the scores alone are 16 GiB).

CUDA sources: ``tpudml_torch/csrc/xent.cu`` (kernels 10–13) and
``tpudml_torch/csrc/xent_lean.cu`` (the lean kernels 14, 15). The kernels
take any width d >= 1: a ragged contraction edge is masked inside them (W
is never padded); the lean kernels give each 512-column chunk of d a block
of one thread-block cluster (:func:`lean_plan`).

- :func:`xent_forward` / :func:`xent_forward_save` launch kernel 10 / 11
  for CUDA tensors; :func:`xent_dx` / :func:`xent_dw` launch kernels 12
  and 13, :func:`xent_dx_lean` / :func:`xent_dw_lean` kernels 14 and 15;
  each has a plain PyTorch version (``*_reference``), which CPU tensors
  run. A CUDA input the kernels do not take raises: nothing falls back.
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

from tpudml_torch.ops.cuda_lib import (
    F, I, P, STORAGE_DTYPES, CudaLibrary, Kernel, check_cuda_operand, ptr,
)
from tpudml_torch.ops.tiling import round_up

_LIB = CudaLibrary("xent.cu", {
    "xent_fwd": [P] * 7 + [I] * 4 + [P],
    "xent_fwd_save": [P] * 8 + [I] * 4 + [P],
    "xent_dx_s": [P] * 5 + [I] * 3 + [F, I, P],
    "xent_dw_s": [P] * 6 + [I] * 3 + [F, I, P],
    "xent_tile_width": [],
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
XENT_DX = Kernel("xent_dx_s", _LIB, "xent_dx_s",
                 replaces="tpudml/ops/xent_kernel.py:175")
XENT_DW = Kernel("xent_dw_s", _LIB, "xent_dw_s",
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


def _forward_launch(kernel: Kernel, x, w, b, labels, s=None):
    n, d = x.shape
    v = w.shape[1]
    tiles = -(-v // kernel.library.load().xent_tile_width())
    part = torch.empty((3, tiles, n), dtype=torch.float32, device=x.device)
    lse = torch.empty((n,), dtype=torch.float32, device=x.device)
    picked = torch.empty_like(lse)
    saved = () if s is None else (ptr(s),)
    with torch.cuda.device(x.device):
        kernel.launch(ptr(x), ptr(w), ptr(b), ptr(labels), *saved, ptr(part),
                      ptr(lse), ptr(picked), I(n), I(d), I(v), _is_bf16(x))
    return lse, picked


def xent_forward(x, w, b, labels):
    """(lse [N], picked [N]) f32 of s = x·W + b for x [N, d], w [d, V],
    b [V] (one dtype: f32 or bf16) and int32 labels [N]: kernel 10 for
    CUDA tensors, :func:`xent_forward_reference` for CPU tensors."""
    if not x.is_cuda:
        return xent_forward_reference(x, w, b, labels)
    _check_forward_operands(x, w, b, labels)
    return _forward_launch(XENT_FORWARD, x, w, b, labels)


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


def xent_dx(s, w, labels, lse, inv_n: float):
    """dx [N, d] = dlog·Wᵀ in w's dtype from the saved f32 scores s [N, V]:
    kernel 12 for CUDA tensors, :func:`xent_dx_reference` for CPU ones."""
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
    with torch.cuda.device(s.device):
        XENT_DW.launch(ptr(s), ptr(x), ptr(labels), ptr(lse), ptr(dw), ptr(db),
                       I(n), I(d), I(v), F(inv_n), _is_bf16(x))
    return dw, db


def _check_lean_operands(x, w, b, labels, lse) -> None:
    _check_forward_operands(x, w, b, labels)
    check_cuda_operand("lse", lse, torch.float32, 1)
    if lse.shape != labels.shape or lse.device != x.device:
        raise ValueError(f"lse {tuple(lse.shape)} on {lse.device} does not match "
                         f"labels {tuple(labels.shape)} on {x.device}")


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
    # Rows come in fixed ranges; beyond one, each range's f32 partials go to
    # scratch that a second pass sums in range order.
    ranges = -(-n // XENT_DW_LEAN.library.load().xent_dw_lean_range_rows())
    part = db_part = None
    if ranges > 1:
        part = torch.empty((ranges, d, v), dtype=torch.float32, device=x.device)
        db_part = torch.empty((ranges, v), dtype=torch.float32, device=x.device)
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
