"""Fused linear cross-entropy: the port of ``tpudml/ops/xent_kernel.py``
``linear_cross_entropy`` in its saved-scores mode (Pallas ``_fwd_kernel``,
``_fwd_kernel_save``, ``_dx_s_kernel``, ``_dw_s_kernel``).

The LM head's ``x @ W + b`` and the mean softmax cross-entropy against
integer labels, without the [N, V] logits ever being a tensor of the
caller: on the card, the forward kernel writes the f32 scores once for
the backward (1 GiB at N = 8192, V = 32768) and reduces them to per-row
(lse, picked); the two backward kernels build dlogits from those scores
while staging them and contract it with W (dX) and x (dW, db). CUDA
sources: ``tpudml_torch/csrc/xent.cu``.

- :func:`xent_forward` / :func:`xent_forward_save` launch kernel 10 / 11
  for CUDA tensors; :func:`xent_dx` / :func:`xent_dw` launch kernels 12
  and 13; each has a plain PyTorch version (``*_reference``), which CPU
  tensors run. A CUDA input the kernels do not take raises: nothing falls
  back.
- :func:`linear_cross_entropy` is the JAX package's entry point. When a
  gradient is needed it runs the ``torch.autograd.Function`` (kernel 11
  forward, saving the f32 scores; kernels 12 and 13 backward); under
  ``torch.no_grad()``, or when no input requires grad, it runs kernel 10,
  as JAX runs the ``custom_vjp`` primal outside differentiation.

Semantics, as in the JAX package:
- scores are f32 whatever the operand dtype; loss = mean(lse − picked);
- a label outside [0, V) gives picked = 0 (loss = lse) and a zero one-hot:
  it is NOT clamped to an edge class as ``softmax_cross_entropy`` does;
- dlog = (exp(s − lse) − onehot)·(1/N) is rounded to the operand dtype
  before each backward product; 1/N is applied inside the kernels and the
  cotangent g multiplies outside (``_scale_cotangents``);
- dX is stored in x's dtype and dW in W's; db is summed in f32 from the
  unrounded dlog, then cast to the bias dtype.

Only the saved-scores backward is ported. ``save_s`` resolves as in JAX
(``_auto_save_s``: saved scores while the padded f32 residual fits
``SAVE_S_AUTO_MAX_BYTES``); the lean recompute backward (kernels 14, 15)
is not ported, and a call that resolves to it raises.
"""

from __future__ import annotations

import torch

from tpudml_torch.ops.cuda_lib import (
    F, I, P, STORAGE_DTYPES, CudaLibrary, Kernel, check_cuda_operand, ptr,
)
from tpudml_torch.ops.tiling import round_up

LEAN_NOT_PORTED = (
    "the lean recompute backward of the fused linear-xent head (save_s=False) "
    "is not ported yet: ROADMAP.md queue 2 kernels 14 and 15"
)
MAX_DIM = 1024  # widest d the wrappers take (bench.py's large config)

_LIB = CudaLibrary("xent.cu", {
    "xent_fwd": [P] * 7 + [I] * 4 + [P],
    "xent_fwd_save": [P] * 8 + [I] * 4 + [P],
    "xent_dx_s": [P] * 5 + [I] * 3 + [F, I, P],
    "xent_dw_s": [P] * 6 + [I] * 3 + [F, I, P],
    "xent_tile_width": [],
})
XENT_FORWARD = Kernel("xent_fwd", _LIB, "xent_fwd",
                      replaces="tpudml/ops/xent_kernel.py:105")
XENT_FORWARD_SAVE = Kernel("xent_fwd_save", _LIB, "xent_fwd_save",
                           replaces="tpudml/ops/xent_kernel.py:111")
XENT_DX = Kernel("xent_dx_s", _LIB, "xent_dx_s",
                 replaces="tpudml/ops/xent_kernel.py:175")
XENT_DW = Kernel("xent_dw_s", _LIB, "xent_dw_s",
                 replaces="tpudml/ops/xent_kernel.py:199")

# The save_s=None threshold and the tiling rule, copied from the JAX
# package so that the same (N, V) resolves to the same mode.
SAVE_S_AUTO_MAX_BYTES = 2 * 1024**3


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
    if d % 8 or not 8 <= d <= MAX_DIM:
        raise ValueError(f"xent kernels take d a multiple of 8 up to {MAX_DIM}, got {d}")
    if n < 1 or v < 1:
        raise ValueError(f"xent kernels need N, V >= 1, got N={n}, V={v}")


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


# ---------------------------------------------------------------- autograd


class _LinearXentSaved(torch.autograd.Function):
    """Saved-scores mode: kernel 11 forward, kernels 12 and 13 backward."""

    @staticmethod
    def forward(ctx, x, w, b, labels):
        lse, picked, s = xent_forward_save(x, w, b, labels)
        ctx.save_for_backward(x, w, labels, lse, s)
        ctx.bias_dtype = b.dtype
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
        # _scale_cotangents: 1/N scaled inside the kernels, g multiplies here.
        gf = g.float()
        if dx is not None:
            dx = (dx.float() * gf).to(x.dtype)
        if dw is not None:
            dw = (dw.float() * gf).to(w.dtype)
            db = (db * gf).to(ctx.bias_dtype)
        return dx, dw, db, None


def linear_cross_entropy(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                         bias: torch.Tensor | None = None, *,
                         block_n: int = 256, block_v: int = 2048,
                         save_s: bool | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy of ``x @ w [+ bias]`` against integer
    ``labels`` (module docstring). ``x`` [..., d] flattens to [N, d] and
    ``labels`` [...] to [N]; ``w`` is the full [d, V] head. ``block_n`` and
    ``block_v`` are the JAX kernels' tiles: here they only decide
    ``save_s=None`` (``_auto_save_s``), the card's kernels tile for
    themselves. A ``save_s`` that resolves to False (the lean backward)
    raises ``NotImplementedError``."""
    d = x.shape[-1]
    v = w.shape[-1]
    xn = x.reshape(-1, d)
    ln = labels.reshape(-1)
    if xn.shape[0] != ln.shape[0]:
        raise ValueError(f"{tuple(x.shape)} rows != {tuple(labels.shape)} labels")
    if save_s is None:
        save_s = _auto_save_s(xn.shape[0], v, block_n, block_v)
    if not save_s:
        raise NotImplementedError(LEAN_NOT_PORTED)
    b = torch.zeros((v,), dtype=w.dtype, device=w.device) if bias is None else bias
    ln = ln.to(torch.int32)
    if xn.is_cuda:
        xn, w, b, ln = (t.contiguous() for t in (xn, w, b, ln))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xn, w, b)):
        return _LinearXentSaved.apply(xn, w, b, ln)
    lse, picked = xent_forward(xn, w, b, ln)
    return (lse - picked).mean()
