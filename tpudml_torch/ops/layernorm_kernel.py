"""Fused residual add + LayerNorm: the port of
``tpudml/ops/layernorm_kernel.py`` ``fused_add_layernorm`` (Pallas
``_add_ln_fwd_kernel`` and ``_add_ln_bwd_kernel``).

At every residual junction of the ``fused_ln`` trunk, ``s = x + r`` and
``y = LayerNorm(s)`` come out of one kernel, and the backward folds the
downstream cotangent of ``s`` into the LayerNorm input gradient:

    g  = dy·γ
    dx = rstd · (g − mean(g) − ŝ·mean(g·ŝ)) + ds       (= dr as well)
    dγ = Σ_rows dy·ŝ,   dβ = Σ_rows dy

- :func:`add_layernorm_forward` / :func:`add_layernorm_backward` launch
  the CUDA kernels (``tpudml_torch/csrc/add_layernorm.cu``) for CUDA
  tensors and run their plain versions (``*_reference``) for CPU tensors;
  a CUDA input the kernels do not take raises, nothing falls back.
- :func:`fused_add_layernorm` is the ``torch.autograd.Function`` over the
  two, returning ``(s, y)``. When ``s`` has no downstream use (the final
  ``ln_f`` junction) autograd hands its backward no ``ds``, and the kernel
  gets a null pointer, not a zeros tensor.

Statistics follow the JAX package: f32, single pass, variance
E[s²] − mean² clamped at 0, eps 1e-5; ``s`` is rounded to the stream
dtype before the statistics. Each kernel has an f32 and a bf16 twin (its
own ``Kernel`` and launch counter, ``*_bf16``), chosen by the rows' dtype:
the bf16 twins read and write the rows (x, r, s, y; s, dy, ds, dx) in
bf16 and keep γ, β, the statistics and dγ, dβ in f32.
"""

from __future__ import annotations

import torch

from tpudml_torch.ops.cuda_lib import (
    F, I, P, CudaLibrary, Kernel, check_cuda_operand, ptr, storage_twin,
)

MAX_DIM = 1024  # widest row the kernels keep in registers (32 floats a lane)
BWD_ROWS_PER_BLOCK = 32  # backward rows per block = rows per dγ/dβ partial

_FWD_ARGS = [P] * 8 + [I, I, F, P]
_BWD_ARGS = [P] * 10 + [I, I, I, P]
_LIB = CudaLibrary("add_layernorm.cu", {
    "add_ln_fwd_f32": _FWD_ARGS, "add_ln_fwd_bf16": _FWD_ARGS,
    "add_ln_bwd_f32": _BWD_ARGS, "add_ln_bwd_bf16": _BWD_ARGS,
})
_FWD_AT = "tpudml/ops/layernorm_kernel.py:225"
_BWD_AT = "tpudml/ops/layernorm_kernel.py:231"
ADD_LN_FORWARD = Kernel("add_layernorm_fwd", _LIB, "add_ln_fwd_f32", replaces=_FWD_AT)
ADD_LN_FORWARD_BF16 = Kernel("add_layernorm_fwd_bf16", _LIB, "add_ln_fwd_bf16",
                             replaces=_FWD_AT)
ADD_LN_BACKWARD = Kernel("add_layernorm_bwd", _LIB, "add_ln_bwd_f32", replaces=_BWD_AT)
ADD_LN_BACKWARD_BF16 = Kernel("add_layernorm_bwd_bf16", _LIB, "add_ln_bwd_bf16",
                              replaces=_BWD_AT)


def add_layernorm_forward_reference(x, r, scale, bias, eps: float = 1e-5):
    """Plain version over rows [N, d]: (s, y, mean [N] f32, rstd [N] f32)."""
    s = x + r
    sf = s.float()
    m = sf.mean(dim=-1)
    var = (sf.square().mean(dim=-1) - m.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    y = (sf - m[:, None]) * rstd[:, None] * scale.float() + bias.float()
    return s, y.to(s.dtype), m, rstd


def add_layernorm_backward_reference(s, scale, dy, ds, mean, rstd):
    """Plain version over rows [N, d]: (dx, dγ f32, dβ f32); ``ds`` may be
    None."""
    xhat = (s.float() - mean[:, None]) * rstd[:, None]
    dyf = dy.float()
    gy = dyf * scale.float()
    dx = rstd[:, None] * (gy - gy.mean(dim=-1, keepdim=True)
                          - xhat * (gy * xhat).mean(dim=-1, keepdim=True))
    if ds is not None:
        dx = dx + ds.float()
    return dx.to(s.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def _check_rows(named, n: int, d: int) -> None:
    dtype = named[0][1].dtype
    for name, t in named:
        check_cuda_operand(name, t, dtype, 2)
        if t.shape != (n, d):
            raise ValueError(f"{name} must be [{n}, {d}], got {tuple(t.shape)}")


def _check_vecs(named, length: int) -> None:
    for name, t in named:
        check_cuda_operand(name, t, torch.float32, 1)
        if t.shape != (length,):
            raise ValueError(f"{name} must be [{length}], got {tuple(t.shape)}")


def _check_width(d: int) -> None:
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"add+LN kernel width must be in [1, {MAX_DIM}], got {d}")


def add_layernorm_forward(x: torch.Tensor, r: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          eps: float = 1e-5):
    """(s, y, mean, rstd) for rows x, r [N, d]: the forward kernel for CUDA
    tensors (f32 or bf16 rows, f32 scale and bias, contiguous,
    d <= ``MAX_DIM``), the plain version for CPU tensors."""
    if not x.is_cuda:
        return add_layernorm_forward_reference(x, r, scale, bias, eps)
    n, d = x.shape
    kernel = storage_twin(x, ADD_LN_FORWARD, ADD_LN_FORWARD_BF16)
    _check_width(d)
    _check_rows((("x", x), ("r", r)), n, d)
    _check_vecs((("scale", scale), ("bias", bias)), d)
    s = torch.empty_like(x)
    y = torch.empty_like(x)
    mean = torch.empty((n,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        kernel.launch(
            ptr(x), ptr(r), ptr(scale), ptr(bias), ptr(s), ptr(y), ptr(mean),
            ptr(rstd), I(n), I(d), F(eps),
        )
    return s, y, mean, rstd


def add_layernorm_backward(s: torch.Tensor, scale: torch.Tensor,
                           dy: torch.Tensor, ds: torch.Tensor | None,
                           mean: torch.Tensor, rstd: torch.Tensor):
    """(dx, dγ, dβ) for rows [N, d]: the backward kernel (row pass plus the
    block-ordered dγ/dβ column sum, one launch) for CUDA tensors, the plain
    version for CPU tensors. ``ds`` None merges nothing."""
    if not s.is_cuda:
        return add_layernorm_backward_reference(s, scale, dy, ds, mean, rstd)
    n, d = s.shape
    kernel = storage_twin(s, ADD_LN_BACKWARD, ADD_LN_BACKWARD_BF16)
    _check_width(d)
    rows = (("s", s), ("dy", dy)) + ((("ds", ds),) if ds is not None else ())
    _check_rows(rows, n, d)
    _check_vecs((("scale", scale),), d)
    _check_vecs((("mean", mean), ("rstd", rstd)), n)
    dx = torch.empty_like(s)
    dgamma = torch.empty((d,), dtype=torch.float32, device=s.device)
    dbeta = torch.empty_like(dgamma)
    blocks = -(-n // BWD_ROWS_PER_BLOCK)
    part = torch.empty((2, blocks, d), dtype=torch.float32, device=s.device)
    with torch.cuda.device(s.device):
        kernel.launch(
            ptr(s), ptr(scale), ptr(dy), P(None) if ds is None else ptr(ds),
            ptr(mean), ptr(rstd), ptr(dx), ptr(dgamma), ptr(dbeta), ptr(part),
            I(n), I(d), I(BWD_ROWS_PER_BLOCK),
        )
    return dx, dgamma, dbeta


class _FusedAddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, scale, bias, eps):
        s, y, mean, rstd = add_layernorm_forward(x, r, scale, bias, eps)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(s, scale, mean, rstd)
        ctx.dtypes = (scale.dtype, bias.dtype)
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, scale, mean, rstd = ctx.saved_tensors
        if dy is None:  # y unused downstream: only the residual passes
            return ds, ds, None, None, None
        dx, dgamma, dbeta = add_layernorm_backward(
            s, scale, dy.contiguous(), None if ds is None else ds.contiguous(),
            mean, rstd)
        # d(x) = d(r) = dx: the sum hands its cotangent to both addends.
        return (dx, dx, dgamma.to(ctx.dtypes[0]), dbeta.to(ctx.dtypes[1]),
                None)


def fused_add_layernorm(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, *, eps: float = 1e-5):
    """Residual-junction fusion: ``(s, y)`` with ``s = x + r`` and
    ``y = LayerNorm(s)`` over the trailing axis of x, r [..., d], one
    kernel per direction on the card (module docstring)."""
    d = x.shape[-1]
    if x.shape != r.shape:
        raise ValueError(f"x {tuple(x.shape)} != r {tuple(r.shape)}")
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(
            f"scale/bias {tuple(scale.shape)}/{tuple(bias.shape)} must be ({d},)"
        )
    s, y = _FusedAddLayerNorm.apply(x.reshape(-1, d), r.reshape(-1, d),
                                    scale, bias, eps)
    return s.reshape(x.shape), y.reshape(x.shape)
