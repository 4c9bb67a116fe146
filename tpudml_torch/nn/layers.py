"""Dense, Conv2D, BatchNorm and LayerNorm: the port of
``tpudml/nn/layers.py`` (the LM's and the ResNet's subset).

Parameters keep the JAX package's names, and its layout where torch
computes in it — ``Dense.kernel`` is [in, out] and ``y = x @ kernel +
bias``; ``LayerNorm`` and ``BatchNorm`` have ``scale`` and ``bias`` — so
a ``tpudml`` param tree loads without transposes
(``tpudml_torch.interop``), except ``Conv2D.kernel``: JAX stores it HWIO
and convolves NHWC; the port stores it OIHW in ``channels_last`` memory
and convolves NCHW-indexed tensors in ``channels_last`` memory, the
layout cuDNN's fast kernels take (a ``[N, H, W, C]`` batch
``permute(0, 3, 1, 2)`` is exactly that, with no copy), so the interop
transposes conv kernels. Initial values come from a ``torch.Generator``
on the CPU; they follow the same distributions as the JAX init, not its
numbers.

Mixed precision follows ``TransformerLM._cast_params`` of the JAX package:
a ``Dense`` built with ``compute_dtype`` keeps its f32 master parameters
and casts them to that dtype at every use (an explicit cast where JAX
casts, not ``torch.autocast``); ``LayerNorm`` keeps f32 parameters and
statistics and returns its input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def uniform_fan_in(shape, fan_in: int, generator: torch.Generator | None):
    """U(-b, b) with b = 1/sqrt(fan_in) (torch's default Linear init)."""
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def cast(p: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``p`` at ``dtype`` (None: unchanged, compute in the parameter dtype)."""
    return p if dtype is None else p.to(dtype)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with kernel [in, out], computed in
    ``compute_dtype`` (None: the parameters' dtype)."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(
            uniform_fan_in((in_features, out_features), in_features, generator)
        )
        self.bias = nn.Parameter(
            uniform_fan_in((out_features,), in_features, generator)
        )

    def cast_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(kernel, bias) cast to the compute dtype, as used."""
        return cast(self.kernel, self.compute_dtype), cast(self.bias, self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.cast_params()
        return x @ kernel + bias


class LayerNorm(nn.Module):
    """Layer normalization over the trailing axis with the JAX package's
    statistics: f32, SINGLE-PASS moments E[x²] − m², clamped at 0 (f32
    cancellation can go slightly negative), eps 1e-5. Not
    ``nn.LayerNorm``, whose two-pass variance rounds differently."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of a window ``k`` at stride ``s`` over ``n``
    positions: ``total = max((ceil(n/s) − 1)·s + k − n, 0)``, ``total // 2``
    before and the rest after (asymmetric at stride > 1, e.g. (0, 1) for
    a 3×3 stride-2 window over 32 positions, where torch's ``padding=1``
    would be (1, 1))."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: tuple[int, int], s: tuple[int, int],
             value: float = 0.0) -> tuple[torch.Tensor, tuple[int, int]]:
    """(x, padding) such that a window ``k`` at stride ``s`` over ``x``'s
    last two dims with ``padding`` is XLA's ``"SAME"``: symmetric pads go
    to the op as its padding, others are written out with ``F.pad``."""
    (ht, hb), (wl, wr) = (same_padding(n, kk, ss) for n, kk, ss in zip(x.shape[-2:], k, s))
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb), value=value), (0, 0)


class Conv2D(nn.Module):
    """2-D convolution of an NCHW-indexed ``x`` (``channels_last`` memory)
    with ``kernel`` [out, in, kh, kw], computed in ``compute_dtype`` (None:
    the parameters' dtype; the kernel and bias are cast at use, as the
    JAX ResNet casts its conv params). ``padding`` is ``"SAME"`` (XLA's,
    :func:`same_padding`), ``"VALID"`` or an int (symmetric). Init
    U(±1/√fan_in), fan_in = kh·kw·in, as JAX's ``_uniform_fan_in``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | tuple[int, int] = 3, stride: int | tuple[int, int] = 1,
                 padding: str | int = "SAME", use_bias: bool = True, *,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        k = (kernel_size, kernel_size) if isinstance(kernel_size, int) else tuple(kernel_size)
        self.ksize = k
        self.stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        if not isinstance(padding, int) and padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME', 'VALID' or an int, got {padding!r}")
        self.padding = padding
        self.compute_dtype = compute_dtype
        fan_in = k[0] * k[1] * in_channels
        self.kernel = nn.Parameter(uniform_fan_in(
            (out_channels, in_channels, *k), fan_in, generator,
        ).contiguous(memory_format=torch.channels_last))
        self.bias = (nn.Parameter(uniform_fan_in((out_channels,), fan_in, generator))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = cast(self.kernel, self.compute_dtype)
        bias = None if self.bias is None else cast(self.bias, self.compute_dtype)
        if self.padding == "SAME":
            x, padding = pad_same(x, self.ksize, self.stride)
        else:
            padding = 0 if self.padding == "VALID" else self.padding
        return F.conv2d(x, kernel, bias, self.stride, padding)


class BatchNorm(nn.Module):
    """Batch normalization of an NCHW-indexed ``x`` over (N, H, W) (or of
    [N, C] rows over N) with the JAX package's choices, written out (not
    ``nn.BatchNorm2d`` / ``F.batch_norm``, which differ in all three):

    - statistics in f32: for a bf16 input SINGLE-PASS moments off the
      bf16 stream, ``max(E[x²] − m², 0)``; for f32 the two-pass
      ``E[(x − m)²]`` (at large means the single pass loses every
      variance bit to f32 cancellation);
    - the running update ``m·state + (1 − m)·batch`` with ``momentum`` m
      = 0.9 (torch's ``momentum`` is the other weight), and the BIASED
      batch variance in the running ``var`` (torch keeps the unbiased);
    - no ``num_batches_tracked``: the buffers are ``mean`` and ``var``,
      the float state ``DataParallel`` averages over its replicas.

    Training mode (``self.training``) normalizes by the batch statistics
    and updates the buffers in place; eval mode uses the buffers and
    leaves them alone. Normalization runs in f32 and returns ``x``'s
    dtype."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = (0, *range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if self.training:
            mean = xf.mean(axes, keepdim=True)
            if x.dtype == torch.bfloat16:
                var = (xf.square().mean(axes, keepdim=True) - mean.square()).clamp_min(0.0)
            else:
                var = (xf - mean).square().mean(axes, keepdim=True)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean.detach().flatten())
                self.var.copy_(m * self.var + (1 - m) * var.detach().flatten())
        else:
            mean, var = self.mean.view(shape), self.var.view(shape)
        y = (xf - mean) * torch.rsqrt(var.float() + self.eps)
        y = y * self.scale.float().view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)
