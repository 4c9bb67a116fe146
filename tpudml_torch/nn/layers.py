"""Dense, Conv2D, MaxPool, AvgPool, BatchNorm, LayerNorm, Flatten,
Activation, Dropout and Sequential: the port of ``tpudml/nn/layers.py``.

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

Dropout draws its keep mask from a :class:`tpudml_torch.core.prng.Key`
through ONE function, :func:`dropout_mask` (a generator on the tensor's
device seeded from the key's path), so a test can swap that one function
for JAX's draw at the same key and hold every dropout path to JAX's.

Mixed precision follows ``TransformerLM._cast_params`` of the JAX package:
a ``Dense`` built with ``compute_dtype`` keeps its f32 master parameters
and casts them to that dtype at every use (an explicit cast where JAX
casts, not ``torch.autocast``); ``LayerNorm`` keeps f32 parameters and
statistics and returns its input's dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpudml_torch.core.prng import Key


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


class _Pool(nn.Module):
    def __init__(self, window: int = 2, stride: int | None = None):
        super().__init__()
        self.window, self.stride = window, stride or window


class MaxPool(_Pool):
    """Max over ``window``² windows at ``stride`` (default ``window``) of an
    NCHW-indexed ``x``, VALID (JAX's ``reduce_window`` max with −inf
    init); the gradient goes to the first maximum of a window in row-major
    order, as JAX's does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.window, self.stride)


class AvgPool(_Pool):
    """Mean over ``window``² windows at ``stride`` (default ``window``) of an
    NCHW-indexed ``x``, VALID: the window sum over ``window``²."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.window, self.stride)


class Flatten(nn.Module):
    """[N, ...] -> [N, prod(...)] in the order of the given layout (NHWC
    arrays flatten as JAX's do). ``nhwc=True`` takes an NCHW-indexed
    4-D tensor (the convs' view of an NHWC batch) and flattens it in JAX's
    (H, W, C) order, the row order of the next Dense kernel."""

    def __init__(self, nhwc: bool = False):
        super().__init__()
        self.nhwc = nhwc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.nhwc and x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


class _Relu(torch.autograd.Function):
    """``max(x, 0)`` with ``jax.nn.relu``'s derivative: the gradient where
    ``x > 0``, else 0. They differ from ``F.relu``'s only at a NaN input,
    whose gradient torch passes through and JAX zeroes (so a NaN batch
    poisons the same parameters in both)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.relu``: ``max(x, 0)``, its derivative 0 where ``x <= 0`` or
    ``x`` is NaN."""
    return _Relu.apply(x)


class Activation(nn.Module):
    """``fn(x)``, default relu (``jax.nn.relu``)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor] = relu):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def dropout_mask(key: Key, keep: float, shape, device) -> torch.Tensor:
    """The keep mask of one dropout: ``uniform < keep`` (JAX's
    ``bernoulli``) from ``key``'s generator on ``device``. Every dropout of
    the port draws through this function."""
    gen = key.generator(device)
    return torch.rand(shape, generator=gen, device=device) < keep


def dropout(x: torch.Tensor, rate: float, key: Key | None, training: bool) -> torch.Tensor:
    """Inverted dropout, JAX's ``Dropout.apply``: ``x`` unchanged when not
    training or at rate 0; else ``where(mask, x / keep, 0)`` with ``keep =
    1 − rate`` and the mask of :func:`dropout_mask`. Training without a
    key raises."""
    if not training or rate == 0.0:
        return x
    if key is None:
        raise ValueError("Dropout in train mode requires an rng")
    keep = 1.0 - rate
    mask = dropout_mask(key, keep, x.shape, x.device)
    return torch.where(mask, x / keep, 0.0)


class Dropout(nn.Module):
    """:func:`dropout` at ``rate`` in training mode (``self.training``)."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, key: Key | None = None) -> torch.Tensor:
        return dropout(x, self.rate, key, self.training)


class Sequential(nn.Module):
    """Chain of modules, registered as ``layer{i}`` so that parameter names
    are JAX's param-tree keys (``layer1.kernel``, ``layer3.router.kernel``;
    layers without parameters have no names, as they have no JAX entry).

    ``key`` is split into one key a layer, as JAX's ``Sequential.apply``
    splits its rng (``split(key, n)[i]`` for layer i), and handed to the
    layers that draw (``Dropout``, a nested ``Sequential``).

    A layer whose ``returns_aux`` is true (``MoELayer``) returns ``(y,
    aux)``; the chain records the sum of those aux terms of its last
    forward in ``aux_loss`` (None without such a layer), as JAX's
    ``Sequential.apply`` threads each MoE layer's ``aux_loss`` state, and
    ``tpudml_torch.train.collect_aux_losses`` reads it."""

    def __init__(self, layers: Sequence[nn.Module] = ()):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(f"layer{i}", layer)
        self.aux_loss = None

    def forward(self, x: torch.Tensor, key: Key | None = None) -> torch.Tensor:
        aux = []
        layers = list(self.children())
        for i, layer in enumerate(layers):
            if key is not None and isinstance(layer, (Dropout, Sequential)):
                x = layer(x, key=key.split(max(len(layers), 1), i))
            elif getattr(layer, "returns_aux", False):
                x, a = layer(x)
                aux.append(a.float())
            else:
                x = layer(x)
        self.aux_loss = torch.stack(aux).sum() if aux else None
        return x
