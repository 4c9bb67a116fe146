"""Dense and LayerNorm: the port of ``tpudml/nn/layers.py`` (the LM's subset).

Parameters keep the JAX package's layout and names — ``Dense.kernel`` is
[in, out] and ``y = x @ kernel + bias``; ``LayerNorm`` has ``scale`` and
``bias`` — so a ``tpudml`` param tree loads without transposes
(``tpudml_torch.interop``). Initial values come from a ``torch.Generator``
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
