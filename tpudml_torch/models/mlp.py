"""ForwardMLP, the MindSpore-track model (the port of
``tpudml/models/mlp.py``): flatten(784) → 512 → 256 → 128 → 64 → 32 →
10, relu between layers; the softmax head is folded into the loss.

A ``Sequential`` (``layer0`` the flatten, then Dense/relu pairs), so its
parameter names are JAX's keys. It flattens the NHWC batch as given, in
JAX's order.
"""

from __future__ import annotations

import torch

from tpudml_torch.device import resolve_device
from tpudml_torch.nn.layers import Activation, Dense, Flatten, Sequential, relu


class ForwardMLP(Sequential):
    """Parameters are drawn on the CPU from ``generator`` (default: seeded
    with 0) and moved to ``device`` (default "cuda"; asking for the card
    without one raises)."""

    def __init__(self, in_features: int = 784,
                 hidden: tuple[int, ...] = (512, 256, 128, 64, 32),
                 num_classes: int = 10, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        layers: list = [Flatten()]
        prev = in_features
        for h in hidden:
            layers += [Dense(prev, h, generator=g), Activation(relu)]
            prev = h
        layers.append(Dense(prev, num_classes, generator=g))
        super().__init__(layers)
        self.to(dev)
