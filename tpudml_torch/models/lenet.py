"""LeNet-style CNN, the model of the reference's tasks 1–4 (the port of
``tpudml/models/lenet.py``): conv(1→6, k5, pad 2) → relu → maxpool2 →
conv(6→16, k5, valid) → relu → maxpool2 → flatten(400) → fc(400→120) →
relu → fc(120→10).

A ``Sequential`` whose children are ``layer0`` … ``layer9``, so its
parameter names are JAX's keys and ``interop.sequential_params_from_tpudml``
carries a JAX tree across (conv kernels HWIO → OIHW). ``forward`` takes an
NHWC batch, as JAX's ``apply`` does, and views it NCHW-indexed in
``channels_last`` memory (``permute``, no copy) for the convs and pools.
JAX flattens its NHWC activations in (H, W, C) order, the row order of
``layer7``'s [400, 120] kernel, so ``layer6`` flattens the NCHW-indexed
view in that order (``Flatten(nhwc=True)``), not in (C, H, W) order.
"""

from __future__ import annotations

import torch

from tpudml_torch.core.prng import Key
from tpudml_torch.device import resolve_device
from tpudml_torch.nn.layers import Activation, Conv2D, Dense, Flatten, MaxPool, Sequential, relu


class LeNet(Sequential):
    """Parameters are drawn on the CPU from ``generator`` (default: seeded
    with 0), with the JAX init's distributions, and moved to ``device``
    (default "cuda"; asking for the card without one raises)."""

    def __init__(self, num_classes: int = 10, in_channels: int = 1, *,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        super().__init__((
            Conv2D(in_channels, 6, kernel_size=5, padding=2, generator=g),
            Activation(relu),
            MaxPool(2),
            Conv2D(6, 16, kernel_size=5, padding="VALID", generator=g),
            Activation(relu),
            MaxPool(2),
            Flatten(nhwc=True),
            Dense(400, 120, generator=g),
            Activation(relu),
            Dense(120, num_classes, generator=g),
        ))
        self.to(dev)

    def forward(self, x: torch.Tensor, key: Key | None = None) -> torch.Tensor:
        """NHWC images [N, 28, 28, C] -> logits [N, num_classes]."""
        return super().forward(x.permute(0, 3, 1, 2), key=key)
