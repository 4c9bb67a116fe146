"""Stage-partitioned models for model parallelism, task4 (the port of
``tpudml/models/staged.py``: ``StagedModel``, ``lenet_stages``).

The reference splits its LeNet into ``SubNetConv`` and ``SubNetFC``
(codes/task4/model.py:18-66). A :class:`StagedModel` is that partition as
data: an ordered list of ``(name, module)`` stages, registered as children
under their names, so the parameters are keyed by stage as JAX keys them
(``conv.layer0.kernel``, ``fc.layer2.bias``) and a sharding rule of
``tpudml_torch.parallel.mp`` sees JAX's paths.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpudml_torch.core.prng import Key
from tpudml_torch.device import resolve_device
from tpudml_torch.nn.layers import Activation, Conv2D, Dense, Flatten, MaxPool, Sequential, relu


class StagedModel(nn.Module):
    """A chain of named stages. ``nhwc_input``: the input is an NHWC image
    batch, viewed NCHW-indexed (``channels_last`` memory, no copy) before
    the first stage, as ``LeNet`` does. A dropout ``key`` goes to every
    stage that is a ``Sequential``, as JAX hands every stage the same rng;
    the stages' aux terms are summed into ``aux_loss`` (None without one)."""

    def __init__(self, stages: Sequence[tuple[str, nn.Module]] = (), *,
                 nhwc_input: bool = False):
        super().__init__()
        for name, stage in stages:
            self.add_module(name, stage)
        self.nhwc_input = nhwc_input
        self.aux_loss = None

    def stage_names(self) -> list[str]:
        return [name for name, _ in self.named_children()]

    def forward(self, x: torch.Tensor, key: Key | None = None) -> torch.Tensor:
        if self.nhwc_input and x.dim() == 4:
            x = x.permute(0, 3, 1, 2)
        aux = []
        for stage in self.children():
            x = stage(x, key=key) if key is not None and isinstance(stage, Sequential) \
                else stage(x)
            if getattr(stage, "aux_loss", None) is not None:
                aux.append(stage.aux_loss.float())
        self.aux_loss = torch.stack(aux).sum() if aux else None
        return x


def lenet_stages(num_classes: int = 10, in_channels: int = 1, *,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None) -> StagedModel:
    """The reference's two-way split of LeNet: a ``conv`` stage and an
    ``fc`` stage (codes/task4/model.py:18-47), NHWC images in. Parameters
    are drawn on the CPU from ``generator`` (default: seeded with 0) with
    the JAX init's distributions and moved to ``device`` (default "cuda";
    asking for the card without one raises)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    conv = Sequential((
        Conv2D(in_channels, 6, kernel_size=5, padding=2, generator=g),
        Activation(relu),
        MaxPool(2),
        Conv2D(6, 16, kernel_size=5, padding="VALID", generator=g),
        Activation(relu),
        MaxPool(2),
        Flatten(nhwc=True),
    ))
    fc = Sequential((
        Dense(400, 120, generator=g),
        Activation(relu),
        Dense(120, num_classes, generator=g),
    ))
    return StagedModel((("conv", conv), ("fc", fc)), nhwc_input=True).to(dev)
