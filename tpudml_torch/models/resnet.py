"""ResNet for CIFAR, the north-star model (the port of
``tpudml/models/resnet.py``: ``BasicBlock``, ``BottleneckBlock``,
``ResNet``, ``ResNet18/34/50``).

The same parameter and state names as the JAX package (``stem``,
``stem_bn``, ``block{i}.{conv1, bn1, conv2, bn2[, conv3, bn3], proj,
proj_bn}``, ``head``; BatchNorm's running ``mean``/``var`` are buffers),
so ``tpudml_torch.interop.resnet_params_from_tpudml`` carries a
``tpudml`` tree across (conv kernels HWIO → OIHW).

``forward(x)`` takes an NHWC batch, as JAX's ``apply`` does, and views it
NCHW-indexed in ``channels_last`` memory (``permute``, no copy), the
layout of every activation after it. ``self.training`` selects batch
statistics (JAX's ``train=True``).

Mixed precision mirrors each JAX cast, explicitly (not
``torch.autocast``): the input is cast to ``compute_dtype``; conv and
head weights are cast at use (f32 masters); each BatchNorm computes its
statistics and normalization in f32 and its output goes back to the
compute dtype; ReLU, the residual add and the global average pool run
in the compute dtype; the logits come back in f32. The ImageNet stem's
max-pool is XLA's ``reduce_window`` SAME with −inf padding.

Parameters are drawn on the CPU from ``generator`` (default: seeded with
0) and moved to ``device`` (default "cuda"; asking for the card without
one raises); they follow the JAX init's distributions, not its numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudml_torch.device import resolve_device
from tpudml_torch.nn import layers
from tpudml_torch.nn.layers import BatchNorm, Conv2D, Dense, pad_same

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (ResNet-18/34 block)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, *,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        cdt, g = compute_dtype, generator
        self.compute_dtype = cdt
        self.conv1 = Conv2D(in_channels, out_channels, 3, stride, "SAME", use_bias=False,
                            generator=g, compute_dtype=cdt)
        self.conv2 = Conv2D(out_channels, out_channels, 3, 1, "SAME", use_bias=False,
                            generator=g, compute_dtype=cdt)
        self.bn1 = BatchNorm(out_channels)
        self.bn2 = BatchNorm(out_channels)
        self.has_projection = stride != 1 or in_channels != out_channels
        if self.has_projection:
            self.proj = Conv2D(in_channels, out_channels, 1, stride, "SAME", use_bias=False,
                               generator=g, compute_dtype=cdt)
            self.proj_bn = BatchNorm(out_channels)

    def _bn(self, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
        return bn(x).to(self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        y = layers.relu(self._bn(self.bn1, self.conv1(x)))
        y = self._bn(self.bn2, self.conv2(y))
        if self.has_projection:
            shortcut = self._bn(self.proj_bn, self.proj(x))
        return layers.relu(y + shortcut)


class BottleneckBlock(nn.Module):
    """1x1 reduce → 3x3 → 1x1 expand (×4) + shortcut: the ResNet-50/101
    block, with BasicBlock's dtype handling."""

    EXPANSION = 4

    def __init__(self, in_channels: int, mid_channels: int, stride: int = 1, *,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        cdt, g = compute_dtype, generator
        self.compute_dtype = cdt
        self.out_channels = out = mid_channels * self.EXPANSION
        self.conv1 = Conv2D(in_channels, mid_channels, 1, 1, "SAME", use_bias=False,
                            generator=g, compute_dtype=cdt)
        self.conv2 = Conv2D(mid_channels, mid_channels, 3, stride, "SAME", use_bias=False,
                            generator=g, compute_dtype=cdt)
        self.conv3 = Conv2D(mid_channels, out, 1, 1, "SAME", use_bias=False,
                            generator=g, compute_dtype=cdt)
        self.bn1 = BatchNorm(mid_channels)
        self.bn2 = BatchNorm(mid_channels)
        self.bn3 = BatchNorm(out)
        self.has_projection = stride != 1 or in_channels != out
        if self.has_projection:
            self.proj = Conv2D(in_channels, out, 1, stride, "SAME", use_bias=False,
                               generator=g, compute_dtype=cdt)
            self.proj_bn = BatchNorm(out)

    def _bn(self, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
        return bn(x).to(self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        y = layers.relu(self._bn(self.bn1, self.conv1(x)))
        y = layers.relu(self._bn(self.bn2, self.conv2(y)))
        y = self._bn(self.bn3, self.conv3(y))
        if self.has_projection:
            shortcut = self._bn(self.proj_bn, self.proj(x))
        return layers.relu(y + shortcut)


class ResNet(nn.Module):
    """Configurable ResNet: basic blocks (18/34) or bottlenecks (50/101);
    ``stem`` "cifar" (3x3/s1) or "imagenet" (7x7/s2 + 3x3/s2 max-pool)."""

    def __init__(self, stage_sizes: tuple[int, ...] = (2, 2, 2, 2), num_classes: int = 10,
                 width: int = 64, stem: str = "cifar", in_channels: int = 3,
                 block: str = "basic", compute_dtype: torch.dtype = torch.float32, *,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {compute_dtype}")
        if stem not in ("cifar", "imagenet"):
            raise ValueError(f"stem must be 'cifar' or 'imagenet', got {stem!r}")
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got {block!r}")
        dev = torch.device(device)
        if dev.type != "meta":  # meta: shapes only (parameter counts), nothing allocated
            dev = resolve_device(dev)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.stage_sizes = tuple(stage_sizes)
        self.stem_kind = stem
        self.compute_dtype = compute_dtype
        k, s = (7, 2) if stem == "imagenet" else (3, 1)
        self.stem = Conv2D(in_channels, width, k, s, "SAME", use_bias=False, generator=g,
                           compute_dtype=compute_dtype)
        self.stem_bn = BatchNorm(width)
        in_ch, n_blocks = width, 0
        for stage, n in enumerate(stage_sizes):
            ch = width * 2**stage
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                if block == "bottleneck":
                    blk = BottleneckBlock(in_ch, ch, stride, compute_dtype=compute_dtype,
                                          generator=g)
                    in_ch = blk.out_channels
                else:
                    blk = BasicBlock(in_ch, ch, stride, compute_dtype=compute_dtype,
                                     generator=g)
                    in_ch = ch
                self.add_module(f"block{n_blocks}", blk)
                n_blocks += 1
        self.n_blocks = n_blocks
        self.feature_dim = in_ch
        self.head = Dense(in_ch, num_classes, generator=g, compute_dtype=compute_dtype)
        self.to(dev)

    def blocks(self) -> list[nn.Module]:
        return [getattr(self, f"block{i}") for i in range(self.n_blocks)]

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        """NHWC images -> f32 logits. ``key`` (a train step's dropout key)
        is unused: the ResNet draws nothing, and JAX's ignores its rng."""
        cdt = self.compute_dtype
        y = x.to(cdt).permute(0, 3, 1, 2)  # NHWC -> NCHW-indexed, channels_last memory
        y = layers.relu(self.stem_bn(self.stem(y))).to(cdt)
        if self.stem_kind == "imagenet":
            y, padding = pad_same(y, (3, 3), (2, 2), value=float("-inf"))
            y = F.max_pool2d(y, 3, 2, padding)
        for blk in self.blocks():
            y = blk(y)
        y = y.mean(dim=(2, 3))  # global average pool
        return self.head(y).float()


def ResNet18(num_classes: int = 10, compute_dtype: torch.dtype = torch.float32,
             **kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), num_classes=num_classes,
                  compute_dtype=compute_dtype, **kw)


def ResNet34(num_classes: int = 10, compute_dtype: torch.dtype = torch.float32,
             **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes,
                  compute_dtype=compute_dtype, **kw)


def ResNet50(num_classes: int = 10, compute_dtype: torch.dtype = torch.float32,
             **kw) -> ResNet:
    """Bottleneck ResNet-50 (BASELINE.json's MindSpore auto-parallel
    parity config)."""
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes,
                  compute_dtype=compute_dtype, block="bottleneck", **kw)
