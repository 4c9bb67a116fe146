"""Layers, attention and losses of the port (``tpudml.nn``)."""

from tpudml_torch.nn.attention import (
    MultiHeadAttention,
    chunk_flash_window,
    decode_attention,
    dot_product_attention,
    rotary_embedding,
)
from tpudml_torch.nn.layers import (
    Activation,
    AvgPool,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    Flatten,
    LayerNorm,
    MaxPool,
    Sequential,
)
from tpudml_torch.nn.losses import softmax_cross_entropy

__all__ = [
    "Activation",
    "AvgPool",
    "BatchNorm",
    "Conv2D",
    "Dense",
    "Dropout",
    "Flatten",
    "LayerNorm",
    "MaxPool",
    "MultiHeadAttention",
    "Sequential",
    "chunk_flash_window",
    "decode_attention",
    "dot_product_attention",
    "rotary_embedding",
    "softmax_cross_entropy",
]
