"""Layers, attention and losses of the port (``tpudml.nn`` subset)."""

from tpudml_torch.nn.attention import (
    MultiHeadAttention,
    chunk_flash_window,
    decode_attention,
    dot_product_attention,
    rotary_embedding,
)
from tpudml_torch.nn.layers import (
    Activation,
    BatchNorm,
    Conv2D,
    Dense,
    Flatten,
    LayerNorm,
    Sequential,
)
from tpudml_torch.nn.losses import softmax_cross_entropy

__all__ = [
    "Activation",
    "BatchNorm",
    "Conv2D",
    "Dense",
    "Flatten",
    "LayerNorm",
    "MultiHeadAttention",
    "Sequential",
    "chunk_flash_window",
    "decode_attention",
    "dot_product_attention",
    "rotary_embedding",
    "softmax_cross_entropy",
]
