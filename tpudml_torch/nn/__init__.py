"""Layers and attention of the port (``tpudml.nn`` serving subset)."""

from tpudml_torch.nn.attention import (
    MultiHeadAttention,
    chunk_flash_window,
    decode_attention,
    dot_product_attention,
    rotary_embedding,
)
from tpudml_torch.nn.layers import Dense, LayerNorm

__all__ = [
    "Dense",
    "LayerNorm",
    "MultiHeadAttention",
    "chunk_flash_window",
    "decode_attention",
    "dot_product_attention",
    "rotary_embedding",
]
