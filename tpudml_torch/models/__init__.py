"""Models of the port (``tpudml.models`` serving subset)."""

from tpudml_torch.models.transformer import TransformerBlock, TransformerLM

__all__ = ["TransformerBlock", "TransformerLM"]
