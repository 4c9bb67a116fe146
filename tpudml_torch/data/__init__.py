"""Data of the port (``tpudml.data`` subset): seeded synthetic sets."""

from tpudml_torch.data.datasets import synthetic_lm

__all__ = ["synthetic_lm"]
