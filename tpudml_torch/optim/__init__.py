"""Optimizers of the port (``tpudml.optim`` subset)."""

from tpudml_torch.optim.optimizers import (
    Adam,
    AdamW,
    GradientDescent,
    Optimizer,
    Sgd,
    make_optimizer,
)

__all__ = ["Adam", "AdamW", "GradientDescent", "Optimizer", "Sgd", "make_optimizer"]
