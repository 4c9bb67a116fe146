"""Optimizers of the port (``tpudml.optim`` subset)."""

from tpudml_torch.optim.optimizers import (
    Adam,
    AdamW,
    ClipByGlobalNorm,
    GradientDescent,
    Optimizer,
    Sgd,
    make_optimizer,
    shard_aware_clip,
)

__all__ = ["Adam", "AdamW", "ClipByGlobalNorm", "GradientDescent", "Optimizer", "Sgd",
           "make_optimizer", "shard_aware_clip"]
