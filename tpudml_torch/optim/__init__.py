"""Optimizers and learning-rate schedules of the port (``tpudml.optim``
without ZeRO-1)."""

from tpudml_torch.optim.optimizers import (
    Adam,
    AdamW,
    ClipByGlobalNorm,
    GradientDescent,
    Optimizer,
    ReferenceAdam,
    Sgd,
    make_optimizer,
    shard_aware_clip,
)
from tpudml_torch.optim.schedules import (
    Scheduled,
    constant,
    cosine_decay,
    linear_warmup,
    step_decay,
    warmup_cosine,
)

__all__ = ["Adam", "AdamW", "ClipByGlobalNorm", "GradientDescent", "Optimizer",
           "ReferenceAdam", "Scheduled", "Sgd", "constant", "cosine_decay", "linear_warmup",
           "make_optimizer", "shard_aware_clip", "step_decay", "warmup_cosine"]
