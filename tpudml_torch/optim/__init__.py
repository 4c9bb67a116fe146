"""Optimizers, the ZeRO-1 wrapper and learning-rate schedules of the port
(``tpudml.optim``)."""

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
from tpudml_torch.optim.zero1 import ZeRO1, stages_stacked, with_stacked, zero1_handles

__all__ = ["Adam", "AdamW", "ClipByGlobalNorm", "GradientDescent", "Optimizer",
           "ReferenceAdam", "Scheduled", "Sgd", "constant", "cosine_decay", "linear_warmup",
           "ZeRO1", "make_optimizer", "shard_aware_clip", "stages_stacked", "step_decay",
           "warmup_cosine", "with_stacked", "zero1_handles"]
