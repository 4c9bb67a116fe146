"""Learning-rate schedules and the optimizer wrapper that drives them (the
port of ``tpudml/optim/schedules.py``).

A schedule is a ``step -> lr`` function computed in f32, as JAX's are (its
result is that f32 value as a Python float). ``Scheduled`` wraps an
optimizer of the port, keeps the step count in its own state and replaces
the wrapped optimizer's ``lr`` at every update.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch

from tpudml_torch.optim.optimizers import Optimizer


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float) -> Callable:
    return lambda step: float(_f32(lr))


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0) -> Callable:
    """lr · (α + (1-α)·(1+cos(π·t/T))/2), clamped after T."""

    def schedule(step):
        frac = torch.clamp(_f32(step) / max(decay_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac))
        return float(lr * (alpha + (1.0 - alpha) * cos))

    return schedule


def linear_warmup(lr: float, warmup_steps: int) -> Callable:
    """0 → lr over ``warmup_steps``, constant after."""

    def schedule(step):
        return float(lr * torch.clamp((_f32(step) + 1) / max(warmup_steps, 1), 0.0, 1.0))

    return schedule


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  alpha: float = 0.0) -> Callable:
    """Linear warmup into a cosine decay, the standard transformer recipe."""
    decay = cosine_decay(lr, max(total_steps - warmup_steps, 1), alpha)

    def schedule(step):
        if step < warmup_steps:
            return float(lr * (_f32(step) + 1) / max(warmup_steps, 1))
        return decay(step - warmup_steps)

    return schedule


def step_decay(lr: float, step_size: int, gamma: float = 0.1) -> Callable:
    """lr · γ^floor(t/step_size) (torch StepLR semantics)."""

    def schedule(step):
        return float(lr * _f32(gamma) ** torch.floor(_f32(step) / max(step_size, 1)))

    return schedule


@dataclass(frozen=True)
class Scheduled(Optimizer):
    """Drive ``base``'s learning rate from ``schedule(step)``.

    Usage::

        opt = Scheduled(Sgd(momentum=0.9), warmup_cosine(0.1, 100, 1000))
    """

    base: Optimizer
    schedule: Callable

    def __post_init__(self):
        # update() swaps the lr with dataclasses.replace: refuse a base that
        # cannot take it at construction, not at the first update.
        if not dataclasses.is_dataclass(self.base) or not any(
            f.name == "lr" for f in dataclasses.fields(self.base)
        ):
            raise ValueError(
                f"Scheduled needs a dataclass optimizer with an 'lr' field; "
                f"got {type(self.base).__name__}"
            )

    def init(self, params):
        return {"inner": self.base.init(params), "t": 0}

    def update(self, grads, state, params):
        inner_opt = dataclasses.replace(self.base, lr=self.schedule(state["t"]))
        params, inner_state = inner_opt.update(grads, state["inner"], params)
        return params, {"inner": inner_state, "t": state["t"] + 1}

    def current_lr(self, state) -> float:
        return self.schedule(state["t"])
