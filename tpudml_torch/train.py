"""Training step (the port of ``tpudml/train.py``: ``TrainState``,
``make_loss_fn``, ``make_train_step_body``, ``make_train_step``, and the
fused-head LM step ``make_lm_fused_loss_fn``,
``make_lm_fused_train_step_body``, ``make_lm_fused_train_step``).

The JAX package jits one XLA program per step (grad + optimizer update)
and donates the state; the port runs the same step eagerly: the loss's
autograd gives the gradients, and the optimizer updates the model's
parameters and its own state in place. The returned ``TrainState`` is the
same object, advanced one step — rebinding ``ts`` each step, as JAX
callers must, works unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from tpudml_torch.nn.losses import softmax_cross_entropy
from tpudml_torch.ops.xent_kernel import linear_cross_entropy
from tpudml_torch.optim import Optimizer

NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item 3, the rest of train.py)"


@dataclass
class TrainState:
    """Everything that evolves during training: the model (its
    parameters), the optimizer state and the step count."""

    model: nn.Module
    opt_state: Any
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer) -> "TrainState":
        return cls(model=model, opt_state=optimizer.init(params_of(model)))


def params_of(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters by name (the optimizers' pytree)."""
    return dict(model.named_parameters())


def make_loss_fn(model: nn.Module) -> Callable:
    """(tokens, labels) -> (loss, logits): ``model``'s forward and the
    mean softmax cross-entropy over the materialized logits."""

    def loss_fn(tokens, labels):
        logits = model(tokens)
        return softmax_cross_entropy(logits, labels), logits

    return loss_fn


def make_lm_fused_loss_fn(model: nn.Module, save_scores: bool | None = None) -> Callable:
    """(tokens, labels) -> (loss, None) through the fused linear-cross-entropy
    head: ``model.apply_features`` then ``linear_cross_entropy`` on the head's
    kernel and bias cast to the compute dtype, so the [B·T, V] logits are
    never a tensor of the step (the second item, None, stands where
    :func:`make_loss_fn` returns the logits). ``save_scores`` is
    ``linear_cross_entropy``'s ``save_s``; only the saved-scores mode is
    ported, and a value that resolves to the lean mode raises."""

    def loss_fn(tokens, labels):
        feats = model.apply_features(tokens)
        kernel, bias = model.head.cast_params()
        return linear_cross_entropy(feats, kernel, labels, bias, save_s=save_scores), None

    return loss_fn


def _step_body(optimizer: Optimizer, loss_fn: Callable) -> Callable:
    """(ts, tokens, labels) -> (ts, {"loss": loss}): forward, backward and
    optimizer update through ``loss_fn``."""

    def step(ts: TrainState, tokens: torch.Tensor, labels: torch.Tensor):
        params = params_of(ts.model)
        value, _ = loss_fn(tokens, labels)
        grads = torch.autograd.grad(value, list(params.values()))
        _, ts.opt_state = optimizer.update(dict(zip(params, grads)),
                                           ts.opt_state, params)
        ts.step += 1
        return ts, {"loss": value.detach()}

    return step


def make_train_step_body(model: nn.Module, optimizer: Optimizer,
                         accum_steps: int = 1) -> Callable:
    """(ts, tokens, labels) -> (ts, {"loss": loss}) on tensors that already
    lie on the model's device: forward, backward, optimizer update."""
    if accum_steps != 1:
        raise NotImplementedError(f"accum_steps > 1 {NOT_PORTED}")
    return _step_body(optimizer, make_loss_fn(model))


def make_lm_fused_train_step_body(model: nn.Module, optimizer: Optimizer,
                                  save_scores: bool | None = None) -> Callable:
    """:func:`make_train_step_body` through :func:`make_lm_fused_loss_fn`:
    the flagship LM step (``bench.py`` ``bench_transformer``). Metrics
    carry the loss only."""
    return _step_body(optimizer, make_lm_fused_loss_fn(model, save_scores))


def _on_device(body: Callable) -> Callable:
    """``body`` taking the batch as numpy arrays or tensors anywhere,
    moved to the model's device as int64 token ids."""

    def step(ts: TrainState, tokens, labels):
        dev = next(ts.model.parameters()).device
        return body(ts, _ids(tokens, dev), _ids(labels, dev))

    return step


def make_train_step(model: nn.Module, optimizer: Optimizer,
                    accum_steps: int = 1) -> Callable:
    """Single-device train step: :func:`make_train_step_body` taking the
    batch as numpy arrays or tensors anywhere, moved to the model's
    device as int64 token ids. The step's ``loss`` metric stays on the
    device (reading it waits for the step)."""
    return _on_device(make_train_step_body(model, optimizer, accum_steps))


def make_lm_fused_train_step(model: nn.Module, optimizer: Optimizer,
                             save_scores: bool | None = None) -> Callable:
    """:func:`make_lm_fused_train_step_body` taking the batch as
    :func:`make_train_step` does."""
    return _on_device(make_lm_fused_train_step_body(model, optimizer, save_scores))


def _ids(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=torch.long)
