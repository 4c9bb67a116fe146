"""Training step (the port of ``tpudml/train.py``: ``TrainState``,
``make_loss_fn``, ``make_train_step_body``, ``make_train_step``, the
fused-head LM step ``make_lm_fused_loss_fn``,
``make_lm_fused_train_step_body``, ``make_lm_fused_train_step``, the
DP engine's un-aggregated local step ``local_grads``/``accumulate_grads`` (for both of
JAX's ``accumulate_grads`` and ``accumulate_fused_grads``), and the MoE
aux-loss plumbing ``collect_aux_losses``, ``model_has_moe``,
``resolve_aux_loss_weight``, and the host side: ``make_eval_step``,
``evaluate`` and the epoch loop ``train_loop``).

The loss functions run the model in training mode (JAX's ``train=True``:
BatchNorm normalizes by the batch and updates its running statistics
once a step, JAX's ``new_state``); evaluation runs it in eval mode
under ``torch.no_grad()`` and restores the mode after.

A MoE model's objective adds α·Σ(its layers' Switch load-balancing terms)
to the cross-entropy, as in JAX: ``aux_loss_weight=None`` means α =
``DEFAULT_MOE_AUX_WEIGHT`` for a model with MoE layers and 0 otherwise.

The JAX package jits one XLA program per step (grad + optimizer update)
and donates the state; the port runs the same step eagerly: the loss's
autograd gives the gradients, and the optimizer updates the model's
parameters and its own state in place. The returned ``TrainState`` is the
same object, advanced one step — rebinding ``ts`` each step, as JAX
callers must, works unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from tpudml_torch.nn.losses import accuracy, softmax_cross_entropy
from tpudml_torch.nn.moe import MoELayer
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


DEFAULT_MOE_AUX_WEIGHT = 1e-2  # the canonical Switch load-balancing α


def collect_aux_losses(model: nn.Module) -> torch.Tensor:
    """Sum of the aux terms (the Switch load-balancing terms of its MoE
    layers) that ``model`` recorded in its last forward, f32; 0 for a
    model that recorded none."""
    aux = getattr(model, "aux_loss", None)
    if aux is None:
        return torch.zeros((), dtype=torch.float32)
    return aux.float()


def model_has_moe(model: nn.Module) -> bool:
    """Whether ``model`` holds MoE layers (so the aux pressure defaults on:
    without it a top-1 router collapses onto one expert)."""
    return any(isinstance(m, MoELayer) for m in model.modules())


def resolve_aux_loss_weight(model: nn.Module, aux_loss_weight: float | None) -> float:
    """None -> the canonical α for MoE-bearing models, 0 otherwise."""
    if aux_loss_weight is not None:
        return aux_loss_weight
    return DEFAULT_MOE_AUX_WEIGHT if model_has_moe(model) else 0.0


def _with_aux(model: nn.Module, loss: torch.Tensor, aux_w: float) -> torch.Tensor:
    return loss + aux_w * collect_aux_losses(model).to(loss.device) if aux_w else loss


def make_loss_fn(model: nn.Module, aux_loss_weight: float | None = None,
                 loss: Callable = softmax_cross_entropy) -> Callable:
    """(tokens, labels) -> (loss, logits): ``model``'s forward and ``loss``
    (default the mean softmax cross-entropy) over the materialized logits,
    plus α·aux (module docstring)."""
    aux_w = resolve_aux_loss_weight(model, aux_loss_weight)

    def loss_fn(tokens, labels):
        if not model.training:
            model.train()
        logits = model(tokens)
        return _with_aux(model, loss(logits, labels), aux_w), logits

    return loss_fn


def make_lm_fused_loss_fn(model: nn.Module, save_scores: bool | None = None,
                          aux_loss_weight: float | None = None) -> Callable:
    """(tokens, labels) -> (loss, None) through the fused linear-cross-entropy
    head: ``model.apply_features`` then ``linear_cross_entropy`` on the head's
    kernel and bias cast to the compute dtype, so the [B·T, V] logits are
    never a tensor of the step (the second item, None, stands where
    :func:`make_loss_fn` returns the logits). ``save_scores`` is
    ``linear_cross_entropy``'s ``save_s``: True keeps the f32 scores for the
    backward, False recomputes them there (the lean O(N) residuals), None
    picks by the residual's size. Plus α·aux (module docstring)."""
    aux_w = resolve_aux_loss_weight(model, aux_loss_weight)

    def loss_fn(tokens, labels):
        feats = model.apply_features(tokens)
        kernel, bias = model.head.cast_params()
        loss = linear_cross_entropy(feats, kernel, labels, bias, save_s=save_scores)
        return _with_aux(model, loss, aux_w), None

    return loss_fn


def local_grads(loss_fn: Callable, model: nn.Module, tokens: torch.Tensor,
                labels: torch.Tensor, with_accuracy: bool = False):
    """Forward and backward without the update: ``(grads, metrics)``, the
    gradients of ``loss_fn`` (:func:`make_loss_fn` or
    :func:`make_lm_fused_loss_fn`) over ``model``'s parameters by name,
    and ``{"loss"}`` plus, with ``with_accuracy`` and a ``loss_fn`` that
    returns logits, ``{"accuracy"}`` (detached). Every parameter has a
    gradient, so that every rank's flat buffer holds the same tensors: one
    the loss does not reach gets zeros."""
    params = params_of(model)
    value, logits = loss_fn(tokens, labels)
    grads = torch.autograd.grad(value, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    metrics = {"loss": value.detach()}
    if with_accuracy and logits is not None:
        metrics["accuracy"] = accuracy(logits.detach(), labels)
    return dict(zip(params, grads)), metrics


def _step_body(optimizer: Optimizer, loss_fn: Callable) -> Callable:
    """(ts, tokens, labels) -> (ts, {"loss": loss}): :func:`local_grads`,
    then the optimizer update."""

    def step(ts: TrainState, tokens: torch.Tensor, labels: torch.Tensor):
        grads, metrics = local_grads(loss_fn, ts.model, tokens, labels)
        _, ts.opt_state = optimizer.update(grads, ts.opt_state, params_of(ts.model))
        ts.step += 1
        return ts, metrics

    return step


def accumulate_grads(loss_fn: Callable, model: nn.Module, images: torch.Tensor,
                     labels: torch.Tensor, rng=None, accum_steps: int = 1):
    """The DP engine's local step: :func:`local_grads` with accuracy, which
    the engine aggregates before the optimizer update. ``accum_steps > 1``
    and dropout ``rng`` are not ported."""
    if accum_steps != 1:
        raise NotImplementedError(f"accum_steps > 1 {NOT_PORTED}")
    if rng is not None:
        raise NotImplementedError(f"dropout rngs {NOT_PORTED}")
    return local_grads(loss_fn, model, images, labels, with_accuracy=True)


def make_train_step_body(model: nn.Module, optimizer: Optimizer,
                         accum_steps: int = 1,
                         aux_loss_weight: float | None = None) -> Callable:
    """(ts, tokens, labels) -> (ts, {"loss": loss}) on tensors that already
    lie on the model's device: forward, backward, optimizer update."""
    if accum_steps != 1:
        raise NotImplementedError(f"accum_steps > 1 {NOT_PORTED}")
    return _step_body(optimizer, make_loss_fn(model, aux_loss_weight))


def make_lm_fused_train_step_body(model: nn.Module, optimizer: Optimizer,
                                  save_scores: bool | None = None,
                                  aux_loss_weight: float | None = None) -> Callable:
    """:func:`make_train_step_body` through :func:`make_lm_fused_loss_fn`:
    the flagship LM step (``bench.py`` ``bench_transformer``). Metrics
    carry the loss only."""
    return _step_body(optimizer, make_lm_fused_loss_fn(model, save_scores, aux_loss_weight))


def to_device(x, device) -> torch.Tensor:
    """A batch array (numpy or a tensor anywhere) on ``device``: integer
    ids (tokens, class labels) as int64, floats (images) as they are."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if not x.is_floating_point():
        x = x.long()
    return x.to(device)


def _on_device(body: Callable) -> Callable:
    """``body`` taking the batch as numpy arrays or tensors anywhere,
    moved to the model's device by :func:`to_device`."""

    def step(ts: TrainState, inputs, labels):
        dev = next(ts.model.parameters()).device
        return body(ts, to_device(inputs, dev), to_device(labels, dev))

    return step


def make_train_step(model: nn.Module, optimizer: Optimizer,
                    accum_steps: int = 1,
                    aux_loss_weight: float | None = None) -> Callable:
    """Single-device train step: :func:`make_train_step_body` taking the
    batch as numpy arrays or tensors anywhere, moved to the model's
    device by :func:`to_device` (token ids and labels as int64, images
    as floats). The step's ``loss`` metric stays on the device (reading
    it waits for the step)."""
    return _on_device(make_train_step_body(model, optimizer, accum_steps, aux_loss_weight))


def make_lm_fused_train_step(model: nn.Module, optimizer: Optimizer,
                             save_scores: bool | None = None,
                             aux_loss_weight: float | None = None) -> Callable:
    """:func:`make_lm_fused_train_step_body` taking the batch as
    :func:`make_train_step` does."""
    return _on_device(make_lm_fused_train_step_body(model, optimizer, save_scores,
                                                    aux_loss_weight))


def make_eval_step(model: nn.Module) -> Callable:
    """(images, labels) -> the number of rows whose argmax logit is the
    label (a device tensor): ``model`` in eval mode under
    ``torch.no_grad()``, its mode restored after; the batch as
    :func:`make_train_step` takes it."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def step(images, labels):
        mode = model.training
        model.eval()
        try:
            logits = model(to_device(images, dev))
        finally:
            model.train(mode)
        return (logits.argmax(-1) == to_device(labels, dev)).sum()

    return step


def evaluate(model: nn.Module, ts: TrainState, loader) -> float:
    """Top-1 test accuracy over ``loader``'s batches (reference ``test()``
    parity, codes/task1/pytorch/model.py:67-81). ``ts.model`` is
    ``model``: the port's state holds the parameters in the model."""
    if ts.model is not model:
        raise ValueError("ts.model is not the model to evaluate")
    step = make_eval_step(model)
    correct, total = 0, 0
    for images, labels in loader:
        correct += int(step(images, labels))
        total += len(labels)
    return correct / max(total, 1)


def _sync(model: nn.Module) -> None:
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_loop(model: nn.Module, optimizer: Optimizer, train_loader, num_epochs: int,
               writer=None, log_every: int = 20, step_fn: Callable | None = None,
               state: TrainState | None = None, hooks: list[Callable] | None = None,
               accum_steps: int = 1) -> tuple[TrainState, dict]:
    """Host-side epoch loop with the reference's logging cadence (loss every
    ``log_every`` iters, codes/task1/pytorch/model.py:57-61) and the total
    wall clock (codes/task2/model-mp.py:48,76-78), as JAX's ``train_loop``:
    ``step_fn`` (default :func:`make_train_step`) over every batch of
    every epoch (``set_epoch`` first, where the loader has it), a restored
    ``state`` resuming step-granular (finished epochs skipped, the partial
    one fast-forwarded), ``hooks(epoch=, step=, train_state=, metrics=)``
    after each step, and the last step's metrics as floats plus
    ``train_time_s`` and ``steps``. JAX's ``key`` has no counterpart (the
    model holds its initial parameters; dropout rngs are not ported), nor
    do the obs ``step_stats`` scalars. ``accum_steps > 1`` with a
    ``step_fn`` raises ``ValueError`` (the engine owns accumulation), and
    without one :func:`make_train_step` raises (not ported)."""
    ts = state or TrainState.create(model, optimizer)
    if step_fn is not None and accum_steps > 1:
        raise ValueError(
            "accum_steps is handled by the engine that built step_fn; this "
            "engine/entrypoint does not support gradient accumulation")
    step = step_fn or make_train_step(model, optimizer, accum_steps=accum_steps)
    counter = start_step = ts.step
    steps_per_epoch = len(train_loader) if hasattr(train_loader, "__len__") else 0
    if steps_per_epoch:
        start_epoch = min(start_step // steps_per_epoch, num_epochs)
        skip_batches = start_step - start_epoch * steps_per_epoch
    else:
        start_epoch, skip_batches = 0, 0
    t0 = time.time()
    metrics = None  # device values; read only on a log step and at the end
    for epoch in range(start_epoch, num_epochs):
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        for i, (images, labels) in enumerate(train_loader):
            if epoch == start_epoch and i < skip_batches:
                continue  # fast-forward the sampler to the resume point
            ts, metrics = step(ts, images, labels)
            counter += 1
            if log_every and counter % log_every == 0:
                loss = float(metrics["loss"])
                if writer is not None:
                    writer.add_scalar("Train Loss", loss, counter)
                print(f"epoch {epoch} iter {counter}: loss {loss:.4f}")
            for h in hooks or ():
                h(epoch=epoch, step=counter, train_state=ts, metrics=metrics)
    _sync(ts.model)
    train_time = time.time() - t0
    print(f"Training time: {train_time:.3f}s")
    if writer is not None:
        writer.add_scalar("Train Time", train_time, counter)
    last = {k: float(v) for k, v in metrics.items()} if metrics is not None else {}
    last["train_time_s"] = train_time
    last["steps"] = counter
    return ts, last
