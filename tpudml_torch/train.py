"""Training step (the port of ``tpudml/train.py``: ``TrainState``,
``make_loss_fn``, ``make_train_step_body``, ``make_train_step``, the
fused-head LM step ``make_lm_fused_loss_fn``, its vocab-sharded form
``make_lm_fused_sharded_loss_fn`` (the GSPMD engines' ``fused_xent``),
``make_lm_fused_train_step_body``, ``make_lm_fused_train_step``, the
DP engine's un-aggregated local step ``local_grads``/``accumulate_grads`` (for both of
JAX's ``accumulate_grads`` and ``accumulate_fused_grads``), and the MoE
aux-loss plumbing ``collect_aux_losses``, ``model_has_moe``,
``resolve_aux_loss_weight``, and the host side: ``make_eval_step``,
``evaluate``, the sharded engines' ``evaluate_counts`` and the epoch
loop ``train_loop``).

The loss functions run the model in training mode (JAX's ``train=True``:
BatchNorm normalizes by the batch and updates its running statistics
once a step, JAX's ``new_state``); evaluation runs it in eval mode
under ``torch.no_grad()`` and restores the mode after. A step built with
``rng_root`` (a ``tpudml_torch.core.prng.Key``) hands the model the
dropout key ``rng_root.fold_in(step)`` (and ``.fold_in(i)`` for
micro-batch ``i`` under ``accum_steps``), as JAX's folds its rng.

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

from tpudml_torch.core.prng import Key
from tpudml_torch.nn.losses import accuracy, softmax_cross_entropy
from tpudml_torch.nn.moe import MoELayer
from tpudml_torch.ops.xent_kernel import linear_cross_entropy
from tpudml_torch.optim import Optimizer

@dataclass
class TrainState:
    """Everything that evolves during training: the model (its
    parameters), the optimizer state and the step count; under
    ``DataParallel(zero1_overlap=True)`` also this rank's parameter chunks
    (``param_chunks``, by name), which the model's parameters lag between
    steps."""

    model: nn.Module
    opt_state: Any
    step: int = 0
    param_chunks: dict | None = None

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


def _keyed(key: Key | None) -> dict:
    """The model call's keyword for a dropout key (none without one, so a
    model that draws nothing needs no ``key`` argument)."""
    return {} if key is None else {"key": key}


def make_loss_fn(model: nn.Module, aux_loss_weight: float | None = None,
                 loss: Callable = softmax_cross_entropy) -> Callable:
    """(tokens, labels[, key]) -> (loss, logits): ``model``'s forward in
    training mode (``key`` seeds its dropout) and ``loss`` (default the
    mean softmax cross-entropy) over the materialized logits, plus α·aux
    (module docstring)."""
    aux_w = resolve_aux_loss_weight(model, aux_loss_weight)

    def loss_fn(tokens, labels, key: Key | None = None):
        if not model.training:
            model.train()
        logits = model(tokens, **_keyed(key))
        return _with_aux(model, loss(logits, labels), aux_w), logits

    return loss_fn


def make_lm_fused_loss_fn(model: nn.Module, save_scores: bool | None = None,
                          aux_loss_weight: float | None = None) -> Callable:
    """(tokens, labels[, key]) -> (loss, None) through the fused
    linear-cross-entropy head: ``model.apply_features`` (``key`` seeds its
    dropout) then ``linear_cross_entropy`` on the head's kernel and bias
    cast to the compute dtype, so the [B·T, V] logits are never a tensor
    of the step (the second item, None, stands where :func:`make_loss_fn`
    returns the logits). ``save_scores`` is ``linear_cross_entropy``'s
    ``save_s``: True keeps the f32 scores for the backward, False
    recomputes them there (the lean O(N) residuals), None picks by the
    residual's size. Plus α·aux (module docstring)."""
    aux_w = resolve_aux_loss_weight(model, aux_loss_weight)

    def loss_fn(tokens, labels, key: Key | None = None):
        if not model.training:
            model.train()
        feats = model.apply_features(tokens, **_keyed(key))
        kernel, bias = model.head.cast_params()
        loss = linear_cross_entropy(feats, kernel, labels, bias, save_s=save_scores)
        return _with_aux(model, loss, aux_w), None

    return loss_fn


class _HeadInputs(nn.Module):
    """``model.apply_features`` and the head's kernel and bias cast to the
    compute dtype, as one module call (for ``torch.func.functional_call``
    with gathered parameters)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.m = model

    def forward(self, tokens, **kwargs):
        feats = self.m.apply_features(tokens, **kwargs)
        return (feats, *self.m.head.cast_params())


def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def make_lm_fused_sharded_loss_fn(model: nn.Module, engine, kernel_spec,
                                  batch_axis: str | None = None,
                                  save_scores: bool | None = None,
                                  aux_loss_weight: float | None = None) -> Callable:
    """(tokens, labels[, key]) -> (loss, None) through the fused head when
    the head itself is SHARDED: the loss of ``GSPMDParallel(fused_xent=True)``
    (TP, FSDP, FSDP×TP) over ``engine`` (its mesh groups and its
    parameter gather). The trunk runs on the gathered parameters; what
    the head does is read from ``kernel_spec``, the head kernel's [d, V]
    placed spec:

    - dim 1 names the VOCAB axis: ``sharded_linear_cross_entropy`` over
      that axis's group, the head's dim 1 (and its bias) left in blocks;
      a demoted dim 1 (a vocabulary the axis does not divide) takes the
      plain ``linear_cross_entropy`` on the gathered head;
    - dim 0 sharded (FSDP×TP puts ``data`` there): gathered on use by the
      engine, its gradient the gather's reduce-scatter;
    - vocab axis == ``batch_axis`` (1-D FSDP): the tokens' features and
      labels are all-gathered over the group first, every rank scores all
      of them against its vocabulary slice and the loss is the global
      mean; the partial dX goes back to the token shards by one
      reduce-scatter, times the group size, so that each rank's trunk
      gradient is its rows' mean gradient, as the engine's data mean
      expects (the head's own gradient is already the global one);
    - otherwise, under ``batch_axis``, each rank's loss is the mean over
      its rows, which the engine averages over the data group with the
      gradients.

    The function carries ``keep`` (the head's dimensions left in blocks,
    for the engine's gather) and ``wire_bytes`` (the head's ring-model
    bytes into a rank in its last call). Plus α·aux (module docstring)."""
    from tpudml_torch.comm.collectives import gather_rows
    from tpudml_torch.comm.timing import collective_wire_bytes
    from tpudml_torch.ops.xent_kernel import sharded_linear_cross_entropy

    aux_w = resolve_aux_loss_weight(model, aux_loss_weight)
    kspec = tuple(kernel_spec) + (None,) * (2 - len(kernel_spec))
    v_axes = _spec_axes(kspec[1])
    if len(v_axes) > 1:
        raise ValueError(f"head kernel vocab dim sharded over {v_axes}: the partial-stat "
                         "merge runs over ONE mesh axis")
    vocab_axis = v_axes[0] if v_axes else None
    gather_batch = batch_axis is not None and batch_axis == vocab_axis
    heads = _HeadInputs(model)

    def loss_fn(tokens, labels, key: Key | None = None):
        if not model.training:
            model.train()
        full = engine.gather(params_of(model), loss_fn.keep)
        feats, kernel, bias = torch.func.functional_call(
            heads, {f"m.{n}": t for n, t in full.items()}, (tokens,), _keyed(key),
            strict=False)
        xn, ln = feats.reshape(-1, feats.shape[-1]), labels.reshape(-1)
        if vocab_axis is None:
            loss = linear_cross_entropy(xn, kernel, ln, bias, save_s=save_scores)
            loss_fn.wire_bytes = 0.0
            return _with_aux(model, loss, aux_w), None
        group, _, size = engine.groups[vocab_axis]
        wire = 0.0
        if gather_batch:
            nbytes = xn.numel() * xn.element_size()
            wire += (collective_wire_bytes("all_gather", nbytes, size)
                     + collective_wire_bytes("reduce_scatter", nbytes * size, size)
                     + collective_wire_bytes("all_gather", ln.numel() * ln.element_size(),
                                             size))
            xn, ln = gather_rows(xn, group, grad_scale=size), gather_rows(ln, group)
        else:
            wire += collective_wire_bytes("psum", xn.numel() * xn.element_size(), size)
        wire += 3 * collective_wire_bytes("psum", xn.shape[0] * 4, size)  # lse: max, sum; picked
        loss_fn.wire_bytes = wire
        loss = sharded_linear_cross_entropy(xn, kernel, ln, bias, group=group,
                                            save_s=save_scores, reduce_dx=not gather_batch)
        return _with_aux(model, loss, aux_w), None

    loss_fn.keep = {"head.kernel": (1,), "head.bias": (0,)} if vocab_axis else {}
    loss_fn.wire_bytes = 0.0
    return loss_fn


def local_grads(loss_fn: Callable, model: nn.Module, tokens: torch.Tensor,
                labels: torch.Tensor, with_accuracy: bool = False, key: Key | None = None):
    """Forward and backward without the update: ``(grads, metrics)``, the
    gradients of ``loss_fn`` (:func:`make_loss_fn` or
    :func:`make_lm_fused_loss_fn`, with dropout ``key``) over ``model``'s
    parameters by name, and ``{"loss"}`` plus, with ``with_accuracy`` and
    a ``loss_fn`` that returns logits, ``{"accuracy"}`` (detached). Every
    parameter has a gradient, so that every rank's flat buffer holds the
    same tensors: one the loss does not reach gets zeros."""
    params = params_of(model)
    value, logits = loss_fn(tokens, labels, key)
    grads = torch.autograd.grad(value, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    metrics = {"loss": value.detach()}
    if with_accuracy and logits is not None:
        metrics["accuracy"] = accuracy(logits.detach(), labels)
    return dict(zip(params, grads)), metrics


def nonfinite_leaves(tensors: list) -> torch.Tensor:
    """Bool tensor [len(tensors)]: which tensors hold a non-finite element,
    with no host read and in two multi-tensor launches whatever their
    number: t·0 is 0 where t is finite and NaN where it is not, so the norm
    of the products is NaN exactly for such a tensor (a finite outlier
    cannot overflow it)."""
    return torch.stack(torch._foreach_norm(torch._foreach_mul(tensors, 0.0))).isnan()


def _grads_nonfinite(grads: dict) -> torch.Tensor:
    """0-d bool tensor: any non-finite element in any gradient."""
    return nonfinite_leaves(list(grads.values())).any()


def accumulate_grads(loss_fn: Callable, model: nn.Module, images: torch.Tensor,
                     labels: torch.Tensor, rng: Key | None = None, accum_steps: int = 1,
                     taint: bool = False):
    """The gradients of ``loss_fn`` over the batch and its metrics (the
    loss, and the accuracy where ``loss_fn`` returns logits), computed in
    ``accum_steps`` sequential micro-batches of consecutive rows (JAX's
    ``accumulate_grads`` and ``accumulate_fused_grads``): gradients and
    metrics are the micro-batches' means (summed from zero in order, then
    times 1/accum_steps), micro-batch ``i`` draws its dropout from
    ``rng.fold_in(i)``, and the model's state threads through the
    micro-batches (BatchNorm's running statistics see every one, in
    order). ``accum_steps=1`` is one :func:`local_grads` with ``rng`` as it
    is. A batch not divisible by ``accum_steps`` raises ``ValueError``.
    ``taint=True`` adds ``metrics["bad_micro"]``, an int32 tensor: the
    index of the FIRST micro-batch whose gradients hold a non-finite
    value, -1 if none (the sentinel's escalation names it)."""
    if accum_steps == 1:
        grads, metrics = local_grads(loss_fn, model, images, labels, with_accuracy=True,
                                     key=rng)
        if taint:
            metrics["bad_micro"] = torch.where(_grads_nonfinite(grads), 0, -1).to(torch.int32)
        return grads, metrics
    batch = images.shape[0]
    if batch % accum_steps:
        raise ValueError(f"(per-replica) batch {batch} not divisible by accum_steps "
                         f"{accum_steps}")
    micro = batch // accum_steps
    grads_sum = metrics_sum = bad = None
    for i in range(accum_steps):
        rows = slice(i * micro, (i + 1) * micro)
        grads, metrics = local_grads(loss_fn, model, images[rows], labels[rows],
                                     with_accuracy=True,
                                     key=None if rng is None else rng.fold_in(i))
        if grads_sum is None:
            grads_sum = {n: torch.zeros_like(g) for n, g in grads.items()}
            metrics_sum = {k: torch.zeros_like(v) for k, v in metrics.items()}
        grads_sum = {n: grads_sum[n] + g for n, g in grads.items()}
        metrics_sum = {k: metrics_sum[k] + v for k, v in metrics.items()}
        if taint:
            if bad is None:
                bad = torch.full((), -1, dtype=torch.int32, device=images.device)
            bad = torch.where((bad < 0) & _grads_nonfinite(grads), i, bad).to(torch.int32)
    inv = 1.0 / accum_steps
    metrics = {k: v * inv for k, v in metrics_sum.items()}
    if taint:
        metrics["bad_micro"] = bad
    return {n: g * inv for n, g in grads_sum.items()}, metrics


def _step_body(optimizer: Optimizer, loss_fn: Callable, rng_root: Key | None,
               accum_steps: int) -> Callable:
    """(ts, tokens, labels) -> (ts, metrics): :func:`accumulate_grads` with
    the step's dropout key ``rng_root.fold_in(ts.step)``, then the
    optimizer update."""

    def step(ts: TrainState, tokens: torch.Tensor, labels: torch.Tensor):
        rng = None if rng_root is None else rng_root.fold_in(ts.step)
        grads, metrics = accumulate_grads(loss_fn, ts.model, tokens, labels, rng, accum_steps)
        _, ts.opt_state = optimizer.update(grads, ts.opt_state, params_of(ts.model))
        ts.step += 1
        return ts, metrics

    return step


def make_train_step_body(model: nn.Module, optimizer: Optimizer,
                         rng_root: Key | None = None, accum_steps: int = 1,
                         loss: Callable = softmax_cross_entropy,
                         aux_loss_weight: float | None = None) -> Callable:
    """(ts, tokens, labels) -> (ts, {"loss", "accuracy"}) on tensors that
    already lie on the model's device: forward, backward (in
    ``accum_steps`` micro-batches, :func:`accumulate_grads`), optimizer
    update. ``rng_root`` seeds the dropout keys, folded with the step
    count."""
    return _step_body(optimizer, make_loss_fn(model, aux_loss_weight, loss), rng_root,
                      accum_steps)


def make_lm_fused_train_step_body(model: nn.Module, optimizer: Optimizer,
                                  rng_root: Key | None = None,
                                  save_scores: bool | None = None,
                                  aux_loss_weight: float | None = None) -> Callable:
    """:func:`make_train_step_body` through :func:`make_lm_fused_loss_fn`:
    the flagship LM step (``bench.py`` ``bench_transformer``). Metrics
    carry the loss only."""
    return _step_body(optimizer, make_lm_fused_loss_fn(model, save_scores, aux_loss_weight),
                      rng_root, 1)


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
                    rng_root: Key | None = None, accum_steps: int = 1,
                    loss: Callable = softmax_cross_entropy,
                    aux_loss_weight: float | None = None) -> Callable:
    """Single-device train step: :func:`make_train_step_body` taking the
    batch as numpy arrays or tensors anywhere, moved to the model's
    device by :func:`to_device` (token ids and labels as int64, images
    as floats). The step's metrics stay on the device (reading one waits
    for the step)."""
    return _on_device(make_train_step_body(model, optimizer, rng_root, accum_steps, loss,
                                           aux_loss_weight))


def make_lm_fused_train_step(model: nn.Module, optimizer: Optimizer,
                             rng_root: Key | None = None,
                             save_scores: bool | None = None,
                             aux_loss_weight: float | None = None) -> Callable:
    """:func:`make_lm_fused_train_step_body` taking the batch as
    :func:`make_train_step` does."""
    return _on_device(make_lm_fused_train_step_body(model, optimizer, rng_root, save_scores,
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


def evaluate_counts(step: Callable, ts: TrainState, loader) -> float:
    """Accuracy from a ``(x, labels) -> (correct, count)`` step (the
    sharded engines' ``make_counting_eval_step``), accumulated over
    ``loader``'s global batches: the loop behind their ``evaluate``
    methods. ``ts`` is JAX's argument; the port's step closes over the
    model, which holds the parameters."""
    correct = total = 0
    for x, labels in loader:
        c, n = step(x, labels)
        correct += int(c)
        total += int(n)
    return correct / max(total, 1)


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
               key: Key | None = None,
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
    ``train_time_s`` and ``steps``. The default step draws its dropout
    keys from ``key.fold_in(0x0D0)``, JAX's domain-separated branch of the
    seed key (the model already holds its initial parameters, which JAX
    draws from ``key``; without a key the step has none and a dropout
    model raises). A step's ``step_stats`` (the DP engine's ``obs=``)
    streams as ``obs/*`` scalars on the loss's cadence, as in JAX.
    ``accum_steps > 1`` with a ``step_fn`` raises ``ValueError`` (the
    engine owns accumulation)."""
    ts = state or TrainState.create(model, optimizer)
    if step_fn is not None and accum_steps > 1:
        raise ValueError(
            "accum_steps is handled by the engine that built step_fn; this "
            "engine/entrypoint does not support gradient accumulation")
    step = step_fn or make_train_step(
        model, optimizer, rng_root=None if key is None else key.fold_in(0x0D0),
        accum_steps=accum_steps)
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
                    stats = metrics.get("step_stats")
                    if stats is not None:
                        writer.add_scalars({f"obs/{k}": float(v)
                                            for k, v in stats.to_scalars().items()}, counter)
                print(f"epoch {epoch} iter {counter}: loss {loss:.4f}")
            for h in hooks or ():
                h(epoch=epoch, step=counter, train_state=ts, metrics=metrics)
    _sync(ts.model)
    train_time = time.time() - t0
    print(f"Training time: {train_time:.3f}s")
    if writer is not None:
        writer.add_scalar("Train Time", train_time, counter)
    last = {k: ({kk: float(vv) for kk, vv in v.to_scalars().items()}
                if hasattr(v, "to_scalars") else float(v))  # obs StepStats
            for k, v in (metrics or {}).items()}
    last["train_time_s"] = train_time
    last["steps"] = counter
    return ts, last
