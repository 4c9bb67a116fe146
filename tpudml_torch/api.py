"""High-level Model API, the MindSpore-track surface (the port of
``tpudml/api.py``).

The reference's second-framework track trains through ``Model(net, loss,
opt, metrics)`` + ``model.train(epochs, ds, callbacks=[LossMonitor()],
dataset_sink_mode=True)`` + ``model.eval`` (codes/task1/mindspore/
model.ipynb cells 5-7). Sink mode is the built step
(``tpudml_torch.train.make_train_step``); ``dataset_sink_mode=False``
runs the same math written out (forward, loss, autograd, update), the
eager comparison mode. Both draw dropout keys from ``seed_key(seed)
.fold_in(0x0D0)`` folded with the step, as JAX's facade does. Given a
process ``group`` (JAX's ``mesh``), sink-mode training is a
``DataParallel`` engine over it, fed plain global batches (or a
``ShardedDataLoader``'s stacked ones).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Sequence

import torch
from torch import nn

from tpudml_torch.core.prng import seed_key
from tpudml_torch.nn.losses import accuracy, softmax_cross_entropy
from tpudml_torch.optim import Optimizer
from tpudml_torch.train import TrainState, make_train_step, params_of, to_device

_METRIC_FNS: dict[str, Callable] = {
    "accuracy": accuracy,
    "loss": lambda logits, labels: softmax_cross_entropy(logits, labels),
}


class Callback:
    """Training callback with MindSpore-Callback-shaped hooks."""

    def on_train_begin(self, model: "Model") -> None: ...

    def on_step_end(self, model: "Model", step: int, loss: float) -> None: ...

    def on_epoch_end(self, model: "Model", epoch: int, loss: float) -> None: ...

    def on_train_end(self, model: "Model") -> None: ...


class LossMonitor(Callback):
    """mindspore.train.LossMonitor (notebook cell 6): prints the loss every
    ``per_print_times`` steps."""

    def __init__(self, per_print_times: int = 1):
        self.per_print_times = per_print_times

    def on_step_end(self, model, step, loss):
        if self.per_print_times and step % self.per_print_times == 0:
            print(f"step: {step}, loss is {loss:.6f}")


class Model:
    """``Model(network, loss_fn, optimizer, metrics)`` over the port's
    engines. ``network`` is a module of the port holding its parameters on
    its device (its forward takes a dropout ``key``); ``seed`` seeds the
    dropout keys (JAX also draws the initial parameters from it).

    Usage (the notebook, model.ipynb cells 5-7)::

        model = Model(ForwardMLP(), optimizer=make_optimizer("sgd", 0.01),
                      metrics={"Accuracy"})
        model.train(10, train_loader, callbacks=[LossMonitor()])
        print(model.eval(test_loader))   # {"Accuracy": 0.97}
    """

    def __init__(self, network: nn.Module, loss_fn: Callable = softmax_cross_entropy,
                 optimizer: Optimizer | None = None,
                 metrics: Sequence[str] | set[str] = ("accuracy",), seed: int = 0,
                 group=None):
        if optimizer is None:
            raise ValueError("Model needs an optimizer")
        unknown = {m.lower() for m in metrics} - set(_METRIC_FNS)
        if unknown:
            raise ValueError(f"unknown metrics {sorted(unknown)}; options: {sorted(_METRIC_FNS)}")
        self.network = network
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.metrics = tuple(m.lower() for m in metrics)
        self._rng_root = seed_key(seed).fold_in(0x0D0)
        self._sink_step = None
        self.group = group
        if group is not None:
            from tpudml_torch.parallel.dp import DataParallel

            self._engine = DataParallel(network, optimizer, group, rng_root=self._rng_root,
                                        loss=loss_fn, stacked_batches=False)
            self.state = self._engine.create_state()
        else:
            self._engine = None
            self.state = TrainState.create(network, optimizer)
        self.device = next(network.parameters()).device

    # ------------------------------------------------------------- training

    def _eager_step(self, ts: TrainState, images, labels):
        """dataset_sink_mode=False: the sink step's math written out."""
        x, y = to_device(images, self.device), to_device(labels, self.device)
        self.network.train()
        logits = self.network(x, key=self._rng_root.fold_in(ts.step))
        loss = self.loss_fn(logits, y)
        params = params_of(self.network)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        _, ts.opt_state = self.optimizer.update(dict(zip(params, grads)), ts.opt_state, params)
        ts.step += 1
        return ts, {"loss": loss.detach(), "accuracy": accuracy(logits.detach(), y)}

    def train(self, epochs: int, dataset: Iterable,
              callbacks: Sequence[Callback] | None = None,
              dataset_sink_mode: bool = True) -> "Model":
        """Train in place for ``epochs`` passes over ``dataset`` (any iterable
        of (images, labels); a loader's ``set_epoch`` is called). Records
        ``train_time_s``; returns self."""
        callbacks = list(callbacks or [])
        if not dataset_sink_mode and self._engine is not None:
            raise ValueError("eager mode is single-device; drop group= to use it")
        if self._engine is not None:
            # The loader's type, not shape inference, decides the batch form.
            from tpudml_torch.data import ShardedDataLoader

            self._engine.stacked_batches = isinstance(dataset, ShardedDataLoader)
        if dataset_sink_mode and self._sink_step is None:
            self._sink_step = (self._engine.make_train_step() if self._engine is not None
                               else make_train_step(self.network, self.optimizer,
                                                    rng_root=self._rng_root, loss=self.loss_fn))
        step_fn = self._sink_step if dataset_sink_mode else self._eager_step
        for cb in callbacks:
            cb.on_train_begin(self)
        t0 = time.time()
        counter = 0
        for epoch in range(epochs):
            if hasattr(dataset, "set_epoch"):
                dataset.set_epoch(epoch)
            metrics = None
            for images, labels in dataset:
                self.state, metrics = step_fn(self.state, images, labels)
                counter += 1
                if callbacks:
                    # Reading the loss waits for the step: only for a callback.
                    loss = float(metrics["loss"])
                    for cb in callbacks:
                        cb.on_step_end(self, counter, loss)
            if callbacks:
                loss = float(metrics["loss"]) if metrics is not None else float("nan")
                for cb in callbacks:
                    cb.on_epoch_end(self, epoch, loss)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.train_time_s = time.time() - t0
        for cb in callbacks:
            cb.on_train_end(self)
        return self

    # ------------------------------------------------------------ inference

    @torch.no_grad()
    def predict(self, images) -> torch.Tensor:
        """Logits of ``images`` in eval mode (the mode restored after)."""
        mode = self.network.training
        self.network.eval()
        try:
            return self.network(to_device(images, self.device))
        finally:
            self.network.train(mode)

    def eval(self, dataset: Iterable) -> dict[str, float]:
        """Metric name -> value over ``dataset``, capitalized as the notebook
        prints them (``{'Accuracy': 0.97}``)."""
        totals = {m: 0.0 for m in self.metrics}
        count = 0
        for images, labels in dataset:
            labels = to_device(labels, self.device)
            logits = self.predict(images)
            n = len(labels)
            for m in self.metrics:
                totals[m] += float(_METRIC_FNS[m](logits, labels)) * n
            count += n
        return {m.capitalize(): v / max(count, 1) for m, v in totals.items()}
