"""Data parallelism over a ``torch.distributed`` process group (the port
of ``tpudml/parallel/dp.py``).

The reference's DDP loop (codes/task2/model.py:40-72, codes/task3/
model.py:39-64): replicated parameters, a per-replica slice of each
global batch, gradients aggregated every step. JAX runs the whole step as
one SPMD program over a mesh ``data`` axis; the port runs one process per
replica, each on its own device, and the step eagerly: the local forward
and backward (``tpudml_torch.train.accumulate_grads``), then ONE
aggregation collective over the group (the chosen strategy of
``tpudml_torch.comm.collectives`` on a flat copy of the gradients, not
one call per parameter), then the optimizer update and the metrics
averaged over the replicas. The model is not wrapped in
``DistributedDataParallel``: the explicit collective after the backward
keeps the split step's timing and the three strategies as JAX has them
(overlapping it with the backward is later work).

Two execution modes, as in JAX:

- **fused** (default): local grads, aggregation, update, back to back.
- **split / measure_comm**: the device is synchronized after the local
  grads, one rank may sleep before the collective (the straggler of
  codes/task2/model-mp.py:47,64-65), and the aggregation alone is timed
  into ``comm_stats`` with its ring-model wire bytes.

``obs=True`` (or a ``tpudml_torch.obs.Tracer``) records one ``train_step``
span a step, the card synchronized before it closes (JAX's span times the
dispatch; the port's eager step would otherwise time only the launches),
feeds ``comm_stats`` to the tracer, and adds ``metrics["step_stats"]``
(``tpudml_torch.obs.StepStats``) from the aggregated gradients; the split
step builds them from its measured wire bytes. ``sentinel=True`` (or a
dict of ``GradSentinel`` options) wraps the optimizer in
``tpudml_torch.resilience.GradSentinel`` (``self.sentinel``): a
non-finite step is skipped on the device, and ``metrics["bad_micro"]``
names the first poisoned micro-batch (the max over the replicas).

On a CUDA device the group must be NCCL's, on the CPU gloo's; anything
else raises. JAX's ``DispatchThrottle`` (``tpudml/parallel/sharding.py``)
bounds asynchronous dispatch on its CPU mesh; an eager step has nothing
to bound, so it has no counterpart here.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from tpudml_torch.capabilities import reject
from tpudml_torch.comm.collectives import (
    aggregation_wire_bytes, broadcast_from, get_aggregator, pmax_tree, pmean_tree,
)
from tpudml_torch.comm.timing import (
    CommStats, collective_wire_bytes, synchronize, timed_call,
)
from tpudml_torch.core.dist import backend_for
from tpudml_torch.nn.attention import MultiHeadAttention
from tpudml_torch.nn.losses import softmax_cross_entropy
from tpudml_torch.obs.stepstats import dp_wire_bytes_per_step, grad_normsq, make_step_stats
from tpudml_torch.obs.tracer import NULL_SPAN, Tracer
from tpudml_torch.optim import Optimizer
from tpudml_torch.resilience.sentinel import attach_sentinel, find_sentinel
from tpudml_torch.train import (
    TrainState, accumulate_grads, make_lm_fused_loss_fn, make_loss_fn, params_of, to_device,
)

NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item {})"


def _use_flash(model: nn.Module) -> None:
    """Swap a dense causal trunk onto the flash kernels, in place."""
    model.impl = "flash"
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.impl = "flash"


def shard_rows(images, labels, world: int, rank: int, stacked: bool | None):
    """Rank ``rank``'s rows of a global batch (tensors or numpy arrays):
    ``[rank·B, (rank+1)·B)`` of a ``[world×B, ...]`` batch, or the
    ``[world, B, ...]`` stacked form flattened first. ``stacked=None``
    infers it: stacked iff the leading dim is the world size AND the
    inputs carry at least two more dims than the labels (image-shaped
    samples), so 2-D LM token batches never match the inference."""
    images, labels = torch.as_tensor(images), torch.as_tensor(labels)
    if stacked is None:
        stacked = (labels.dim() >= 2 and labels.shape[0] == world
                   and images.dim() >= labels.dim() + 2)
    if stacked:
        if images.shape[0] != world:
            raise ValueError(f"stacked batch leading dim {images.shape[0]} != "
                             f"{world}-way data group")
        images = images.reshape(-1, *images.shape[2:])
        labels = labels.reshape(-1, *labels.shape[2:])
    if images.shape[0] % world:
        raise ValueError(
            f"global batch of {images.shape[0]} rows is not divisible by the "
            f"{world}-way data group; pick a divisible batch_size "
            "(drop_remainder=True avoids ragged final batches)")
    b = images.shape[0] // world
    return images[rank * b:(rank + 1) * b], labels[rank * b:(rank + 1) * b]


class DataParallel:
    """DP training engine: this process's replica of ``model`` on its
    device, aggregated over ``group`` (None = the default group, which
    ``tpudml_torch.core.distributed_init`` or ``process_group`` brings
    up).

    Usage::

        dp = DataParallel(model, opt, aggregation="allreduce")
        ts = dp.create_state()
        step = dp.make_train_step()        # (ts, images, labels) -> (ts, metrics)

    ``images``/``labels`` are GLOBAL batches (leading dim = world ×
    per-replica batch), the same on every rank; each rank trains on its
    rows (:meth:`shard_batch`), so a run fed the global batches of a JAX
    ``DataParallel`` run sees the same per-replica data. Replicas start
    equal when every rank builds ``model`` from the same seed
    (:meth:`broadcast_params` forces it). ``flash_attn=True`` swaps the
    model's dense trunk onto the flash kernels in place (JAX returns a
    new model). ``accum_steps`` splits each replica's rows into
    sequential micro-batches (``tpudml_torch.train.accumulate_grads``);
    ``rng_root`` (a ``tpudml_torch.core.prng.Key``) seeds the dropout
    streams, one a replica and a step: ``rng_root.fold_in(step)
    .fold_in(rank)``, as JAX folds the mesh position. ``sentinel`` and
    ``obs``: module docstring. ``zero1`` and ``zero1_overlap`` are not
    ported and raise ``NotImplementedError`` naming their ROADMAP item.
    """

    def __init__(
        self,
        model: nn.Module,
        optimizer: Optimizer,
        group=None,
        *,
        aggregation: str = "allreduce",
        measure_comm: bool = False,
        bottleneck_rank: int | None = None,
        bottleneck_delay_s: float = 0.1,
        rng_root=None,
        accum_steps: int = 1,
        loss: Callable = softmax_cross_entropy,
        stacked_batches: bool | None = None,
        aux_loss_weight: float | None = None,
        fused_xent: bool = False,
        save_scores: bool | None = None,
        zero1: bool = False,
        zero1_overlap: bool = False,
        sentinel: bool | dict = False,
        obs=False,
        flash_attn: bool = False,
        device: str | torch.device | None = None,
    ):
        if save_scores and not fused_xent:
            reject("save_scores_needs_fused_xent")
        if fused_xent and (measure_comm or loss is not softmax_cross_entropy):
            reject("dp_fused_xent_split_step")
        if zero1_overlap and not zero1:
            reject("zero1_overlap_needs_zero1")
        if zero1 and aggregation != "allreduce":
            reject("zero1_replaces_aggregation")
        if zero1_overlap and accum_steps < 2:
            reject("zero1_overlap_needs_accum")
        if zero1_overlap and measure_comm:
            reject("zero1_overlap_measure_comm")
        if flash_attn and (getattr(model, "impl", None) != "full"
                           or getattr(model, "seq_sharded", False)):
            reject("train_flash_attn_dense")
        for knob, on, item in (("zero1", zero1, "7 (ZeRO-1)"),
                               ("zero1_overlap", zero1_overlap, "7 (ZeRO-1)")):
            if on:
                raise NotImplementedError(f"DataParallel({knob}=...) {NOT_PORTED.format(item)}")
        aggregator = get_aggregator(aggregation)
        if not dist.is_initialized():
            raise RuntimeError(
                "DataParallel needs a process group: call "
                "tpudml_torch.core.distributed_init (or run inside process_group) first")
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        backend = dist.get_backend(group)
        if backend != backend_for(self.device):
            raise RuntimeError(f"a {self.device.type} replica needs a "
                               f"{backend_for(self.device)} group; this one is {backend}")
        self.aggregator = aggregator
        self.flash_attn = flash_attn
        if flash_attn:  # after every check: a refused engine leaves the model as it was
            _use_flash(model)
        self.model = model
        self.optimizer = optimizer
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.stacked_batches = stacked_batches
        self.aggregation = aggregation
        self.measure_comm = measure_comm
        self.bottleneck_rank = bottleneck_rank
        self.bottleneck_delay_s = bottleneck_delay_s
        self.rng_root = rng_root
        self.accum_steps = accum_steps
        self.comm_stats = CommStats()
        # Observability: obs=True builds a Tracer, a Tracer passes through.
        self.tracer: Tracer | None = None
        self._step_wire_bytes: float | None = None
        if obs:
            self.tracer = obs if isinstance(obs, Tracer) else Tracer()
            self.comm_stats.tracer = self.tracer
        # The sentinel wraps the optimizer outermost: the gradients it sees
        # are already aggregated, so its decision needs no collective.
        self.sentinel = None
        if sentinel:
            kw = dict(sentinel) if isinstance(sentinel, dict) else {}
            self.optimizer = attach_sentinel(self.optimizer, (), **kw)
            self.sentinel = find_sentinel(self.optimizer)
        self.fused_xent = fused_xent
        self._fused_loss_fn = (make_lm_fused_loss_fn(model, save_scores, aux_loss_weight)
                               if fused_xent else None)
        self._loss_fn = make_loss_fn(model, aux_loss_weight, loss)

    # ---------------------------------------------------------------- state

    def create_state(self) -> TrainState:
        """The replica's TrainState (its model and a fresh optimizer state)."""
        return TrainState.create(self.model, self.optimizer)

    def broadcast_params(self, ts: TrainState, root: int = 0) -> TrainState:
        """Copy rank ``root``'s parameters into every replica (one
        broadcast of the flat parameters): the reference's
        ``init_parameters`` (codes/task2/dist_utils.py:33-37), needed only
        when replicas may have diverged."""
        params = params_of(ts.model)
        new = broadcast_from({n: p.detach() for n, p in params.items()}, self.group, root)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(new[name])
        return ts

    def shard_batch(self, images, labels):
        """This rank's rows of a global host batch, on the replica's device
        (:func:`shard_rows` with the engine's ``stacked_batches``); token
        ids and labels as int64, images as floats."""
        x, y = shard_rows(images, labels, self.world, self.rank, self.stacked_batches)
        return to_device(x, self.device), to_device(y, self.device)

    def _model_state(self) -> dict:
        return {n: b for n, b in self.model.named_buffers() if b.is_floating_point()}

    def _pmean_model_state(self) -> None:
        """Average the model's float buffers (BatchNorm's running
        statistics, which each replica updated from its own rows: not
        SyncBN) over the replicas after the local step, as JAX does; the
        transformer has none."""
        state = self._model_state()
        if state:
            new = pmean_tree(state, self.group)
            with torch.no_grad():
                for name, b in state.items():
                    b.copy_(new[name])

    def _agg_metrics(self, local: dict) -> dict:
        """The step's metrics averaged over the replicas (one collective),
        but the sentinel's ``bad_micro`` index: its max (-1 is clean; a
        mean would mangle the integer)."""
        means = pmean_tree({k: v for k, v in local.items() if k != "bad_micro"}, self.group)
        if "bad_micro" in local:
            means["bad_micro"] = pmax_tree(local["bad_micro"], self.group)
        return means

    def _obs_span(self):
        """The step's tracer span (the card synchronized before it closes);
        the shared no-op when obs is off."""
        if self.tracer is None:
            return NULL_SPAN
        return self.tracer.span("train_step", cat="step", sync=next(self.model.parameters()))

    def _obs_step_stats(self, metrics: dict, grads: dict, ts: TrainState, step: int,
                        wire_bytes: float | None = None) -> dict:
        """``metrics`` with the step's ``StepStats`` (obs on only): the
        aggregated gradients' norm, the post-update sentinel counters, and
        the wire bytes a step (the ring model's, or the split step's
        measured ones) times ``step + 1``."""
        if self.tracer is None:
            return metrics
        if wire_bytes is None:
            if self._step_wire_bytes is None:  # the shapes are the same every step
                self._step_wire_bytes = dp_wire_bytes_per_step(
                    grads, self._model_state(), self.world, aggregation=self.aggregation)
            wire_bytes = self._step_wire_bytes
        metrics["step_stats"] = make_step_stats(metrics["loss"], grad_normsq(grads),
                                                ts.opt_state, wire_bytes, step)
        return metrics

    def local_grads(self, ts: TrainState, images, labels):
        """This rank's un-aggregated ``(grads, metrics)`` on its rows of the
        global batch (``tpudml_torch.train.accumulate_grads``, with the
        replica's dropout key of the step)."""
        x, y = self.shard_batch(images, labels)
        loss_fn = self._fused_loss_fn if self.fused_xent else self._loss_fn
        rng = (None if self.rng_root is None
               else self.rng_root.fold_in(ts.step).fold_in(self.rank))
        return accumulate_grads(loss_fn, ts.model, x, y, rng, self.accum_steps,
                                taint=self.sentinel is not None)

    def _aggregate(self, grads: dict) -> dict:
        """The step's collectives: the gradients' aggregation and the model
        state's mean."""
        grads = self.aggregator(grads, self.group)
        self._pmean_model_state()
        return grads

    def _update(self, ts: TrainState, grads: dict) -> TrainState:
        _, ts.opt_state = self.optimizer.update(grads, ts.opt_state, params_of(ts.model))
        ts.step += 1
        return ts

    # ----------------------------------------------------------- the steps

    def make_train_step(self) -> Callable:
        return self._make_split_step() if self.measure_comm else self._make_fused_step()

    def _make_fused_step(self) -> Callable:
        def step(ts: TrainState, images, labels):
            with self._obs_span():
                index = ts.step
                grads, local = self.local_grads(ts, images, labels)
                grads = self._aggregate(grads)
                ts = self._update(ts, grads)
                metrics = self._obs_step_stats(self._agg_metrics(local), grads, ts, index)
            return ts, metrics

        return step

    def _make_split_step(self) -> Callable:
        """Local grads → [device synchronized; the straggler's sleep] →
        the aggregation, TIMED (the ``comm_time_sum`` span of
        model-mp.py:61-66) → the update."""
        wire_bytes: list = []

        def step(ts: TrainState, images, labels):
            with self._obs_span():
                return split(ts, images, labels)

        def split(ts: TrainState, images, labels):
            index = ts.step
            grads, local = self.local_grads(ts, images, labels)
            synchronize(grads)
            if (self.bottleneck_rank is not None
                    and self.rank == self.bottleneck_rank % self.world):
                # This rank enters the collective late (reference:
                # time.sleep(bottle_neck_delay) on one rank); in a
                # synchronous step every rank inherits the delay.
                time.sleep(self.bottleneck_delay_s)
            if not wire_bytes:
                state_bytes = sum(b.numel() * b.element_size()
                                  for b in self._model_state().values())
                wire_bytes.append(
                    aggregation_wire_bytes(self.aggregation, grads, self.world)
                    + collective_wire_bytes("psum", state_bytes, self.world))
            grads = timed_call(self.comm_stats, self._aggregate, grads, nbytes=wire_bytes[0])
            ts = self._update(ts, grads)
            return ts, self._obs_step_stats(self._agg_metrics(local), grads, ts, index,
                                            wire_bytes[0])

        return step

