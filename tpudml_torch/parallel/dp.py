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
from tpudml_torch.optim import Optimizer, ZeRO1
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
    ``obs``: module docstring. ``zero1=True`` wraps the optimizer in
    ``tpudml_torch.optim.ZeRO1`` over the group: its reduce-scatter is the
    aggregation and each rank holds 1/N of the optimizer state;
    ``zero1_overlap=True`` (with ``accum_steps >= 2``) also keeps 1/N of
    the parameters, as ``ts.param_chunks``, and gathers them at the next
    step's start, overlapped with the first micro-batch (read the full
    parameters through :meth:`gather_params`).
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
        if isinstance(optimizer, ZeRO1):
            if not zero1:
                reject("zero1_optimizer_needs_zero1")
            if optimizer.axis_name != "data" or optimizer.world != self.world:
                raise ValueError(
                    f"ZeRO1(axis_name={optimizer.axis_name!r}, world={optimizer.world}) does "
                    f"not match the engine's 'data' axis of size {self.world}")
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
        # ZeRO-1: the optimizer reduce-scatters the gradients and updates this
        # rank's 1/N chunk (tpudml_torch.optim.zero1); zero1_overlap keeps the
        # parameters' chunks in the state and gathers them at the next step's
        # start, behind its first micro-batch.
        self.zero1, self.zero1_overlap = zero1, zero1_overlap
        self._param_names = set(params_of(model))
        if zero1 and not isinstance(optimizer, ZeRO1):
            self.optimizer = ZeRO1(optimizer, axis_name="data", world=self.world, group=group)
        self._param_template = None
        self._fired_modules = None  # zero1_overlap: the modules whose forward runs in a step
        # The sentinel wraps the optimizer outermost (the gradients it sees
        # are already aggregated, so its decision needs no collective), or,
        # under ZeRO-1, sits inside it on the disjoint chunks.
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
        """The replica's TrainState (its model and a fresh optimizer state:
        under ZeRO-1 this rank's chunk of it; the overlap variant also
        carries this rank's parameter chunks in ``param_chunks``)."""
        ts = TrainState.create(self.model, self.optimizer)
        if self.zero1_overlap:
            params = params_of(self.model)
            self._param_template = {n: tuple(p.shape) for n, p in params.items()}
            ts.param_chunks = self.optimizer.shard_params(params)
        return ts

    def gather_params(self, ts: TrainState) -> dict[str, torch.Tensor]:
        """The full parameters: the model's; under ``zero1_overlap`` first
        gathered from ``ts.param_chunks`` into the model (they are stale
        there between steps). Evaluation, checkpoints and parity read
        them through this."""
        if self.zero1_overlap:
            if self._param_template is None:
                raise ValueError("zero1_overlap: create_state must run before gather_params "
                                 "(the original param shapes come from it)")
            full = self.optimizer.gather_params(ts.param_chunks, self._param_template)
            with torch.no_grad():
                for n, p in params_of(self.model).items():
                    p.copy_(full[n])
        return {n: p.detach() for n, p in params_of(self.model).items()}

    def placement(self, kind: str, name: str, shape: tuple):
        """Where this rank's leaf sits (``checkpoint.sharded``'s placement):
        under ZeRO-1 an optimizer-state tensor of a parameter is this rank's
        chunk ``[r·c, (r+1)·c)`` of JAX's flat-padded ``[N·c]`` layout (``[S,
        N·c]`` stacked); every other leaf is replicated (None)."""
        from tpudml_torch.checkpoint.sharded import Window

        if not self.zero1 or kind != "opt" or name not in self._param_names:
            return None
        if self.zero1_overlap:
            raise ValueError("a zero1_overlap state carries parameter chunks: gather_params "
                             "first, and checkpoint a zero1=True engine's state")
        c, r = shape[-1], self.rank
        if len(shape) == 2:
            return Window((shape[0], self.world * c), [[0, shape[0]], [r * c, (r + 1) * c]])
        return Window((self.world * c,), [[r * c, (r + 1) * c]])

    def broadcast_params(self, ts: TrainState, root: int = 0) -> TrainState:
        """Copy rank ``root``'s parameters into every replica (one
        broadcast of the flat parameters): the reference's
        ``init_parameters`` (codes/task2/dist_utils.py:33-37), needed only
        when replicas may have diverged."""
        if self.zero1_overlap:
            raise ValueError("broadcast_params is meaningless under zero1_overlap: the "
                             "per-rank param chunks are distinct BY DESIGN, not divergent")
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
                    grads, self._model_state(), self.world, aggregation=self.aggregation,
                    zero1=self.zero1)
            wire_bytes = self._step_wire_bytes
        normsq = grad_normsq(grads)
        if self.zero1:
            # The grads here are the replica's own (the reduce-scatter is
            # inside the update): the RMS of their norms, as JAX reports.
            normsq = pmean_tree(normsq.to(self.device), self.group)
        metrics["step_stats"] = make_step_stats(metrics["loss"], normsq,
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
        """The step's collectives: the gradients' aggregation (none under
        ZeRO-1, whose reduce-scatter is the mean) and the model state's
        mean."""
        if not self.zero1:
            grads = self.aggregator(grads, self.group)
        self._pmean_model_state()
        return grads

    def _update(self, ts: TrainState, grads: dict) -> TrainState:
        if self.zero1_overlap:
            _, ts.opt_state = self.optimizer.update_shards(grads, ts.opt_state,
                                                           ts.param_chunks)
        else:
            _, ts.opt_state = self.optimizer.update(grads, ts.opt_state, params_of(ts.model))
        ts.step += 1
        return ts

    def _exchange(self, ts: TrainState, grads: dict) -> TrainState:
        """ZeRO-1's weight-update exchange (the split step times it whole):
        the model state's mean, reduce-scatter, chunk update, all-gather."""
        self._pmean_model_state()
        return self._update(ts, grads)

    def _gather_at_start(self, ts: TrainState) -> list:
        """zero1_overlap: start one async all-gather a leaf of the chunks and
        land each leaf (wait, write it into the model) just before its
        module's forward runs, so the gathers of later layers overlap the
        first micro-batch's early layers. A module lands at its forward
        pre-hook only if that hook fired in the first step (which lands
        everything up front and records them): a parameter its model reads
        outside its module's forward (the fused trunk's LayerNorm scales, the
        fused head) is landed before the forward. Returns what
        :meth:`_gather_done` finishes."""
        params = params_of(self.model)
        owners = {}
        for mod_name, mod in self.model.named_modules():
            for k, _ in mod.named_parameters(recurse=False):
                owners[f"{mod_name}.{k}" if mod_name else k] = mod_name
        fired = self._fired_modules
        late = [n for n in params if fired is not None and owners[n] in fired]
        pending = {}
        for n in [n for n in params if n not in late] + late:  # the up-front ones first
            chunk = ts.param_chunks[n]
            full = chunk.new_empty(self.world * chunk.numel())
            work = dist.all_gather_into_tensor(full, chunk.contiguous(), group=self.group,
                                               async_op=True)
            pending[n] = (work, full)

        def land(names):
            with torch.no_grad():
                for n in names:
                    if n in pending:
                        work, full = pending.pop(n)
                        work.wait()
                        p = params[n]
                        p.copy_(full[:p.numel()].view(p.shape))

        land([n for n in params if n not in late])
        record = fired is None
        seen: set = set()
        hooks = []
        for mod_name, mod in self.model.named_modules():
            own = [n for n in late if owners[n] == mod_name]
            if record or own:
                hooks.append(mod.register_forward_pre_hook(
                    lambda m, args, mod_name=mod_name, own=own:
                    seen.add(mod_name) if record else land(own)))
        if record:
            self._fired_modules = seen
        return [hooks, land, pending]

    @staticmethod
    def _gather_done(started: list) -> None:
        hooks, land, pending = started
        for h in hooks:
            h.remove()
        land(list(pending))

    # ----------------------------------------------------------- the steps

    def make_train_step(self) -> Callable:
        return self._make_split_step() if self.measure_comm else self._make_fused_step()

    def _make_fused_step(self) -> Callable:
        if self.zero1_overlap and self._param_template is None:
            raise ValueError("zero1_overlap: call create_state before make_train_step (the "
                             "step gathers into the original param shapes recorded there)")

        def step(ts: TrainState, images, labels):
            with self._obs_span():
                index = ts.step
                started = self._gather_at_start(ts) if self.zero1_overlap else None
                try:
                    grads, local = self.local_grads(ts, images, labels)
                finally:
                    if started is not None:
                        self._gather_done(started)
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
                    dp_wire_bytes_per_step(grads, self._model_state(), self.world, zero1=True)
                    if self.zero1 else
                    aggregation_wire_bytes(self.aggregation, grads, self.world)
                    + collective_wire_bytes("psum", state_bytes, self.world))
            if self.zero1:  # the whole weight-update exchange is the comm span
                ts = timed_call(self.comm_stats, self._exchange, ts, grads,
                                nbytes=wire_bytes[0])
            else:
                grads = timed_call(self.comm_stats, self._aggregate, grads,
                                   nbytes=wire_bytes[0])
                ts = self._update(ts, grads)
            return ts, self._obs_step_stats(self._agg_metrics(local), grads, ts, index,
                                            wire_bytes[0])

        return step

