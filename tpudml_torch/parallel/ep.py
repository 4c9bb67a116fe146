"""Expert parallelism over ``torch.distributed`` process groups (the port
of ``tpudml/parallel/ep.py``).

Tokens and experts shard over the same ranks (the GShard layout): each
rank trains on its rows of every global batch, its MoE layers route those
tokens and ship the ``[E, C, d]`` capacity buffers to the experts' owners
by ``all_to_all`` (``tpudml_torch.nn.moe``), and the parameters fall into
two gradient classes:

- **expert parameters** (a name with an ``experts`` component): each rank
  holds its E/W experts, and their gradients already sum every rank's
  cotangents through the all_to_all's backward, so the engine divides by
  the expert world W to get the mean over the global batch;
- **everything else** (router, embeddings, dense layers): replicated, and
  averaged over all ranks, as under data parallelism.

JAX runs the step as one SPMD program over a mesh ``expert`` axis (and,
with ``batch_axis``, a ``data`` axis); the port runs one process per
shard and the step eagerly: the local forward and backward
(``tpudml_torch.train.local_grads``), the gradient means (one collective
per class and group), the model state's means, the update and the
metrics' mean. The mesh is a dict of axis sizes laid row-major over the
job's ranks, as JAX lays devices: with ``{"data": D, "expert": W}``,
rank ``data_idx·W + expert_idx`` holds shard ``data_idx·W + expert_idx`` of
each batch, the expert groups (which run the all_to_all) gather the ranks
of one ``data_idx``, and the data groups those of one ``expert_idx``.

The optimizer is rewrapped by ``shard_aware_clip``: a ``ClipByGlobalNorm``
in its chain sums the expert leaves' squares over the expert group and
counts the replicated ones once, so every rank clips by the same scale.

Parity oracle (tests): EP over W ranks trains as JAX's ``ExpertParallel``
over W devices from the same parameters and global batches. On a CUDA
device the group must be NCCL's, on the CPU gloo's.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpudml_torch.comm.collectives import all_gather_tree, pmean_tree
from tpudml_torch.core.dist import backend_for
from tpudml_torch.nn.moe import MoELayer, expert_rows, is_expert_param
from tpudml_torch.optim import Optimizer, shard_aware_clip
from tpudml_torch.parallel.dp import shard_rows
from tpudml_torch.parallel.sharding import make_counting_eval_step
from tpudml_torch.train import (
    TrainState, evaluate_counts, local_grads, make_loss_fn, params_of, to_device,
)


def expert_specs(params: dict, axis_name: str = "expert") -> dict:
    """Per-parameter placement (JAX's PartitionSpecs): ``axis_name`` for an
    expert leaf, whose leading (num_experts) dim shards over that axis;
    None for a replicated one."""
    return {n: axis_name if is_expert_param(n) else None for n in params}


def mesh_groups(mesh: dict[str, int]) -> dict[str, tuple]:
    """``{axis: (its process group, this rank's index on it, its size)}``
    for ``mesh``'s axis sizes laid row-major over the job's ranks. A
    one-axis mesh is the default group; on more axes every rank takes part
    in building every subgroup (``dist.new_group``), in one order."""
    axes, sizes = list(mesh), [mesh[a] for a in mesh]
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {mesh} does not lay out over the {world} ranks of the job")
    rank = dist.get_rank()
    coords = [(rank // math.prod(sizes[i + 1:])) % sizes[i] for i in range(len(axes))]
    if len(axes) == 1:
        return {axes[0]: (dist.group.WORLD, coords[0], sizes[0])}
    out = {}
    for i, axis in enumerate(axes):
        others = [range(s) for j, s in enumerate(sizes) if j != i]
        for rest in itertools.product(*others):
            members = []
            for k in range(sizes[i]):
                c = list(rest)
                c.insert(i, k)
                members.append(sum(ci * math.prod(sizes[j + 1:]) for j, ci in enumerate(c)))
            sub = dist.new_group(members, backend=dist.get_backend())
            if list(rest) == coords[:i] + coords[i + 1:]:
                out[axis] = (sub, coords[i], sizes[i])
    return out


class ExpertParallel:
    """EP training engine over a process group's ``expert`` axis.

    Usage::

        model = TransformerLM(..., moe_experts=8, moe_axis="expert")
        ep = ExpertParallel(model, opt)          # the default group, one axis
        ts = ep.create_state()
        step = ep.make_train_step()              # (ts, x, labels) -> (ts, metrics)

    The model's MoE layers must carry ``axis_name`` equal to this engine's
    ``axis_name``; the engine binds them to the expert group and keeps this
    rank's slice of each expert tensor (the model is built whole, from the
    same seed on every rank, as JAX's ``create_state`` draws it whole and
    shards it). Batches are GLOBAL and the same on every rank; each rank
    trains on its rows (:meth:`shard_batch`). ``mesh`` is the axis sizes
    laid row-major over the job's ranks (default ``{axis_name: world}``);
    ``batch_axis`` names a second axis of it for EP×DP (experts replicate
    over it, tokens shard over both). ``aux_loss_weight`` is the Switch
    load-balancing α (JAX's default 1e-2; 0.0 turns it off).
    """

    def __init__(self, model: nn.Module, optimizer: Optimizer, mesh: dict | None = None,
                 axis_name: str = "expert", aux_loss_weight: float = 1e-2,
                 batch_axis: str | None = None):
        if not dist.is_initialized():
            raise RuntimeError(
                "ExpertParallel needs a process group: call "
                "tpudml_torch.core.distributed_init (or run inside process_group) first")
        mesh = dict(mesh) if mesh is not None else {axis_name: dist.get_world_size()}
        if axis_name not in mesh:
            raise ValueError(f"axis_name {axis_name!r} is not a mesh axis (mesh: {mesh})")
        if batch_axis is not None and (batch_axis not in mesh or batch_axis == axis_name):
            raise ValueError(
                f"batch_axis {batch_axis!r} must be a mesh axis distinct "
                f"from the expert axis {axis_name!r} (mesh: {tuple(mesh)})")
        if set(mesh) - {axis_name, batch_axis}:
            raise ValueError(f"mesh {mesh} has axes beyond the expert axis and batch_axis")
        self.device = next(model.parameters()).device
        backend = dist.get_backend()
        if backend != backend_for(self.device):
            raise RuntimeError(f"a {self.device.type} shard needs a "
                               f"{backend_for(self.device)} group; this one is {backend}")
        layers = [m for m in model.modules() if isinstance(m, MoELayer)]
        for layer in layers:
            if layer.axis_name != axis_name:
                raise ValueError(f"a MoELayer has axis_name {layer.axis_name!r}; build the "
                                 f"model's MoE layers with axis_name={axis_name!r}")
        groups = mesh_groups(mesh)
        self.model = model
        self.mesh = mesh
        self.axis_name = axis_name
        self.batch_axis = batch_axis
        self.group = dist.group.WORLD  # the replicated leaves' and the metrics' mean
        self.expert_group, self.expert_index, self.world = groups[axis_name]
        self.data_group, data_index, _ = groups[batch_axis] if batch_axis else (None, 0, 1)
        self.n_shards = dist.get_world_size()
        self.shard = data_index * self.world + self.expert_index  # this rank's batch rows
        for layer in layers:
            self._keep_local_experts(layer)
            layer.group = self.expert_group
        self.optimizer = shard_aware_clip(optimizer, (self.expert_group,), is_expert_param)
        self._loss_fn = make_loss_fn(model, aux_loss_weight)

    def _keep_local_experts(self, layer: MoELayer) -> None:
        """Replace ``layer``'s expert tensors [E, ...] by this rank's rows
        (``expert_rows``; nothing to do at W = 1)."""
        e = layer.num_experts
        for name, p in list(layer.experts.named_parameters(recurse=False)):
            if p.shape[0] != e:
                raise ValueError(f"expert tensor {name} holds {p.shape[0]} of {e} experts: "
                                 "the model is already sharded")
            rows = expert_rows(p.detach(), self.expert_index, self.world, name)
            if self.world > 1:
                setattr(layer.experts, name, nn.Parameter(rows.clone(),
                                                          requires_grad=p.requires_grad))

    # ---------------------------------------------------------------- state

    def create_state(self) -> TrainState:
        """This rank's TrainState (its shard of the model, a fresh optimizer
        state of the rewrapped optimizer)."""
        return TrainState.create(self.model, self.optimizer)

    def shard_batch(self, images, labels):
        """This rank's rows of a global batch on its device: shard
        ``data_idx·W + expert_idx`` of ``mesh``'s row-major layout."""
        x, y = shard_rows(images, labels, self.n_shards, self.shard, stacked=False)
        return to_device(x, self.device), to_device(y, self.device)

    # ------------------------------------------------------------ the means

    def _mean(self, tree: dict, expert_sums: bool) -> dict:
        """JAX's ``_mean_grads`` rule on a dict of tensors: expert leaves ÷ W
        where they are sums over the expert group (``expert_sums``: the
        gradients, whose sum came through the all_to_all), then averaged
        over the data group; every other leaf averaged over all ranks. One
        collective a class."""
        div = self.world if expert_sums else 1
        expert = {n: t / div for n, t in tree.items() if is_expert_param(n)}
        rest = {n: t for n, t in tree.items() if not is_expert_param(n)}
        out = dict(pmean_tree(rest, self.group)) if rest else {}
        if expert and self.data_group is not None:
            expert = pmean_tree(expert, self.data_group)
        out.update(expert)
        return {n: out[n] for n in tree}

    def mean_grads(self, ts: TrainState, images, labels):
        """``(grads, local metrics)``: this rank's gradients on its rows of
        the global batch, averaged by the EP rule (:meth:`_mean`); the
        metrics (loss, accuracy) are this rank's own."""
        x, y = self.shard_batch(images, labels)
        grads, metrics = local_grads(self._loss_fn, ts.model, x, y, with_accuracy=True)
        return self._mean(grads, expert_sums=True), metrics

    def _mean_model_state(self) -> None:
        """The model's float buffers: an expert's averaged over the data
        group, the rest over all ranks (none in the transformer or the MoE
        classifier; BatchNorm's would be)."""
        state = {n: b for n, b in self.model.named_buffers() if b.is_floating_point()}
        if state:
            new = self._mean(state, expert_sums=False)
            with torch.no_grad():
                for name, b in state.items():
                    b.copy_(new[name])

    # ----------------------------------------------------------- the steps

    def make_train_step(self) -> Callable:
        """(ts, images, labels) -> (ts, {"loss", "accuracy"} averaged over all
        ranks): the local step, the means, the update."""

        def step(ts: TrainState, images, labels):
            grads, local = self.mean_grads(ts, images, labels)
            self._mean_model_state()
            _, ts.opt_state = self.optimizer.update(grads, ts.opt_state, params_of(ts.model))
            ts.step += 1
            return ts, pmean_tree(local, self.group)

        return step

    # ----------------------------------------------------------- checkpoints

    def placement(self, kind: str, name: str, shape: tuple):
        """Where this rank's leaf sits (``checkpoint.sharded``'s placement):
        an expert tensor of the parameters or the optimizer state is rows
        ``[i·E/W, (i+1)·E/W)`` of the whole, written by data index 0; every
        other leaf is replicated (None)."""
        from tpudml_torch.checkpoint.sharded import Window

        if kind not in ("param", "opt") or not is_expert_param(name) or not shape:
            return None
        rows = shape[0]
        index = [[self.expert_index * rows, (self.expert_index + 1) * rows],
                 *[[0, n] for n in shape[1:]]]
        return Window((rows * self.world, *shape[1:]), index,
                      write=self.shard // self.world == 0)

    def _whole(self, tree: dict) -> dict:
        """``tree`` (by parameter name) with every expert tensor
        all-gathered whole over the expert group (one collective a dtype)."""
        experts = {n: t.detach() for n, t in tree.items() if is_expert_param(n)}
        full = all_gather_tree(experts, self.expert_group, axis=0, tiled=True) if experts else {}
        return {n: full[n] if n in full else t.detach() for n, t in tree.items()}

    def full_state(self, ts: TrainState) -> list:
        """JAX's global view of ``ts`` for the base store (call on every
        rank): ``[params, model state, optimizer state, step]`` in JAX's
        TrainState order, each expert tensor whole, the MoE layers' last
        aux terms as JAX's ``aux_loss`` state entries, Python ints (Adam's
        clock, the step) as int32. Rank 0 writes it as JAX's task5 writes
        its global arrays."""
        params = params_of(ts.model)

        def whole(state):
            if isinstance(state, dict):
                if state and set(state) <= set(params):
                    return self._whole(state)
                return {k: whole(v) for k, v in state.items()}
            if isinstance(state, int) and not isinstance(state, bool):
                return np.int32(state)
            return state

        state = {n: b.detach() for n, b in ts.model.named_buffers() if b.is_floating_point()}
        # JAX's model state also holds each MoE layer's last aux term,
        # averaged over the ranks as its EP engine averages the state.
        aux = {f"{n}.aux_loss": getattr(m, "last_aux", None)
               for n, m in ts.model.named_modules() if isinstance(m, MoELayer)}
        if aux:
            dev = next(ts.model.parameters()).device
            state.update(pmean_tree({k: (v if v is not None else torch.zeros((), device=dev))
                                     .float().reshape(()) for k, v in aux.items()}, self.group))
        return [self._whole(params), state, whole(ts.opt_state), np.int32(ts.step)]

    @torch.no_grad()
    def load_full_state(self, ts: TrainState, full: list) -> TrainState:
        """Write a :meth:`full_state` tree (as restored: whole experts) back
        into ``ts`` in place: this rank's rows of each expert tensor, the
        rest whole, the ints and the step as ints (the aux terms are a
        record the next forward rewrites)."""
        params, buffers, opt, step = full

        def local(name, t):
            t = torch.as_tensor(t)
            return expert_rows(t, self.expert_index, self.world, name) \
                if is_expert_param(name) and t.dim() else t

        for n, p in params_of(ts.model).items():
            p.copy_(local(n, params[n]))
        for n, b in ts.model.named_buffers():
            if n in buffers:
                b.copy_(torch.as_tensor(buffers[n]))

        def load(state, saved):
            if isinstance(state, dict):
                for k, v in state.items():
                    if isinstance(v, torch.Tensor):
                        v.copy_(local(k, saved[k]))
                    elif isinstance(v, int) and not isinstance(v, bool):
                        state[k] = int(saved[k])
                    else:
                        load(v, saved[k])

        load(ts.opt_state, opt)
        ts.step = int(step)
        return ts

    def make_forward(self) -> Callable:
        """x (the global batch) -> the logits of every row, on every rank:
        this rank's rows through the model (its MoE layers' all_to_all over
        the expert group) in eval mode without a graph, all-gathered in
        shard order (JAX's jitted forward with batch-sharded output)."""

        @torch.no_grad()
        def forward(x):
            xb, _ = self.shard_batch(x, torch.zeros(len(x), dtype=torch.long))
            mode = self.model.training
            self.model.eval()
            try:
                logits = self.model(xb)
            finally:
                self.model.train(mode)
            return all_gather_tree(logits, self.group, axis=0, tiled=True)

        return forward

    def make_eval_step(self) -> Callable:
        """(images, labels) -> (correct, count) summed over all ranks
        (``make_counting_eval_step``)."""
        return make_counting_eval_step(self.model, self.shard_batch, self.group)

    def evaluate(self, ts: TrainState, loader) -> float:
        """Top-1 accuracy over ``loader``'s global batches, every rank's rows
        counted once."""
        return evaluate_counts(self.make_eval_step(), ts, loader)
