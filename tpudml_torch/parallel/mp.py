"""Model parallelism driven by sharding rules (the port of
``tpudml/parallel/mp.py``: ``stage_sharding_rules``, ``replicated_rules``,
``tensor_parallel_rules``, ``apply_rules``, ``GSPMDParallel``).

A rule maps each parameter, by its JAX path, to a ``PartitionSpec``: here
a tuple with one entry per dimension, a mesh axis name (or a tuple of
names, or None), as JAX's ``PartitionSpec`` holds them; ``()`` is
replicated. Specs are in JAX's layout (a conv kernel HWIO) and equal
JAX's leaf for leaf, the demotion of a dimension the axis size does not
divide included. The mesh is a dict of axis sizes laid row-major over
the job's ranks (``parallel.ep.mesh_groups``).

Placement is JAX's ``NamedSharding``'s: each rank keeps its block of
every sharded parameter, the contiguous block in rank order along each
sharded dimension, and its optimizer state is shaped like that block.

The step gathers the weights (JAX's XLA partitioner moves activations
instead, a defined difference). Before the forward, each sharded
parameter is all-gathered over its axis, one collective a dtype and
axis, through an autograd op. Over an axis that is not ``batch_axis``
every rank of the group runs the whole forward and backward on the same
rows, so the full gradient is the same on each and the op's backward
keeps this rank's block of it. Over ``batch_axis`` itself (FSDP shards
the parameters over the data axis, ``parallel/fsdp.py``) the ranks hold
different rows, so the backward reduce-scatters the ranks' full
gradients (one collective a dtype) and divides by the axis size: this
rank's block of their data mean. With ``batch_axis`` each data rank
takes its rows of the global batch, and the gradients of the leaves not
split over it (and the loss, and the model's float buffers) are averaged
over the data group. The results are those of single-device training,
for any rule. Custom autograd functions (the flash kernels) see plain
tensors.

``fused_xent`` trains a ``TransformerLM`` through the vocab-sharded fused
head (``train.make_lm_fused_sharded_loss_fn``): the head's vocabulary
dimension stays in blocks, each rank runs the head kernels on its shard
and the shards merge their statistics.

What crosses ranks each step: the all-gather of the sharded parameters'
blocks, (size − 1) × the block's bytes into each rank; over
``batch_axis`` also the reduce-scatter of the gathered gradient; the
data group's mean of the other gradients. For ``lenet_stages`` at world
2 every leaf shards (51,902 f32 parameters): 103,804 bytes into each rank
a step, and no gradient exchange.

JAX's ``DispatchThrottle`` has nothing to bound in an eager step
(``parallel/sharding.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpudml_torch.capabilities import reject
from tpudml_torch.comm.collectives import pmax_tree, pmean_tree, psum_tree
from tpudml_torch.comm.timing import collective_wire_bytes
from tpudml_torch.core.dist import backend_for
from tpudml_torch.nn.losses import softmax_cross_entropy
from tpudml_torch.obs.stepstats import grad_normsq, make_step_stats
from tpudml_torch.obs.tracer import NULL_SPAN, Tracer
from tpudml_torch.optim import Optimizer, shard_aware_clip
from tpudml_torch.parallel.dp import _use_flash, shard_rows
from tpudml_torch.parallel.ep import mesh_groups
from tpudml_torch.parallel.sharding import make_counting_eval_step
from tpudml_torch.resilience.sentinel import attach_sentinel, find_sentinel
from tpudml_torch.train import (
    TrainState, accumulate_grads, make_lm_fused_sharded_loss_fn, make_loss_fn, params_of,
    resolve_aux_loss_weight, to_device,
)

PartitionSpec = tuple
RuleFn = Callable[[tuple, "Leaf"], PartitionSpec]

# JAX's HWIO dimension j of a conv kernel is the port's (OIHW) dimension
# _OIHW[j].
_OIHW = (2, 3, 1, 0)


@dataclass(frozen=True)
class Leaf:
    """A parameter as a rule sees it: its shape in JAX's layout."""

    shape: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _is_conv_kernel(name: str, t: torch.Tensor) -> bool:
    return t.dim() == 4 and name.split(".")[-1] == "kernel"


def jax_leaf(name: str, t: torch.Tensor) -> Leaf:
    """``t`` (named ``name``) as JAX holds it: a conv kernel OIHW -> HWIO."""
    s = tuple(t.shape)
    if _is_conv_kernel(name, t):
        s = (s[2], s[3], s[1], s[0])
    return Leaf(s)


def port_dim(name: str, t: torch.Tensor, jax_dim: int) -> int:
    """The port's dimension of ``t`` that JAX's ``jax_dim`` names."""
    return _OIHW[jax_dim] if _is_conv_kernel(name, t) else jax_dim


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


# ------------------------------------------------------------------ rules


def stage_sharding_rules(axis_name: str = "stage") -> RuleFn:
    """Shard each weight's OUTPUT dimension over the axis: kernel [in, out]
    -> (None, axis); conv kernel [h, w, in, out] -> (None, None, None,
    axis); bias [out] -> (axis,); the rest replicated. A dimension the
    axis size does not divide is demoted at :func:`apply_rules`."""

    def rule(path: tuple, leaf) -> PartitionSpec:
        name = path[-1] if path else ""
        if name == "kernel" and leaf.ndim == 2:
            return (None, axis_name)
        if name == "kernel" and leaf.ndim == 4:
            return (None, None, None, axis_name)
        if name == "bias" and leaf.ndim == 1:
            return (axis_name,)
        return ()

    return rule


def replicated_rules() -> RuleFn:
    return lambda path, leaf: ()


def tensor_parallel_rules(axis_name: str = "model") -> RuleFn:
    """Megatron-style tensor parallelism for the transformer: QKV and the
    MLP's fc1 split on the output dimension, the attention out and fc2
    kernels on the input dimension, the token table on the vocabulary, the
    head on its output; norms, the positions and the out/fc2 biases
    replicated; other leaves by :func:`stage_sharding_rules`."""
    generic = stage_sharding_rules(axis_name)

    def rule(path: tuple, leaf) -> PartitionSpec:
        names = set(path)
        last2 = tuple(path[-2:]) if len(path) >= 2 else ()
        if "attn" in names:
            if last2 and last2[0] in ("q", "k", "v"):
                return (None, axis_name) if last2[1] == "kernel" else (axis_name,)
            if last2 == ("out", "kernel"):
                return (axis_name, None)
            return ()
        if last2 and last2[0] == "fc1":
            return (None, axis_name) if last2[1] == "kernel" else (axis_name,)
        if last2 and last2[0] == "fc2":
            return (axis_name, None) if last2[1] == "kernel" else ()
        if path and path[-1] == "tok_embed":
            return (axis_name, None)
        if path and path[-1] == "pos_embed":
            return ()
        if last2 and last2[0] == "head":
            return (None, axis_name) if last2[1] == "kernel" else (axis_name,)
        if "ln1" in names or "ln2" in names or "ln_f" in names:
            return ()
        return generic(path, leaf)

    return rule


def _named(tree) -> dict[str, torch.Tensor]:
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def apply_rules(rule: RuleFn, params, mesh: dict[str, int]) -> dict[str, PartitionSpec]:
    """``{name: spec}`` for ``params`` (a module or a dict by dotted name):
    ``rule`` on each parameter's JAX path and JAX-layout shape, each
    dimension whose size the product of its axes' sizes does not divide
    demoted to None (any model runs on any mesh, less parallel)."""
    out = {}
    for name, t in _named(params).items():
        leaf = jax_leaf(name, t)
        spec = rule(tuple(name.split(".")), leaf)
        dims = []
        for dim, entry in enumerate(spec):
            size = math.prod(mesh[a] for a in _axes(entry))
            dims.append(entry if entry is not None and leaf.shape[dim] % size == 0 else None)
        out[name] = tuple(dims)
    return out


def block_window(name: str, t_shape: tuple, spec: PartitionSpec, mesh: dict[str, int],
                 coords: dict[str, int]) -> list[list[int]]:
    """The ``[start, stop)`` window of each JAX dimension that the rank at
    mesh ``coords`` holds of a leaf of JAX shape ``t_shape`` under
    ``spec``: along a sharded dimension, block ``row-major index of its
    axes`` of ``prod(sizes)`` equal blocks, as ``NamedSharding`` places
    it."""
    out = []
    for dim, n in enumerate(t_shape):
        axes = _axes(spec[dim]) if dim < len(spec) else ()
        parts, index = 1, 0
        for a in axes:
            parts, index = parts * mesh[a], index * mesh[a] + coords[a]
        size = n // parts
        out.append([index * size, (index + 1) * size])
    return out


def cut_to_blocks(model: nn.Module, specs: dict[str, PartitionSpec], mesh: dict[str, int],
                  coords: dict[str, int]) -> dict[str, tuple]:
    """Replace every parameter of ``model`` that ``specs`` shards by the
    block the rank at mesh ``coords`` holds (:func:`block_window`), in
    place; returns every parameter's full JAX shape, by name."""
    shapes = {n: jax_leaf(n, p).shape for n, p in model.named_parameters()}
    for name, p in list(model.named_parameters()):
        spec = specs[name]
        if not any(_axes(e) for e in spec):
            continue
        block = p.detach()
        for jd, (lo, hi) in enumerate(block_window(name, shapes[name], spec, mesh, coords)):
            block = block.narrow(port_dim(name, p, jd), lo, hi - lo)
        mod_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(mod_name) if mod_name else model
        setattr(owner, attr, nn.Parameter(block.clone(memory_format=torch.contiguous_format)
                                          if p.dim() != 4 else
                                          block.contiguous(memory_format=torch.channels_last),
                                          requires_grad=p.requires_grad))
    return shapes


# ----------------------------------------------------------- the gather


def _by_dtype(xs) -> list[list[int]]:
    groups: dict = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    return list(groups.values())


def reduce_scatter_blocks(gs, dims: tuple, group, size: int) -> list[torch.Tensor]:
    """This rank's block, along ``dims[i]``, of the group's sum of each
    ``gs[i]`` divided by ``size`` (their mean): one reduce-scatter a dtype
    over the blocks laid out rank-major."""
    out: list = [None] * len(gs)
    for idx in _by_dtype(gs):
        pieces = [gs[i].unflatten(dims[i], (size, -1)).movedim(dims[i], 0).reshape(size, -1)
                  for i in idx]
        mine = pieces[0].new_empty(sum(p.shape[1] for p in pieces))
        dist.reduce_scatter_tensor(mine, torch.cat(pieces, dim=1).reshape(-1), group=group)
        mine.div_(size)
        for i, piece in zip(idx, mine.split([p.shape[1] for p in pieces])):
            shape = list(gs[i].shape)
            shape[dims[i]] //= size
            out[i] = piece.view(shape)
    return out


class _GatherBlocks(torch.autograd.Function):
    """All-gather the blocks ``xs`` along their dimensions ``dims`` over one
    group of ``size`` ranks (one collective a dtype): the full tensors,
    blocks in rank order. Backward: this rank's (``index``) block of each
    gradient, which every rank of the group computed on the same rows; or,
    with ``batch`` (the group is the data axis, whose ranks hold different
    rows), this rank's block of the ranks' mean gradient
    (:func:`reduce_scatter_blocks`)."""

    @staticmethod
    def forward(ctx, group, size: int, index: int, dims: tuple, batch: bool, *xs):
        ctx.group, ctx.size, ctx.index, ctx.dims, ctx.batch = group, size, index, dims, batch
        out: list = [None] * len(xs)
        for idx in _by_dtype(xs):
            flat = torch.cat([xs[i].reshape(-1) for i in idx])
            full = flat.new_empty(size * flat.numel())
            dist.all_gather_into_tensor(full, flat, group=group)
            rows = full.view(size, -1).split([xs[i].numel() for i in idx], dim=1)
            for i, piece in zip(idx, rows):
                blocks = piece.reshape(size, *xs[i].shape).unbind(0)
                full_i = torch.cat(blocks, dim=dims[i])
                if xs[i].dim() == 4 and xs[i].is_contiguous(memory_format=torch.channels_last):
                    full_i = full_i.contiguous(memory_format=torch.channels_last)
                out[i] = full_i
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.batch:
            return (None,) * 5 + tuple(reduce_scatter_blocks(gs, ctx.dims, ctx.group, ctx.size))
        out = []
        for g, dim in zip(gs, ctx.dims):
            b = g.shape[dim] // ctx.size
            out.append(g.narrow(dim, ctx.index * b, b).contiguous())
        return (None,) * 5 + tuple(out)


class _Gathered(nn.Module):
    """The engine's model called with its sharded parameters gathered
    (``torch.func.functional_call``); train/eval mode and the aux terms
    are the model's."""

    def __init__(self, engine: "GSPMDParallel"):
        super().__init__()
        self.inner = engine.model
        object.__setattr__(self, "_engine", engine)

    @property
    def training(self) -> bool:  # the model's mode, however it was set
        return self.inner.training

    @training.setter
    def training(self, mode: bool) -> None:
        pass  # train()/eval() reach the model as a child

    @property
    def aux_loss(self):
        return getattr(self.inner, "aux_loss", None)

    def forward(self, *args, **kwargs):
        full = self._engine.gather(params_of(self.inner))
        return torch.func.functional_call(self.inner, full, args, kwargs, strict=False)


# ------------------------------------------------------------------ engine


class GSPMDParallel:
    """Model-(+data-)parallel training engine driven by sharding rules.

    Usage::

        mp = GSPMDParallel(model, opt, {"stage": S})   # the mesh's axis sizes
        ts = mp.create_state()                         # params cut to blocks
        step = mp.make_train_step()                    # (ts, x, y) -> (ts, metrics)

    ``model`` is built whole, from the same seed on every rank (as JAX's
    ``create_state`` draws it whole and places it); :meth:`create_state`
    keeps this rank's block of every sharded parameter. Batches are
    GLOBAL and the same on every rank. ``mesh`` defaults to
    ``{axis_name: world}``. With a second axis ``batch_axis`` (``{"data":
    D, "stage": S}``) the batch shards over it. ``rng_root`` seeds the
    dropout keys ``rng_root.fold_in(step)`` (and ``.fold_in(data index)``
    under ``batch_axis``); ``accum_steps``, ``loss`` and
    ``aux_loss_weight`` as in ``train.make_train_step``; ``sentinel`` and
    ``obs`` as in ``DataParallel`` (the sentinel's and a clip's norm count
    a sharded leaf's blocks once each, a replicated leaf once);
    ``flash_attn=True`` swaps a dense causal trunk onto the flash kernels
    in place. ``fused_xent`` (a ``TransformerLM``; no ``accum_steps``, the
    built-in loss) trains through the vocab-sharded fused head, built at
    :meth:`make_train_step` from the head kernel's placed spec
    (``train.make_lm_fused_sharded_loss_fn``); ``save_scores`` is its
    ``save_s``. Its metrics carry the loss only, as JAX's.
    """

    def __init__(self, model: nn.Module, optimizer: Optimizer, mesh: dict | None = None,
                 rule: RuleFn | None = None, axis_name: str = "stage",
                 batch_axis: str | None = None, rng_root=None, accum_steps: int = 1,
                 loss: Callable = softmax_cross_entropy, aux_loss_weight: float | None = None,
                 fused_xent: bool = False, save_scores: bool | None = None,
                 sentinel: bool | dict = False, obs=False, flash_attn: bool = False):
        if save_scores and not fused_xent:
            reject("save_scores_needs_fused_xent")
        if fused_xent and (accum_steps != 1 or loss is not softmax_cross_entropy):
            reject("gspmd_fused_xent_accum")
        if flash_attn and (getattr(model, "impl", None) != "full"
                           or getattr(model, "seq_sharded", False)):
            reject("train_flash_attn_dense")
        if not dist.is_initialized():
            raise RuntimeError(
                "GSPMDParallel needs a process group: call "
                "tpudml_torch.core.distributed_init (or run inside process_group) first")
        mesh = dict(mesh) if mesh is not None else {axis_name: dist.get_world_size()}
        if rule is None and axis_name not in mesh:
            raise ValueError(f"axis_name {axis_name!r} not in mesh axes {tuple(mesh)}")
        if batch_axis is not None and batch_axis not in mesh:
            raise ValueError(f"batch_axis {batch_axis!r} not in mesh axes {tuple(mesh)}")
        self.device = next(model.parameters()).device
        if dist.get_backend() != backend_for(self.device):
            raise RuntimeError(f"a {self.device.type} rank needs a {backend_for(self.device)} "
                               f"group; this one is {dist.get_backend()}")
        self.flash_attn = flash_attn
        if flash_attn:
            _use_flash(model)
        self.model = model
        self.mesh = mesh
        self.axis_name = axis_name
        self.batch_axis = batch_axis
        self.rule = rule or stage_sharding_rules(axis_name)
        self.rng_root = rng_root
        self.accum_steps = accum_steps
        self.groups = mesh_groups(mesh)
        self.coords = {a: self.groups[a][1] for a in mesh}
        self.param_specs = apply_rules(self.rule, model, mesh)
        # The leaves split over the batch axis: their gradient comes out of
        # the gather's reduce-scatter already averaged over the data group.
        self._batch_sharded = {n for n, spec in self.param_specs.items()
                               if batch_axis in {a for e in spec for a in _axes(e)}}
        buffers = {n: b for n, b in model.named_buffers() if b.is_floating_point()}
        self.buffer_specs = apply_rules(self.rule, buffers, mesh)
        if any(_axes(e) for spec in self.buffer_specs.values() for e in spec):
            raise ValueError("the rule shards a model buffer; GSPMDParallel keeps the model "
                             "state replicated")
        sharded_axes = [a for a in mesh
                        if any(a in _axes(e) for s in self.param_specs.values() for e in s)]
        self._divergent = tuple(self.groups[a][0] for a in sharded_axes)
        self._sharded_axes = tuple(sharded_axes)
        self.optimizer = shard_aware_clip(optimizer, self._divergent, self.norm_share)
        self.sentinel = None
        if sentinel:
            kw = dict(sentinel) if isinstance(sentinel, dict) else {}
            self.optimizer = attach_sentinel(self.optimizer, self._divergent,
                                             sharded=self.norm_share, **kw)
            self.sentinel = find_sentinel(self.optimizer)
        self.tracer: Tracer | None = None
        if obs:
            self.tracer = obs if isinstance(obs, Tracer) else Tracer()
        self._gathered = _Gathered(self)
        self._loss_fn = make_loss_fn(self._gathered,
                                     resolve_aux_loss_weight(model, aux_loss_weight), loss)
        self.fused_xent = fused_xent
        self.save_scores = save_scores
        self._aux_loss_weight = aux_loss_weight
        self._fused_loss_fn = None
        self._wire_bytes = None
        self._cut = False

    # ---------------------------------------------------------------- state

    def is_sharded(self, name: str) -> bool:
        """Whether parameter ``name`` is split over a mesh axis."""
        return any(_axes(e) for e in self.param_specs.get(name, ()))

    def norm_share(self, name: str) -> float:
        """The weight of parameter ``name``'s squared gradient in a norm
        summed over the groups of every sharded axis: 0 for a replicated
        leaf (counted once, outside the sum), else 1 / the ranks that hold
        the same block (a leaf split over the model axis only is held alike
        by each data rank of a {data, model} mesh)."""
        if not self.is_sharded(name):
            return 0.0
        used = {a for e in self.param_specs[name] for a in _axes(e)}
        return 1.0 / math.prod(self.mesh[a] for a in self._sharded_axes if a not in used)

    def window(self, name: str) -> list[list[int]]:
        """This rank's ``[start, stop)`` of each JAX dimension of parameter
        ``name`` (of its full JAX shape)."""
        return block_window(name, self._global_shape[name], self.param_specs[name],
                            self.mesh, self.coords)

    def create_state(self) -> TrainState:
        """Cut every sharded parameter to this rank's block (once), then a
        fresh optimizer state over the blocks."""
        if not self._cut:
            self._global_shape = cut_to_blocks(self.model, self.param_specs, self.mesh,
                                               self.coords)
            self._cut = True
        return TrainState.create(self.model, self.optimizer)

    def state_specs(self) -> dict:
        """JAX's ``state_specs`` as dicts by name: the parameters' specs,
        the model state's (replicated), the optimizer state's (a moment
        takes its parameter's spec) and the step's ``()``."""
        return {"params": dict(self.param_specs), "model_state": dict(self.buffer_specs),
                "opt_state": dict(self.param_specs), "step": ()}

    def placement(self, kind: str, name: str, shape: tuple):
        """Where this rank's leaf sits (``checkpoint.sharded``'s placement):
        a sharded parameter, and its optimizer state's tensors, are the
        rank's window of the whole, written by the rank whose coordinates
        on the other axes are 0; every other leaf is replicated (None)."""
        from tpudml_torch.checkpoint.sharded import Window

        if kind not in ("param", "opt") or not self.is_sharded(name):
            return None
        spec = self.param_specs[name]
        used = {a for e in spec for a in _axes(e)}
        write = all(c == 0 for a, c in self.coords.items() if a not in used)
        return Window(self._global_shape[name], self.window(name), write)

    def _gather_ops(self, names, keep: dict | None = None) -> dict:
        """Per parameter, its gathers in order: (JAX dimension, axis), a
        dimension's last axis first (the blocks' row-major order), none
        along the dimensions ``keep[name]`` holds in blocks."""
        keep = keep or {}
        return {n: [(jd, a) for jd, e in enumerate(self.param_specs[n])
                    if jd not in keep.get(n, ()) for a in reversed(_axes(e))] for n in names}

    def gather(self, params: dict, keep: dict | None = None) -> dict:
        """``params`` (a dict by parameter name) with every sharded block
        all-gathered to the full tensor, differentiable (module
        docstring: over ``batch_axis`` the backward is the gradient's
        reduce-scatter, over another axis a narrow); the dimensions
        ``keep[name]`` (JAX's) stay in blocks. One collective a round,
        axis and dtype."""
        ops = self._gather_ops(params, keep)
        out = dict(params)
        for r in range(max((len(o) for o in ops.values()), default=0)):
            for axis in self.mesh:
                names = [n for n, o in ops.items() if len(o) > r and o[r][1] == axis]
                if not names:
                    continue
                group, index, size = self.groups[axis]
                dims = tuple(port_dim(n, params[n], ops[n][r][0]) for n in names)
                full = _GatherBlocks.apply(group, size, index, dims, axis == self.batch_axis,
                                           *[out[n] for n in names])
                out.update(zip(names, full))
        return out

    def shard_batch(self, images, labels):
        """This rank's rows of a global batch on its device: all of it, or
        its data index's rows under ``batch_axis``."""
        if self.batch_axis is not None:
            _, index, size = self.groups[self.batch_axis]
            images, labels = shard_rows(images, labels, size, index, stacked=False)
        return to_device(images, self.device), to_device(labels, self.device)

    # ----------------------------------------------------------- the steps

    def step_wire_bytes(self) -> float:
        """Ring-model bytes into a rank a step: each gather (and, over
        ``batch_axis``, its gradient's reduce-scatter), the data group's
        mean of the other gradients, and the fused head's own collectives
        (``train.make_lm_fused_sharded_loss_fn``)."""
        if self._wire_bytes is None:
            params = params_of(self.model)
            keep = self._fused_loss_fn.keep if self._fused_loss_fn is not None else None
            total = 0.0
            for name, ops in self._gather_ops(params, keep).items():
                nbytes = params[name].numel() * params[name].element_size()
                for _, a in ops:
                    total += collective_wire_bytes("all_gather", nbytes, self.mesh[a])
                    nbytes *= self.mesh[a]
                    if a == self.batch_axis:
                        total += collective_wire_bytes("reduce_scatter", nbytes, self.mesh[a])
            if self.batch_axis is not None:
                gb = sum(p.numel() * p.element_size() for n, p in params.items()
                         if n not in self._batch_sharded)
                total += collective_wire_bytes("psum", gb, self.mesh[self.batch_axis])
            self._wire_bytes = total
        head = self._fused_loss_fn.wire_bytes if self._fused_loss_fn is not None else 0.0
        return self._wire_bytes + head

    def _data_mean(self, tree: dict, grads: bool = False) -> dict:
        """The data group's mean of ``tree`` (of its gradients not split over
        ``batch_axis``, which their reduce-scatter averaged, with
        ``grads``)."""
        if self.batch_axis is None or not tree:
            return tree
        if grads:
            rest = {n: g for n, g in tree.items() if n not in self._batch_sharded}
            return {**tree, **self._data_mean(rest)} if rest else tree
        return pmean_tree(tree, self.groups[self.batch_axis][0])

    def _mean_model_state(self) -> None:
        if self.batch_axis is None:
            return
        state = {n: b for n, b in self.model.named_buffers() if b.is_floating_point()}
        if state:
            new = self._data_mean(state)
            with torch.no_grad():
                for name, b in state.items():
                    b.copy_(new[name])

    def _normsq(self, grads: dict) -> torch.Tensor:
        """The global gradient's squared norm: sharded blocks summed over
        their groups (each weighted by :meth:`norm_share`), replicated
        leaves once."""
        dev = next(iter(grads.values())).device
        s = torch.zeros((), device=dev)
        by_share: dict = {}
        for n, g in grads.items():
            by_share.setdefault(self.norm_share(n), []).append(g)
        for share, leaves in by_share.items():
            if share:
                s = s + share * grad_normsq(leaves).to(dev)
        for group in self._divergent:
            s = psum_tree(s, group)
        return s + (grad_normsq(by_share[0.0]).to(dev) if 0.0 in by_share else 0.0)

    def make_train_step(self) -> Callable:
        """(ts, images, labels) -> (ts, metrics): gather, forward and
        backward (in ``accum_steps`` micro-batches), the data group's mean,
        the update of this rank's blocks. Metrics: ``loss``, ``accuracy``
        (and ``bad_micro`` with the sentinel, ``step_stats`` with obs)."""
        if not self._cut:
            raise RuntimeError("call create_state() before make_train_step()")
        if self.fused_xent and self._fused_loss_fn is None:
            # Built here, not in __init__: the sharded head reads the head
            # kernel's placed spec, which create_state fixed.
            if "head.kernel" not in self.param_specs or not hasattr(self.model,
                                                                    "apply_features"):
                raise ValueError("fused_xent needs a model with a 'head' Dense and "
                                 "apply_features (TransformerLM)")
            self._fused_loss_fn = make_lm_fused_sharded_loss_fn(
                self.model, self, self.param_specs["head.kernel"], self.batch_axis,
                self.save_scores, self._aux_loss_weight)
            self._wire_bytes = None
        loss_fn = self._fused_loss_fn if self.fused_xent else self._loss_fn

        def step(ts: TrainState, images, labels):
            span = (NULL_SPAN if self.tracer is None else
                    self.tracer.span("train_step", cat="step", sync=next(self.model.parameters())))
            with span:
                index = ts.step
                x, y = self.shard_batch(images, labels)
                rng = None if self.rng_root is None else self.rng_root.fold_in(ts.step)
                if rng is not None and self.batch_axis is not None:
                    rng = rng.fold_in(self.coords[self.batch_axis])
                grads, local = accumulate_grads(loss_fn, self.model, x, y, rng,
                                                self.accum_steps,
                                                taint=self.sentinel is not None)
                grads = self._data_mean(grads, grads=True)
                self._mean_model_state()
                params = params_of(self.model)
                _, ts.opt_state = self.optimizer.update(grads, ts.opt_state, params)
                ts.step += 1
                metrics = {k: v for k, v in local.items() if k != "bad_micro"}
                metrics = self._data_mean(metrics)
                if "bad_micro" in local:
                    metrics["bad_micro"] = local["bad_micro"]
                    if self.batch_axis is not None:
                        metrics["bad_micro"] = pmax_tree(local["bad_micro"],
                                                         self.groups[self.batch_axis][0])
                if self.tracer is not None:
                    metrics["step_stats"] = make_step_stats(
                        metrics["loss"], self._normsq(grads), ts.opt_state,
                        self.step_wire_bytes(), index)
            return ts, metrics

        return step

    def make_eval_step(self) -> Callable:
        """(images, labels) -> (correct, count) over the global batch, with
        the gathered parameters (``make_counting_eval_step``; summed over
        the data group under ``batch_axis``)."""
        if not self._cut:
            raise RuntimeError("call create_state() before make_eval_step()")
        group = self.groups[self.batch_axis][0] if self.batch_axis is not None else None
        return make_counting_eval_step(self._gathered, self.shard_batch, group,
                                       reduce=self.batch_axis is not None)

    def gather_params(self) -> dict[str, torch.Tensor]:
        """Every parameter in full (detached), as the model holds it before
        :meth:`create_state` cut it: what a single-device run holds."""
        with torch.no_grad():
            return {n: t.detach() for n, t in self.gather(params_of(self.model)).items()}

    def full_state(self, ts: TrainState) -> list:
        """JAX's global view of ``ts`` for the base store (call on every
        rank): ``[params, model state, optimizer state, step]`` in JAX's
        TrainState order, every sharded parameter and its optimizer
        tensors whole, Python ints (Adam's clock, the step) as int32. Rank
        0 writes it as JAX's task5 writes its global arrays."""
        names = set(self.param_specs)

        def whole(state):
            if isinstance(state, dict):
                if state and set(state) <= names:
                    with torch.no_grad():
                        return {n: t.detach() for n, t in self.gather(state).items()}
                return {k: whole(v) for k, v in state.items()}
            if isinstance(state, int) and not isinstance(state, bool):
                return np.int32(state)
            return state

        buffers = {n: b.detach() for n, b in ts.model.named_buffers() if b.is_floating_point()}
        return [self.gather_params(), buffers, whole(ts.opt_state), np.int32(ts.step)]

    @torch.no_grad()
    def load_full_state(self, ts: TrainState, full: list) -> TrainState:
        """Write a :meth:`full_state` tree (as restored: whole leaves) back
        into ``ts`` in place: this rank's block of each sharded parameter
        and of its optimizer tensors, the rest whole, the ints and the step
        as ints."""
        params, buffers, opt, step = full
        live = params_of(ts.model)

        def block(name, t):
            t = torch.as_tensor(t)
            if name in live and self.is_sharded(name) and t.dim():
                for jd, (lo, hi) in enumerate(self.window(name)):
                    t = t.narrow(port_dim(name, live[name], jd), lo, hi - lo)
            return t

        for n, p in live.items():
            p.copy_(block(n, params[n]))
        for n, b in ts.model.named_buffers():
            if n in buffers:
                b.copy_(torch.as_tensor(buffers[n]))

        def load(state, saved):
            for k, v in state.items():
                if isinstance(v, torch.Tensor):
                    v.copy_(block(k, saved[k]))
                elif isinstance(v, int) and not isinstance(v, bool):
                    state[k] = int(saved[k])
                elif isinstance(v, dict):
                    load(v, saved[k])

        load(ts.opt_state, opt)
        ts.step = int(step)
        return ts
