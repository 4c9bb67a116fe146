"""Collectives over a process group (the port of
``tpudml/comm/collectives.py``).

The JAX functions take a pytree and a mesh axis and lower to one XLA
program. Here a "tree" is a tensor or a dict of tensors (name -> tensor,
e.g. a model's gradients), and the axis is a ``torch.distributed``
process group (None = the default group). The reference issues one
collective per parameter tensor (SURVEY.md §3.2); these wrappers copy a
tree into one flat buffer per dtype, run ONE collective on each buffer,
and split the result back into tensors of the leaves' shapes, so a step's
aggregation costs one collective (two for ReduceScatter) whatever the
number of parameters. The results are new tensors; the inputs are left
as they were.

Every rank of the group must call the same function on trees of the same
names, shapes and dtypes, in the same order.
"""

from __future__ import annotations

import inspect
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from tpudml_torch.comm.timing import collective_wire_bytes

Tree = torch.Tensor | dict


def _world(group) -> int:
    return dist.get_world_size(group)


def _global(group, rank: int) -> int:
    return dist.get_global_rank(group or dist.group.WORLD, rank)


def _leaves(tree: Tree) -> tuple[list | None, list[torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        return None, [tree]
    return list(tree), list(tree.values())


def _rebuild(keys, leaves):
    return leaves[0] if keys is None else dict(zip(keys, leaves))


def _divides(t: torch.Tensor, world: int) -> bool:
    return t.dim() >= 1 and t.shape[0] % world == 0


def _split_rest(leaves, world: int) -> tuple[list[int], list[int]]:
    """Indices of the leaves ReduceScatter splits (dim 0 divides the
    world) and of the rest, which take the all_reduce mean."""
    split = [i for i, g in enumerate(leaves) if _divides(g, world)]
    rest = [i for i, g in enumerate(leaves) if not _divides(g, world)]
    return split, rest


def _nbytes(leaves) -> float:
    return float(sum(t.numel() * t.element_size() for t in leaves))


def _by_dtype(leaves) -> list[list[int]]:
    """Indices of ``leaves`` grouped by dtype, in first-seen order: one
    flat buffer each."""
    groups: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _flat_apply(tree: Tree, fn: Callable[[torch.Tensor], torch.Tensor]) -> Tree:
    """``fn`` on one flat copy of the tree's leaves per dtype; the result
    split back into the leaves' shapes (views of ``fn``'s output)."""
    keys, leaves = _leaves(tree)
    out: list = [None] * len(leaves)
    for idx in _by_dtype(leaves):
        flat = fn(torch.cat([leaves[i].reshape(-1) for i in idx]))
        for i, piece in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = piece.view(leaves[i].shape)
    return _rebuild(keys, out)


def _rows_apply(tree: Tree, world: int, fn) -> Tree:
    """For leaves whose dim 0 divides ``world``: one [world, m] buffer per
    dtype whose row r holds every leaf's r-th dim-0 chunk; ``fn`` maps it
    to a [world, m] result, split back into the leaves' shapes."""
    keys, leaves = _leaves(tree)
    out: list = [None] * len(leaves)
    for idx in _by_dtype(leaves):
        rows = torch.cat([leaves[i].reshape(world, -1) for i in idx], dim=1)
        full = fn(rows)
        cols = [leaves[i].numel() // world for i in idx]
        for i, piece in zip(idx, full.split(cols, dim=1)):
            out[i] = piece.reshape(leaves[i].shape)
    return _rebuild(keys, out)


def _all_reduce(tree: Tree, op, group, divisor: int | None = None) -> Tree:
    def reduce(flat):
        dist.all_reduce(flat, op=op, group=group)
        return flat if divisor is None else flat.div_(divisor)

    return _flat_apply(tree, reduce)


def psum_tree(tree: Tree, group=None) -> Tree:
    """AllReduce-SUM over every leaf (one collective per dtype)."""
    return _all_reduce(tree, dist.ReduceOp.SUM, group)


def pmax_tree(tree: Tree, group=None) -> Tree:
    """AllReduce-MAX over every leaf: the merge collective for online
    statistics (running maxima, lse merges)."""
    return _all_reduce(tree, dist.ReduceOp.MAX, group)


def pmean_tree(tree: Tree, group=None) -> Tree:
    """AllReduce-MEAN over every leaf: the sum, then ÷ world (also at world
    1, where it is exact: the step pays what it pays at any world)."""
    return _all_reduce(tree, dist.ReduceOp.SUM, group, _world(group))


class _ReplicatedSum(torch.autograd.Function):
    """AllReduce-SUM whose backward passes the cotangent through: the
    output is replicated, every rank holds the same cotangent of it, and
    each rank's input owes exactly that (JAX's psum under shard_map)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumCotangent(torch.autograd.Function):
    """Identity whose backward all-reduces (sums) the cotangent: an input
    that every rank of the group holds alike and feeds into its own part
    of a sum (JAX's transpose of a replicated ``shard_map`` input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def sum_cotangent(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as it is; its gradient is the group's sum of the gradients the
    ranks compute for it (a vocab shard's partial dX summed to the whole)."""
    return _SumCotangent.apply(x, group)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0, rank order; backward: this rank's rows of the
    group's reduce-scatter (sum) of the cotangent, times ``scale``."""

    @staticmethod
    def forward(ctx, x, group, scale: float):
        ctx.group, ctx.scale = group, scale
        out = x.new_empty((_world(group) * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        mine = g.new_empty((g.shape[0] // _world(ctx.group), *g.shape[1:]))
        dist.reduce_scatter_tensor(mine, g.contiguous(), group=ctx.group)
        if ctx.scale != 1:
            mine.mul_(ctx.scale)
        return mine, None, None


def gather_rows(x: torch.Tensor, group=None, grad_scale: float = 1.0) -> torch.Tensor:
    """Every rank's rows of ``x`` [n, ...] stacked in rank order [W·n, ...]
    (JAX's tiled ``all_gather``). Differentiable: the gradient of this
    rank's rows is its rows of the group's sum of the cotangents (one
    reduce-scatter), times ``grad_scale``."""
    return _GatherRows.apply(x, group, grad_scale)


def plogsumexp(x: torch.Tensor, group=None) -> torch.Tensor:
    """Cross-rank log-sum-exp merge: each rank holds a partial
    ``lse_local`` over its slice of a reduced axis; the result is their
    logsumexp over the group, ``m + log Σ exp(x − m)`` with ``m`` the
    group max of the detached input (the shift keeps the sum finite and
    carries no gradient: lse is shift-invariant). Differentiable: d lse /
    d lse_local = exp(lse_local − lse), through the sum."""
    m = pmax_tree(x.detach(), group)
    return m + torch.log(_ReplicatedSum.apply(torch.exp(x - m), group))


def allreduce_average_gradients(grads: Tree, group=None) -> Tree:
    """Gradient aggregation, AllReduce strategy: the reference's per-param
    ``all_reduce(SUM)`` then ``/world_size`` (codes/task2/dist_utils.py:
    39-42), here one all_reduce of the flat gradient."""
    return pmean_tree(grads, group)


def _allreduce_wire(leaves, world: int) -> float:
    return collective_wire_bytes("psum", _nbytes(leaves), world)


def allgather_average_gradients(grads: Tree, group=None) -> Tree:
    """Gradient aggregation, AllGather strategy: gather every replica's
    flat gradient, then average locally. A correct all-gather-mean for
    any world size (the reference's ``[zeros]*2`` list hardcodes world=2,
    codes/task2/dist_utils.py:44-49). Equal to the AllReduce mean; it
    moves world× the bytes, the comparison task2 asks for."""
    world = _world(group)

    def gather_mean(flat):
        out = flat.new_empty(world * flat.numel())
        dist.all_gather_into_tensor(out, flat, group=group)
        return out.view(world, -1).mean(0)

    return _flat_apply(grads, gather_mean)


def _allgather_wire(leaves, world: int) -> float:
    return collective_wire_bytes("all_gather", _nbytes(leaves), world)


def reduce_scatter_average_gradients(grads: Tree, group=None) -> Tree:
    """Gradient aggregation, ReduceScatter + AllGather: the two legs of a
    ring all-reduce as two collectives. Each rank reduces its 1/world row
    of the flat [world, m] buffer (every leaf's r-th dim-0 chunk), all
    ranks gather the rows back, ÷ world. Leaves whose dim 0 does not
    divide the world take the mean (one all_reduce) instead, as in JAX."""
    world = _world(group)
    keys, leaves = _leaves(grads)
    split, rest = _split_rest(leaves, world)

    def rs_ag(rows):
        shard = rows.new_empty(rows.shape[1])
        dist.reduce_scatter_tensor(shard, rows.reshape(-1), op=dist.ReduceOp.SUM,
                                   group=group)
        full = torch.empty_like(rows)
        dist.all_gather_into_tensor(full.view(-1), shard, group=group)
        return full.div_(world)

    out: list = [None] * len(leaves)
    for idx, agg in ((split, lambda t: _rows_apply(t, world, rs_ag)),
                     (rest, lambda t: pmean_tree(t, group))):
        if idx:
            part = agg({i: leaves[i] for i in idx})
            for i in idx:
                out[i] = part[i]
    return _rebuild(keys, out)


def _reduce_scatter_wire(leaves, world: int) -> float:
    split, rest = _split_rest(leaves, world)
    split_bytes = _nbytes([leaves[i] for i in split])
    return (collective_wire_bytes("psum_scatter", split_bytes, world)
            + collective_wire_bytes("all_gather", split_bytes / world, world)
            + collective_wire_bytes("psum", _nbytes([leaves[i] for i in rest]), world))


def all_gather_tree(tree: Tree, group=None, axis: int = 0, tiled: bool = False) -> Tree:
    """AllGather every leaf: a new axis of size world at ``axis``, or,
    ``tiled``, the ranks' leaves concatenated along ``axis``."""
    world = _world(group)
    keys, leaves = _leaves(tree)
    out: list = [None] * len(leaves)
    for idx in _by_dtype(leaves):
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        gathered = flat.new_empty(world * flat.numel())
        dist.all_gather_into_tensor(gathered, flat, group=group)
        rows = gathered.view(world, -1)
        for i, piece in zip(idx, rows.split([leaves[i].numel() for i in idx], dim=1)):
            stacked = piece.reshape(world, *leaves[i].shape)
            out[i] = (torch.cat(stacked.unbind(0), dim=axis) if tiled
                      else stacked.movedim(0, axis))
    return _rebuild(keys, out)


def psum_scatter_tree(tree: Tree, group=None, axis: int = 0) -> Tree:
    """ReduceScatter every leaf along ``axis`` (tiled): rank r keeps the
    sum of the r-th 1/world slice. The axis must divide the world."""
    world = _world(group)
    keys, leaves = _leaves(tree)
    for t in leaves:
        if t.shape[axis] % world:
            raise ValueError(f"axis {axis} of a {tuple(t.shape)} leaf does not divide "
                             f"the {world}-rank group")
    moved = [t.movedim(axis, 0) for t in leaves]
    out: list = [None] * len(leaves)
    for idx in _by_dtype(leaves):
        rows = torch.cat([moved[i].reshape(world, -1) for i in idx], dim=1)
        shard = rows.new_empty(rows.shape[1])
        dist.reduce_scatter_tensor(shard, rows.reshape(-1), op=dist.ReduceOp.SUM,
                                   group=group)
        for i, piece in zip(idx, shard.split([moved[i].numel() // world for i in idx])):
            shape = (moved[i].shape[0] // world, *moved[i].shape[1:])
            out[i] = piece.view(shape).movedim(0, axis)
    return _rebuild(keys, out)


def broadcast_from(tree: Tree, group=None, root: int = 0) -> Tree:
    """Every leaf from rank ``root`` of the group to all ranks: the
    reference's per-param ``dist.broadcast(p, 0)`` (codes/task2/
    dist_utils.py:33-37) as one broadcast of the flat tree. Replicas built
    from one seed start equal anyway; this restores agreement after they
    diverged (a per-rank restore)."""
    src = _global(group, root)

    def bcast(flat):
        dist.broadcast(flat, src=src, group=group)
        return flat

    return _flat_apply(tree, bcast)


def ppermute_ring(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Ring shift: rank i's value goes to rank (i + shift) mod world (one
    ``batch_isend_irecv`` pair)."""
    world = _world(group)
    if world == 1:
        return x.clone()
    rank = dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), _global(group, (rank + shift) % world),
                      group),
           dist.P2POp(dist.irecv, out, _global(group, (rank - shift) % world), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def stage_exchange(sends, recvs, group=None, counter: list | None = None) -> list[torch.Tensor]:
    """One tick of point-to-point traffic over ``group``: ``sends`` lists
    ``(peer, tensor)`` and ``recvs`` ``(peer, shape, dtype, device)``, peers
    as ranks of the group. Every op of the tick is posted in ONE
    ``batch_isend_irecv``, sends then receives, each in the order listed;
    both ends of a pair derive their lists from the same static schedule,
    so every send meets its receive. Returns the received tensors in
    ``recvs`` order; appends the bytes this rank sends to ``counter`` (the
    pipelines' per-tick record)."""
    ops, out, wire = [], [], 0
    for peer, t in sends:
        t = t.contiguous()
        wire += t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.isend, t, _global(group, peer), group))
    for peer, shape, dtype, device in recvs:
        buf = torch.empty(shape, dtype=dtype, device=device)
        ops.append(dist.P2POp(dist.irecv, buf, _global(group, peer), group))
        out.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if counter is not None:
        counter.append(wire)
    return out


def _open_shift(x: torch.Tensor, group, step: int, counter) -> torch.Tensor:
    """Rank i's ``x`` to rank i + ``step`` (±1) of the group; a rank with no
    sender receives zeros, the one with no receiver sends nothing."""
    world, rank = _world(group), dist.get_rank(group)
    dst, src = rank + step, rank - step
    sends = [(dst, x)] if 0 <= dst < world else []
    recvs = [(src, x.shape, x.dtype, x.device)] if 0 <= src < world else []
    got = stage_exchange(sends, recvs, group, counter)
    return got[0] if got else torch.zeros_like(x)


class _Shift(torch.autograd.Function):
    """The open shift; backward: the cotangent shifted the other way (JAX's
    transpose of ``ppermute`` with the open permutation)."""

    @staticmethod
    def forward(ctx, x, group, step, counter):
        ctx.group, ctx.step, ctx.counter = group, step, counter
        return _open_shift(x, group, step, counter)

    @staticmethod
    def backward(ctx, g):
        return _open_shift(g.contiguous(), ctx.group, -ctx.step, ctx.counter), None, None, None


def shift_next(x: torch.Tensor, group=None, counter: list | None = None) -> torch.Tensor:
    """Stage i's ``x`` to stage i + 1 (JAX's ``ppermute`` with the open
    permutation ``[(i, i + 1)]``): the first stage receives zeros and the
    last sends nothing. Differentiable; ``counter`` as
    :func:`stage_exchange`'s."""
    return _Shift.apply(x, group, 1, counter)


def shift_prev(x: torch.Tensor, group=None, counter: list | None = None) -> torch.Tensor:
    """Stage i's ``x`` to stage i − 1 (the open permutation ``[(i, i − 1)]``):
    the last stage receives zeros and the first sends nothing."""
    return _Shift.apply(x, group, -1, counter)


def _all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    world = _world(group)
    if x.shape[split_axis] % world:
        raise ValueError(f"split axis {split_axis} of {tuple(x.shape)} does not divide "
                         f"the {world}-rank group")
    send = torch.stack(x.chunk(world, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """All-to-all whose backward is the inverse all-to-all (split and
    concat axes swapped): JAX's transpose of ``lax.all_to_all``. Chunk j
    of rank r's input became chunk r of rank j's output, so the cotangent
    of that output chunk goes back to rank r, to chunk j of its input."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, ctx.group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group=None, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """All-to-all (tiled): ``x`` splits into world chunks along
    ``split_axis``, chunk j goes to rank j, and the chunks received are
    concatenated along ``concat_axis`` in rank order (the Ulysses
    sequence-parallel primitive, and the MoE dispatch's ``[E, C, d] ->
    [E/W, W·C, d]`` at split 0, concat 1). Differentiable: the backward
    is the inverse all-to-all. At world 1 it still goes through the
    group's collective."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


AGGREGATORS = {
    "allreduce": allreduce_average_gradients,
    "allgather": allgather_average_gradients,
    "reducescatter": reduce_scatter_average_gradients,
}

# Each aggregator's ring-model wire bytes (``_WIRE_MODEL`` of
# ``tpudml_torch.comm.timing`` for each collective it issues), written
# beside the aggregator above.
_AGGREGATOR_WIRE = {
    "allreduce": _allreduce_wire,
    "allgather": _allgather_wire,
    "reducescatter": _reduce_scatter_wire,
}


def get_aggregator(name: str):
    """Factory keyed by the config's ``aggregation`` field (task2's ≥2
    collective-primitive contract, sections/task2.tex:18)."""
    try:
        return AGGREGATORS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown aggregation {name!r}; options: {sorted(AGGREGATORS)}"
        ) from None


def aggregation_wire_bytes(name: str, grads: Tree, world: int) -> float:
    """Ring-model bytes one rank moves to aggregate ``grads`` with the
    ``name`` strategy."""
    get_aggregator(name)
    return _AGGREGATOR_WIRE[name.lower()](_leaves(grads)[1], world)


# ------------------------------------------------------------- wire meter

# The torch.distributed entry points the port's collectives go through:
# name -> (the ring model's kind, the argument whose bytes are the payload).
_METERED = {
    "all_reduce": ("psum", "tensor"),
    "broadcast": ("pbroadcast", "tensor"),
    "all_gather_into_tensor": ("all_gather", "input_tensor"),
    "all_gather": ("all_gather", "tensor"),
    "reduce_scatter_tensor": ("psum_scatter", "input"),
    "all_to_all_single": ("all_to_all", "input"),
    "all_to_all": ("all_to_all", "input_tensor_list"),
}


@dataclass
class WireMeter:
    """What :func:`wire_meter` counted: the ring-model wire bytes this
    process moved (``collective_wire_bytes`` of each call's payload over
    its group)."""

    wire_bytes: float = 0.0


_ACTIVE: list = []


@contextmanager
def wire_meter():
    """Count the wire bytes of every collective issued in the body, at the
    ``torch.distributed`` call itself, so that the engines' own calls (the
    weight gathers, the pipelines' tick exchanges, the fused head's sums)
    count as well as this module's. Each call adds the ring model's bytes
    (``comm.timing.collective_wire_bytes``) for its payload over its
    group's size; a ``batch_isend_irecv`` adds the bytes it sends. The
    plan's verification step reads it. Not reentrant."""
    if _ACTIVE:
        raise RuntimeError("wire_meter is already counting")
    meter = WireMeter()
    real = {name: getattr(dist, name) for name in (*_METERED, "batch_isend_irecv")}

    def metered(name):
        kind, arg = _METERED[name]
        fn, sig = real[name], inspect.signature(real[name])

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs).arguments
            payload = bound[arg]
            nbytes = (_nbytes(payload) if isinstance(payload, list)
                      else float(payload.numel() * payload.element_size()))
            meter.wire_bytes += collective_wire_bytes(kind, nbytes, _world(bound.get("group")))
            return fn(*args, **kwargs)

        return call

    def batch_isend_irecv(p2p_op_list):
        sent = [op.tensor for op in p2p_op_list if op.op.__name__ == "isend"]
        meter.wire_bytes += _nbytes(sent)  # a sent buffer crosses the wire once
        return real["batch_isend_irecv"](p2p_op_list)

    _ACTIVE.append(meter)
    try:
        for name in _METERED:
            setattr(dist, name, metered(name))
        dist.batch_isend_irecv = batch_isend_irecv
        yield meter
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
        _ACTIVE.pop()
