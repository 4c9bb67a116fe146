"""ZeRO-1 weight-update sharding as an optimizer wrapper (the port of
``tpudml/optim/zero1.py``: ``ZeRO1``, ``zero1_handles``,
``stages_stacked``, ``with_stacked``).

The transform of arXiv 2004.13336: instead of every data replica applying
the whole optimizer update to a replicated state, reduce-scatter the
gradients over the data group, update a 1/N chunk of the parameters and
of the optimizer state on each rank, then all-gather the updated
parameters. The bytes on the wire are those of the all-reduce the
replicated update pays (reduce-scatter + all-gather); the optimizer's work
and its state's memory drop by N.

Layout, per leaf as in JAX: each parameter is raveled and zero-padded to
a multiple of ``world`` (``[N·c]``), and rank r holds chunk r (``[c]``).
A leaf the ``stacked`` predicate marks (by parameter name: the
pipelines' stage-stacked ``stages`` leaves) keeps its leading dim:
``[S, N·c]``, chunked along the columns. The zero padding is exact for
every optimizer of the port: a zero gradient keeps zero moments and
gives a zero update. The reduce-scatter's mean (sum ÷ N) is exact whether
or not the gradients were averaged already.

The port's engines run one process a rank, so ``group`` names the data
group (None: the default group) and ``world`` its size. The state this
wrapper's ``init`` returns is this rank's: the base optimizer's state
over the chunks ``[c]`` (JAX's ``init`` returns the global ``[N·c]``
layout, which its placement then shards). The parameters are updated in
place, as every port optimizer does: :meth:`update` slices this rank's
chunks, updates them, gathers them and copies the full values back.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from tpudml_torch.capabilities import reject
from tpudml_torch.comm.collectives import all_gather_tree, psum_scatter_tree
from tpudml_torch.optim.optimizers import ClipByGlobalNorm, Optimizer, shard_aware_clip


def _chain_has_clip(opt: Optimizer) -> bool:
    while isinstance(opt, Optimizer):
        if isinstance(opt, ClipByGlobalNorm):
            return True
        opt = getattr(opt, "base", None)
    return False


def _flat_pad(x: torch.Tensor, world: int) -> torch.Tensor:
    """Ravel + zero-pad to a multiple of ``world`` (a scalar becomes [1])."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = world * -(-n // world) - n
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def _rows_pad(x: torch.Tensor, world: int) -> torch.Tensor:
    """Stacked-leaf layout: [S, ...] -> [S, world·c], zero-padded columns."""
    rows = x.reshape(x.shape[0], -1)
    n = rows.shape[1]
    pad = world * -(-n // world) - n
    return torch.cat([rows, rows.new_zeros(rows.shape[0], pad)], dim=1) if pad else rows


@dataclass(frozen=True)
class ZeRO1(Optimizer):
    """Weight-update-sharding wrapper: ``base`` runs on this rank's 1/N
    chunk of every leaf (module docstring).

    ``world`` must be the size of the data group ``group`` (None: the
    default group). Must be the OUTERMOST wrapper but for a sentinel,
    which ``attach_sentinel`` puts inside: a :class:`ClipByGlobalNorm`
    below is rewrapped at construction to sum its squares over the data
    group (the chunks are disjoint over it, so that is the global norm of
    the mean gradient). With ``stacked`` set, a clip in the chain is
    rejected.
    """

    base: Optimizer = None  # type: ignore[assignment]
    axis_name: str = "data"
    world: int = None  # type: ignore[assignment]
    stacked: Callable[[str], bool] | None = None
    group: Any = None

    def __post_init__(self):
        if self.base is None:
            raise ValueError("ZeRO1 needs a base optimizer")
        if not isinstance(self.world, int) or self.world < 1:
            raise ValueError("ZeRO1 needs the data group's size: pass world=<its size>")
        if _chain_has_clip(self.base):
            if self.stacked is not None:
                reject("zero1_stacked_clip")
            object.__setattr__(self, "base", shard_aware_clip(self.base, (self.group,), None))

    # -- layout ----------------------------------------------------------

    def _is_stacked(self, name: str) -> bool:
        return self.stacked is not None and self.stacked(name)

    def index(self) -> int:
        """This rank's chunk: its rank in the data group (0 alone)."""
        return dist.get_rank(self.group) if dist.is_initialized() else 0

    def flatten_params(self, params: dict) -> dict:
        """The FULL flat-padded layout of every leaf: ``[N·c]``, or ``[S,
        N·c]`` for a stacked one (the global shape of the moments)."""
        return {n: _rows_pad(p, self.world) if self._is_stacked(n) else _flat_pad(p, self.world)
                for n, p in params.items()}

    def init_spec(self, param_specs: dict) -> dict:
        """The chunks' specs by name: ``(axis,)``, or ``(stage spec, axis)``
        for a stacked leaf; the base state's leaves take their
        parameter's."""
        return {n: ((spec[0] if len(spec) else None, self.axis_name) if self._is_stacked(n)
                    else (self.axis_name,)) for n, spec in param_specs.items()}

    # -- the pieces ------------------------------------------------------

    def shard_params(self, params: dict) -> dict:
        """This rank's chunk of every (replicated) full leaf, as new tensors."""
        i = self.index()
        out = {}
        for n, p in self.flatten_params({k: v.detach() for k, v in params.items()}).items():
            c = p.shape[-1] // self.world
            out[n] = p[..., i * c:(i + 1) * c].clone()
        return out

    def scatter_grads(self, grads: dict) -> dict:
        """Reduce-scatter-MEAN every leaf over the data group: this rank
        keeps its chunk of the mean gradient (one collective a dtype for
        the flat leaves, one for the stacked)."""
        flat = {n: _flat_pad(g, self.world) for n, g in grads.items() if not self._is_stacked(n)}
        rows = {n: _rows_pad(g, self.world) for n, g in grads.items() if self._is_stacked(n)}
        out = {}
        for tree, axis in ((flat, 0), (rows, 1)):
            if tree:
                out.update({n: c / self.world for n, c in
                            psum_scatter_tree(tree, self.group, axis=axis).items()})
        return {n: out[n] for n in grads}

    def gather_params(self, chunks: dict, template: dict) -> dict:
        """All-gather the chunks back to full leaves shaped like
        ``template`` (tensors, or shapes), the zero padding sliced off."""
        out = {}
        for stacked, axis in ((False, 0), (True, 1)):
            part = {n: c for n, c in chunks.items() if self._is_stacked(n) == stacked}
            if not part:
                continue
            for n, full in all_gather_tree(part, self.group, axis=axis, tiled=True).items():
                shape = tuple(template[n].shape) if hasattr(template[n], "shape") \
                    else tuple(template[n])
                if stacked:
                    out[n] = full[:, :math.prod(shape[1:])].reshape(shape)
                else:
                    out[n] = full[:math.prod(shape)].reshape(shape)
        return {n: out[n] for n in chunks}

    # -- the Optimizer contract ------------------------------------------

    def init(self, params):
        return self.base.init(self.shard_params(params))

    def update_shards(self, grads, state, param_chunks):
        """The sharded update WITHOUT the trailing all-gather: the chunks
        updated in place; returns ``(param_chunks, new_state)``. The
        overlap engine gathers at the start of the next step."""
        return self.base.update(self.scatter_grads(grads), state, param_chunks)

    @torch.no_grad()
    def update(self, grads, state, params):
        """Reduce-scatter → the base update of this rank's chunks → all-gather;
        the full parameters written back in place."""
        chunks = self.shard_params(params)
        _, new_state = self.update_shards(grads, state, chunks)
        full = self.gather_params(chunks, params)
        for n, p in params.items():
            p.copy_(full[n])
        return params, new_state


def zero1_handles(optimizer, axis_name: str) -> bool:
    """True when ``optimizer`` is a ZeRO1 over ``axis_name``: its engine
    skips its own gradient mean (the reduce-scatter is the mean)."""
    return isinstance(optimizer, ZeRO1) and optimizer.axis_name == axis_name


def stages_stacked(name: str) -> bool:
    """The pipelines' stacked-leaf predicate: parameters under the top-level
    ``stages`` name carry a leading stage dim."""
    return str(name).split(".")[0] == "stages"


def with_stacked(opt: ZeRO1, pred: Callable[[str], bool]) -> ZeRO1:
    """``opt`` with its ``stacked`` predicate filled (as it is when set)."""
    if opt.stacked is not None:
        return opt
    return dataclasses.replace(opt, stacked=pred)
