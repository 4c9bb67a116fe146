"""Fully-sharded data parallelism (FSDP / ZeRO-3) over the ``data`` axis
(the port of ``tpudml/parallel/fsdp.py``).

FSDP shards the batch AND the parameters, gradients and optimizer state
over the same ``data`` axis: a rank's parameter, gradient and optimizer
bytes scale 1/W while the training math stays DP's. It is
``GSPMDParallel`` with ``batch_axis = axis_name`` and a rule that splits
each leaf's largest divisible dimension over that axis
(:func:`fsdp_sharding_rules`, JAX's rule leaf for leaf). The schedule is
the engine's: each weight is all-gathered on use before the forward, its
gradient comes back as the data group's reduce-scatter (this rank's
block of the mean), and the optimizer updates the block where it lives.
XLA derives the same schedule from the shardings in JAX.

It composes with tensor parallelism on a 2-D ``{"data": D, "model": M}``
mesh: ``base_rule=tensor_parallel_rules("model")`` claims its dimensions
first, and FSDP shards the largest remaining free one over ``data``.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from tpudml_torch.nn.losses import softmax_cross_entropy
from tpudml_torch.optim import Optimizer
from tpudml_torch.parallel.mp import GSPMDParallel, PartitionSpec, RuleFn


def fsdp_sharding_rules(axis_name: str = "data", base: RuleFn | None = None,
                        axis_size: int | None = None) -> RuleFn:
    """ZeRO-3 parameter layout: each leaf's largest free dimension that
    ``axis_size`` divides (when given; without it the largest, which
    ``apply_rules`` demotes if the axis does not divide it) goes over
    ``axis_name``; ties break toward the leading dimension (its blocks
    are contiguous). ``base`` (e.g. ``tensor_parallel_rules``) claims
    dimensions first. The spec is canonical: no trailing None. Leaves with
    no such dimension (small or odd biases) stay replicated."""

    def rule(path: tuple, leaf) -> PartitionSpec:
        spec = list(base(path, leaf)) if base is not None else []
        spec += [None] * (leaf.ndim - len(spec))
        free = [i for i in range(leaf.ndim) if spec[i] is None]
        if axis_size:
            free = [i for i in free if leaf.shape[i] % axis_size == 0]
        best, best_size = None, 0
        for i in free:
            if leaf.shape[i] > best_size:
                best, best_size = i, leaf.shape[i]
        if best is not None:
            spec[best] = axis_name
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    return rule


class FSDP(GSPMDParallel):
    """FSDP/ZeRO-3 training engine.

    Usage::

        eng = FSDP(model, opt)               # mesh {"data": world}
        ts = eng.create_state()              # params and optimizer state 1/W a rank
        step = eng.make_train_step()         # (ts, x, labels) -> (ts, metrics)

    2-D composition with tensor parallelism::

        eng = FSDP(model, opt, {"data": 2, "model": 4},
                   base_rule=tensor_parallel_rules("model"))

    Batches are GLOBAL and the same on every rank; each data rank trains on
    its rows. Keyword arguments as ``GSPMDParallel``'s. Over W ranks it
    trains what replicated DP and single-device training train, step for
    step: the sharding moves bytes, not the math.
    """

    def __init__(self, model: nn.Module, optimizer: Optimizer, mesh: dict | None = None,
                 axis_name: str = "data", base_rule: RuleFn | None = None, rng_root=None,
                 accum_steps: int = 1, loss: Callable = softmax_cross_entropy,
                 aux_loss_weight: float | None = None, fused_xent: bool = False,
                 save_scores: bool | None = None, sentinel: bool | dict = False, obs=False,
                 flash_attn: bool = False):
        import torch.distributed as dist

        if mesh is None and dist.is_initialized():
            mesh = {axis_name: dist.get_world_size()}
        if mesh is not None and axis_name not in mesh:
            raise ValueError(f"FSDP axis {axis_name!r} not in mesh axes {tuple(mesh)}")
        super().__init__(
            model, optimizer, mesh,
            rule=fsdp_sharding_rules(axis_name, base_rule,
                                     axis_size=mesh[axis_name] if mesh else None),
            axis_name=axis_name, batch_axis=axis_name, rng_root=rng_root,
            accum_steps=accum_steps, loss=loss, aux_loss_weight=aux_loss_weight,
            fused_xent=fused_xent, save_scores=save_scores, sentinel=sentinel, obs=obs,
            flash_attn=flash_attn)
