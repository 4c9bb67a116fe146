"""Shared pieces of the sharded engines (the port of
``tpudml/parallel/sharding.py``: ``make_counting_eval_step``).

JAX's version jits one ``shard_map`` program over the engine's mesh axes;
here each rank evaluates its rows of the global batch eagerly and the
counts are summed over the engine's process group. JAX's
``DispatchThrottle`` bounds asynchronous dispatch on a CPU mesh; the
eager engines have nothing to bound (see ``parallel/dp.py``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from tpudml_torch.comm.collectives import psum_tree


def make_counting_eval_step(model: nn.Module, shard_batch: Callable, group=None,
                            reduce: bool = True) -> Callable:
    """(images, labels) -> (correct, count), both summed over ``group``:
    ``shard_batch`` takes this rank's rows of the global batch to its
    device, ``model`` runs in eval mode under ``torch.no_grad()`` (its mode
    restored after), and ``correct`` counts the rows whose argmax logit is
    the label. The counts are int64 tensors; every rank gets the totals.
    ``reduce=False``: each rank evaluates the whole batch (a replicated
    batch), and its counts are the totals."""

    @torch.no_grad()
    def step(images, labels):
        x, y = shard_batch(images, labels)
        mode = model.training
        model.eval()
        try:
            logits = model(x)
        finally:
            model.train(mode)
        counts = torch.stack([(logits.argmax(-1) == y).sum(),
                              torch.tensor(y.numel(), device=y.device)])
        correct, count = psum_tree(counts, group) if reduce else counts
        return correct, count

    return step
