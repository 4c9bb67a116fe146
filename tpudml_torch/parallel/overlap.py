"""Collective-matmul overlap: a row-sharded tensor-parallel matmul whose
all-reduce runs chunk by chunk under the next chunk's product (the port
of ``tpudml/parallel/overlap.py``).

A tensor-parallel block ends its attention and MLP branches with a
matmul whose partial products are summed over the model group; done
whole, the all-reduce starts after the whole [rows, m] product and its
wire time is exposed. :func:`tp_overlap_matmul` splits the rows into
``chunks`` pieces and starts each piece's all-reduce (``async_op=True``)
as soon as its product exists, so reduce i runs while product i+1 is
computed and only the last chunk's reduce (1/chunks of the bytes) stays
exposed. The chunks split rows, which the reduce never mixes, so the
result is ``all_reduce(x @ w)``, in value and in gradient.

In the JAX package only the planner and tests call it; here only tests
do. It needs a group of two ranks or more, so one card cannot run it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpudml_torch.capabilities import reject

# 4 hides 3/4 of the reduce behind compute while each chunk's product
# stays large at the flagship's row counts (JAX's planner prices it).
OVERLAP_CHUNKS = 4


class _OverlapMatmul(torch.autograd.Function):
    """Forward: the row chunks' f32 products, each all-reduced as soon as it
    exists; backward: the replicated output's cotangent passes through the
    sum, as the plain ``all_reduce(x @ w)``'s does (dX = g·Wᵀ, dW = xᵀ·g)."""

    @staticmethod
    def forward(ctx, x, w, group, chunks: int):
        ctx.save_for_backward(x, w)
        parts, works = [], []
        for xc in x.chunk(chunks, dim=0):
            p = xc.float() @ w.float()
            works.append(dist.all_reduce(p, op=dist.ReduceOp.SUM, group=group,
                                         async_op=True))
            parts.append(p)
        for work in works:
            work.wait()
        return torch.cat(parts, dim=0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.float()
        dx = (gf @ w.float().T).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = (x.float().T @ gf).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def tp_overlap_matmul(x: torch.Tensor, w: torch.Tensor, *, group=None,
                      chunks: int = OVERLAP_CHUNKS) -> torch.Tensor:
    """``all_reduce(x @ w)`` over ``group`` in ``chunks`` row chunks, each
    chunk's all-reduce overlapping the next chunk's product (module
    docstring). ``x`` [rows, k_local] is the feature-sharded activation,
    ``w`` [k_local, m] this rank's weight shard; the products accumulate in
    f32 and the result has ``x``'s dtype. Rejects a group of one rank
    (``tp_overlap_needs_model_axis``: no reduce to hide) and rows that
    ``chunks`` does not divide."""
    if chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    if dist.get_world_size(group) <= 1:
        reject("tp_overlap_needs_model_axis")
    rows = x.shape[0]
    if rows % chunks:
        raise ValueError(f"rows {rows} must divide by chunks {chunks} (pad the batch or "
                         "pick a divisor; uneven chunks would recompile per shape)")
    return _OverlapMatmul.apply(x, w, group, chunks)
