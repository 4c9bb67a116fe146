"""Softmax cross-entropy and top-1 accuracy (the port of
``tpudml/nn/losses.py`` ``softmax_cross_entropy``, ``accuracy``). Plain PyTorch: the JAX package computes it
with XLA, not with a Pallas kernel.

Semantics follow the JAX function exactly: the mean over rows of
lse − logit[label], statistics in f32 whatever the logits dtype, labels
clamped to [0, V−1] (an out-of-range id picks an edge class instead of
being dropped), and the backward (softmax − onehot) · g / n, which keeps
only the per-row lse from the forward.
"""

from __future__ import annotations

import torch


class _SoftmaxCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        ids = labels.reshape(-1).long().clamp(0, v - 1)
        m = flat.amax(dim=-1)
        lse = torch.log(torch.exp(flat.float() - m.float()[:, None]).sum(-1)) + m.float()
        picked = flat.gather(1, ids[:, None])[:, 0].float()
        ctx.save_for_backward(logits, ids, lse)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        logits, ids, lse = ctx.saved_tensors
        v = logits.shape[-1]
        p = torch.exp(logits.reshape(-1, v).float() - lse[:, None])
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, ids] -= 1.0  # softmax − onehot, in place
        dlogits = (p * (g / lse.numel())).to(logits.dtype)
        return dlogits.reshape(logits.shape), None


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of ``logits`` [..., V] against integer
    ``labels`` [...] (module docstring)."""
    if logits.shape[:-1] != labels.shape:
        raise ValueError(
            f"labels {tuple(labels.shape)} must match logits' leading axes "
            f"{tuple(logits.shape[:-1])}"
        )
    return _SoftmaxCrossEntropy.apply(logits, labels)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy: the f32 mean of ``argmax(logits) == labels``."""
    return (logits.argmax(dim=-1) == labels).float().mean()
