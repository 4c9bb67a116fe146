"""Step telemetry: :class:`StepStats` (the port of
``tpudml/obs/stepstats.py``).

With ``obs=`` on, the DP engine's step adds ``metrics["step_stats"]``:
the loss, the global gradient norm, the sentinel's skip counters and the
ring-model comm bytes accumulated so far, every one a 0-d tensor on the
step's device, computed from tensors the step already has (no host read:
the step's own loss read is the only sync, as in JAX). The comm-bytes
leaf is priced from the gradient and model-state shapes with the ring
model of ``comm.timing.collective_wire_bytes`` and multiplied by the
step count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tpudml_torch.comm.timing import collective_wire_bytes


@dataclass
class StepStats:
    """One step's telemetry; every field a 0-d tensor."""

    loss: torch.Tensor
    grad_norm: torch.Tensor
    skips: torch.Tensor          # sentinel total skipped steps (0 without one)
    consecutive: torch.Tensor    # sentinel consecutive-skip counter
    comm_bytes: torch.Tensor     # accumulated ring-model wire bytes/device

    def to_scalars(self) -> dict:
        """The fields by their MetricsWriter names."""
        return {
            "loss": self.loss,
            "grad_norm": self.grad_norm,
            "sentinel_skips": self.skips,
            "sentinel_consecutive": self.consecutive,
            "comm_bytes": self.comm_bytes,
        }


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes(tree: Any) -> float:
    """Payload bytes of the tensors of a (nested) dict, list or tuple."""
    return float(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def grad_normsq(grads: Any) -> torch.Tensor:
    """Sum of the squared gradient entries, f32 (on the gradients'
    device; the leaves' norms in one multi-tensor launch, squared and
    summed); callers reduce it across ranks as their layout needs."""
    leaves = [g if g.dtype == torch.float32 else g.float() for g in _tensors(grads)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(torch._foreach_norm(leaves)).square().sum()


def dp_wire_bytes_per_step(grads: Any, model_state: Any, world: int,
                           aggregation: str = "allreduce", zero1: bool = False) -> float:
    """Ring-model wire bytes one DP step moves a device: the gradients'
    aggregation (strategy-dependent) and the model state's mean. ZeRO-1's
    reduce-scatter and chunk all_gather price as psum does."""
    gb = tree_bytes(grads)
    msb = tree_bytes(model_state)
    if zero1:
        agg = (collective_wire_bytes("psum_scatter", gb, world)
               + collective_wire_bytes("all_gather", gb / max(world, 1), world))
    elif aggregation == "allgather":
        agg = collective_wire_bytes("all_gather", gb, world)
    else:
        # allreduce; reducescatter's psum_scatter + all_gather prices as psum.
        agg = collective_wire_bytes("psum", gb, world)
    return agg + collective_wire_bytes("psum", msb, world)


def make_step_stats(loss: torch.Tensor, normsq: torch.Tensor, opt_state: Any,
                    comm_bytes_per_step: float, step: int) -> StepStats:
    """The StepStats of a step, from its loss, the squared gradient norm,
    the POST-update optimizer state (a GradSentinel's counters are read
    from it; zeros without one), the per-step wire bytes and the step
    index (``ts.step`` before the update). ``comm_bytes`` is
    f32(bytes) × f32(step + 1), as JAX computes it."""
    from tpudml_torch.resilience.sentinel import find_sentinel_state

    dev = loss.device
    st = find_sentinel_state(opt_state)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    comm = np.float32(comm_bytes_per_step) * np.float32(step + 1)
    return StepStats(
        loss=loss.float(),
        grad_norm=torch.sqrt(torch.clamp(normsq, min=0.0)),
        skips=st["skips"].to(torch.int32) if st is not None else zero,
        consecutive=st["consecutive"].to(torch.int32) if st is not None else zero,
        comm_bytes=torch.full((), float(comm), dtype=torch.float32, device=dev),
    )
