"""First-order optimizers (the port of ``tpudml/optim/optimizers.py``:
``GradientDescent``, ``Sgd``, ``Adam``, ``ReferenceAdam``, ``AdamW``,
``ClipByGlobalNorm``, ``shard_aware_clip``, ``make_optimizer``).

Same contract as the JAX package, over dicts of tensors keyed by
parameter name (``dict(model.named_parameters())``):
``init(params) -> state`` and ``update(grads, state, params) ->
(params, state)``. The port updates the parameter tensors IN PLACE (the
JAX functions return new pytrees) and returns the same dict; the
optimizer state is a plain dict too, so it carries across from a
``tpudml`` state (``tpudml_torch.interop.adam_state_from_tpudml``,
``sgd_state_from_tpudml``).

Adam is written out with the JAX package's exact formula and order of
operations, ``p − lr·(m/c1) / (sqrt(v/c2) + eps)`` with
``c = 1 − β**t`` in f32; ``torch.optim.Adam`` rounds differently.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from tpudml_torch.comm.collectives import psum_tree

Params = dict[str, torch.Tensor]


class Optimizer:
    """Base optimizer: stateless ``init``; subclasses implement ``update``."""

    def init(self, params: Params):
        return ()

    def update(self, grads: Params, state, params: Params):
        raise NotImplementedError


@dataclass(frozen=True)
class GradientDescent(Optimizer):
    """Vanilla gradient descent: ``p -= lr * g``."""

    lr: float = 1e-3

    @torch.no_grad()
    def update(self, grads, state, params):
        for name, p in params.items():
            p.sub_(self.lr * grads[name])
        return params, state


@dataclass(frozen=True)
class Sgd(Optimizer):
    """SGD with (optional) heavy-ball momentum, torch.optim.SGD's
    formulation: ``buf = mu·buf + g; p −= lr·buf``; no state when mu = 0."""

    lr: float = 1e-2
    momentum: float = 0.0

    def init(self, params):
        if self.momentum == 0.0:
            return ()
        return {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def update(self, grads, state, params):
        for name, p in params.items():
            if self.momentum == 0.0:
                p.sub_(self.lr * grads[name])
                continue
            buf = state[name]
            buf.copy_(self.momentum * buf + grads[name])
            p.sub_(self.lr * buf)
        return params, state


def _bias_correction(beta: float, t):
    """1 − β**t computed in f32, as the JAX update does with an f32 step:
    a Python float for an int ``t``, a 0-d f32 tensor on ``t``'s device
    for a tensor ``t`` (a state that must advance without a host read,
    as under ``GradSentinel``)."""
    if isinstance(t, torch.Tensor):
        b = torch.full((), beta, dtype=torch.float32, device=t.device)
        return 1.0 - b ** t.float()
    b = torch.tensor(beta, dtype=torch.float32)
    return float(1.0 - b ** torch.tensor(float(t), dtype=torch.float32))


@dataclass(frozen=True)
class Adam(Optimizer):
    """Standard Adam (Kingma & Ba) with bias correction."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params):
        return {
            "m": {n: torch.zeros_like(p) for n, p in params.items()},
            "v": {n: torch.zeros_like(p) for n, p in params.items()},
            "t": 0,
        }

    @torch.no_grad()
    def _adam_step(self, grads, state, params) -> dict:
        """Advance the moments in place and apply the Adam step to
        ``params``; returns the new state."""
        t = state["t"] + 1
        c1 = _bias_correction(self.b1, t)
        c2 = _bias_correction(self.b2, t)
        for name, p in params.items():
            g = grads[name]
            m = state["m"][name]
            v = state["v"][name]
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g * g)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
        return {"m": state["m"], "v": state["v"], "t": t}

    def update(self, grads, state, params):
        return params, self._adam_step(grads, state, params)


@dataclass(frozen=True)
class ReferenceAdam(Optimizer):
    """The reference's hand-written Adam WITHOUT bias correction
    (codes/task1/pytorch/MyOptimizer.py:26-43): ``m = b1·m + (1−b1)·g;
    v = b2·v + (1−b2)·g²; p −= (lr·m) / (sqrt(v) + eps)``, in JAX's order
    of operations. task1's early-step update scale depends on the missing
    correction."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params):
        return {"m": {n: torch.zeros_like(p) for n, p in params.items()},
                "v": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, state, params):
        for name, p in params.items():
            g = grads[name]
            m = state["m"][name]
            v = state["v"][name]
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g * g)
            p.sub_(self.lr * m / (torch.sqrt(v) + self.eps))
        return params, state


@dataclass(frozen=True)
class AdamW(Adam):
    """Adam with DECOUPLED weight decay: ``p_new − lr·wd·p_old``."""

    weight_decay: float = 0.01

    @torch.no_grad()
    def update(self, grads, state, params):
        decay = ({n: self.lr * self.weight_decay * p for n, p in params.items()}
                 if self.weight_decay else None)
        state = self._adam_step(grads, state, params)
        if decay is not None:
            for name, p in params.items():
                p.sub_(decay[name])
        return params, state


@dataclass(frozen=True)
class ClipByGlobalNorm(Optimizer):
    """Gradient clipping wrapper: scales the WHOLE gradient dict by
    ``min(1, max_norm / max(norm, 1e-12))``, ``norm`` its global L2 norm
    (squares summed in f32), then defers to ``base``; the state is
    ``base``'s.

    An engine whose update runs on rank-local gradient shards
    (``ExpertParallel``: each rank holds its slice of the experts) must
    reduce the norm across ranks, or every rank derives another scale and
    the replicated parameters drift apart. JAX names mesh axes there; the
    port's ``axes`` are process groups (None = the default group): the
    squares of the leaves ``sharded`` marks (a predicate on the parameter
    name; None = every leaf) are summed over each group in turn, those of
    the replicated leaves counted once. A float ``sharded(name)`` weighs
    the leaf's squares (``GSPMDParallel.norm_share``: 1 / the ranks of
    those groups holding the same block). Engines rewrap the clip with
    :func:`shard_aware_clip`.
    """

    base: Optimizer = None  # type: ignore[assignment]
    max_norm: float = 1.0
    axes: tuple = ()
    sharded: Any = None  # Callable[[str], bool | float]; None = every leaf local

    def __post_init__(self):
        if self.base is None:
            raise ValueError("ClipByGlobalNorm needs a base optimizer")

    def init(self, params):
        return self.base.init(params)

    @torch.no_grad()
    def scale(self, grads: Params) -> torch.Tensor:
        """The factor the update multiplies every gradient by (f32), from
        the L2 norm of ``grads`` over the ranks of ``axes``."""
        local = rep = torch.zeros((), dtype=torch.float32,
                                  device=next(iter(grads.values())).device)
        for name, g in grads.items():
            s = g.float().square().sum()
            share = 1.0 if self.sharded is None else float(self.sharded(name))
            if share:
                local = local + s * share
            else:
                rep = rep + s
        for group in self.axes:
            local = psum_tree(local, group)
        norm = torch.sqrt(local + rep)
        return torch.clamp(self.max_norm / torch.clamp(norm, min=1e-12), max=1.0)

    def update(self, grads, state, params):
        scale = self.scale(grads)
        grads = {n: (g * scale).to(g.dtype) for n, g in grads.items()}
        return self.base.update(grads, state, params)


def shard_aware_clip(opt: Optimizer, axes: tuple, sharded) -> Optimizer:
    """Rewrap every :class:`ClipByGlobalNorm` in ``opt``'s ``.base`` chain
    that has no ``axes`` yet, so that its norm reduces over the engine's
    process groups ``axes`` with ``sharded`` marking the rank-local leaves.
    A clip nested below the top of the chain (or below another clip)
    would otherwise compute a rank-local norm. Returns a new chain; the
    optimizers are frozen dataclasses."""
    if isinstance(opt, ClipByGlobalNorm) and not opt.axes:
        opt = dataclasses.replace(opt, axes=tuple(axes), sharded=sharded)
        # fall through: the clip's own .base may nest another clip
    base = getattr(opt, "base", None)
    if isinstance(base, Optimizer):
        new_base = shard_aware_clip(base, axes, sharded)
        if new_base is not base:
            opt = dataclasses.replace(opt, base=new_base)
    return opt


def make_optimizer(
    name: str, lr: float, momentum: float = 0.0, weight_decay: float = 0.01
) -> Optimizer:
    """Factory of the task entry points' ``--optimizer`` flag."""
    name = name.lower()
    if name == "gd":
        return GradientDescent(lr=lr)
    if name == "sgd":
        return Sgd(lr=lr, momentum=momentum)
    if name == "adam":
        return Adam(lr=lr)
    if name == "adamw":
        return AdamW(lr=lr, weight_decay=weight_decay)
    if name in ("adam_ref", "reference_adam"):
        return ReferenceAdam(lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")
