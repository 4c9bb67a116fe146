"""First-order optimizers (the port of ``tpudml/optim/optimizers.py``:
``GradientDescent``, ``Sgd``, ``Adam``, ``AdamW``, ``make_optimizer``).

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

from dataclasses import dataclass

import torch

NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item 3, ReferenceAdam)"

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


def _bias_correction(beta: float, t: int) -> float:
    """1 − β**t computed in f32, as the JAX update does with an f32 step."""
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
        raise NotImplementedError(f"optimizer {name!r} {NOT_PORTED}")
    raise ValueError(f"unknown optimizer {name!r}")
