"""The step sentinel as an optimizer wrapper (the port of
``tpudml/resilience/sentinel.py``).

One poisoned gradient poisons every replica under synchronous
collectives: after the all-reduce there is no clean copy left, and one
NaN micro-batch turns the run into NaN from that step on.
:class:`GradSentinel` wraps the optimizer any engine already calls:

- global gradient finiteness (every leaf, every element) and an optional
  norm-spike test against a running EMA are computed on the device, with
  no host read;
- on an anomaly the update is suppressed by a branch-free
  ``torch.where`` select: the previous parameters and base optimizer
  state are carried forward bit-exactly (a skipped step is a batch that
  never arrived), the base optimizer's clock (Adam's ``t``) does not
  advance, and a device-side skip counter increments;
- a consecutive-skip budget escalates on the host: :func:`sentinel_hook`
  reads the counters and raises :class:`SentinelTripped`, naming the
  first non-finite leaf by its JAX path (and, under gradient
  accumulation, the poisoned micro-batch from ``metrics["bad_micro"]``).

The base update always runs (its collectives, as in a sharded clip, stay
the same on every rank), then old and new are selected. The port's
optimizers update in place, so the wrapper copies the parameters and the
base state's tensors into one flat buffer a dtype before the update, and
writes ``where(skip, old, new)`` back into the same tensors after it
(``torch._foreach_copy_``): a handful of launches, whatever the number
of leaves, and nothing of the select outlives the step. The checks run
in multi-tensor launches too, and nothing reads the device. A Python-int
entry of the base state (Adam's ``t``) becomes an int32 tensor on the
parameters' device at ``init`` so that it can be held back without a
host read (``Adam`` takes either).

``groups`` lists the process groups over which the gradients seen here
may differ between ranks (JAX's ``axis_names``); the per-leaf non-finite
flags (JAX sums counts: the same decision) and the squared norm are
summed over them, so every rank takes the same decision. The DP engine's
gradients are aggregated before the update: ``groups=()``. Under ZeRO-1
the sentinel sits inside the wrapper, on the reduce-scattered chunks,
with the data group (:func:`attach_sentinel`); ``GSPMDParallel``'s blocks
of sharded parameters differ over the stage group, its replicated leaves
do not (``sharded``). The flags run
in JAX's flatten order of the parameters (their dotted names as the
nested paths), so ``bad_leaf`` indexes the same leaf JAX's does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from tpudml_torch.comm.collectives import psum_tree
from tpudml_torch.core.pytree import jax_sort_key, keystr
from tpudml_torch.obs.stepstats import grad_normsq
from tpudml_torch.optim import Optimizer
from tpudml_torch.train import nonfinite_leaves

#: keys that identify a GradSentinel state dict inside a nested opt_state
_STATE_KEYS = frozenset({"base", "skips", "consecutive", "good_steps", "norm_ema", "bad_leaf"})


class SentinelTripped(RuntimeError):
    """Raised on the host when the consecutive-skip budget is exceeded."""


def _tensor_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def _ints_on(tree, device):
    """``tree`` with its Python-int entries as int32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _ints_on(v, device) for k, v in tree.items()}
    if isinstance(tree, bool) or not isinstance(tree, int):
        return tree
    return torch.tensor(tree, dtype=torch.int32, device=device)


def _snapshot(tensors: list) -> list:
    """The tensors' values before the update: one flat copy a dtype, as
    ``(tensors, flat)`` pairs."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return [(ts, torch.cat([t.reshape(-1) for t in ts])) for ts in groups.values()]


def _select(skip: torch.Tensor, snapshot: list) -> None:
    """Write ``where(skip, old, new)`` back into the snapshot's tensors, in
    a few multi-tensor launches a dtype."""
    for ts, old in snapshot:
        sel = torch.where(skip, old, torch.cat([t.reshape(-1) for t in ts]))
        parts = sel.split([t.numel() for t in ts])
        torch._foreach_copy_(ts, [p.view(t.shape) for p, t in zip(parts, ts)])


def _select_replaced(skip: torch.Tensor, new_tree, orig_tree):
    """``new_tree`` with each tensor the update REPLACED (Adam's ``t``)
    selected against the one it replaced, which it left as it was; the
    tensors it updated in place are :func:`_select`'s."""
    if isinstance(new_tree, torch.Tensor):
        return new_tree if new_tree is orig_tree else torch.where(skip, orig_tree, new_tree)
    if isinstance(new_tree, dict):
        return {k: _select_replaced(skip, v, orig_tree[k]) for k, v in new_tree.items()}
    if isinstance(new_tree, (list, tuple)):
        return type(new_tree)(_select_replaced(skip, v, o) for v, o in zip(new_tree, orig_tree))
    return new_tree


@dataclass(frozen=True)
class GradSentinel(Optimizer):
    """Suppress non-finite / spiking updates on the device.

    ``groups``: process groups over which the gradients here may differ
    between ranks (module docstring); ``sharded`` marks, by parameter name,
    the leaves that do (a rank's block of a sharded parameter; a float
    weighs the leaf's squares, ``GSPMDParallel.norm_share``): the squares
    of the others count once in the norm (None: every leaf). ``spike_factor`` > 0 also skips a
    step whose global gradient norm exceeds ``spike_factor ×`` a running
    EMA (decay ``ema_decay``), armed only after ``warmup_steps``
    non-skipped steps. ``skip_budget``: the CONSECUTIVE skips tolerated
    before :func:`sentinel_hook` escalates; the step itself never raises.
    """

    base: Optimizer = None  # type: ignore[assignment]
    groups: tuple = ()
    sharded: Any = None  # Callable[[str], bool | float]: the leaves that differ over ``groups``
    skip_budget: int = 3
    spike_factor: float = 0.0
    ema_decay: float = 0.99
    warmup_steps: int = 10

    def __post_init__(self):
        if self.base is None:
            raise ValueError("GradSentinel needs a base optimizer")
        if self.skip_budget < 1:
            raise ValueError("skip_budget must be >= 1")
        if self.spike_factor and self.spike_factor <= 1.0:
            raise ValueError(
                "spike_factor must be > 1 (a ratio vs the running norm "
                "EMA) or 0 to disable the spike test")

    def init(self, params):
        dev = next(iter(params.values())).device

        def zero(dtype, value=0):
            return torch.full((), value, dtype=dtype, device=dev)

        return {
            "base": _ints_on(self.base.init(params), dev),
            "skips": zero(torch.int32),
            "consecutive": zero(torch.int32),
            "good_steps": zero(torch.int32),
            "norm_ema": zero(torch.float32),
            "bad_leaf": zero(torch.int32, -1),
        }

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        for group in self.groups:
            x = psum_tree(x, group)
        return x

    @torch.no_grad()
    def update(self, grads, state, params):
        leaves = [grads[n] for n in sorted(grads, key=jax_sort_key)]
        # Which leaves hold a non-finite element, in JAX's leaf order, summed
        # over the divergent groups; the first names the culprit.
        flagged = self._psum(nonfinite_leaves(leaves).to(torch.int32)) > 0
        nonfinite = flagged.any()
        bad_leaf_now = torch.where(nonfinite, torch.argmax(flagged.to(torch.int32)),
                                   -1).to(torch.int32)
        if self.sharded is None:
            normsq = self._psum(grad_normsq(leaves))
        else:
            # A float share weighs a leaf's squares (ClipByGlobalNorm's rule).
            by_share: dict = {}
            for n in sorted(grads, key=jax_sort_key):
                by_share.setdefault(float(self.sharded(n)), []).append(grads[n])
            local = sum((share * grad_normsq(ls).to(leaves[0].device)
                         for share, ls in by_share.items() if share),
                        torch.zeros((), device=leaves[0].device))
            normsq = (self._psum(local)
                      + grad_normsq(by_share.get(0.0, [])).to(leaves[0].device))
        # A non-finite gradient makes the norm non-finite too; skipped
        # steps never enter the EMA (below).
        norm = torch.sqrt(normsq)
        skip = nonfinite
        if self.spike_factor:
            armed = state["good_steps"] >= self.warmup_steps
            skip = skip | (armed & (norm > self.spike_factor * state["norm_ema"]))

        # Always run the base update, then select old or new, in place.
        base = state["base"]
        snapshot = _snapshot([*params.values(), *_tensor_leaves(base)])
        _, new_base = self.base.update(grads, base, params)
        _select(skip, snapshot)
        del snapshot
        out_base = _select_replaced(skip, new_base, base)

        good = (~skip).to(torch.int32)
        ema = state["norm_ema"]
        new_ema = torch.where(
            skip, ema,
            torch.where(state["good_steps"] == 0, norm,
                        self.ema_decay * ema + (1.0 - self.ema_decay) * norm))
        new_state = {
            "base": out_base,
            "skips": state["skips"] + (1 - good),
            "consecutive": torch.where(skip, state["consecutive"] + 1, 0).to(torch.int32),
            "good_steps": state["good_steps"] + good,
            "norm_ema": new_ema,
            "bad_leaf": torch.where(skip, bad_leaf_now, state["bad_leaf"]),
        }
        return params, new_state


# -------------------------------------------------------------- placement


def attach_sentinel(optimizer: Optimizer, divergent_groups: tuple = (), **kwargs) -> Optimizer:
    """Insert a :class:`GradSentinel` at its place in a chain: inside a
    ``ZeRO1`` (it then guards the reduce-scattered chunk gradients, with
    ZeRO-1's data group appended to ``divergent_groups``: the chunks are
    disjoint over it; on a skip the all-gather of the unselected old
    chunks gives back the old parameters bitwise), outermost otherwise.
    ``kwargs`` go to :class:`GradSentinel` (``sharded``, ``skip_budget``,
    ``spike_factor``, ...)."""
    from tpudml_torch.optim.zero1 import ZeRO1

    if isinstance(optimizer, ZeRO1):
        sent = GradSentinel(optimizer.base,
                            groups=tuple(divergent_groups) + (optimizer.group,), **kwargs)
        return dataclasses.replace(optimizer, base=sent)
    return GradSentinel(optimizer, groups=tuple(divergent_groups), **kwargs)


def find_sentinel(optimizer: Optimizer) -> GradSentinel | None:
    """The GradSentinel of an optimizer chain (walking ``.base``), or None."""
    opt = optimizer
    while isinstance(opt, Optimizer):
        if isinstance(opt, GradSentinel):
            return opt
        opt = getattr(opt, "base", None)
    return None


def find_sentinel_state(opt_state) -> dict | None:
    """The sentinel's state dict inside a (nested) optimizer state, or None."""
    if isinstance(opt_state, dict):
        if _STATE_KEYS <= set(opt_state):
            return opt_state
        for v in opt_state.values():
            hit = find_sentinel_state(v)
            if hit is not None:
                return hit
    elif isinstance(opt_state, (tuple, list)):
        for v in opt_state:
            hit = find_sentinel_state(v)
            if hit is not None:
                return hit
    return None


# ------------------------------------------------------------- host side


def param_leaf_names(params) -> list[str]:
    """The parameters' JAX leaf paths (``keystr``) in JAX's flatten order,
    the order ``bad_leaf`` indexes: ``params`` a dict by dotted name or a
    module."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return [keystr(n) for n in sorted(params, key=jax_sort_key)]


def sentinel_stats(opt_state) -> dict:
    """The sentinel's counters as Python scalars (one read each)."""
    st = find_sentinel_state(opt_state)
    if st is None:
        raise ValueError("no GradSentinel state in this optimizer state")
    return {
        "skips": int(st["skips"]),
        "consecutive": int(st["consecutive"]),
        "good_steps": int(st["good_steps"]),
        "norm_ema": float(st["norm_ema"]),
        "bad_leaf": int(st["bad_leaf"]),
    }


def sentinel_hook(sentinel: GradSentinel, params_template: Any = None, check_every: int = 1):
    """A training-loop hook that escalates the consecutive-skip budget.

    Every ``check_every`` steps it reads the counters (the only host read
    the sentinel causes) and raises :class:`SentinelTripped` once
    ``consecutive`` exceeds ``sentinel.skip_budget``, naming the first
    non-finite leaf (by its JAX path, given ``params_template``: the
    parameters or the model) and, when the metrics carry accumulation
    taint, the poisoned micro-batch."""
    names = param_leaf_names(params_template) if params_template is not None else None

    def hook(*, step, train_state, metrics=None, **_):
        if check_every > 1 and step % check_every:
            return
        st = find_sentinel_state(train_state.opt_state)
        if st is None:
            return
        consecutive = int(st["consecutive"])
        if consecutive <= sentinel.skip_budget:
            return
        leaf = int(st["bad_leaf"])
        if names is not None and 0 <= leaf < len(names):
            leaf_desc = f"leaf {leaf} ({names[leaf]})"
        else:
            leaf_desc = f"leaf {leaf}" if leaf >= 0 else "no non-finite leaf"
        micro = ""
        if metrics is not None and "bad_micro" in metrics:
            idx = int(metrics["bad_micro"])
            if idx >= 0:
                micro = f", first poisoned microbatch {idx}"
        from tpudml_torch.obs.tracer import get_tracer

        # The trip lands on the ambient trace before the raise unwinds.
        get_tracer().instant("sentinel_trip", cat="sentinel", args={
            "step": int(step), "consecutive": consecutive,
            "skips": int(st["skips"]), "bad_leaf": leaf})
        raise SentinelTripped(
            f"sentinel skipped {consecutive} consecutive steps "
            f"(budget {sentinel.skip_budget}) at step {step}: first "
            f"non-finite {leaf_desc}{micro}; total skips "
            f"{int(st['skips'])}, norm_ema {float(st['norm_ema']):.3g}")

    return hook
