"""Parameter and optimizer-state interop: ``tpudml`` trees -> the port's state.

The JAX package draws its init from threefry keys, which no torch
generator reproduces, so parity runs carry the JAX parameters across.
The caller hands over the tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); this module never sees jax.
Names flatten with dots (``block0.conv1.kernel``). Every tensor keeps
the JAX layout except a conv kernel (a 4-D ``kernel``), which goes from
JAX's HWIO to the port's OIHW in ``channels_last`` memory.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def lm_params_from_tpudml(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``TransformerLM`` state dict from a ``tpudml.models.TransformerLM``
    param tree: ``tok_embed``, ``pos_embed`` (learned positions only),
    ``block{i}.{ln1, attn.{q,k,v,out}, ln2, fc1, fc2}`` or, in a MoE
    model, ``block{i}.moe.{router.kernel, experts.{w1, b1, w2, b2}}`` in
    place of fc1, fc2, ``ln_f``, ``head``. Dense kernels keep their [in,
    out] layout (the port's ``Dense`` stores them so) and the experts'
    tensors theirs ([E, d, h], [E, h], [E, h, d], [E, d], as the port's
    ``MoELayer`` does); every array becomes a CPU tensor of its own
    dtype. Load with ``model.load_state_dict(state)``."""
    flat = _flatten(tree)
    if "tok_embed" not in flat or "head.kernel" not in flat:
        raise ValueError("not a TransformerLM param tree (no tok_embed/head)")
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def _tensor(name: str, a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor of its dtype; a conv kernel HWIO -> OIHW."""
    t = torch.from_numpy(np.array(a, copy=True))
    if name.endswith("kernel") and t.dim() == 4:
        t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return t


def resnet_params_from_tpudml(params: Mapping[str, Any],
                              model_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``ResNet`` state dict from a ``tpudml.models.ResNet`` param tree and
    its model state (BatchNorm's ``mean``/``var``): ``stem``, ``stem_bn``,
    ``block{i}.{conv1, bn1, conv2, bn2[, conv3, bn3], proj, proj_bn}``,
    ``head``, conv kernels HWIO -> OIHW. Load with
    ``model.load_state_dict(state)``."""
    flat = {**_flatten(params), **_flatten(model_state)}
    if "stem.kernel" not in flat or "head.kernel" not in flat:
        raise ValueError("not a ResNet param tree (no stem/head)")
    return {k: _tensor(k, v) for k, v in flat.items()}


def sgd_state_from_tpudml(opt_state: Any) -> Any:
    """The port's ``Sgd`` state from a ``tpudml`` Sgd state: ``()`` without
    momentum, else the momentum buffers by the parameters' names, conv
    buffers transposed as their kernels are."""
    if isinstance(opt_state, tuple) and not opt_state:
        return ()
    return {k: _tensor(k, v) for k, v in _flatten(opt_state).items()}


def adam_state_from_tpudml(opt_state: Mapping[str, Any]) -> dict:
    """The port's ``Adam``/``AdamW`` state from a ``tpudml`` Adam state
    ``{"m": tree, "v": tree, "t": int}`` (arrays as numpy): the moment
    trees flatten to the same parameter names as
    :func:`lm_params_from_tpudml`, ``t`` becomes a Python int. Move the
    moments to the model's device before updating on it."""
    if set(opt_state) != {"m", "v", "t"}:
        raise ValueError(f"not an Adam state (keys {sorted(opt_state)})")
    return {
        "m": {k: torch.from_numpy(np.array(v, copy=True))
              for k, v in _flatten(opt_state["m"]).items()},
        "v": {k: torch.from_numpy(np.array(v, copy=True))
              for k, v in _flatten(opt_state["v"]).items()},
        "t": int(np.asarray(opt_state["t"])),
    }
