"""Parameter and optimizer-state interop: ``tpudml`` trees -> the port's state.

The JAX package draws its init from threefry keys, which no torch
generator reproduces, so parity runs carry the JAX parameters across.
The caller hands over the tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); this module never sees jax.
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
    ``block{i}.{ln1, attn.{q,k,v,out}, ln2, fc1, fc2}``, ``ln_f``,
    ``head``. Dense kernels keep their [in, out] layout (the port's
    ``Dense`` stores them so); every array becomes a CPU tensor of its
    own dtype. Load with ``model.load_state_dict(state)``."""
    flat = _flatten(tree)
    if "tok_embed" not in flat or "head.kernel" not in flat:
        raise ValueError("not a TransformerLM param tree (no tok_embed/head)")
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


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
