"""Parameter and optimizer-state interop: ``tpudml`` trees -> the port's state.

The JAX package draws its init from threefry keys, which no torch
generator reproduces, so parity runs carry the JAX parameters across.
The caller hands over the tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); this module never sees jax.
Names flatten with dots (``block0.conv1.kernel``). Every tensor keeps
the JAX layout except a conv kernel (a 4-D ``kernel``), which goes from
JAX's HWIO to the port's OIHW in ``channels_last`` memory. Under expert
parallelism a rank holds its slice of each expert tensor
(:func:`ep_state_from_tpudml`); under ``GSPMDParallel`` its block of each
sharded leaf (:func:`gspmd_state_from_tpudml`); under a pipeline its row
of the stage-stacked leaves (:func:`pipeline_state_from_tpudml`), and a
heterogeneous stage its module's tensors from JAX's padded ``[S, L]`` row
and back (:func:`hetero_stage_from_tpudml`, :func:`hetero_stage_to_tpudml`).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tpudml_torch.nn.moe import expert_rows, is_expert_param


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


def sequential_params_from_tpudml(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``nn.Sequential``-of-the-port state dict from a ``tpudml.nn.Sequential``
    param tree: JAX's ``layer{i}`` keys are the port's child names
    (``layer1.kernel``, ``layer3.router.kernel``, ``layer3.experts.w1``),
    layouts as they are (conv kernels HWIO -> OIHW)."""
    if not tree or not all(str(k).startswith("layer") for k in tree):
        raise ValueError(f"not a Sequential param tree (keys {sorted(tree)})")
    return {k: _tensor(k, v) for k, v in _flatten(tree).items()}


def _local_experts(flat: dict[str, torch.Tensor], index: int, world: int) -> dict:
    """``flat`` with every expert tensor cut to rank ``index``'s rows
    (``expert_rows``); the rest as it is."""
    return {name: expert_rows(t, index, world, name).clone()
            if is_expert_param(name) and t.dim() > 0 else t for name, t in flat.items()}


def ep_state_from_tpudml(params: Mapping[str, Any], opt_state: Any, index: int,
                         world: int) -> tuple[dict[str, torch.Tensor], Any]:
    """This rank's ``(state dict, optimizer state)`` under expert
    parallelism from a JAX ``ExpertParallel`` TrainState's ``params`` and
    ``opt_state`` (as numpy: JAX's global view of the sharded arrays):
    replicated tensors copied, expert tensors (a name with an ``experts``
    component) cut to the rank's ``index``-th of ``world`` row blocks, in
    the optimizer state as in the parameters. Parameters keep the layouts
    of :func:`lm_params_from_tpudml` (a ``TransformerLM`` tree) or of
    :func:`sequential_params_from_tpudml` (``layer{i}`` keys); the
    optimizer state is an Adam/AdamW state, an Sgd momentum state, or
    ``()``. Load the state dict into the model that an ``ExpertParallel``
    engine has already cut to its experts."""
    state = (sequential_params_from_tpudml(params) if "tok_embed" not in params
             else lm_params_from_tpudml(params))
    if isinstance(opt_state, Mapping) and set(opt_state) == {"m", "v", "t"}:
        adam = adam_state_from_tpudml(opt_state)
        opt = {"m": _local_experts(adam["m"], index, world),
               "v": _local_experts(adam["v"], index, world), "t": adam["t"]}
    else:
        opt = sgd_state_from_tpudml(opt_state)
        if opt != ():
            opt = _local_experts(opt, index, world)
    return _local_experts(state, index, world), opt


def staged_params_from_tpudml(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``StagedModel`` state dict from a ``tpudml.models.StagedModel`` param
    tree (``lenet_stages``: ``conv.layer{i}``, ``fc.layer{i}``), conv
    kernels HWIO -> OIHW. Load with ``model.load_state_dict(state)``."""
    flat = _flatten(tree)
    if not flat or not all("." in k for k in flat):
        raise ValueError(f"not a StagedModel param tree (keys {sorted(tree)})")
    return {k: _tensor(k, v) for k, v in flat.items()}


def gspmd_state_from_tpudml(params: Mapping[str, Any], opt_state: Any, specs: dict,
                            mesh: dict, coords: dict) -> tuple[dict[str, torch.Tensor], Any]:
    """One rank's ``(state dict, optimizer state)`` of a JAX
    ``GSPMDParallel`` TrainState: ``params`` and ``opt_state`` as numpy (JAX's
    global view), ``specs`` the parameters' specs by dotted name
    (``GSPMDParallel.param_specs``, JAX's layout), ``mesh`` the axis sizes,
    ``coords`` the rank's index on each axis. Each sharded leaf is cut to
    the rank's window (``parallel.mp.block_window``), in the optimizer
    state as in the parameters, before the conv kernels turn OIHW. The
    optimizer state is an Sgd momentum state, ``()``, or an Adam state.
    Load the state dict into the model an engine has cut to its blocks."""
    from tpudml_torch.parallel.mp import block_window

    def blocks(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        out = {}
        for k, a in flat.items():
            win = block_window(k, a.shape, specs[k], mesh, coords)
            out[k] = _tensor(k, a[tuple(slice(lo, hi) for lo, hi in win)])
        return out

    state = blocks(_flatten(params))
    if isinstance(opt_state, Mapping) and set(opt_state) == {"m", "v", "t"}:
        opt = {"m": blocks(_flatten(opt_state["m"])), "v": blocks(_flatten(opt_state["v"])),
               "t": int(np.asarray(opt_state["t"]))}
    elif isinstance(opt_state, tuple) and not opt_state:
        opt = ()
    else:
        opt = blocks(_flatten(opt_state))
    return state, opt


def _stage_rows(flat: dict[str, np.ndarray], stage: int) -> dict[str, torch.Tensor]:
    """``flat`` with every ``stages`` leaf cut to row ``stage`` of its
    leading (stage) dim, kept as ``[1, ...]``."""
    return {k: torch.from_numpy(np.array(a[stage:stage + 1] if k.split(".")[0] == "stages"
                                         else a, copy=True)) for k, a in flat.items()}


def pipeline_state_from_tpudml(params: Mapping[str, Any], opt_state: Any,
                               stage: int) -> tuple[dict[str, torch.Tensor], Any]:
    """One stage's ``(state dict, optimizer state)`` of a JAX ``GPipe``,
    ``OneFOneB`` or ``Interleaved1F1B`` TrainState (``params`` and
    ``opt_state`` as numpy: JAX's global view): ``prologue.*`` and
    ``epilogue.*`` whole, every ``stages.*`` leaf cut to row ``stage``
    (``[1, ...]``, or ``[1, V, ...]`` interleaved), in the optimizer state
    as in the parameters. The optimizer state is an Sgd momentum state,
    ``()``, or an Adam state. Load the state dict into the engine's
    ``ts.model``."""
    state = _stage_rows(_flatten(params), stage)
    if isinstance(opt_state, Mapping) and set(opt_state) == {"m", "v", "t"}:
        opt = {"m": _stage_rows(_flatten(opt_state["m"]), stage),
               "v": _stage_rows(_flatten(opt_state["v"]), stage),
               "t": int(np.asarray(opt_state["t"]))}
    elif isinstance(opt_state, tuple) and not opt_state:
        opt = ()
    else:
        opt = _stage_rows(_flatten(opt_state), stage)
    return state, opt


def _jax_shape(name: str, t: torch.Tensor) -> tuple:
    s = tuple(t.shape)
    return (s[2], s[3], s[1], s[0]) if name.endswith("kernel") and t.dim() == 4 else s


def _jax_order(stage) -> list[str]:
    from tpudml_torch.core.pytree import jax_sort_key

    return sorted((n for n, _ in stage.named_parameters()), key=jax_sort_key)


def hetero_stage_from_tpudml(row: np.ndarray, stage) -> dict[str, torch.Tensor]:
    """A heterogeneous stage's state dict from its row of JAX's
    ``HeteroPipeline`` layout: JAX ravels the stage's param tree (its
    leaves in tree order, each in JAX's layout) into one f32 vector padded
    to the widest stage's L, ``params["stages"][s]``; the port keeps the
    stage module's own tensors. ``stage`` is the port's module for that
    stage (it gives the names and shapes); conv kernels turn OIHW. The
    same call carries an optimizer state row (Sgd momentum, Adam's m or
    v) to the tensors of that state, by the parameters' names."""
    row = np.asarray(row)
    out, at = {}, 0
    for name in _jax_order(stage):
        shape = _jax_shape(name, stage.get_parameter(name))
        n = int(np.prod(shape))
        out[name] = _tensor(name, row[at:at + n].reshape(shape))
        at += n
    if np.any(row[at:]):
        raise ValueError(f"the row's padding past the stage's {at} values is not zero")
    return out


def hetero_stage_to_tpudml(tensors: Mapping[str, torch.Tensor], stage, width: int) -> np.ndarray:
    """The inverse of :func:`hetero_stage_from_tpudml`: ``tensors`` (the
    stage's parameters, or an optimizer state's tensors, by name) raveled
    in JAX's order and layout and zero-padded to ``width`` (JAX's L)."""
    parts = []
    for name in _jax_order(stage):
        t = tensors[name].detach().cpu()
        if name.endswith("kernel") and t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        parts.append(t.reshape(-1).numpy())
    flat = np.concatenate(parts) if parts else np.zeros((0,), np.float32)
    return np.pad(flat, (0, width - flat.shape[0])).astype(np.float32)


def lm_params_from_pipeline(params: Mapping[str, torch.Tensor],
                            v_chunks: int | None = None) -> dict[str, torch.Tensor]:
    """A ``TransformerLM`` state dict from a transformer pipeline's whole
    parameters (``GPipe.gather_params``: a ``TransformerEmbed`` prologue,
    ``TransformerBlock`` stages, a ``TransformerHead`` epilogue): block
    σ = v·S + s is the stages' row ``[s]``, or ``[s, v]`` for an
    ``Interleaved1F1B`` of ``v_chunks``. The LM has V·S layers."""
    out = {}
    for n, t in params.items():
        part, name = n.split(".", 1)
        if part != "stages":
            out[name] = t
            continue
        for s in range(t.shape[0]):
            for v in range(v_chunks or 1):
                out[f"block{v * t.shape[0] + s}.{name}"] = t[s, v] if v_chunks else t[s]
    return out
