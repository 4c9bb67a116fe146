"""int8 weight quantization for the decode path: the port of
``tpudml/serve/fleet/quant.py``.

Every 2-D leaf named ``kernel`` (attention q/k/v/out, fc1/fc2, the LM
head; [in, out] layout) is stored as int8 codes with one f32 absmax scale
per OUTPUT column; embeddings, LayerNorm parameters and biases stay f32.
Trees are nested dicts of tensors (the JAX package's layout) or flat
``state_dict``s, whose leaf name is the last dotted component.

:func:`sim_quantize_params` is the oracle (quantize→dequantize, f32
storage); :func:`quantize_params` + :func:`dequantize_params` is the real
path and equals the oracle bitwise — same ops in the same order
(``q.float() * scale``).
"""

from __future__ import annotations

import torch

from tpudml_torch.serve.cache import _SCALE_EPS


def _quant_kernel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """kernel [in, out] -> (int8 codes [in, out], f32 scale [out])."""
    wf = w.to(torch.float32)
    scale = wf.abs().amax(dim=0).clamp_min(_SCALE_EPS) / 127.0
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def _dequant_kernel(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[None, :]


def _is_kernel(name: str | None, leaf) -> bool:
    return (name is not None and name.rsplit(".", 1)[-1] == "kernel"
            and getattr(leaf, "ndim", 0) == 2)


def quantize_params(params: dict) -> tuple[dict, dict]:
    """Real int8 path: ``(qparams, scales)`` — the tree with every
    eligible kernel stored as int8, and a parallel tree holding the f32
    per-output-channel scales at exactly those paths (None elsewhere)."""

    def _q(node, name=None):
        if isinstance(node, dict):
            pairs = {k: _q(v, k) for k, v in node.items()}
            return ({k: p[0] for k, p in pairs.items()},
                    {k: p[1] for k, p in pairs.items()})
        if _is_kernel(name, node):
            return _quant_kernel(node)
        return node, None

    return _q(params)


def dequantize_params(qparams: dict, scales: dict) -> dict:
    """Inverse of :func:`quantize_params`, bitwise equal to
    :func:`sim_quantize_params` on the same input."""

    def _deq(q, s):
        if isinstance(q, dict):
            return {k: _deq(q[k], s[k]) for k in q}
        return q if s is None else _dequant_kernel(q, s)

    return _deq(qparams, scales)


def sim_quantize_params(params: dict) -> dict:
    """The oracle: quantize→dequantize every eligible kernel, f32 storage."""

    def _sim(node, name=None):
        if isinstance(node, dict):
            return {k: _sim(v, k) for k, v in node.items()}
        return _dequant_kernel(*_quant_kernel(node)) if _is_kernel(name, node) else node

    return _sim(params)


def quantized_param_bytes(qparams: dict, scales: dict) -> int:
    """Stored bytes of the real int8 tree (int8 kernels + f32 scales +
    untouched f32 leaves)."""

    def _bytes(q, s):
        if isinstance(q, dict):
            return sum(_bytes(q[k], s[k]) for k in q)
        total = q.numel() * q.element_size()
        if s is not None:
            total += s.numel() * s.element_size()
        return total

    return _bytes(qparams, scales)
