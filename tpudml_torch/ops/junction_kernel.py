"""Fused attention-block junction (the port of
``tpudml/ops/junction_kernel.py``): flash attention + out-projection +
residual add + LayerNorm as one differentiable unit::

    a      = flash_attention(q, k, v)          # kernel 1 (2, 3 backward)
    h      = a.reshape(B, T, d) @ Wo + bo      # cuBLAS
    (s, y) = fused_add_layernorm(r, h, γ, β)   # kernels 8 (9 backward)

The chain runs through the port's own wrappers: on the card each launches
its kernel (and counts the launch), for CPU tensors each runs its plain
version. Differentiating the junction runs the kernels' backwards end to
end; the product between them is an ordinary matmul. Semantics are those
of the unfused block ``s = r + (attn(q,k,v) @ Wo + bo); y = LN(s)`` with
the sum rounded to the stream dtype before the f32 statistics
(:func:`reference_attn_junction`).
"""

from __future__ import annotations

import torch

from tpudml_torch.markers import marked
from tpudml_torch.ops.attention_kernel import flash_attention
from tpudml_torch.ops.layernorm_kernel import fused_add_layernorm


def _projection(a, wo, bo, r):
    """a [B, T, H, D] @ Wo + bo, in the stream dtype (one rounding of the
    f32-accumulated product, then the bias)."""
    b, t, h, dh = a.shape
    return torch.matmul(a.reshape(b, t, h * dh), wo).to(r.dtype) + bo.to(r.dtype)


# The junction runs as one region under JAX's jit name (tpudml/ops/junction_kernel.py:53).
ATTN_JUNCTION_MARKER = "_attn_junction"


@marked(ATTN_JUNCTION_MARKER)
def fused_attn_junction(q, k, v, r, wo, bo, scale, bias, *, causal: bool = True,
                        eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The attention junction as one unit (module docstring). ``q``/``k``/
    ``v`` [B, T, H, D] (post-projection heads), ``r`` [B, T, d] the
    incoming residual stream (d = H·D), ``wo`` [d, d] / ``bo`` [d] the
    out-projection ([in, out], as ``Dense`` stores it), ``scale``/``bias``
    [d] the junction norm's affine. Returns ``(s, y)``: the new residual
    stream ``s = r + proj`` and ``y = LayerNorm(s)``, the contract of
    ``fused_add_layernorm``."""
    b, t, h, dh = q.shape
    d = h * dh
    if r.shape != (b, t, d):
        raise ValueError(f"r {tuple(r.shape)} must be {(b, t, d)}")
    if wo.shape != (d, d):
        raise ValueError(f"wo {tuple(wo.shape)} must be {(d, d)}")
    a = flash_attention(q, k, v, causal=causal)
    return fused_add_layernorm(r, _projection(a, wo, bo, r), scale, bias, eps=eps)


def reference_attn_junction(q, k, v, r, wo, bo, scale, bias, *, causal: bool = True,
                            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The unfused junction in plain PyTorch (plain attention, the rounded
    residual sum, f32 LayerNorm statistics), differentiable: what the
    fused unit must reproduce."""
    from tpudml_torch.nn.attention import dot_product_attention

    a = dot_product_attention(q, k, v, causal=causal)
    s = r + _projection(a, wo, bo, r)
    sf = s.float()
    m = sf.mean(-1, keepdim=True)
    var = torch.clamp((sf * sf).mean(-1, keepdim=True) - m * m, min=0.0)
    y = (sf - m) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return s, y.to(s.dtype)
