"""Preallocated KV caches for incremental decode: the port of
``tpudml/serve/cache.py``.

Layout is ``[B, max_len, kv_heads, head_dim]`` per layer, B the engine's
slot count. Kinds, as in the JAX package:

- ``"f32"`` / ``"bf16"``: plain dtype storage; a read casts back to the
  compute dtype.
- ``"int8"``: per-(token, head) symmetric quantization, ``scale =
  amax(|x|)/127`` over head_dim, stored beside the codes as f32
  ``[B, max_len, kv_heads]``; a read dequantizes (``q * scale``).
- ``"bf16_sim"`` / ``"int8_sim"``: test oracles that store the
  quantize→dequantize round trip in an f32 cache.

Writes update the cache IN PLACE and return it. Out-of-range start
positions are clamped as ``lax.dynamic_update_slice`` clamps them, so the
two packages write the same rows for any position.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

KINDS = ("f32", "bf16", "int8", "bf16_sim", "int8_sim")

# Floor on the per-(token, head) scale: an all-zero row (unwritten cache
# positions) would otherwise divide 0/0 at dequant time.
_SCALE_EPS = 1e-8

_STORE_DTYPE = {
    "f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
    "bf16_sim": torch.float32, "int8_sim": torch.float32,
}


@dataclass
class KVCache:
    """One layer's cache: K/V plus (int8 only) per-(token, head) scales."""

    k: torch.Tensor  # [B, L, Hkv, Dh] storage dtype
    v: torch.Tensor
    k_scale: torch.Tensor  # [B, L, Hkv] f32; shape [0] when unused
    v_scale: torch.Tensor
    kind: str

    @property
    def max_len(self) -> int:
        return self.k.shape[1]


def init_cache(batch: int, max_len: int, kv_heads: int, head_dim: int,
               kind: str = "f32", device: str | torch.device = "cpu") -> KVCache:
    if kind not in KINDS:
        raise ValueError(f"unknown cache kind {kind!r}; one of {KINDS}")
    shape = (batch, max_len, kv_heads, head_dim)
    sshape = (batch, max_len, kv_heads) if kind == "int8" else (0,)
    return KVCache(
        k=torch.zeros(shape, dtype=_STORE_DTYPE[kind], device=device),
        v=torch.zeros(shape, dtype=_STORE_DTYPE[kind], device=device),
        k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        kind=kind,
    )


def _quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., Dh] -> (int8 codes, f32 scale [...]); round half to even."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1).clamp_min(_SCALE_EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def _encode(x: torch.Tensor, kind: str):
    """Storage-form (values, scales-or-None) of new K/V rows."""
    if kind == "int8":
        return _quant(x)
    if kind == "int8_sim":
        q, s = _quant(x)
        return _dequant(q, s), None
    if kind == "bf16":
        return x.to(torch.bfloat16), None
    if kind == "bf16_sim":
        return x.to(torch.bfloat16).to(torch.float32), None
    return x.to(torch.float32), None


def write_token(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: torch.Tensor) -> KVCache:
    """Write Q consecutive tokens per slot: k_new/v_new [B, Q, Hkv, Dh]
    from per-slot positions ``pos`` [B] (Q = 1 in a decode step, K+1 in a
    speculative verify window), in place."""
    ks, kscale = _encode(k_new, cache.kind)
    vs, vscale = _encode(v_new, cache.kind)
    q = ks.shape[1]
    rows = torch.arange(cache.k.shape[0], device=cache.k.device)
    p = pos.to(device=cache.k.device, dtype=torch.long).clamp(0, cache.max_len - q)
    if q > 1:  # a window: Q consecutive rows a slot
        rows = rows[:, None]
        p = p[:, None] + torch.arange(q, device=cache.k.device)[None, :]
    else:  # a decode step: one row a slot, with no index arithmetic
        ks, vs = ks[:, 0], vs[:, 0]
        if cache.kind == "int8":
            kscale, vscale = kscale[:, 0], vscale[:, 0]
    cache.k[rows, p] = ks
    cache.v[rows, p] = vs
    if cache.kind == "int8":
        cache.k_scale[rows, p] = kscale
        cache.v_scale[rows, p] = vscale
    return cache


def write_chunk(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                slot: int, start: int) -> KVCache:
    """Prefill write: k_new/v_new [1, C, Hkv, Dh] into one slot's rows
    [start, start+C), in place."""
    ks, kscale = _encode(k_new, cache.kind)
    vs, vscale = _encode(v_new, cache.kind)
    c = ks.shape[1]
    slot = min(max(int(slot), 0), cache.k.shape[0] - 1)
    start = min(max(int(start), 0), cache.max_len - c)
    cache.k[slot, start:start + c] = ks[0]
    cache.v[slot, start:start + c] = vs[0]
    if cache.kind == "int8":
        cache.k_scale[slot, start:start + c] = kscale[0]
        cache.v_scale[slot, start:start + c] = vscale[0]
    return cache


def read_all(cache: KVCache, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-cache read for the decode step: [B, L, Hkv, Dh] in the
    compute dtype, dequantized in the int8 case."""
    if cache.kind == "int8":
        k = _dequant(cache.k, cache.k_scale)
        v = _dequant(cache.v, cache.v_scale)
        return k.to(dtype), v.to(dtype)
    return cache.k.to(dtype), cache.v.to(dtype)


def read_slot_prefix(cache: KVCache, slot: int, length: int,
                     dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """One slot's first ``length`` rows for a prefill chunk's attention
    window: [1, length, Hkv, Dh] (a view for f32 storage)."""
    slot = min(max(int(slot), 0), cache.k.shape[0] - 1)
    k = cache.k[slot:slot + 1, :length]
    v = cache.v[slot:slot + 1, :length]
    if cache.kind == "int8":
        k = _dequant(k, cache.k_scale[slot:slot + 1, :length])
        v = _dequant(v, cache.v_scale[slot:slot + 1, :length])
    return k.to(dtype), v.to(dtype)


def cache_bytes(cache: KVCache) -> int:
    """Total storage bytes (K + V + scales)."""
    return sum(x.numel() * x.element_size()
               for x in (cache.k, cache.v, cache.k_scale, cache.v_scale))
