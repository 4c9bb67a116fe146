"""Attention ops and the multi-head attention module: the port of
``tpudml/nn/attention.py`` (single-device subset: full and flash
attention, the serving paths).

Layout is [B, T, H, D] throughout, as in the JAX package. Scores and
softmax run in f32; masked entries get ``NEG_INF`` (large-finite, so a
fully masked row never computes inf − inf). The serving paths read K/V
from a ``tpudml_torch.serve.cache.KVCache`` and update it IN PLACE (the
JAX package returns a new cache; the engine here keeps one set of
buffers).
"""

from __future__ import annotations

import torch
from torch import nn

from tpudml_torch.nn.layers import Dense
from tpudml_torch.ops.attention_kernel import (
    NEG_INF, flash_attention, flash_forward_lse,
)

IMPLS = ("full", "flash")
CP_NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item 8, context parallel)"


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor,
                     base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over [B, T, H, D_head]: rotate-half with
    the halves concatenated. ``positions`` are [T] (shared by the batch)
    or [B, T] (each slot at its own depth, the continuous-batching decode
    regime)."""
    d = x.shape[-1] // 2
    freqs = base ** (-torch.arange(d, dtype=torch.float32, device=x.device) / d)
    angles = positions.to(torch.float32)[..., :, None] * freqs
    cos = torch.cos(angles)[..., :, None, :].to(x.dtype)
    sin = torch.sin(angles)[..., :, None, :].to(x.dtype)
    if positions.dim() == 1:
        cos, sin = cos[None], sin[None]
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _scores(q, k):
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return s / torch.sqrt(torch.tensor(d, dtype=torch.float32))


def dot_product_attention(q, k, v, *, causal: bool = False,
                          q_offset: int = 0, k_offset: int = 0):
    """Scaled dot-product attention over [B, T, H, D]; ``q_offset`` /
    ``k_offset`` are the global positions of q[:, 0] and k[:, 0] (the
    causal mask of a prefill chunk at its offset in the window)."""
    s = _scores(q, k)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def decode_attention(q, k, v, pos):
    """Single-token decode attention: q [B, 1, H, D] over a full cache
    k/v [B, L, H, D] with per-slot current positions ``pos`` [B]; each
    slot attends its written prefix ``k_pos <= pos[b]`` only."""
    s = _scores(q, k)
    mask = torch.arange(k.shape[1], device=q.device)[None, :] <= pos[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def chunk_flash_window(q, k, v, start: int):
    """Prefill-chunk attention through the flash kernel: q [B, C, H, D] at
    global offset ``start`` (a multiple of C) over the window k/v
    [B, start+C, H, D].

    The window runs as ``start/C + 1`` equal-length block calls of
    :func:`flash_forward_lse` — every block below the chunk fully visible
    (causal=False), the diagonal block masked locally — merged with the
    online log-sum-exp rule. Same work as one causal pass over the
    window; earlier chunks are never recomputed."""
    b, c, h, d = q.shape
    n = start // c + 1
    num = torch.zeros((b, c, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, c), NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, c), dtype=torch.float32, device=q.device)
    for j in range(n):
        kb = k[:, j * c:(j + 1) * c]
        vb = v[:, j * c:(j + 1) * c]
        o_b, lse_b = flash_forward_lse(q, kb, vb, causal=(j == n - 1))
        m_new = torch.maximum(m, lse_b)
        c_old = torch.exp(m - m_new)
        c_new = torch.exp(lse_b - m_new)
        num = (num * c_old.transpose(1, 2)[..., None]
               + o_b * c_new.transpose(1, 2)[..., None])
        den = den * c_old + c_new
        m = m_new
    return (num / den.transpose(1, 2)[..., None]).to(q.dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention with separate head-aligned q/k/v/out projections
    (``Dense``, [in, out] kernels). ``num_kv_heads`` < ``num_heads`` is
    GQA/MQA: K/V project to kv_heads·head_dim and are repeated per query
    group (``repeat_interleave``, as ``jnp.repeat``) before attention, so
    the dK/dV of a GQA model sum through the repeat's autograd. ``impl``
    selects the attention of ``forward``: "full" (the plain masked
    softmax) or "flash" (:func:`flash_attention`, the flash kernels on the
    card); "ring" and "ulysses" are context-parallel and not ported.
    ``compute_dtype`` is the projections' (``Dense``); scores and softmax
    run in f32 whatever it is, and RoPE rounds cos/sin to the input dtype."""

    def __init__(self, embed_dim: int, num_heads: int, *, causal: bool = False,
                 impl: str = "full", num_kv_heads: int | None = None,
                 rope: bool = False, rope_base: float = 10000.0,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} % num_heads {num_heads} != 0")
        if impl in ("ring", "ulysses"):
            raise NotImplementedError(f"attention impl {impl!r} {CP_NOT_PORTED}")
        if impl not in IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}")
        kv = num_kv_heads
        if kv is not None and (kv < 1 or num_heads % kv):
            raise ValueError(f"num_kv_heads {kv} must divide num_heads {num_heads}")
        if rope and (embed_dim // num_heads) % 2:
            raise ValueError(
                f"rope requires an even head_dim, got {embed_dim // num_heads}"
            )
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.causal = causal
        self.impl = impl
        self.kv_heads = kv or num_heads
        self.head_dim = embed_dim // num_heads
        self.rope = rope
        self.rope_base = rope_base
        kv_dim = self.kv_heads * self.head_dim
        dense = dict(generator=generator, compute_dtype=compute_dtype)
        self.q = Dense(embed_dim, embed_dim, **dense)
        self.k = Dense(embed_dim, kv_dim, **dense)
        self.v = Dense(embed_dim, kv_dim, **dense)
        self.out = Dense(embed_dim, embed_dim, **dense)

    def _heads(self, x, n_heads):
        b, t, _ = x.shape
        return x.reshape(b, t, n_heads, self.head_dim)

    def _project(self, x):
        """(q, k, v) head tensors for x [B, T, d]."""
        return (self._heads(self.q(x), self.num_heads),
                self._heads(self.k(x), self.kv_heads),
                self._heads(self.v(x), self.kv_heads))

    def _gqa_repeat(self, k, v, n_heads):
        group = n_heads // k.shape[2]
        if group > 1:
            k = torch.repeat_interleave(k, group, dim=2)
            v = torch.repeat_interleave(v, group, dim=2)
        return k, v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full forward over x [B, T, d] through ``impl``'s attention."""
        b, t, _ = x.shape
        q, k, v = self._project(x)
        if self.rope:
            # Before the GQA repeat, as the JAX module does.
            positions = torch.arange(t, device=x.device)
            q = rotary_embedding(q, positions, self.rope_base)
            k = rotary_embedding(k, positions, self.rope_base)
        k, v = self._gqa_repeat(k, v, self.num_heads)
        if self.impl == "flash":
            o = flash_attention(q, k, v, causal=self.causal)
        else:
            o = dot_product_attention(q, k, v, causal=self.causal)
        return self.out(o.reshape(b, t, self.embed_dim))

    # ----------------------------------------------------- serving paths

    def apply_decode(self, cache, x, pos):
        """One decode step: x [B, 1, d] at per-slot positions ``pos`` [B].
        Writes this token's K/V into the cache at ``pos`` (in place), then
        attends q over each slot's written prefix. Returns (out [B, 1, d],
        cache)."""
        from tpudml_torch.serve.cache import read_all, write_token

        b = x.shape[0]
        q, k_new, v_new = self._project(x)
        if self.rope:
            q = rotary_embedding(q, pos[:, None], self.rope_base)
            k_new = rotary_embedding(k_new, pos[:, None], self.rope_base)
        cache = write_token(cache, k_new, v_new, pos)
        k, v = read_all(cache, x.dtype)
        k, v = self._gqa_repeat(k, v, self.num_heads)
        o = decode_attention(q, k, v, pos).reshape(b, 1, self.embed_dim)
        return self.out(o), cache

    def apply_prefill(self, cache, x, slot: int, start: int):
        """Prefill one chunk of one slot: x [1, C, d] at global positions
        [start, start+C). Writes their K/V (in place), attends the chunk
        over the slot's [0, start+C) window, returns (out [1, C, d],
        cache). On the card the window attention runs the flash kernel
        (:func:`chunk_flash_window`); on the CPU the plain masked
        attention — chosen by the tensor's device, never by a failure."""
        from tpudml_torch.serve.cache import read_slot_prefix, write_chunk

        c = x.shape[1]
        q, k_new, v_new = self._project(x)
        if self.rope:
            positions = start + torch.arange(c, device=x.device)
            q = rotary_embedding(q, positions, self.rope_base)
            k_new = rotary_embedding(k_new, positions, self.rope_base)
        cache = write_chunk(cache, k_new, v_new, slot, start)
        k, v = read_slot_prefix(cache, slot, start + c, x.dtype)
        k, v = self._gqa_repeat(k, v, self.num_heads)
        if q.is_cuda:
            o = chunk_flash_window(q, k, v, start)
        else:
            o = dot_product_attention(q, k, v, causal=True, q_offset=start)
        return self.out(o.reshape(1, c, self.embed_dim)), cache
