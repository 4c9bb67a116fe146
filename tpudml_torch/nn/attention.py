"""Attention ops and the multi-head attention module: the port of
``tpudml/nn/attention.py`` (full, flash, ring and Ulysses attention, the
sequence-sharded positions and the serving paths).

Layout is [B, T, H, D] throughout, as in the JAX package. Scores and
softmax run in f32; masked entries get ``NEG_INF`` (large-finite, so a
fully masked row never computes inf − inf). The serving paths read K/V
from a ``tpudml_torch.serve.cache.KVCache`` or, paged, through a page
table from a ``tpudml_torch.serve.paged.PagedKVCache``, and update it IN
PLACE (the JAX package returns a new cache; the engine here keeps one set
of buffers).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from tpudml_torch.nn.layers import Dense
from tpudml_torch.ops.attention_kernel import (
    NEG_INF, flash_attention, flash_forward_lse,
)

IMPLS = ("full", "flash", "ring", "ulysses")
SEQ_LAYOUTS = ("contiguous", "striped")


def sharded_positions(t_local: int, seq_sharded: bool, seq_layout: str, group=None,
                      device=None) -> torch.Tensor:
    """GLOBAL token positions [t_local] of this rank's sequence shard: the
    one definition RoPE, the position table and the ring's masks derive
    from. Contiguous: ``idx·Tl + j``; striped: ``idx + W·j``; unsharded:
    ``j`` (``idx``, ``W``: this rank's index and the size of the ``seq``
    process ``group``, None for the default group)."""
    j = torch.arange(t_local, device=device)
    if not seq_sharded:
        return j
    idx, world = dist.get_rank(group), dist.get_world_size(group)
    if seq_layout == "striped":
        return idx + world * j
    return idx * t_local + j


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


def decode_attention_window(q, k, v, pos):
    """Multi-token decode attention: q [B, Q, H, D] — Q consecutive tokens
    per slot, the first at per-slot position ``pos`` [B] — over a full
    cache k/v [B, L, H, D]. The speculative verify window (Q = K+1) and
    the paged decode step land here; Q = 1 is :func:`decode_attention`.
    Query j masks ``k_pos <= pos[b] + j``: its own row, the committed
    prefix and the earlier window rows, all written before this call."""
    s = _scores(q, k)
    q_pos = pos[:, None] + torch.arange(q.shape[1], device=q.device)[None, :]
    mask = torch.arange(k.shape[1], device=q.device)[None, None, :] <= q_pos[:, :, None]
    s = torch.where(mask[:, None], s, NEG_INF)
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
    softmax), "flash" (:func:`flash_attention`, the flash kernels on the
    card), or the context-parallel "ring" and "ulysses"
    (``tpudml_torch.parallel.cp``) over the sequence shards of the process
    group ``group`` (None: the default group; ``ContextParallel`` binds
    its ``seq`` group). ``seq_sharded`` makes the RoPE positions global
    (:func:`sharded_positions`) in ``seq_layout`` "contiguous" or
    "striped" (ring only: token t on rank t mod W). ``compute_dtype`` is
    the projections' (``Dense``); scores and softmax run in f32 whatever
    it is, and RoPE rounds cos/sin to the input dtype."""

    def __init__(self, embed_dim: int, num_heads: int, *, causal: bool = False,
                 impl: str = "full", num_kv_heads: int | None = None,
                 rope: bool = False, rope_base: float = 10000.0,
                 seq_sharded: bool = False, seq_layout: str = "contiguous",
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} % num_heads {num_heads} != 0")
        if impl not in IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}")
        kv = num_kv_heads
        if kv is not None and (kv < 1 or num_heads % kv):
            raise ValueError(f"num_kv_heads {kv} must divide num_heads {num_heads}")
        if seq_layout not in SEQ_LAYOUTS:
            raise ValueError(f"unknown seq_layout {seq_layout!r}")
        if seq_layout == "striped" and impl != "ring":
            # Ulysses and full attention gather shards in rank order: under
            # striping that is a permuted sequence, whose causal mask would
            # let tokens see the future. Only the ring's folds know the
            # striped positions.
            raise ValueError(f"seq_layout='striped' requires impl='ring', got {impl!r}")
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
        self.seq_sharded = seq_sharded
        self.seq_layout = seq_layout
        self.group = None  # the seq process group of ring/ulysses and the positions
        kv_dim = self.kv_heads * self.head_dim
        dense = dict(generator=generator, compute_dtype=compute_dtype)
        self.q = Dense(embed_dim, embed_dim, **dense)
        self.k = Dense(embed_dim, kv_dim, **dense)
        self.v = Dense(embed_dim, kv_dim, **dense)
        self.out = Dense(embed_dim, embed_dim, **dense)

    def _heads(self, x, n_heads):
        b, t, _ = x.shape
        return x.reshape(b, t, n_heads, self.head_dim)

    def _project(self, x, n_heads: int | None = None, n_kv: int | None = None):
        """(q, k, v) head tensors for x [B, T, d]. ``n_heads``/``n_kv``
        override the head counts, so that the tensor-parallel serving step
        runs this code on a rank's head-aligned block of the projections
        (``tpudml_torch.serve.tp``)."""
        return (self._heads(self.q(x), n_heads or self.num_heads),
                self._heads(self.k(x), n_kv or self.kv_heads),
                self._heads(self.v(x), n_kv or self.kv_heads))

    def _gqa_repeat(self, k, v, n_heads):
        group = n_heads // k.shape[2]
        if group > 1:
            k = torch.repeat_interleave(k, group, dim=2)
            v = torch.repeat_interleave(v, group, dim=2)
        return k, v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full forward over x [B, T, d] (this rank's sequence shard when
        ``seq_sharded``) through ``impl``'s attention."""
        b, t, _ = x.shape
        q, k, v = self._project(x)
        if self.rope:
            # Before the GQA repeat, as the JAX module does.
            positions = sharded_positions(t, self.seq_sharded, self.seq_layout, self.group,
                                          x.device)
            q = rotary_embedding(q, positions, self.rope_base)
            k = rotary_embedding(k, positions, self.rope_base)
        k, v = self._gqa_repeat(k, v, self.num_heads)
        if self.impl == "flash":
            o = flash_attention(q, k, v, causal=self.causal)
        elif self.impl == "ring":
            from tpudml_torch.parallel.cp import ring_attention

            o = ring_attention(q, k, v, self.group, causal=self.causal,
                               layout=self.seq_layout)
        elif self.impl == "ulysses":
            from tpudml_torch.parallel.cp import ulysses_attention

            o = ulysses_attention(q, k, v, self.group, causal=self.causal)
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

    def _window_qkv(self, x, pos, n_heads: int | None = None, n_kv: int | None = None):
        """(q, k_new, v_new) of a window x [B, Q, d] whose first token sits
        at per-slot position ``pos`` [B] (head counts as :meth:`_project`)."""
        q, k_new, v_new = self._project(x, n_heads, n_kv)
        if self.rope:
            positions = pos[:, None] + torch.arange(x.shape[1], device=x.device)[None, :]
            q = rotary_embedding(q, positions, self.rope_base)
            k_new = rotary_embedding(k_new, positions, self.rope_base)
        return q, k_new, v_new

    def _window_out(self, q, k, v, pos):
        b, qlen = q.shape[:2]
        k, v = self._gqa_repeat(k, v, self.num_heads)
        o = decode_attention_window(q, k, v, pos)
        return self.out(o.reshape(b, qlen, self.embed_dim))

    def apply_decode_window(self, cache, x, pos):
        """Decode a window of Q consecutive tokens per slot: x [B, Q, d] at
        positions pos..pos+Q-1 (the speculative verify window). Writes all
        Q rows' K/V (in place), attends each query over the prefix and the
        earlier window rows, returns (out [B, Q, d], cache). Rows past the
        committed count are rewritten by a later window before any
        unmasked read."""
        from tpudml_torch.serve.cache import read_all, write_token

        q, k_new, v_new = self._window_qkv(x, pos)
        cache = write_token(cache, k_new, v_new, pos)
        k, v = read_all(cache, x.dtype)
        return self._window_out(q, k, v, pos), cache

    def apply_decode_paged(self, pool, table, x, pos):
        """Decode step over a paged pool: x [B, Q, d] (Q = 1 plain decode,
        K+1 spec verify), ``table`` [B, max_pages] each slot's page map,
        ``pos`` [B]. Same math as :meth:`apply_decode_window`: the gathered
        table window holds the same values at the same flat positions.
        Returns (out [B, Q, d], pool)."""
        from tpudml_torch.serve.paged import read_table, write_tokens

        q, k_new, v_new = self._window_qkv(x, pos)
        pool = write_tokens(pool, k_new, v_new, table, pos)
        k, v = read_table(pool, table, x.dtype)
        return self._window_out(q, k, v, pos), pool

    def _chunk_qkv(self, x, start: int, n_heads: int | None = None,
                   n_kv: int | None = None):
        """(q, k_new, v_new) of a prefill chunk x [1, C, d] at global
        positions [start, start+C) (head counts as :meth:`_project`)."""
        q, k_new, v_new = self._project(x, n_heads, n_kv)
        if self.rope:
            positions = start + torch.arange(x.shape[1], device=x.device)
            q = rotary_embedding(q, positions, self.rope_base)
            k_new = rotary_embedding(k_new, positions, self.rope_base)
        return q, k_new, v_new

    def _prefill_window(self, q, k, v, start: int):
        """A prefill chunk's window attention, q [1, C, H, D] over the
        window's K/V (GQA-repeated to q's H heads): on the card the flash
        kernel (:func:`chunk_flash_window`), on the CPU the plain masked
        attention — chosen by the tensor's device, never by a failure.
        Returns o [1, C, H, D] (before the out projection)."""
        k, v = self._gqa_repeat(k, v, q.shape[2])
        if q.is_cuda:
            return chunk_flash_window(q, k, v, start)
        return dot_product_attention(q, k, v, causal=True, q_offset=start)

    def _prefill_attend(self, q, k, v, start: int):
        """:meth:`_prefill_window` through the out projection."""
        o = self._prefill_window(q, k, v, start)
        return self.out(o.reshape(1, q.shape[1], self.embed_dim))

    def apply_prefill_paged(self, pool, table_row, x, start: int):
        """Prefill one chunk of the slot owning ``table_row`` [max_pages]:
        x [1, C, d] at global positions [start, start+C). Mirrors
        :meth:`apply_prefill` over the paged pool, the window attention
        through the flash kernel on the card."""
        from tpudml_torch.serve.paged import read_row_prefix, write_chunk

        c = x.shape[1]
        q, k_new, v_new = self._chunk_qkv(x, start)
        pool = write_chunk(pool, k_new, v_new, table_row, start)
        k, v = read_row_prefix(pool, table_row, start + c, x.dtype)
        return self._prefill_attend(q, k, v, start), pool

    def apply_prefill(self, cache, x, slot: int, start: int):
        """Prefill one chunk of one slot: x [1, C, d] at global positions
        [start, start+C). Writes their K/V (in place), attends the chunk
        over the slot's [0, start+C) window, returns (out [1, C, d],
        cache). On the card the window attention runs the flash kernel
        (:func:`chunk_flash_window`); on the CPU the plain masked
        attention — chosen by the tensor's device, never by a failure."""
        from tpudml_torch.serve.cache import read_slot_prefix, write_chunk

        c = x.shape[1]
        q, k_new, v_new = self._chunk_qkv(x, start)
        cache = write_chunk(cache, k_new, v_new, slot, start)
        k, v = read_slot_prefix(cache, slot, start + c, x.dtype)
        return self._prefill_attend(q, k, v, start), cache
