"""Decoder-only LM: the port of ``tpudml/models/transformer.py``
(single-device subset, plus the expert-parallel MoE blocks of
``moe_axis`` and the sequence-sharded trunk of context parallelism —
init, the full forward with full, flash, ring or Ulysses
attention and the unfused or fused add+LayerNorm trunk, dense or MoE FFN
branches, bf16 compute with f32 master weights, the pre-head features,
and the KV-cached serving paths: decode, the speculative verify window
and chunked prefill, over the dense cache or a paged pool).

Parameter names follow the JAX param tree: ``tok_embed``, ``pos_embed``
(learned positions, absent with RoPE), ``block{i}.{ln1, attn.{q,k,v,out},
ln2, fc1, fc2}`` (with ``moe_experts``: ``block{i}.moe.{router.kernel,
experts.{w1, b1, w2, b2}}`` in place of fc1, fc2), ``ln_f``, ``head``;
Dense kernels are [in, out]. The blocks are pre-LN with a GELU (tanh
approximation, ``jax.nn.gelu``'s default) MLP of ratio 4, or the MoE layer
of ``tpudml_torch.nn.moe`` (relu experts of the same ratio). The serving
paths run exactly the full forward's unfused math, so greedy decode is
logit-exact against it; a ``fused_ln=True`` or MoE model refuses them, as
the JAX package's does.

A MoE model records the sum of its layers' Switch load-balancing terms
of the last forward in ``aux_loss`` (differentiable to the routers; None
for a dense model); ``tpudml_torch.train`` adds it to the objective.

``fused_ln=True`` runs the deferred trunk: each block's closing residual
add is deferred into the NEXT norm's fused add+LayerNorm
(``tpudml_torch.ops.fused_add_layernorm``), so 2L of the 2L+1 norms —
every one but the first block's ``ln1`` — and all 2L adds run as one
kernel per direction. Same math as the unfused trunk.

``dropout > 0`` drops each block's attention and FFN branches in training
mode (``self.training``), before their residual adds, as JAX's
``TransformerBlock._drop`` does: block ``i`` draws from ``key.fold_in(i)``
folded with salt 1 (attention) or 2 (FFN), through
``tpudml_torch.nn.layers.dropout``. In the fused trunk the dropped branch
is the residual input of the next ``fused_add_layernorm``. Training with
dropout and no key raises, as in JAX.

``compute_dtype`` (None or ``torch.bfloat16``) is the JAX model's mixed
precision (``_cast_params``): parameters stay f32 master weights, and
every one except the LayerNorms' (``ln1``, ``ln2``, ``ln_f``) and the MoE
routers' is cast to the compute dtype where it is used — the Dense layers cast their kernel
and bias, and the embeddings gather rows of the f32 tables and cast them.
The gather-then-cast forward equals JAX's cast-then-gather; its backward
sums the table gradient in f32, where JAX's ``embed_lookup`` rounds it to
bf16 once (a defined difference, ROADMAP queue 3). LayerNorm statistics,
attention scores and softmax stay f32; the logits stay in the compute
dtype. None computes in the parameter dtype. The serving paths compute
the same way (bf16 embeddings, blocks and head; f32 LayerNorm parameters
returning their input's dtype, so the decode features are bf16), and
their KV caches store the cache kind's dtype whatever the compute dtype.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpudml_torch.core.prng import Key
from tpudml_torch.device import resolve_device
from tpudml_torch.nn.attention import MultiHeadAttention, sharded_positions
from tpudml_torch.nn.layers import Dense, LayerNorm, cast, dropout
from tpudml_torch.nn.moe import MoELayer
from tpudml_torch.ops.layernorm_kernel import fused_add_layernorm

MLP_RATIO = 4
COMPUTE_DTYPES = (None, torch.float32, torch.bfloat16)


class TransformerBlock(nn.Module):
    """Pre-LN decoder block: x + MHA(LN(x)); x + FFN(LN(x)), the FFN dense
    or, with ``moe_experts``, a ``MoELayer``; ``seq_sharded`` and
    ``seq_layout`` are the attention's (``MultiHeadAttention``)."""

    def __init__(self, embed_dim: int, num_heads: int, *, impl: str = "full",
                 num_kv_heads: int | None = None, rope: bool = False,
                 rope_base: float = 10000.0, moe_experts: int = 0,
                 moe_axis: str | None = None, moe_capacity_factor: float = 2.0,
                 moe_top_k: int = 1, moe_dispatch: str = "gather",
                 moe_ragged_dw: str = "grouped", dropout: float = 0.0,
                 fused_ln: bool = False, seq_sharded: bool = False,
                 seq_layout: str = "contiguous", generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        d = embed_dim
        self.dropout = dropout
        self.fused_ln = fused_ln
        self.ln1 = LayerNorm(d)
        self.attn = MultiHeadAttention(
            d, num_heads, causal=True, impl=impl, num_kv_heads=num_kv_heads,
            rope=rope, rope_base=rope_base, seq_sharded=seq_sharded,
            seq_layout=seq_layout, generator=generator, compute_dtype=compute_dtype,
        )
        self.ln2 = LayerNorm(d)
        self.moe = None
        if moe_experts:
            self.moe = MoELayer(d, moe_experts, MLP_RATIO, moe_capacity_factor,
                                moe_top_k, moe_axis, dispatch=moe_dispatch,
                                ragged_dw=moe_ragged_dw, compute_dtype=compute_dtype,
                                generator=generator)
        else:
            self.fc1 = Dense(d, MLP_RATIO * d, generator=generator,
                             compute_dtype=compute_dtype)
            self.fc2 = Dense(MLP_RATIO * d, d, generator=generator,
                             compute_dtype=compute_dtype)

    def ffn(self, y: torch.Tensor):
        """The post-norm FFN branch (JAX's ``_ffn_branch``): (h, the MoE
        layer's aux term, or None for the dense MLP)."""
        if self.moe is not None:
            return self.moe(y)
        return self.fc2(F.gelu(self.fc1(y), approximate="tanh")), None

    def drop(self, h: torch.Tensor, key: Key | None, salt: int) -> torch.Tensor:
        """A branch's inverted dropout in training mode (JAX's ``_drop``):
        ``key.fold_in(salt)`` keeps the attention and FFN masks apart."""
        if not self.training or self.dropout == 0.0:
            return h
        if key is None:
            raise ValueError("TransformerBlock dropout requires an rng in train mode")
        return dropout(h, self.dropout, key.fold_in(salt), True)

    def forward(self, x: torch.Tensor, key: Key | None = None):
        """(x + both branches, the FFN's aux term or None). With
        ``fused_ln`` the ln2 junction (x + attention branch, then ln2) runs
        as one fused add+LN: the pipeline-stage form of the LM's deferred
        trunk, whose closing residual add stays a plain add so that the
        block maps x to one tensor (JAX's ``TransformerBlock(fused_ln=True)``)."""
        if self.fused_ln:
            s, y2 = fused_add_layernorm(x, self.drop(self.attn(self.ln1(x)), key, 1),
                                        self.ln2.scale, self.ln2.bias)
            h, aux = self.ffn(y2)
            return s + self.drop(h, key, 2), aux
        x = x + self.drop(self.attn(self.ln1(x)), key, 1)
        h, aux = self.ffn(self.ln2(x))
        return x + self.drop(h, key, 2), aux


def embed_tokens(tok_embed: torch.Tensor, pos_embed: torch.Tensor | None,
                 tokens: torch.Tensor, max_len: int,
                 compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """tokens [B, T] -> [B, T, d] in the compute dtype: plain indexing of
    the f32 token table, then the cast, plus the learned positions
    ``pos_embed[:T]`` unless it is None (RoPE). Its backward sums the same
    rows as JAX's one-hot-matmul backward, in another order and in f32.
    The embedding of both ``TransformerLM`` and ``TransformerEmbed``."""
    h = cast(tok_embed[tokens], compute_dtype)
    if pos_embed is not None:
        t = tokens.shape[1]
        if t > max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {max_len}")
        h = h + cast(pos_embed[:t], compute_dtype)
    return h


def final_norm(ln_f: LayerNorm, x: torch.Tensor, fused_ln: bool) -> torch.Tensor:
    """``ln_f(x)``; with ``fused_ln`` through the fused add+LN kernel on
    ``(x, 0)``, the kernel that closes the fused trunk's last residual add
    inside ``ln_f`` (``TransformerLM``): adding 0 leaves every element as
    it is, so a pipeline whose blocks close their own adds normalizes its
    output as the LM does, bit for bit."""
    if not fused_ln:
        return ln_f(x)
    return fused_add_layernorm(x, torch.zeros_like(x), ln_f.scale, ln_f.bias)[1]


class TransformerEmbed(nn.Module):
    """Token (+ learned position) embedding: the pipeline's prologue (JAX's
    ``TransformerEmbed``, parameters ``tok_embed`` and, unless
    ``use_pos_embed=False`` for RoPE, ``pos_embed``), drawn as
    ``TransformerLM`` draws its embedding (tokens, then positions, 0.02 ×
    a standard normal) and computed by the same :func:`embed_tokens`.
    Sequences past ``max_len`` raise when there is a position table."""

    def __init__(self, vocab_size: int, embed_dim: int, max_len: int = 1024, *,
                 use_pos_embed: bool = True, compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.tok_embed = nn.Parameter(0.02 * torch.randn((vocab_size, embed_dim), generator=g))
        self.pos_embed = (nn.Parameter(0.02 * torch.randn((max_len, embed_dim), generator=g))
                          if use_pos_embed else None)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_tokens(self.tok_embed, self.pos_embed, tokens, self.max_len,
                            self.compute_dtype)


class TransformerHead(nn.Module):
    """Final LayerNorm then the vocab projection: the pipeline's epilogue
    (JAX's ``TransformerHead``: ``ln_f``, ``head``). ``fused_ln`` runs
    ``ln_f`` through the fused add+LN kernel (:func:`final_norm`), so that
    a pipeline of ``fused_ln`` blocks computes what the ``fused_ln``
    ``TransformerLM`` computes."""

    def __init__(self, embed_dim: int, vocab_size: int, *, fused_ln: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.fused_ln = fused_ln
        self.ln_f = LayerNorm(embed_dim)
        self.head = Dense(embed_dim, vocab_size, generator=g, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(final_norm(self.ln_f, x, self.fused_ln))


class TransformerLM(nn.Module):
    """Decoder-only language model: token (+ learned position, unless
    ``rope``) embeddings, ``num_layers`` pre-LN blocks, final LayerNorm,
    vocab projection. ``impl`` is the blocks' attention ("full", "flash",
    or with ``seq_sharded`` "ring" or "ulysses"); ``fused_ln`` selects the deferred fused add+LN trunk;
    ``compute_dtype`` the mixed precision (module docstring);
    ``moe_experts > 0`` swaps each block's FFN for a ``MoELayer`` with the
    ``moe_*`` settings (capacity factor, top-k, dispatch, ragged dW;
    ``moe_axis`` names the expert-parallel axis of the layers, which an
    ``ExpertParallel`` engine binds to its group; the parameters are drawn
    as without it).
    ``dropout`` is the rate of the blocks' branch dropout (module
    docstring). ``seq_sharded=True`` (with ``impl`` "ring" or "ulysses")
    makes the model run on one rank's shard of the time axis, under
    ``ContextParallel``, which binds the ``seq`` process group
    (``seq_group`` here, ``group`` of each attention): the position table
    and RoPE read global positions in ``seq_layout`` "contiguous" or
    "striped" (``nn.attention.sharded_positions``), and the serving paths
    refuse the model. Parameters are drawn on the CPU from ``generator``
    (default: seeded with 0) and moved to ``device`` (default "cuda";
    asking for the card without one raises)."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 num_heads: int = 4, num_layers: int = 2, max_len: int = 1024,
                 num_kv_heads: int | None = None,
                 rope: bool = False, rope_base: float = 10000.0, *,
                 impl: str = "full", fused_ln: bool = False,
                 dropout: float = 0.0, moe_experts: int = 0,
                 moe_axis: str | None = None, moe_capacity_factor: float = 2.0,
                 moe_top_k: int = 1, moe_dispatch: str = "gather",
                 moe_ragged_dw: str = "grouped", seq_sharded: bool = False,
                 seq_layout: str = "contiguous",
                 compute_dtype: torch.dtype | None = None,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {compute_dtype}")
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.max_len = max_len
        self.num_kv_heads = num_kv_heads
        self.rope = rope
        self.impl = impl
        self.fused_ln = fused_ln
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.moe_experts = moe_experts
        self.seq_sharded = seq_sharded
        self.seq_layout = seq_layout
        self.seq_group = None  # the seq process group of the global positions
        self.aux_loss = None  # the last forward's summed MoE aux terms
        self.tok_embed = nn.Parameter(
            0.02 * torch.randn((vocab_size, embed_dim), generator=g))
        self.pos_embed = (
            None if rope else
            nn.Parameter(0.02 * torch.randn((max_len, embed_dim), generator=g))
        )
        self.ln_f = LayerNorm(embed_dim)
        self.head = Dense(embed_dim, vocab_size, generator=g,
                          compute_dtype=compute_dtype)
        for i in range(num_layers):
            self.add_module(f"block{i}", TransformerBlock(
                embed_dim, num_heads, impl=impl, num_kv_heads=num_kv_heads,
                rope=rope, rope_base=rope_base, moe_experts=moe_experts,
                moe_axis=moe_axis, moe_capacity_factor=moe_capacity_factor,
                moe_top_k=moe_top_k,
                moe_dispatch=moe_dispatch, moe_ragged_dw=moe_ragged_dw,
                dropout=dropout, seq_sharded=seq_sharded, seq_layout=seq_layout,
                generator=g, compute_dtype=compute_dtype,
            ))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def blocks(self) -> list[TransformerBlock]:
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> [B, T, d] in the compute dtype
        (:func:`embed_tokens`); seq-sharded, the position table's rows at
        the shard's global positions, the length checked is the whole
        sequence's (W·T)."""
        if not self.seq_sharded:
            return embed_tokens(self.tok_embed, self.pos_embed, tokens, self.max_len,
                                self.compute_dtype)
        t = tokens.shape[1]
        h = cast(self.tok_embed[tokens], self.compute_dtype)
        if self.pos_embed is not None:
            t_global = dist.get_world_size(self.seq_group) * t
            if t_global > self.max_len:
                raise ValueError(f"sequence length {t_global} exceeds max_len {self.max_len}")
            positions = sharded_positions(t, True, self.seq_layout, self.seq_group,
                                          tokens.device)
            h = h + cast(self.pos_embed[positions], self.compute_dtype)
        return h

    def _use_fused_ln(self) -> bool:
        # num_layers=0 leaves no junction to fuse.
        return self.fused_ln and self.num_layers > 0

    def _trunk(self, tokens: torch.Tensor, key: Key | None):
        """embed -> blocks (unfused); no final norm or head. Block ``i``
        draws its dropout from ``key.fold_in(i)``. Returns (h, the blocks'
        aux terms)."""
        h = self._embed(tokens)
        aux = []
        for i, block in enumerate(self.blocks()):
            h, a = block(h, None if key is None else key.fold_in(i))
            aux.append(a)
        return h, aux

    def _trunk_deferred(self, tokens: torch.Tensor, key: Key | None):
        """Fused-junction trunk: embed -> blocks with each residual add
        deferred into the next norm's fused add+LN, whose residual input is
        the (dropped) branch. Returns ``(s, pend, aux)``: the residual
        stream, the last block's still-unadded FFN branch (so the caller
        closes the last junction inside the final norm) and the blocks' aux
        terms."""
        s = self._embed(tokens)
        pend = None
        aux = []
        for i, block in enumerate(self.blocks()):
            brng = None if key is None else key.fold_in(i)
            if pend is None:
                y = block.ln1(s)
            else:
                s, y = fused_add_layernorm(s, pend, block.ln1.scale, block.ln1.bias)
            s, y2 = fused_add_layernorm(s, block.drop(block.attn(y), brng, 1),
                                        block.ln2.scale, block.ln2.bias)
            h, a = block.ffn(y2)
            pend = block.drop(h, brng, 2)
            aux.append(a)
        return s, pend, aux

    def apply_features(self, tokens: torch.Tensor, key: Key | None = None) -> torch.Tensor:
        """Pre-head features [B, T, d]: embed -> blocks -> final LayerNorm,
        without the vocab projection; ``key`` seeds the dropout in
        training mode. Records ``aux_loss`` (module docstring)."""
        if self._use_fused_ln():
            # The last block's residual add fuses into ln_f.
            s, pend, aux = self._trunk_deferred(tokens, key)
            _, y = fused_add_layernorm(s, pend, self.ln_f.scale, self.ln_f.bias)
        else:
            h, aux = self._trunk(tokens, key)
            y = self.ln_f(h)
        terms = [a for a in aux if a is not None]
        self.aux_loss = torch.stack(terms).sum() if terms else None
        return y

    def forward(self, tokens: torch.Tensor, key: Key | None = None) -> torch.Tensor:
        """Full forward: tokens [B, T] -> logits [B, T, V]."""
        return self.head(self.apply_features(tokens, key))

    # ----------------------------------------------------- serving paths

    def _serve_guard(self) -> None:
        if self.moe_experts:
            raise NotImplementedError("serve decode does not compose with MoE blocks yet")
        if self._use_fused_ln():
            # The fused junction is a training throughput fusion; the
            # serving paths run the unfused math, the parity reference.
            raise NotImplementedError(
                "serve decode runs the unfused-LN math; build the serving "
                "model with fused_ln=False"
            )
        if self.seq_sharded:
            raise ValueError("serve decode requires seq_sharded=False")
        if self.impl not in ("full", "flash"):
            raise ValueError(
                f"serve decode supports impl='full'/'flash' attention "
                f"configs, not {self.impl!r} (ring/ulysses shard the "
                f"sequence axis, which a per-slot cache does not)"
            )

    def init_decode_cache(self, batch: int, max_len: int | None = None,
                          kind: str = "f32"):
        """Per-layer KV caches for ``batch`` decode slots, on the model's
        device: a tuple of ``num_layers`` ``KVCache``, each
        [batch, max_len, kv_heads, head_dim]."""
        from tpudml_torch.serve.cache import init_cache

        self._serve_guard()
        max_len = self.max_len if max_len is None else max_len
        if not self.rope and max_len > self.max_len:
            raise ValueError(
                f"cache max_len {max_len} exceeds the position table "
                f"({self.max_len}); only RoPE models extrapolate"
            )
        head_dim = self.embed_dim // self.num_heads
        kv_heads = self.num_kv_heads or self.num_heads
        return tuple(
            init_cache(batch, max_len, kv_heads, head_dim, kind, self.device)
            for _ in range(self.num_layers)
        )

    def init_paged_cache(self, num_pages: int, page_size: int, kind: str = "f32"):
        """Per-layer page pools on the model's device: a tuple of
        ``num_layers`` ``PagedKVCache``, each [num_pages, page_size,
        kv_heads, head_dim]. The slot→page table lives with the engine."""
        from tpudml_torch.serve.paged import init_pool

        self._serve_guard()
        head_dim = self.embed_dim // self.num_heads
        kv_heads = self.num_kv_heads or self.num_heads
        return tuple(
            init_pool(num_pages, page_size, kv_heads, head_dim, kind, self.device)
            for _ in range(self.num_layers)
        )

    def _decode_embed(self, tokens, pos):
        """[B] tokens at per-slot positions ``pos`` [B] -> [B, 1, d]."""
        return self._decode_embed_window(tokens[:, None], pos)

    def _decode_embed_window(self, tokens, pos):
        """[B, Q] window tokens, the first at per-slot positions ``pos``
        [B] -> [B, Q, d] in the compute dtype."""
        h = cast(self.tok_embed[tokens], self.compute_dtype)
        if not self.rope:
            positions = pos[:, None] + torch.arange(tokens.shape[1], device=pos.device)[None, :]
            h = h + cast(self.pos_embed[positions], self.compute_dtype)
        return h

    def _chunk_embed(self, chunk, start: int):
        """A prefill chunk [1, C] at global positions [start, start+C) ->
        [1, C, d] in the compute dtype."""
        c = chunk.shape[1]
        h = cast(self.tok_embed[chunk], self.compute_dtype)
        if not self.rope:
            if start + c > self.max_len:
                raise ValueError(
                    f"prefill window {start + c} exceeds max_len {self.max_len}"
                )
            h = h + cast(self.pos_embed[start:start + c], self.compute_dtype)[None]
        return h

    def _serve_blocks(self, caches, h, attend):
        """Shared block loop of both serving paths: pre-LN attention via
        ``attend(attn_module, cache, y)`` and the dense FFN."""
        new_caches = []
        for block, cache in zip(self.blocks(), caches):
            a, cache = attend(block.attn, cache, block.ln1(h))
            h = h + a
            h = h + block.ffn(block.ln2(h))[0]
            new_caches.append(cache)
        return h, tuple(new_caches)

    def apply_decode_features(self, caches, tokens, pos):
        """One incremental decode step stopping at the post-``ln_f``
        features: (features [B, d], caches). The input of the fused decode
        head, which never materializes the [B, V] logits."""
        self._serve_guard()
        h = self._decode_embed(tokens, pos)
        h, caches = self._serve_blocks(
            caches, h, lambda attn, cache, y: attn.apply_decode(cache, y, pos))
        return self.ln_f(h)[:, 0, :], caches

    def apply_decode(self, caches, tokens, pos):
        """One incremental decode step: ``tokens`` [B] at per-slot
        positions ``pos`` [B] -> (logits [B, V], caches). Each slot's K/V
        land in its cache row at ``pos``."""
        h, caches = self.apply_decode_features(caches, tokens, pos)
        return self.head(h), caches

    def apply_decode_window(self, caches, tokens, pos):
        """Decode a window of Q consecutive tokens per slot over the dense
        cache: ``tokens`` [B, Q], the first at ``pos`` [B] -> (logits
        [B, Q, V], caches). The speculative verify step: one pass scores
        all Q positions."""
        self._serve_guard()
        h = self._decode_embed_window(tokens, pos)
        h, caches = self._serve_blocks(
            caches, h, lambda attn, cache, y: attn.apply_decode_window(cache, y, pos))
        return self.head(self.ln_f(h)), caches

    def apply_decode_paged(self, caches, table, tokens, pos):
        """Decode over paged pools: ``table`` [B, max_pages] maps each slot
        to its pages, ``tokens`` [B, Q] (Q = 1 plain decode, K+1 spec
        verify), ``pos`` [B] -> (logits [B, Q, V], pools)."""
        self._serve_guard()
        h = self._decode_embed_window(tokens, pos)
        h, caches = self._serve_blocks(
            caches, h,
            lambda attn, pool, y: attn.apply_decode_paged(pool, table, y, pos))
        return self.head(self.ln_f(h)), caches

    def apply_prefill_paged(self, caches, table_row, chunk, start: int):
        """Paged prefill of one chunk: ``table_row`` [max_pages] is the
        admitted slot's page map, ``chunk`` [1, C] tokens at positions
        [start, start+C) -> pools (on the card through the flash kernel)."""
        self._serve_guard()
        _, caches = self._serve_blocks(
            caches, self._chunk_embed(chunk, start),
            lambda attn, pool, y: attn.apply_prefill_paged(pool, table_row, y, start))
        return caches

    def apply_prefill(self, caches, chunk, slot: int, start: int):
        """Prefill one chunk of one slot's prompt: ``chunk`` [1, C] tokens
        at global positions [start, start+C) -> caches. No logits: the
        engine feeds the prompt's last token through ``apply_decode``."""
        self._serve_guard()
        _, caches = self._serve_blocks(
            caches, self._chunk_embed(chunk, start),
            lambda attn, cache, y: attn.apply_prefill(cache, y, slot, start))
        return caches
