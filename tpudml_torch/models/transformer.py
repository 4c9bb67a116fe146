"""Decoder-only LM: the port of ``tpudml/models/transformer.py``
(single-device subset — init, the full forward with full or flash
attention and the unfused or fused add+LayerNorm trunk, bf16 compute
with f32 master weights, the pre-head features, and the KV-cached decode
and chunked prefill paths).

Parameter names follow the JAX param tree: ``tok_embed``, ``pos_embed``
(learned positions, absent with RoPE), ``block{i}.{ln1, attn.{q,k,v,out},
ln2, fc1, fc2}``, ``ln_f``, ``head``; Dense kernels are [in, out]. The
blocks are pre-LN with a GELU (tanh approximation, ``jax.nn.gelu``'s
default) MLP of ratio 4. The serving paths run exactly the full
forward's unfused math, so greedy decode is logit-exact against it; a
``fused_ln=True`` model refuses them, as the JAX package's does.

``fused_ln=True`` runs the deferred trunk: each block's closing residual
add is deferred into the NEXT norm's fused add+LayerNorm
(``tpudml_torch.ops.fused_add_layernorm``), so 2L of the 2L+1 norms —
every one but the first block's ``ln1`` — and all 2L adds run as one
kernel per direction. Same math as the unfused trunk.

``compute_dtype`` (None or ``torch.bfloat16``) is the JAX model's mixed
precision (``_cast_params``): parameters stay f32 master weights, and
every one except the LayerNorms' (``ln1``, ``ln2``, ``ln_f``) is cast to
the compute dtype where it is used — the Dense layers cast their kernel
and bias, and the embeddings gather rows of the f32 tables and cast them.
The gather-then-cast forward equals JAX's cast-then-gather; its backward
sums the table gradient in f32, where JAX's ``embed_lookup`` rounds it to
bf16 once (a defined difference, ROADMAP queue 3). LayerNorm statistics,
attention scores and softmax stay f32; the logits stay in the compute
dtype. None computes in the parameter dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudml_torch.device import resolve_device
from tpudml_torch.nn.attention import MultiHeadAttention
from tpudml_torch.nn.layers import Dense, LayerNorm, cast
from tpudml_torch.ops.layernorm_kernel import fused_add_layernorm

MLP_RATIO = 4
NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item {})"
COMPUTE_DTYPES = (None, torch.float32, torch.bfloat16)


class TransformerBlock(nn.Module):
    """Pre-LN decoder block: x + MHA(LN(x)); x + FFN(LN(x))."""

    def __init__(self, embed_dim: int, num_heads: int, *, impl: str = "full",
                 num_kv_heads: int | None = None, rope: bool = False,
                 rope_base: float = 10000.0,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        d = embed_dim
        self.ln1 = LayerNorm(d)
        self.attn = MultiHeadAttention(
            d, num_heads, causal=True, impl=impl, num_kv_heads=num_kv_heads,
            rope=rope, rope_base=rope_base, generator=generator,
            compute_dtype=compute_dtype,
        )
        self.ln2 = LayerNorm(d)
        self.fc1 = Dense(d, MLP_RATIO * d, generator=generator,
                         compute_dtype=compute_dtype)
        self.fc2 = Dense(MLP_RATIO * d, d, generator=generator,
                         compute_dtype=compute_dtype)

    def ffn(self, y: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(y), approximate="tanh"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.ffn(self.ln2(x))


class TransformerLM(nn.Module):
    """Decoder-only language model: token (+ learned position, unless
    ``rope``) embeddings, ``num_layers`` pre-LN blocks, final LayerNorm,
    vocab projection. ``impl`` is the blocks' attention ("full" or
    "flash"); ``fused_ln`` selects the deferred fused add+LN trunk;
    ``compute_dtype`` the mixed precision (module docstring).
    Parameters are drawn on the CPU from ``generator`` (default: seeded
    with 0) and moved to ``device`` (default "cuda"; asking for the card
    without one raises). ``dropout > 0`` and ``moe_experts`` are not
    ported and raise."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 num_heads: int = 4, num_layers: int = 2, max_len: int = 1024,
                 num_kv_heads: int | None = None,
                 rope: bool = False, rope_base: float = 10000.0, *,
                 impl: str = "full", fused_ln: bool = False,
                 dropout: float = 0.0, moe_experts: int = 0,
                 compute_dtype: torch.dtype | None = None,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {compute_dtype}")
        if dropout:
            raise NotImplementedError(f"dropout {NOT_PORTED.format('3 (Dropout)')}")
        if moe_experts:
            raise NotImplementedError(f"moe_experts {NOT_PORTED.format('9 (MoE)')}")
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
                rope=rope, rope_base=rope_base, generator=g,
                compute_dtype=compute_dtype,
            ))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def blocks(self) -> list[TransformerBlock]:
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> [B, T, d] in the compute dtype. Plain indexing
        of the f32 tables, then the cast: its backward sums the same rows
        as JAX's one-hot-matmul backward, in another order and in f32."""
        t = tokens.shape[1]
        h = cast(self.tok_embed[tokens], self.compute_dtype)
        if not self.rope:
            if t > self.max_len:
                raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}")
            h = h + cast(self.pos_embed[:t], self.compute_dtype)
        return h

    def _use_fused_ln(self) -> bool:
        # num_layers=0 leaves no junction to fuse.
        return self.fused_ln and self.num_layers > 0

    def _trunk(self, tokens: torch.Tensor) -> torch.Tensor:
        """embed -> blocks (unfused); no final norm or head."""
        h = self._embed(tokens)
        for block in self.blocks():
            h = block(h)
        return h

    def _trunk_deferred(self, tokens: torch.Tensor):
        """Fused-junction trunk: embed -> blocks with each residual add
        deferred into the next norm's fused add+LN. Returns ``(s, pend)``:
        the residual stream and the last block's still-unadded FFN branch,
        so the caller closes the last junction inside the final norm."""
        s = self._embed(tokens)
        pend = None
        for block in self.blocks():
            if pend is None:
                y = block.ln1(s)
            else:
                s, y = fused_add_layernorm(s, pend, block.ln1.scale, block.ln1.bias)
            s, y2 = fused_add_layernorm(s, block.attn(y), block.ln2.scale,
                                        block.ln2.bias)
            pend = block.ffn(y2)
        return s, pend

    def _features_deferred(self, tokens: torch.Tensor) -> torch.Tensor:
        """Deferred trunk closed through the final norm: the last block's
        residual add fuses into ln_f."""
        s, pend = self._trunk_deferred(tokens)
        _, y = fused_add_layernorm(s, pend, self.ln_f.scale, self.ln_f.bias)
        return y

    def apply_features(self, tokens: torch.Tensor) -> torch.Tensor:
        """Pre-head features [B, T, d]: embed -> blocks -> final LayerNorm,
        without the vocab projection."""
        if self._use_fused_ln():
            return self._features_deferred(tokens)
        return self.ln_f(self._trunk(tokens))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full forward: tokens [B, T] -> logits [B, T, V]."""
        return self.head(self.apply_features(tokens))

    # ----------------------------------------------------- serving paths

    def _serve_guard(self) -> None:
        if self.compute_dtype not in (None, torch.float32):
            raise NotImplementedError(
                f"serving with compute_dtype {NOT_PORTED.format('1 (serving levers)')}"
            )
        if self._use_fused_ln():
            # The fused junction is a training throughput fusion; the
            # serving paths run the unfused math, the parity reference.
            raise NotImplementedError(
                "serve decode runs the unfused-LN math; build the serving "
                "model with fused_ln=False"
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

    def _decode_embed(self, tokens, pos):
        """[B] tokens at per-slot positions ``pos`` [B] -> [B, 1, d]."""
        h = self.tok_embed[tokens][:, None, :]
        if not self.rope:
            h = h + self.pos_embed[pos][:, None, :]
        return h

    def _serve_blocks(self, caches, h, attend):
        """Shared block loop of both serving paths: pre-LN attention via
        ``attend(attn_module, cache, y)`` and the dense FFN."""
        new_caches = []
        for block, cache in zip(self.blocks(), caches):
            a, cache = attend(block.attn, cache, block.ln1(h))
            h = h + a
            h = h + block.ffn(block.ln2(h))
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

    def apply_prefill(self, caches, chunk, slot: int, start: int):
        """Prefill one chunk of one slot's prompt: ``chunk`` [1, C] tokens
        at global positions [start, start+C) -> caches. No logits: the
        engine feeds the prompt's last token through ``apply_decode``."""
        self._serve_guard()
        c = chunk.shape[1]
        h = self.tok_embed[chunk]
        if not self.rope:
            if start + c > self.max_len:
                raise ValueError(
                    f"prefill window {start + c} exceeds max_len {self.max_len}"
                )
            h = h + self.pos_embed[start:start + c][None]
        _, caches = self._serve_blocks(
            caches, h,
            lambda attn, cache, y: attn.apply_prefill(cache, y, slot, start))
        return caches
