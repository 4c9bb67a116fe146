"""Tensor-parallel serving: the decode and chunked-prefill steps on one
rank's shard of the model (the port of ``tpudml/serve/tp.py``).

The placement is exactly ``parallel.mp.tensor_parallel_rules``: the QKV
projections, fc1 and the head split on their output dimension, the
attention out and fc2 kernels on their input dimension, the token table
on the vocabulary; the norms, the position table and the out and fc2
biases are replicated. Each rank keeps its block of every leaf
(:meth:`TPServing.shard_params`), so it holds 1/W of the heads, the MLP
and the vocabulary: the serving form of the rules, not the gathered
weights of ``GSPMDParallel``'s training step. The KV cache holds the
rank's ``kv_heads / W`` heads, the same placement as the K/V projections
that fill it, so cache writes and reads need no collective. A decode step
pays two sums a block over the group (attention out, fc2), one for the
vocab-sharded embedding, and one tiled all-gather of the [B, V/W] logits
for the greedy argmax.

JAX runs the step as one program under ``shard_map``; the port runs one
process a rank (the ``model`` axis of ``parallel.ep.mesh_groups``), every
rank the same step on its shard, with the collectives at the same places.
The block math is the serving model's own: ``MultiHeadAttention``'s
projections with the local head counts, the cache ops, the decode
attention, and on the card the prefill window through the flash kernel
(``chunk_flash_window``) at the local heads.

Divisibility is rejected, never demoted: heads, kv heads, the vocabulary
and the MLP's hidden width must divide by W (``apply_rules`` would keep a
non-dividing leaf whole, and the local shapes would break).
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpudml_torch.comm.collectives import all_gather_tree
from tpudml_torch.core.dist import backend_for
from tpudml_torch.models.transformer import MLP_RATIO
from tpudml_torch.nn.attention import decode_attention
from tpudml_torch.nn.layers import cast
from tpudml_torch.parallel.ep import mesh_groups
from tpudml_torch.parallel.mp import apply_rules, cut_to_blocks, tensor_parallel_rules
from tpudml_torch.serve.cache import (
    init_cache, read_all, read_slot_prefix, write_chunk, write_token,
)


class TPServing:
    """The sharded decode and prefill steps of one (model, mesh, axis).

    ``mesh`` is the axis sizes laid row-major over the job's ranks
    (``{axis_name: W}``, as ``GSPMDParallel`` takes it). Build, then
    :meth:`shard_params` (a copy of ``model`` cut to this rank's blocks;
    the caller's model is left whole), :meth:`init_caches`, and serve
    through :meth:`decode_step` and :meth:`prefill`.
    """

    def __init__(self, model, mesh: dict, axis_name: str, cfg):
        if getattr(cfg, "cache_layout", "dense") != "dense" or getattr(cfg, "spec_k", 0):
            # Behind the engine's own guard: the decode step has no page
            # table or verify-window variant.
            from tpudml_torch.capabilities import reject
            from tpudml_torch.serve.engine import ServeCompositionError

            reject("serve_tp_dense_only", exc=ServeCompositionError)
        if axis_name not in mesh:
            raise ValueError(f"axis_name {axis_name!r} not in mesh axes {tuple(mesh)}")
        self.model = model
        self.mesh = dict(mesh)
        self.axis = axis_name
        self.cfg = cfg
        self.world = mesh[axis_name]
        d = model.embed_dim
        kv_heads = model.num_kv_heads or model.num_heads
        hidden = MLP_RATIO * d
        for what, n in (("num_heads", model.num_heads), ("kv_heads", kv_heads),
                        ("vocab_size", model.vocab_size), ("mlp hidden dim", hidden)):
            if n % self.world:
                raise ValueError(
                    f"TP serving requires {what} ({n}) divisible by the "
                    f"'{axis_name}' axis size ({self.world}); apply_rules "
                    f"would demote the shard and break the manual decode body"
                )
        self.h_local = model.num_heads // self.world
        self.kv_local = kv_heads // self.world
        self.v_local = model.vocab_size // self.world
        self.local = None  # the rank's shard of the model (shard_params)
        self.param_specs = None
        self.group = self.index = None

    # ------------------------------------------------------------ placement

    def shard_params(self):
        """This rank's shard: a copy of the model with every leaf that
        ``tensor_parallel_rules`` splits cut to the rank's block. Needs the
        process group (one rank a shard; NCCL for a CUDA model, gloo for
        the CPU)."""
        if not dist.is_initialized():
            raise RuntimeError(
                "tensor-parallel serving needs a process group: call "
                "tpudml_torch.core.distributed_init (or run inside process_group) first")
        device = self.model.device
        if dist.get_backend() != backend_for(device):
            raise RuntimeError(f"a {device.type} shard needs a {backend_for(device)} group; "
                               f"this one is {dist.get_backend()}")
        groups = mesh_groups(self.mesh)
        self.group, self.index, _ = groups[self.axis]
        coords = {a: groups[a][1] for a in self.mesh}
        self.param_specs = apply_rules(tensor_parallel_rules(self.axis), self.model, self.mesh)
        self.local = copy.deepcopy(self.model)
        cut_to_blocks(self.local, self.param_specs, self.mesh, coords)
        return self.local

    def init_caches(self):
        """Per-layer KV caches of the rank's ``kv_heads / W`` heads (int8
        scales sharded alike), on the model's device."""
        m = self.model
        m._serve_guard()
        return tuple(init_cache(self.cfg.slots, self.cfg.max_len, self.kv_local,
                                m.embed_dim // m.num_heads, self.cfg.cache_kind, m.device)
                     for _ in range(m.num_layers))

    # ------------------------------------------------------------ shared math

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The vocab-sharded gather: tokens outside this rank's rows are
        masked, and the one nonzero row is summed over the group. [N] ->
        [N, d] in the compute dtype."""
        m = self.local
        local = tokens - self.index * self.v_local
        ok = (local >= 0) & (local < self.v_local)
        rows = cast(m.tok_embed[local.clamp(0, self.v_local - 1)], m.compute_dtype)
        return self._psum(rows * ok[:, None].to(rows.dtype))

    def _tp_block(self, block, h, attend):
        """One pre-LN block on the rank's shards: column-parallel in, and on
        the row-parallel way out the sum over the group first, then the
        bias (JAX's ``h + psum(a @ W_out) + b_out``)."""
        a, cache = attend(block.attn, block.ln1(h))
        kernel, bias = block.attn.out.cast_params()
        h = h + self._psum(a @ kernel) + bias
        f = F.gelu(block.fc1(block.ln2(h)), approximate="tanh")
        kernel, bias = block.fc2.cast_params()
        return h + self._psum(f @ kernel) + bias, cache

    # --------------------------------------------------------------- decode

    @torch.inference_mode()
    def decode_step(self, caches, tokens: torch.Tensor, pos: torch.Tensor):
        """One greedy decode step for all slots: ``tokens`` [B] at per-slot
        positions ``pos`` [B] -> (next tokens [B] int32, logits [B, V] on
        every rank); the rank's caches update in place."""
        m = self.local
        h = self._embed(tokens)[:, None, :]
        if not m.rope:
            h = h + cast(m.pos_embed[pos], m.compute_dtype)[:, None, :]
        new = []
        for block, cache in zip(m.blocks(), caches):
            def attend(attn, y, cache=cache):
                q, k_new, v_new = attn._window_qkv(y, pos, self.h_local, self.kv_local)
                cache = write_token(cache, k_new, v_new, pos)
                k, v = read_all(cache, y.dtype)
                k, v = attn._gqa_repeat(k, v, self.h_local)
                return decode_attention(q, k, v, pos).reshape(y.shape[0], 1, -1), cache

            h, cache = self._tp_block(block, h, attend)
            new.append(cache)
        # ln_f is replicated and the head column-parallel: the stock head
        # gives this rank's [B, V/W] logits.
        shard = m.head(m.ln_f(h))[:, 0, :].contiguous()
        logits = all_gather_tree(shard, self.group, axis=1, tiled=True)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    # -------------------------------------------------------------- prefill

    @torch.inference_mode()
    def prefill(self, caches, chunk: torch.Tensor, slot: int, start: int):
        """Prefill one chunk [1, C] of one slot at global positions [start,
        start+C) into the rank's caches (on the card the window attention
        runs the flash kernel at the rank's heads); returns the caches."""
        m = self.local
        c = chunk.shape[1]
        if not m.rope and start + c > m.max_len:
            raise ValueError(f"prefill window {start + c} exceeds max_len {m.max_len}")
        h = self._embed(chunk[0])[None]  # [1, C, d]
        if not m.rope:
            h = h + cast(m.pos_embed[start:start + c], m.compute_dtype)[None]
        new = []
        for block, cache in zip(m.blocks(), caches):
            def attend(attn, y, cache=cache):
                q, k_new, v_new = attn._chunk_qkv(y, start, self.h_local, self.kv_local)
                cache = write_chunk(cache, k_new, v_new, slot, start)
                k, v = read_slot_prefix(cache, slot, start + c, y.dtype)
                return attn._prefill_window(q, k, v, start).reshape(1, c, -1), cache

            h, cache = self._tp_block(block, h, attend)
            new.append(cache)
        return tuple(new)
