"""Context (sequence) parallelism: ring attention, Ulysses all-to-all and
the ``ContextParallel`` engine (the port of ``tpudml/parallel/cp.py``).

The time axis of every sequence is split over the ranks of a ``seq``
process group; each rank holds its shard's activations, and only K/V
blocks (ring) or head groups (Ulysses) cross ranks.

- **Ring attention** (:func:`ring_attention`): each rank keeps its Q
  shard and passes K/V blocks around the ring (``comm.stage_exchange``,
  one message a tick to rank + 1), folding each arriving block into a
  log-sum-exp merge of normalized partials (:func:`_merge_blocks`, f32).
  On CUDA tensors a block folds through the flash forward kernel with
  its row lse (``ops.flash_forward_lse``, kernel 1); on CPU tensors
  through the plain block math (:func:`_block_fwd_math`). The backward
  is hand-made (a ``torch.autograd.Function``, JAX's custom VJP): with
  the merged lse and Δ = rowsum(dO ⊙ O), each block's gradients are an
  independent flash backward (``ops.flash_block_grads``, kernels 2 and
  3; or :func:`_block_bwd_math`); dq sums locally while dk and dv travel
  with their block and take one more hop home. Every rank posts its
  sends and receives in the same order, tick by tick.
- **Causal layouts.** Contiguous (rank i holds tokens [i·Tl, (i+1)·Tl))
  skips the fully masked blocks (source rank > i) in both directions;
  the shift still runs every tick. Striped (rank i holds tokens
  {t : t mod W == i}, :func:`_stripe_time`) makes every block a
  triangle: masked at the diagonal from ranks <= i, strictly below it
  (``k_shift = 1``) from ranks > i (:func:`_fold_of`).
- **Ulysses** (:func:`ulysses_attention`): ``comm.all_to_all`` moves the
  shards from sequence to heads, the plain ``dot_product_attention`` runs
  on whole sequences of H/W heads (no kernel, as in JAX), and a second
  all_to_all moves them back.

:func:`ring_attention_in_one_process` runs W ranks' ticks in one process
(each rank's K/V block taken by index): the card's check of the real
multi-block folds, which a one-card group (W = 1) never makes.

JAX runs the step as one SPMD program under ``shard_map``; the port runs
one process a rank, and the step eagerly (``ContextParallel``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpudml_torch.capabilities import reject
from tpudml_torch.comm.collectives import all_gather_tree, all_to_all, pmean_tree, stage_exchange
from tpudml_torch.core.dist import backend_for
from tpudml_torch.nn.attention import NEG_INF, MultiHeadAttention, dot_product_attention
from tpudml_torch.optim import Optimizer
from tpudml_torch.parallel.ep import mesh_groups
from tpudml_torch.parallel.sharding import make_counting_eval_step
from tpudml_torch.train import (
    TrainState, evaluate_counts, local_grads, make_lm_fused_loss_fn, make_loss_fn, params_of,
    to_device,
)

LAYOUTS = ("contiguous", "striped")


# ------------------------------------------------------- the block math


def _scale(q) -> torch.Tensor:
    """1/√D as JAX computes it: an f32 square root, then the f32 quotient."""
    return 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32, device=q.device))


def _block_scores(q, kb, diag: bool, k_shift: int = 0) -> torch.Tensor:
    """The scaled, masked score tile [B, H, Tq, Tk] f32 that the forward
    and the backward both recompute through: ``diag`` masks the aligned
    causal diagonal with the key positions shifted by ``k_shift``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float()) * _scale(q)
    if diag:
        pos = torch.arange(q.shape[1], device=q.device)
        mask = pos[:, None] >= pos[None, :] + k_shift
        s = torch.where(mask[None, None], s, NEG_INF)
    return s


def _block_fwd_math(q, kb, vb, diag: bool, k_shift: int = 0):
    """One block's normalized attention partial in plain PyTorch: (out
    [B, Tl, H, D] f32, lse [B, H, Tl] f32)."""
    s = _block_scores(q, kb, diag, k_shift)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vb.float())
    return out / den.transpose(1, 2)[..., None], m + torch.log(den)


def _block_bwd_math(q, kb, vb, do, lse, delta, diag: bool, k_shift: int = 0):
    """One block's exact gradient contributions with the global (lse, Δ):
    p = exp(s − lse), dv = pᵀ·dO, ds = p ⊙ (dO·Vᵀ − Δ), dq = scale·ds·K,
    dk = scale·dsᵀ·Q, all f32."""
    scale = _scale(q)
    p = torch.exp(_block_scores(q, kb, diag, k_shift) - lse[..., None])
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vb.float())
    ds = p * (dp - delta[..., None])
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kb.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq, dk, dv


def _merge_blocks(acc, out_b, lse_b):
    """Online log-sum-exp merge of normalized block partials:
    out = Σ_b out_b · exp(lse_b − lse_total), carried as (num, m, den)."""
    num, m, den = acc
    m_new = torch.maximum(m, lse_b)
    c_old = torch.exp(m - m_new)
    c_new = torch.exp(lse_b - m_new)
    num = num * c_old.transpose(1, 2)[..., None] + out_b * c_new.transpose(1, 2)[..., None]
    return num, m_new, den * c_old + c_new


def _init_acc(q):
    b, t, h, d = q.shape
    return (torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), -torch.inf, dtype=torch.float32, device=q.device),
            torch.zeros((b, h, t), dtype=torch.float32, device=q.device))


def _finish(acc, dtype):
    num, m, den = acc
    return (num / den.transpose(1, 2)[..., None]).to(dtype), m + torch.log(den)


def _fold_of(src: int, idx: int, causal: bool, striped: bool):
    """How rank ``idx`` folds the block of rank ``src`` at a tick past 0:
    ``(diag, k_shift)``, or None for a contiguous causal block that is
    fully masked (skipped). Tick 0 (``src == idx``) folds ``(causal, 0)``."""
    if not causal:
        return False, 0
    if striped:
        return True, int(src > idx)
    return (False, 0) if src < idx else None


def _block_fwd(q, kb, vb, diag: bool, k_shift: int, use_flash: bool):
    if use_flash:
        from tpudml_torch.ops import flash_forward_lse

        return flash_forward_lse(q, kb, vb, causal=diag, k_shift=k_shift)
    return _block_fwd_math(q, kb, vb, diag, k_shift)


def _block_bwd(q, kb, vb, do, lse, delta, diag: bool, k_shift: int, use_flash: bool):
    if use_flash:
        from tpudml_torch.ops import flash_block_grads

        return flash_block_grads(q, kb, vb, do, lse, delta, causal=diag, k_shift=k_shift)
    return _block_bwd_math(q, kb, vb, do, lse, delta, diag, k_shift)


def _delta(do, out):
    """Δ = rowsum(dO ⊙ O) [B, H, T] f32."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


# ------------------------------------------------------------- the ring


def _rotate(tensors, group):
    """Every tensor of rank i to rank i + 1 of the group, in one
    ``batch_isend_irecv`` (the same order on every rank); at world 1 the
    tensors themselves."""
    world = dist.get_world_size(group)
    if world == 1:
        return list(tensors)
    rank = dist.get_rank(group)
    nxt, prev = (rank + 1) % world, (rank - 1) % world
    return stage_exchange([(nxt, t) for t in tensors],
                          [(prev, t.shape, t.dtype, t.device) for t in tensors], group)


def _ring_fwd(q, k, v, group, causal, striped, use_flash, folds):
    world = dist.get_world_size(group)
    idx = dist.get_rank(group)
    acc = _merge_blocks(_init_acc(q), *_block_fwd(q, k, v, causal, 0, use_flash))
    n = 1
    kb, vb = k, v
    for step in range(1, world):
        kb, vb = _rotate((kb, vb), group)
        fold = _fold_of((idx - step) % world, idx, causal, striped)
        if fold is not None:
            acc = _merge_blocks(acc, *_block_fwd(q, kb, vb, *fold, use_flash))
            n += 1
    if folds is not None:
        folds.append(n)
    return _finish(acc, q.dtype)


def _ring_bwd(q, k, v, out, lse, do, group, causal, striped, use_flash, folds):
    world = dist.get_world_size(group)
    idx = dist.get_rank(group)
    delta = _delta(do, out)
    dq, dkb, dvb = (g.float() for g in _block_bwd(q, k, v, do, lse, delta, causal, 0,
                                                  use_flash))
    n = 1
    kb, vb = k, v
    for step in range(1, world):
        kb, vb, dkb, dvb = _rotate((kb, vb, dkb, dvb), group)
        fold = _fold_of((idx - step) % world, idx, causal, striped)
        if fold is not None:
            dq_i, dk_i, dv_i = _block_bwd(q, kb, vb, do, lse, delta, *fold, use_flash)
            dq, dkb, dvb = dq + dq_i.float(), dkb + dk_i.float(), dvb + dv_i.float()
            n += 1
    # The travelling accumulators sit one hop short of home.
    dk, dv = _rotate((dkb, dvb), group)
    if folds is not None:
        folds.append(n)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """Ring attention with the ring backward (JAX's ``_ring_attn`` custom
    VJP): the forward saves (q, k, v, out, lse), nothing of its ticks."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, striped, use_flash, folds):
        out, lse = _ring_fwd(q, k, v, group, causal, striped, use_flash, folds)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (group, causal, striped, use_flash, folds)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, do.contiguous(), *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None, *,
                   causal: bool = False, layout: str = "contiguous",
                   use_flash: bool | None = None, folds: list | None = None) -> torch.Tensor:
    """Ring self-attention over the sequence shards of ``group`` (None: the
    default group). q, k, v are this rank's shards [B, T/W, H, D] (with
    ``layout="striped"``, its stripe, :func:`_stripe_time`); returns its
    output shard, full attention over the whole sequence up to the f32
    sum order. Differentiable through the ring backward (module
    docstring). ``use_flash`` None runs the flash kernels for CUDA tensors
    and the plain block math for CPU tensors; True calls the flash
    wrappers whatever the device (on the CPU, their plain versions).
    ``folds``, a list, gets each direction's number of block folds on
    this rank appended."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown ring layout {layout!r}")
    if use_flash is None:
        use_flash = q.is_cuda
    return _RingAttention.apply(q, k, v, group, causal, layout == "striped", use_flash, folds)


def ring_attention_in_one_process(qs, ks, vs, dos=None, *, causal: bool = True,
                                  layout: str = "contiguous", use_flash: bool = True):
    """W ranks' ring ticks in one process: ``qs``, ``ks``, ``vs`` (and the
    output cotangents ``dos``) are the W ranks' shards, each rank's K/V
    block at tick ``step`` taken by index (rank ``(idx − step) mod W``),
    folded and merged through the same functions as :func:`ring_attention`
    (the flash kernels with ``use_flash``). Returns (outs, lses, and with
    ``dos`` dqs, dks, dvs: each rank's, dk and dv summed at their home
    rank) and the block folds made in each direction over the W ranks."""
    world = len(qs)
    striped = layout == "striped"
    outs, lses, fwd_folds = [], [], 0
    for idx in range(world):
        acc = _init_acc(qs[idx])
        for step in range(world):
            src = (idx - step) % world
            fold = (causal, 0) if step == 0 else _fold_of(src, idx, causal, striped)
            if fold is not None:
                acc = _merge_blocks(acc, *_block_fwd(qs[idx], ks[src], vs[src], *fold,
                                                     use_flash))
                fwd_folds += 1
        out, lse = _finish(acc, qs[idx].dtype)
        outs.append(out)
        lses.append(lse)
    if dos is None:
        return (outs, lses), (fwd_folds, 0)
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dks = [torch.zeros_like(d) for d in dqs]
    dvs = [torch.zeros_like(d) for d in dqs]
    bwd_folds = 0
    for idx in range(world):
        do = dos[idx].contiguous()
        delta = _delta(do, outs[idx])
        for step in range(world):
            src = (idx - step) % world
            fold = (causal, 0) if step == 0 else _fold_of(src, idx, causal, striped)
            if fold is not None:
                dq_i, dk_i, dv_i = _block_bwd(qs[idx], ks[src], vs[src], do, lses[idx], delta,
                                              *fold, use_flash)
                dqs[idx] += dq_i.float()
                dks[src] += dk_i.float()
                dvs[src] += dv_i.float()
                bwd_folds += 1
    grads = ([g.to(x.dtype) for g, x in zip(gs, xs)] for gs, xs in ((dqs, qs), (dks, ks),
                                                                      (dvs, vs)))
    return (outs, lses, *grads), (fwd_folds, bwd_folds)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None, *,
                      causal: bool = False) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) attention over the sequence shards of
    ``group``: [B, T/W, H, D] shards move to [B, T, H/W, D], the plain
    ``dot_product_attention`` runs on them, and the output moves back.
    Differentiable (the all_to_all's backward is its inverse)."""
    world = dist.get_world_size(group)
    if q.shape[2] % world:
        raise ValueError(f"ulysses needs num_heads {q.shape[2]} divisible by axis size {world}")
    qg, kg, vg = (all_to_all(a, group, split_axis=2, concat_axis=1) for a in (q, k, v))
    o = dot_product_attention(qg, kg, vg, causal=causal)
    return all_to_all(o, group, split_axis=1, concat_axis=2)


def _stripe_time(x, world: int):
    """Contiguous [B, T, ...] -> striped: shard slice i (of T/W columns)
    holds the tokens {t : t mod W == i} in order (numpy or torch)."""
    b, t = x.shape[:2]
    return x.reshape(b, t // world, world, *x.shape[2:]).swapaxes(1, 2).reshape(x.shape)


def _unstripe_time(x, world: int):
    b, t = x.shape[:2]
    return x.reshape(b, world, t // world, *x.shape[2:]).swapaxes(1, 2).reshape(x.shape)


# ---------------------------------------------------------------- engine


class ContextParallel:
    """Sequence-parallel training engine over a process group's ``seq``
    axis.

    Usage::

        model = TransformerLM(..., impl="ring", seq_sharded=True)
        cp = ContextParallel(model, opt)          # mesh {"seq": world}
        ts = cp.create_state()
        step = cp.make_train_step()               # (ts, tokens, labels) -> (ts, metrics)

    The model is built whole from the same seed on every rank, with
    ``seq_sharded=True`` and ``seq_layout`` equal to ``layout``; the
    engine binds its attention and positions to the ``seq`` group. The
    parameters stay replicated. Batches are GLOBAL [B, T] and the same on
    every rank; each rank trains on its shard of the time axis (striped
    first when ``layout="striped"``), and the gradients, the model's
    float buffers, the loss and the accuracy are averaged over the ranks
    (per-shard token means of equal shards average to the global mean).
    ``mesh`` is the axis sizes laid row-major over the job's ranks
    (default ``{axis_name: world}``); with ``batch_axis`` ("data" of a
    ``{"data": D, "seq": S}`` mesh) the batch rows shard over it too, the
    ring runs inside each data replica's seq group, and the means run
    over all ranks. ``rng_root`` seeds the dropout keys
    ``rng_root.fold_in(step).fold_in(seq index)``, as JAX folds them.
    ``fused_xent`` trains through the fused linear-xent head on each
    shard (``train.make_lm_fused_loss_fn``; ``save_scores`` its
    ``save_s``); its metrics carry the loss only. ``aux_loss_weight``: the
    MoE α (None: 0.01 for a model with MoE layers).
    """

    def __init__(self, model: nn.Module, optimizer: Optimizer, mesh: dict | None = None,
                 axis_name: str = "seq", batch_axis: str | None = None, rng_root=None,
                 aux_loss_weight: float | None = None, layout: str = "contiguous",
                 fused_xent: bool = False, save_scores: bool | None = None):
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        if save_scores and not fused_xent:
            reject("save_scores_needs_fused_xent")
        model_layout = getattr(model, "seq_layout", "contiguous")
        if model_layout != layout:
            raise ValueError(
                f"engine layout {layout!r} != model seq_layout "
                f"{model_layout!r}; build the model with seq_layout="
                f"{layout!r} so positions/masks match the token placement"
            )
        attns = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
        if not getattr(model, "seq_sharded", False) or any(
                not m.seq_sharded or m.impl not in ("ring", "ulysses") for m in attns):
            raise ValueError("ContextParallel trains a seq-sharded model: build it with "
                             "seq_sharded=True and impl='ring' or 'ulysses'")
        if not dist.is_initialized():
            raise RuntimeError(
                "ContextParallel needs a process group: call "
                "tpudml_torch.core.distributed_init (or run inside process_group) first")
        mesh = dict(mesh) if mesh is not None else {axis_name: dist.get_world_size()}
        if axis_name not in mesh:
            raise ValueError(f"axis_name {axis_name!r} not in mesh axes {tuple(mesh)}")
        if batch_axis is not None and batch_axis not in mesh:
            raise ValueError(f"batch_axis {batch_axis!r} not in mesh axes {tuple(mesh)}")
        if set(mesh) - {axis_name, batch_axis}:
            raise ValueError(f"mesh {mesh} has axes beyond the seq axis and batch_axis")
        self.device = next(model.parameters()).device
        if dist.get_backend() != backend_for(self.device):
            raise RuntimeError(f"a {self.device.type} rank needs a {backend_for(self.device)} "
                               f"group; this one is {dist.get_backend()}")
        groups = mesh_groups(mesh)
        self.layout = layout
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.axis_name = axis_name
        self.batch_axis = batch_axis
        self.rng_root = rng_root
        self.seq_group, self.seq_index, self.world = groups[axis_name]
        self.data_group, self.data_index, self.data_size = (
            groups[batch_axis] if batch_axis is not None else (None, 0, 1))
        self.group = dist.group.WORLD  # the means: over seq (and data), all ranks
        model.seq_group = self.seq_group
        for m in attns:
            m.group = self.seq_group
        self.fused_xent = fused_xent
        self._fused_loss_fn = (make_lm_fused_loss_fn(model, save_scores, aux_loss_weight)
                               if fused_xent else None)
        self._loss_fn = make_loss_fn(model, aux_loss_weight)

    def create_state(self) -> TrainState:
        """The rank's TrainState: the replicated model and a fresh
        optimizer state."""
        return TrainState.create(self.model, self.optimizer)

    def shard_batch(self, tokens, labels):
        """This rank's block of a global [B, T] batch on its device: the
        data index's rows (with ``batch_axis``) and the seq index's T/W
        columns, after striping the time axis when the layout is striped."""
        x, y = (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
                for a in (tokens, labels))
        t = x.shape[1]
        if t % self.world:
            raise ValueError(f"sequence length {t} does not divide over the "
                             f"{self.world}-way seq group")
        if self.layout == "striped":
            x, y = _stripe_time(x, self.world), _stripe_time(y, self.world)
        b = x.shape[0]
        if b % self.data_size:
            raise ValueError(f"global batch of {b} rows does not divide over the "
                             f"{self.data_size}-way data group")
        rows = slice(self.data_index * (b // self.data_size),
                     (self.data_index + 1) * (b // self.data_size))
        cols = slice(self.seq_index * (t // self.world), (self.seq_index + 1) * (t // self.world))
        return to_device(x[rows, cols], self.device), to_device(y[rows, cols], self.device)

    def make_forward(self) -> Callable:
        """tokens (a global [B, T] batch) -> the logits [B, T, V] of the
        whole batch on every rank: this rank's block through the model in
        eval mode without a graph, all-gathered over the seq group (and
        the data group), unstriped."""

        @torch.no_grad()
        def forward(tokens):
            x, _ = self.shard_batch(tokens, tokens)
            mode = self.model.training
            self.model.eval()
            try:
                logits = self.model(x)
            finally:
                self.model.train(mode)
            logits = all_gather_tree(logits.contiguous(), self.seq_group, axis=1, tiled=True)
            if self.data_group is not None:
                logits = all_gather_tree(logits, self.data_group, axis=0, tiled=True)
            if self.layout == "striped":
                logits = _unstripe_time(logits, self.world)
            return logits

        return forward

    def make_eval_step(self) -> Callable:
        """(tokens, labels) -> (correct, count), summed over all ranks."""
        return make_counting_eval_step(self.model, self.shard_batch, self.group)

    def evaluate(self, ts: TrainState, loader) -> float:
        """Token-level top-1 accuracy over ``loader``'s global batches."""
        return evaluate_counts(self.make_eval_step(), ts, loader)

    def _pmean_model_state(self) -> None:
        state = {n: b for n, b in self.model.named_buffers() if b.is_floating_point()}
        if state:
            new = pmean_tree(state, self.group)
            with torch.no_grad():
                for name, b in state.items():
                    b.copy_(new[name])

    def make_train_step(self) -> Callable:
        def step(ts: TrainState, tokens, labels):
            x, y = self.shard_batch(tokens, labels)
            rng = (None if self.rng_root is None
                   else self.rng_root.fold_in(ts.step).fold_in(self.seq_index))
            if self.fused_xent:
                grads, local = local_grads(self._fused_loss_fn, ts.model, x, y, key=rng)
            else:
                grads, local = local_grads(self._loss_fn, ts.model, x, y, with_accuracy=True,
                                           key=rng)
            grads = pmean_tree(grads, self.group)
            self._pmean_model_state()
            _, ts.opt_state = self.optimizer.update(grads, ts.opt_state, params_of(ts.model))
            ts.step += 1
            return ts, pmean_tree(local, self.group)

        return step
