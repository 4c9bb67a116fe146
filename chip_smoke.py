"""Drive the PyTorch port (``tpudml_torch``) end to end on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero without one (it never runs on
the CPU). Phases, each printing its own line(s):

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN, so f32 means f32.
2. build: every CUDA kernel source of the port, one nvcc each, together;
   then, for each instance (head dims 32, 64, 128, 256) of the flash
   forward (kernel 1), dQ (kernel 2) and dK/dV (kernel 3), its ptxas
   registers and spills and its SASS count of bf16 tensor-core products,
   TF32 instructions and f32 FMAs. It fails unless every bf16 instance
   holds ``HMMA.16816.F32.BF16``, none holds TF32 and none spills. Then
   each instance of the LayerNorm kernels 6–9 with its registers and
   spills; it fails if a wide instance (past d = 1024) spills. Then each
   instance of the forward kernels 10 and 11 (``xent.cu``: f32 and bf16,
   with and without the score store, ragged d or not), of the saved-scores
   kernels 12 and
   13 and their range sum
   (``xent_saved.cu``) and of the lean head's kernels 14 and 15 and theirs
   (``xent_lean.cu``), f32 and bf16, with its registers, spills, stack frame
   and SASS counts; it fails if one spills or keeps a stack frame, holds
   TF32, or a bf16 twin of 10–15 holds no ``HMMA.16816.F32.BF16``; then
   the cut the built forward kernels make (rows a block, vocabulary slices,
   blocks) at FWD_PLAN_SHAPES against ``fwd_plan``, the cut the built
   saved-scores kernels make (rows or columns a block,
   reads of s, dW's row ranges, blocks) at SAVED_PLAN_SHAPES against
   ``saved_plan``, and the cut of d the built lean kernels choose (columns
   a block, blocks a cluster, score computations a tile) at d = 512 to
   8192, against ``lean_plan``. Then each instance of the grouped dW
   (kernel 16, ``grouped_dw.cu``: f32 and bf16, with and without 16-byte
   row copies) with its registers, spills, stack frame and SASS counts; it
   fails if one spills or keeps a stack frame, holds TF32, a bf16 twin
   holds no wgmma (``HGMMA.*.F32.BF16``) or ptxas serialized its wgmma;
   then its cut (chunk rows R, list slots, blocks, workspace) at
   GDW_PLAN_SHAPES against ``grouped_dw_plan``. Then the four instances of
   the decode head (kernels 4 and 5, ``decode_head.cu``: f32 and int8
   weights, 16-byte loads or one scalar load a column) with their
   registers, spills, stack frame and SASS counts; it fails if one spills,
   keeps a stack frame or holds TF32; then its cut (tiles, slices of d,
   x chunks, buffer) at HEAD_PLAN_SHAPES against ``head_plan``.
3. kernel vs plain version on the card at the main paths' shapes, with
   the tolerances stated: the flash forward (serving: B=1, T=128, H=8,
   D=64: causal, non-causal, odd T, k_shift=1; training: B=8, T=1024,
   H=4, D=128, causal), the fused decode head (B=8, d=512, V=32768, f32
   and int8 weights), the flash backward dQ and dK/dV (B=8, T=1024, H=4,
   D=128 causal; also non-causal, T=1000 and k_shift=1 through
   ``flash_block_grads``), the flash forward, dQ and dK/dV at the
   long-context path's B=2, T=16384, H=4, D=128 causal (the plain
   versions per (batch, head) slice), the fused add+LayerNorm forward and
   backward (N=8192, d=512; also N=1000 and ds=None), the bf16 twins of
   the flash and add+LN kernels at the training shapes, and the fused
   linear-xent kernels 10–13 (N=8192, d=512, V=32768, the ragged
   N=1000, V=1000 and the forward's tile and slice edges XENT_FWD_EDGES,
   with labels −1 and V; f32 and bf16; timed with TFLOP/s at 2·N·d·V, 12
   and 13 beside a yardstick that is not their function, cuBLAS's product
   alone on a dlog materialized in the operand dtype, and 11–13 in f32
   also at the long context's N=32768), the lean head's
   kernels 14 and 15 with kernel 10 that feeds them lse (the same shapes,
   and in f32 the long-context path's N=32768, BASELINE.md:46's N=131072
   and N=2097184 at d=1024, V=256, where N·d passes 2³¹ and the offsets
   need 64 bits; the last two against the plain versions in row chunks;
   timed with TFLOP/s at 4·N·d·V, at the path's shape and at the
   flagship's N=8192 in bf16 and f32),
   and the plain LayerNorm kernels 6 and 7 (N=8192 and N=1000, d=512, f32
   and bf16), and the grouped dW (kernel 16, f32 and bf16 twins) at the MoE
   path's M=8192 rows, (k, n) = (512, 2048) and (2048, 512), E = 4 and 8,
   on a real router's skewed top-1 groups, a set with empty groups and a
   collapsed one, with tail rows past Σ group_sizes, bitwise equal on a
   repeat, timed on the router's groups and on the collapsed set (its
   ratio to the router's time) beside per-expert ``torch.matmul`` and the
   one call ``torch._grouped_mm`` (bf16 output), the bf16 twin also on
   the device, and one slab of 60000 rows past the bf16 twin's 2048-row
   chunk cap; times of the kernel, the plain version and a library call
   computing the same function, beside the bound (bf16 rows against the
   bf16 tensor-core rate), and for the flash kernels their rate in TFLOP/s;
   for the kernels under ~0.13 ms (1 at serving's shape, the bf16 twins
   of 1–3, 4, 5, 6–9) also their device time and the library call's, from
   ``torch.profiler`` over 200 calls; kernels 4 and 5 also their device
   kernels a call (at most one) and their time with a cold L2 (a 256 MiB
   write between calls, CUDA events around each of 50 calls). dQ is held
   bitwise equal on a repeat call at the training, flagship and
   long-context shapes.
   Then the flash forward, dQ and dK/dV (f32 and bf16) at head dims between
   their compiled widths and at the widest, D = 48, 80, 200 and 256
   (causal T=200 and non-causal T=77), with the same tolerances, and dQ and
   dK/dV timed at D = 256 (B=8, T=1024, H=4, causal) beside SDPA's
   backward. Then the widths past the narrow instances, with the
   tolerances of the main shapes: kernels 6–9 (f32 and bf16) at d = 1536,
   2048, 4096, 8192 and 16384 with N·d = 2²⁵, each timed beside its bound
   and ``F.layer_norm``'s forward and backward, with device times, and at
   LN_CHECKS (N = 1, N below the backward's block count, ragged and
   misaligned rows, the looped instances; each backward bitwise equal on
   a repeat), kernels 10–15 at d = 12, 1032 and
   2048 (N = V = 1000, labels −1 and V; timed in f32 at N=4096, d=2048,
   V=8192, and 10, 11 at the flagship's N and V with d = 12), kernels 4
   and 5 at d = 8192 (B=8, V=32768, one launch and at most one device
   kernel a call; wrapper and device times). Then the launches
   past the old grid-y edges:
   kernels 10–13 at N=8,388,609 rows (d=8, V=128; dW in 129 row ranges)
   and the flash forward,
   dQ and dK/dV at B·H=65,537 (B=65,537, H=1, T=16, D=32), against their
   plain versions in row chunks.
4. main path 1, serving: the serving engine at full width (V=32768, d=512, H=8,
   kv_heads=2, L=6, RoPE, f32, random weights from a seeded generator;
   8 slots, max_len 1024, prefill chunks of 128; 16 requests at qps=inf,
   prompts 64-512, 64 new tokens at most), served unfused, with the fused
   f32 head, with the fused int8 head and with the int8_sim oracle.
   Launch counts are zeroed just before and read just after; every
   kernel must have launched, as often as the path requires. Streams are
   checked against a teacher-forced full forward (plain attention) and
   between the fused and unfused runs; a divergence is allowed only at a
   near-tie of the plain logits (top-2 gap < 1e-5), and is printed.
5. main path 2, training: ``TransformerLM(impl="flash", fused_ln=True,
   rope=True)`` at the repo's chip training config (V=32768, d=512, H=4,
   L=6, T=1024, B=8, f32, Adam lr 1e-3; random weights from a seeded
   generator, batches from ``synthetic_lm``) trains TRAIN_STEPS steps
   through ``make_train_step``; the same initial state trains the same
   steps with ``impl="full", fused_ln=False``, which launches no kernel.
   Launch counts are zeroed just before the kernel run and read just
   after: exactly TRAIN_STEPS × (6, 6, 6, 12, 12) for flash fwd, dQ,
   dK/dV, add+LN fwd, add+LN bwd. Step-1 gradients and every step's loss
   agree with the plain run within the stated tolerances.
   5b. the wide trunk, ``train_wide``: phase 5 on task5's ``--embed_dim
   2048 --num_heads 16 --num_layers 2`` (V=32768, T=1024, B=8, f32, head
   dim 128), the width of a GPT-3 1.3B trunk at two layers, whose add+LN
   rows take the wide instances (it fails unless d > 1024): the same
   checks and tolerances, launches exactly TRAIN_STEPS × (2, 2, 2, 4, 4).
6. main path 3, the flagship step (``bench.py`` ``bench_transformer``):
   (a) on an f32 ``impl="flash", fused_ln=True`` model, step-1 gradients
   of ``make_lm_fused_loss_fn(save_scores=True)`` (the fused head's
   kernels 11–13) against ``make_loss_fn`` (materialized logits);
   (b) ``TransformerLM(impl="flash", fused_ln=True, rope=True,
   compute_dtype=bfloat16)`` with f32 master weights trains
   FLAGSHIP_STEPS steps of AdamW lr 3e-4 through
   ``make_lm_fused_train_step(save_scores=True)`` on bench's batch
   (``synthetic_lm(8, 1024, 32768, seed=1)``), against the same initial
   state trained through the kernel-free bf16 step (``impl="full"``,
   unfused LN, materialized logits). Launch counts are zeroed just before
   the kernel run and read just after: exactly FLAGSHIP_STEPS ×
   FLAGSHIP_PER_STEP. Step-1 gradients of both bf16 runs are held against
   the f32 gradients of (a) and against each other, and the losses
   against each other, within the stated bf16 tolerances;
   (c) one evaluation loss under ``torch.no_grad()``, its own path with
   its own zeroed counts, launches kernel 10 and agrees with the
   materialized loss.
   6b. main path 3b, the flagship data-parallel at world 1: a one-rank
   NCCL group (``tpudml_torch.core.process_group`` over a file store in a
   temporary directory, destroyed at the end). The single-card flagship
   step of (b) runs twice from one seed: does it repeat itself bitwise?
   Then ``DataParallel(fused_xent=True, save_scores=True,
   flash_attn=True)`` trains FLAGSHIP_STEPS steps from the same weights
   and batch, with the launch counts zeroed just before and read just
   after: exactly FLAGSHIP_STEPS × FLAGSHIP_PER_STEP, and losses and
   parameters bitwise equal to the single-card run's where that run
   repeats itself (else within DP_GAP_MULT times the gap between the two
   single-card runs).
   Each aggregator (allreduce, allgather, reducescatter) alone on the
   flagship's gradients, by CUDA events and on the device (NCCL kernels
   against the copies), and the DP and single-card ms/step. The split
   step (``measure_comm=True``, f32, materialized logits, flash, fused
   add+LN) trains DP_SPLIT_STEPS steps of phase 5's batches with its own
   zeroed counts (DP_SPLIT_STEPS × PER_STEP): one positive comm span a
   step, losses and parameters bitwise equal to the fused DP step's
   (the same f32 math on the same batches). Then task5
   ``--parallel dp`` (DP_TASK5: 1 device, its loss falls) and
   ``tpudml_torch.comm.bench`` at world 1, every aggregator.
7. main path 4, long-context training (BASELINE.md:45): task5's own
   ``build_engine`` with ``--attn flash --seq_len 16384 --batch_size 2
   --vocab 32768 --embed_dim 512 --num_heads 4 --num_layers 6 --rope
   --lr 0.001 --fused_xent`` (f32, Adam, random weights from the task's
   seed), whose auto mode must resolve to the lean head (the padded f32
   scores would be 4 GiB). Step-1 gradients and loss through the engine's
   loss agree with the saved-scores head's (``--fused_xent_scores``) and
   with the materialized logits'. Then LONG_STEPS steps of
   task5's batches: launch counts zeroed just before and read just after
   must be exactly LONG_STEPS × LONG_PER_STEP (kernels 11–13 never); the
   same initial state trains the same batches through
   ``--fused_xent_scores``, losses within LOSS_TOL; the lean run's peak
   device memory must lie at least LEAN_MEM_GAP below the saved run's (the
   O(N) contract). No kernel-free run: full attention at T=16384 holds
   8 GiB of scores a layer.
8. the plain LayerNorm op path: ``fused_layernorm`` forward and backward
   under autograd at [8192, 512] in f32 and bf16, with its own zeroed
   launch counts (kernels 6 and 7 and their bf16 twins, once each), held
   against ``F.layer_norm``.
9. main path 5, MoE training (``bench.py --moe``, ``bench_moe``): the
   training config (V=32768, d=512, H=4, L=6, T=1024, B=8) with flash
   attention, fused add+LN, RoPE, bf16 compute over f32 master weights,
   AdamW lr 3e-4, top-1 MoE FFNs at capacity factor 1.25, weights from a
   seeded generator, bench's one batch ``synthetic_lm(8, 1024, 32768,
   seed=3)`` every step. First, at E = 4 and 8, step-1 gradients of the
   ``ragged`` dispatch with the grouped-dW backward against the stock one
   on the same weights (equal losses: the forward is the same code;
   gradients within BF16_PAIR_GRAD_RTOL). Then, with the launch counts
   zeroed just before and read just after, MOE_STEPS steps of
   ``make_train_step_body`` for each E ∈ {4, 8} × {gather, ragged_stock,
   ragged_grouped}: ms/step (eager, one card, no ``fori``), finite losses,
   and launches per run: ragged_grouped exactly 2·L = 12 of kernel 16's
   bf16 twin a step, the other two none, and every run the bf16 flash and
   add+LN kernels of the trunk.
10. main path 6, f32 MoE training through task5: ``build_engine`` with
   ``--attn flash --fused_ln --rope --moe_experts 8 --moe_dispatch
   ragged`` at the training config, Adam lr 1e-3; step-1 gradients against
   the stock dW backward (STEP_GRAD_RTOL, equal losses), then
   MOE_F32_STEPS steps with zeroed counts: 12 launches a step of kernel
   16's f32 twin.
11. main path 7, the north star (``tasks/north_star.py``, ``bench.py``
   ``bench_resnet``): ResNet-18 at CIFAR width (11.17M parameters) with
   BatchNorm, SGD 0.1 / 0.9, weights from a seeded generator. It runs no
   kernel of the port: convolutions go to cuDNN, BatchNorm is PyTorch
   ops. Launch counts are zeroed at its start and must all read 0 at its
   end. (1) One f32 3x3 conv at 512 input channels against f64 on the
   card, within TF32_CONV_REL (TF32 is off for convolutions); the same
   conv with cuDNN's TF32 allowed is printed beside it. (2) f32 at a
   batch of 16 from ``synthetic_classification``: the card's train-mode
   logits, BatchNorm statistics after the forward and step-1 gradients
   against the port's CPU run of the same weights, the CPU run replaying
   the card's ReLU masks (``relu_masks``; how many inputs round to the
   other side of 0 unreplayed is printed), within RESNET_F32_REL and
   STEP_GRAD_RTOL. (3) bf16 against f32 on the card: step-1 gradients in
   norm, per parameter and all together, and logits, within the stated
   bf16 bounds (the f32 run replaying the bf16 run's masks). (4) The
   single-card bf16 step at bench's batch of 1024 (one batch,
   ``synthetic_classification(1024, (32, 32, 3), 10, seed=0)``),
   RESNET_STEPS steps twice from one seed: whether it repeats itself
   bitwise, ms/step, imgs/s and peak memory. (5) ``DataParallel`` at
   world 1 on a one-rank NCCL group from the same weights and batch:
   losses, parameters and BatchNorm buffers bitwise equal to (4) where (4)
   repeats itself, else within DP_GAP_MULT times the gap between its two
   runs; its ms/step and imgs/s, labelled world 1. (6) ``python -m
   tpudml_torch.tasks.north_star --epochs 1`` at its defaults (synthetic
   CIFAR, 390 steps of 128): the loss falls, the test accuracy reaches
   NORTH_STAR_ACC_FLOOR, and its imgs/sec/chip line is printed. cuDNN's
   algorithm choice is left as it is (no ``cudnn.deterministic``).
12. one JSON line of per-kernel numbers (launches summed over the main
   paths, and by path), the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

TIE_GAP = 1e-5  # plain top-2 logit gap under which a pick may differ
FLASH_TOL = 1e-5  # max |err| of O and of lse, kernel vs plain (f32 sums in another order)
HEAD_TOL = 1e-4  # max |err| of max logit and lse (512-term f32 dots in another order; lse ~ 10)
# Flash dQ/dK/dV, elementwise |err| <= atol + rtol·|plain|: the JAX
# package's own tolerance for these kernels (f32 sums over up to T keys
# or rows, in another order than the plain version's matmuls).
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5
LN_ROW_TOL = 1e-5  # max |err| of s, y, mean, rstd, dx (d-term row sums in another order; rsqrtf <= 2 ulp)
LN_COL_RTOL = 1e-5  # max |err| of dγ, dβ over max |plain| (N-row sums, block order vs one reduction)
# Training: step-1 gradients, per parameter, max |err| <= STEP_GRAD_RTOL ·
# max |plain grad| (f32 sums over 8192 tokens and 1024 keys in another
# order, ten times the CPU parity tests' 1e-5); per-step losses within
# LOSS_TOL (Adam's first step moves every parameter by ±lr, so a gradient
# whose sign differs under f32 rounding puts that parameter 2·lr apart;
# 1e-3 on a loss of ~10 holds a few such flips).
STEP_GRAD_RTOL = 1e-4
LOSS_TOL = 1e-3
# bf16 twins of the flash and add+LN kernels: what they store in bf16
# (O, dQ, dK, dV; y, dx) within BF16_REL of the plain output's max |value|
# (both round to bf16, 2^-8 relative, after f32 sums in another order that
# may put a value, or a rounded p or ds feeding it, one bf16 step away);
# what stays f32 (lse, s, mean, rstd, dγ, dβ) at the f32 tolerances.
BF16_REL = 2e-2
# Fused linear-xent (#10–13): lse, picked and the saved scores |err| <=
# XENT_ROW_TOL·(1 + |plain|) (d-term f32 dots, then V-term sums, in another
# order); dX, dW, db within XENT_GRAD_REL of the plain output's max |value|
# in f32 (N- or V-term sums) and BF16_REL in bf16 (dlog and the stored
# gradient rounded to bf16 on both sides); db is f32 in both.
XENT_ROW_TOL = 1e-5
XENT_GRAD_REL = 1e-4
# The bf16 flagship (phase 6). Step-1 gradients: each bf16 run within
# BF16_STEP_GRAD_RTOL of the f32 gradient's max |value| per parameter (bf16
# keeps 8 bits; a few hundred roundings per layer compound through 6
# blocks and the backward; on the CPU at the smoke config the port's bf16
# gradients lie within 2.1e-2 of the f32 ones), and the kernel run within
# BF16_PAIR_GRAD_RTOL of the plain bf16 run (two such errors). Losses of
# the two bf16 runs within BF16_LOSS_TOL: the materialized head rounds the
# logits to bf16 (2^-8 of |logit|) where the fused head keeps f32 scores,
# and AdamW's first step moves every parameter by ±lr.
BF16_STEP_GRAD_RTOL = 3e-2
BF16_PAIR_GRAD_RTOL = 5e-2
BF16_LOSS_TOL = 2e-2
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores, H100 SXM data sheet

SERVE_MODEL = dict(vocab_size=32768, embed_dim=512, num_heads=8,
                   num_kv_heads=2, num_layers=6, max_len=1024, rope=True)
SERVE_CFG = dict(slots=8, max_len=1024, prefill_chunk=128)
WORKLOAD = dict(n_requests=16, prompt_len=(64, 512), new_tokens=(16, 64))
# The repo's chip training config (bench.py:325-326), task5 flags
# --vocab 32768 --embed_dim 512 --num_heads 4 --num_layers 6 --seq_len 1024
# --batch_size 8 --attn flash --fused_ln --rope.
TRAIN_MODEL = dict(vocab_size=32768, embed_dim=512, num_heads=4, num_layers=6,
                   max_len=1024, rope=True)
TRAIN_BATCH = 8
TRAIN_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
TRAIN_LR = 1e-3
# Launches of one training step at L=6: flash fwd, dQ, dK/dV one per layer;
# add+LN 2L junctions per direction (the first block's ln1 stays plain).
PER_STEP = {"flash_forward_lse": 6, "flash_dq": 6, "flash_dkdv": 6,
            "add_layernorm_fwd": 12, "add_layernorm_bwd": 12}
# The wide trunk (phase 5b, train_wide): task5's --embed_dim 2048
# --num_heads 16 --num_layers 2 --seq_len 1024 --batch_size 8 --attn flash
# --fused_ln --rope (head dim 128, materialized logits), the width of a
# GPT-3 1.3B trunk at the depth the time limit allows; its add+LN rows
# take the wide instances of kernels 8 and 9.
WIDE_MODEL = dict(vocab_size=32768, embed_dim=2048, num_heads=16, num_layers=2,
                  max_len=1024, rope=True)
WIDE_PER_STEP = {"flash_forward_lse": 2, "flash_dq": 2, "flash_dkdv": 2,
                 "add_layernorm_fwd": 4, "add_layernorm_bwd": 4}
# The flagship (bench.py:320-358): the training config in bf16 compute with
# f32 master weights, AdamW lr 3e-4, the fused head in saved-scores mode,
# bench's one batch synthetic_lm(8, 1024, 32768, seed=1) every step.
FLAGSHIP_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
FLAGSHIP_LR = 3e-4
FLAGSHIP_PER_STEP = {"xent_fwd_save": 1, "xent_dx_s": 1, "xent_dw_s": 1,
                     "flash_forward_lse_bf16": 6, "flash_dq_bf16": 6,
                     "flash_dkdv_bf16": 6, "add_layernorm_fwd_bf16": 12,
                     "add_layernorm_bwd_bf16": 12}
XENT_SHAPE = (8192, 512, 32768)  # N = B·T, d, V of the flagship head
# Long-context training (BASELINE.md:45), task5 flags; --fused_xent in its
# auto mode, which resolves to the lean head at N = B·T = 32768, V = 32768.
LONG_TASK5 = ["--parallel", "single", "--attn", "flash", "--seq_len", "16384",
              "--batch_size", "2", "--vocab", "32768", "--embed_dim", "512",
              "--num_heads", "4", "--num_layers", "6", "--rope", "--steps", "30",
              "--lr", "0.001", "--fused_xent"]
LONG_STEPS = 3  # the first is the warm-up; ms/step is taken over the rest
LONG_PER_STEP = {"flash_forward_lse": 6, "flash_dq": 6, "flash_dkdv": 6,
                 "xent_fwd": 1, "xent_dx_lean": 1, "xent_dw_lean": 1}
LEAN_MEM_GAP = 3 * 1024**3  # the saved run keeps 4 GiB of f32 scores more
LEAN_PATH_N = 32768  # the long-context head: B·T = 2·16384
LEAN_BIG_N = 131072  # BASELINE.md:46's batch, B=32·T=4096 (4096 row tiles of dX)
LEAN_CHUNK = 16384  # rows per call of the plain version at LEAN_BIG_N
# N·d > 2³¹ at the widest d the kernels take: the offsets of x and dX need
# 64 bits (the lean kernels never index N·V), dX has 65537 row tiles (more
# than a grid's y extent holds) and two d chunks; a narrow vocabulary keeps
# the run short.
LEAN_WIDE = (2_097_184, 1024, 256)
LEAN_WIDE_CHUNK = 262144
LONG_FLASH_SHAPE = (2, 16384, 4, 128)  # B, T, H, D of the long-context path
LN_SHAPE = (8192, 512)  # the plain LayerNorm op at the training rows
# Past the old grid-y edges: 65,537 row tiles of 128 (kernels 10–12 held
# 8,388,480 rows) and B·H = 65,537 (the flash kernels held 65,535).
XENT_EDGE = (8_388_609, 8, 128)
# Widths past the narrow instances (phase 3). LayerNorm rows past the 1024
# columns a warp holds in registers: the timed sweep LN_SWEEP at N·d =
# LN_SWEEP_ELEMS (each width checked there too), then LN_CHECKS (N, d, the
# rows' base offset in elements): N = 1, N below the backward's block
# count, ragged bf16 widths (1025, 1100, 4100), a base 4 or 2 bytes off 16,
# and widths that take the looped instances (12000 staged, 20000 shared,
# 40000 device for the backward). xent d no multiple of 8 and past the
# lean kernels' 512-column chunk (clusters of blocks), timed at
# XENT_WIDE_TIMED (N, d, V); the decode head past one 8-row group's stage.
LN_SWEEP = (1536, 2048, 4096, 8192, 16384)
LN_SWEEP_ELEMS = 1 << 25
LN_CHECKS = ((1, 4096, 0), (100, 2048, 0), (300, 1025, 0), (300, 1100, 0), (300, 4100, 0),
             (300, 8192, 0), (300, 4096, 1), (40, 12000, 0), (20, 20000, 0), (10, 40000, 0))
XENT_WIDE = (12, 1032, 2048)
# The forward's tile and slice edges (N, d, V), phase 3: one row and one
# column; a ragged bf16 x row (d = 520) past one 128-row tile and one
# 128-column f32 step; 64 row tiles and a row, d past two 512-wide chunks,
# V short of a step; one column past 32768 at d = 4096.
XENT_FWD_EDGES = ((1, 1, 1), (65, 520, 129), (8193, 1032, 127), (256, 4096, 32769))
XENT_WIDE_TIMED = (4096, 2048, 8192)
HEAD_WIDE = (8, 8192, 32768)
FLASH_D256_SHAPE = (8, 1024, 4, 256)  # B, T, H, D: the training shape at the widest D
XENT_EDGE_CHUNK = 1 << 21
FLASH_EDGE = (65_537, 16, 1, 32)  # B, T, H, D
# MoE (bench.py:586-661, bench_moe): the training config in bf16 with
# top-1 MoE FFNs at capacity factor 1.25, AdamW 3e-4, bench's one batch.
MOE_MODEL = dict(TRAIN_MODEL, impl="flash", fused_ln=True, moe_capacity_factor=1.25,
                 moe_top_k=1)
MOE_EXPERTS = (4, 8)
MOE_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
MOE_LR = 3e-4
# Launches of one bench_moe step at L=6 whatever the variant (bf16 flash,
# add+LN); ragged_grouped adds kernel 16's bf16 twin twice a layer.
MOE_PER_STEP = {"flash_forward_lse_bf16": 6, "flash_dq_bf16": 6, "flash_dkdv_bf16": 6,
                "add_layernorm_fwd_bf16": 12, "add_layernorm_bwd_bf16": 12}
# The f32 MoE path: task5 at the training config, dropless ragged dispatch.
MOE_F32_TASK5 = ["--parallel", "single", "--attn", "flash", "--fused_ln", "--rope",
                 "--moe_experts", "8", "--moe_dispatch", "ragged", "--vocab", "32768",
                 "--embed_dim", "512", "--num_heads", "4", "--num_layers", "6",
                 "--seq_len", "1024", "--batch_size", "8", "--lr", "0.001"]
MOE_F32_STEPS = 3
MOE_F32_PER_STEP = {"flash_forward_lse": 6, "flash_dq": 6, "flash_dkdv": 6,
                    "add_layernorm_fwd": 12, "add_layernorm_bwd": 12, "grouped_dw": 12}
# Kernel 16 in phase 3: the MoE step's rows and both FFN products.
GDW_M = 8192
GDW_SHAPES = ((512, 2048), (2048, 512))  # (k, n) of dW1 and dW2
GDW_TOL = 1e-5  # of max |plain|: both sum the same products in f32, in another order
GDW_LONG = (65536, 512, 2048)  # M, k, n of phase 3's long slab (past the bf16 chunk cap)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# A torch.profiler session on the H100 now and then records no device
# activity, although the calls it profiles launch kernels every time
# (F.layer_norm's bf16 backward, once in four runs of this script): such a
# session is taken again, up to PROFILE_TRIES times.
PROFILE_TRIES = 3


def device_profile(fn, calls: int = 200) -> tuple[float, float]:
    """(ms, kernels) a call: the summed device durations of what ``calls``
    back-to-back calls of ``fn`` launch, and how many device operations
    they launch, over ``calls``, from ``torch.profiler``: a kernel under
    ~0.13 ms is paced by the host through its Python wrapper, so its
    CUDA-event time moves with the host and this is its own time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(ev.time_range.elapsed_us() for ev in events)
        if us > 0:
            return us / 1e3 / calls, len(events) / calls
    check(False, f"the profiler recorded no device time in {PROFILE_TRIES} tries")


def device_ms(fn, calls: int = 200) -> float:
    """The device ms a call of ``device_profile``."""
    return device_profile(fn, calls)[0]


def one_a_call(per_call: float) -> bool:
    """Whether ``device_profile``'s operations a call show one kernel a call:
    never more than one (a second kernel or a memset a call would make it
    two), and the profiler now and then drops an event of a session (199 of
    200 and 48 of 50 seen on the H100), so a count under one passes."""
    return 0.5 < per_call <= 1.0


COLD_FLUSH_BYTES = 256 << 20  # written between calls: five times the 50 MB L2


def cold_ms(fn, calls: int = 50) -> float:
    """Mean device time of one call of ``fn`` that finds the L2 cold: a
    COLD_FLUSH_BYTES write before each call, CUDA events around the call
    alone (the write keeps the card busy while the host enqueues it)."""
    import torch

    flush = torch.empty(COLD_FLUSH_BYTES // 4, device="cuda")
    fn()
    pairs = []
    for _ in range(calls):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / calls


def timed(fn, ref, nbytes: float, flops: float, peak: float = H100_F32_FLOPS, lib=None,
          iters: int = 10) -> dict:
    """Kernel, plain and (where given) library ms of one call, and the bound."""
    ms = cuda_ms(fn, iters=iters, warmup=2)
    plain_ms = cuda_ms(ref, iters=max(iters // 2, 2), warmup=1)
    lib_ms = None if lib is None else cuda_ms(lib, iters=iters, warmup=2)
    bnd, by = bound(nbytes, flops, peak)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)


def bound(nbytes: float, flops: float, peak: float = H100_F32_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak`` (f32 by default; the
    bf16 tensor-core rate for bf16 work)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tflops(flops: float, ms: float) -> float:
    """The rate of ``flops`` operations done in ``ms`` milliseconds."""
    return flops / ms / 1e9


def rel_to_max(got, want) -> float:
    """max |got − want| / max |want|, in f32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


# ------------------------------------------------------------ phase 3


def flash_phase(gen) -> dict:
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import FLASH_FORWARD, flash_forward_lse, flash_forward_lse_reference

    b, h, d = 1, 8, 64
    worst = 0.0
    timed = None
    for t, causal, k_shift in ((128, True, 0), (128, False, 0), (77, True, 0),
                               (128, True, 1)):
        q, k, v = (torch.randn((b, t, h, d), generator=gen).cuda() for _ in range(3))
        o, lse = flash_forward_lse(q, k, v, causal=causal, k_shift=k_shift)
        ro, rlse = flash_forward_lse_reference(q, k, v, causal=causal, k_shift=k_shift)
        torch.cuda.synchronize()
        eo = (o - ro).abs().max().item()
        el = (lse - rlse).abs().max().item()
        print(f"[kernel] flash_forward_lse T={t} causal={causal} k_shift={k_shift}: "
              f"max|dO|={eo:.3e} max|dlse|={el:.3e} (tol {FLASH_TOL:g} each)")
        check(eo <= FLASH_TOL and el <= FLASH_TOL,
              f"flash kernel disagrees with its plain version (T={t}, "
              f"causal={causal}, k_shift={k_shift})")
        worst = max(worst, eo, el)
        if timed is None:  # the main path's diagonal block: T = chunk = 128, causal
            timed = (q, k, v, t)
    q, k, v, t = timed
    ms = cuda_ms(lambda: flash_forward_lse(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: flash_forward_lse_reference(q, k, v, causal=True))
    dev = device_ms(lambda: flash_forward_lse(q, k, v, causal=True))
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    lib_ms, lib_dev = cuda_ms(sdpa), device_ms(sdpa)
    pairs = t * (t + 1) // 2
    bnd, by = bound(4 * (4 * b * t * h * d + b * h * t), 4 * d * pairs * b * h)
    print(f"[kernel] flash_forward_lse B={b} T={t} H={h} D={d} causal: "
          f"kernel {ms:.4f} ms (device {dev:.5f}), plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms (device {lib_dev:.5f}), bound {bnd:.5f} ms ({by})")
    row = dict(name=FLASH_FORWARD.name, route="cuda", source=FLASH_FORWARD.source,
               replaces=FLASH_FORWARD.replaces, max_abs_err=worst, ms=ms, device_ms=dev,
               plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
               library_device_ms=lib_dev, shape=f"B={b} T={t} H={h} D={d} causal (serving)")
    row["at_train_shape"] = flash_train_shape(gen)
    return row


def flash_train_shape(gen) -> dict:
    """The flash forward at the training slice's shape (B=8, T=1024, H=4,
    D=128, causal): agreement with the plain version and times."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import flash_forward_lse, flash_forward_lse_reference

    b, t, h, d = 8, 1024, 4, 128
    q, k, v = (torch.randn((b, t, h, d), generator=gen).cuda() for _ in range(3))
    o, lse = flash_forward_lse(q, k, v, causal=True)
    ro, rlse = flash_forward_lse_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
    check(err <= FLASH_TOL, f"flash kernel disagrees with its plain version at "
          f"the training shape (max |err| {err:.3e})")
    ms = cuda_ms(lambda: flash_forward_lse(q, k, v, causal=True), iters=20)
    plain_ms = cuda_ms(lambda: flash_forward_lse_reference(q, k, v, causal=True), iters=20)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
                     iters=20)
    pairs = b * h * t * (t + 1) // 2
    bnd, by = bound(4 * (4 * b * t * h * d + b * h * t), 4 * d * pairs)
    rate = tflops(4 * d * pairs, ms)
    print(f"[kernel] flash_forward_lse B={b} T={t} H={h} D={d} causal: max|err| "
          f"{err:.3e} (tol {FLASH_TOL:g}); kernel {ms:.4f} ms ({rate:.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
    return dict(shape=f"B={b} T={t} H={h} D={d} causal (training)", max_abs_err=err,
                ms=ms, tflops=rate, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib_ms)


def _bh(x, i: int, j: int):
    """The (batch i, head j) slice of a [B, T, H, D] tensor or of a
    [B, H, T] statistic."""
    return x[i:i + 1, :, j:j + 1] if x.dim() == 4 else x[i:i + 1, j:j + 1]


def flash_long_phase(gen, fwd_row: dict, dq_row: dict, dkdv_row: dict) -> None:
    """Kernels 1–3 at the long-context path's shape (B=2, T=16384, H=4,
    D=128, causal), where they take most of its step: each kernel on the
    full shape against its plain version on every (batch, head) slice (its
    [T, T] f32 scores are 1 GiB a slice), then timed beside the plain
    version over all slices, the bound and SDPA. Adds ``at_long_context``
    to the three rows and folds the errors into their ``max_abs_err``."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        flash_dkdv, flash_dkdv_reference, flash_dq, flash_dq_reference, flash_forward_lse,
        flash_forward_lse_reference,
    )

    b, t, h, d = LONG_FLASH_SHAPE
    slices = [(i, j) for i in range(b) for j in range(h)]
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda() for _ in range(4))
    o, lse = flash_forward_lse(q, k, v, causal=True)
    ro, rlse = torch.empty_like(o), torch.empty_like(lse)
    for i, j in slices:
        so, slse = flash_forward_lse_reference(*(_bh(x, i, j) for x in (q, k, v)),
                                               causal=True)
        _bh(ro, i, j).copy_(so)
        _bh(rlse, i, j).copy_(slse)
    torch.cuda.synchronize()
    e_fwd = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
    print(f"[kernel] flash_forward_lse B={b} T={t} H={h} D={d} causal (plain per (batch, "
          f"head) slice): max|err| of O, lse {e_fwd:.3e} (tol {FLASH_TOL:g})")
    check(e_fwd <= FLASH_TOL, "flash kernel disagrees with its plain version at the "
          "long-context shape")
    del o, lse
    delta = (do * ro).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta)
    dq = flash_dq(*args, causal=True)
    check(torch.equal(dq, flash_dq(*args, causal=True)),
          "flash dQ is not bitwise repeatable at the long-context shape")
    dk, dv = flash_dkdv(*args, causal=True)
    e_dq = e_dkdv = 0.0
    for i, j in slices:
        part = [_bh(x, i, j) for x in args]
        e_dq = max(e_dq, _grad_err(_bh(dq, i, j), flash_dq_reference(*part, causal=True)))
        rdk, rdv = flash_dkdv_reference(*part, causal=True)
        e_dkdv = max(e_dkdv, _grad_err(_bh(dk, i, j), rdk), _grad_err(_bh(dv, i, j), rdv))
        del rdk, rdv
    print(f"[kernel] flash_dq / flash_dkdv B={b} T={t} H={h} D={d} causal (plain per "
          f"(batch, head) slice): max|ddq| {e_dq:.3e}, max|ddk|,|ddv| {e_dkdv:.3e} "
          f"(|err| <= {GRAD_ATOL:g} + {GRAD_RTOL:g}·|plain|); dq repeat bitwise equal")
    del dq, dk, dv
    torch.cuda.empty_cache()

    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    sdpa_f = cuda_ms(sdpa, iters=3, warmup=1)
    sdpa_b = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), iters=3,
                     warmup=1) - sdpa_f
    del qh, kh, vh, doh
    pairs = b * h * t * (t + 1) // 2
    io = b * t * h * d
    for row, fn, ref, ins, err, nbytes, flops, lib, lib_name in (
        (fwd_row, flash_forward_lse, flash_forward_lse_reference, (q, k, v), e_fwd,
         4 * (4 * io + b * h * t), 4 * d * pairs, sdpa_f, "sdpa"),
        (dq_row, flash_dq, flash_dq_reference, args, e_dq, 4 * (5 * io + 2 * b * h * t),
         6 * d * pairs, sdpa_b, "sdpa fwd+bwd minus fwd (dq, dk, dv)"),
        (dkdv_row, flash_dkdv, flash_dkdv_reference, args, e_dkdv,
         4 * (6 * io + 2 * b * h * t), 8 * d * pairs, sdpa_b,
         "sdpa fwd+bwd minus fwd (dq, dk, dv)"),
    ):
        ms = cuda_ms(lambda: fn(*ins, causal=True), iters=3, warmup=1)
        plain_ms = cuda_ms(lambda: [ref(*(_bh(x, i, j) for x in ins), causal=True)
                                    for i, j in slices], iters=2, warmup=1)
        torch.cuda.empty_cache()
        bnd, by = bound(nbytes, flops)
        rate = tflops(flops, ms)
        print(f"[kernel] {row['name']} B={b} T={t} H={h} D={d} causal: kernel {ms:.3f} ms "
              f"({rate:.1f} TFLOP/s), plain (per slice, {len(slices)} calls) {plain_ms:.3f} "
              f"ms, {lib_name} {lib:.3f} ms, bound {bnd:.5f} ms ({by})")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["at_long_context"] = dict(
            shape=f"B={b} T={t} H={h} D={d} causal (long-context training)",
            max_abs_err=err, ms=ms, tflops=rate, plain_ms=plain_ms,
            plain=f"per (batch, head) slice, {len(slices)} calls", bound_ms=bnd,
            bound_by=by, library_ms=lib, library=lib_name)
    torch.cuda.empty_cache()


def _grad_err(got, want) -> float:
    """max |got − want|, after checking |err| <= GRAD_ATOL + GRAD_RTOL·|want|
    elementwise."""
    diff = (got - want).abs()
    ok = bool((diff <= GRAD_ATOL + GRAD_RTOL * want.abs()).all())
    err = diff.max().item()
    check(ok, f"flash backward disagrees with its plain version (max |err| {err:.3e})")
    return err


def flash_bwd_phase(gen) -> list[dict]:
    """dQ (#2) and dK/dV (#3) against their plain versions: the training
    shape (B=8, T=1024, H=4, D=128, causal), a small non-causal case, odd
    T and k_shift=1, through ``flash_block_grads``; then each kernel timed
    at the training shape beside its plain version, its bound and SDPA's
    backward (forward+backward minus forward)."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        FLASH_DKDV, FLASH_DQ, flash_block_grads, flash_block_grads_reference,
        flash_dkdv, flash_dkdv_reference, flash_dq, flash_dq_reference,
        flash_forward_lse_reference,
    )

    err_dq = err_dkdv = 0.0
    main = None
    for b, t, h, d, causal, k_shift in ((8, 1024, 4, 128, True, 0),
                                        (2, 256, 4, 128, False, 0),
                                        (2, 1000, 4, 128, True, 0),
                                        (2, 256, 4, 128, True, 1)):
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda() for _ in range(4))
        # Statistics of a k_shift=0 forward: every row has a finite lse.
        o, lse = flash_forward_lse_reference(q, k, v, causal=causal)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        got = flash_block_grads(*args, causal=causal, k_shift=k_shift)
        want = flash_block_grads_reference(*args, causal=causal, k_shift=k_shift)
        torch.cuda.synchronize()
        e = [_grad_err(g, w) for g, w in zip(got, want)]
        print(f"[kernel] flash_block_grads B={b} T={t} H={h} D={d} causal={causal} "
              f"k_shift={k_shift}: max|ddq|={e[0]:.3e} max|ddk|={e[1]:.3e} "
              f"max|ddv|={e[2]:.3e} (|err| <= {GRAD_ATOL:g} + {GRAD_RTOL:g}·|plain|)")
        err_dq, err_dkdv = max(err_dq, e[0]), max(err_dkdv, e[1], e[2])
        if main is None:
            main = (args, b, t, h, d)
    del got, want
    args, b, t, h, d = main
    dq = flash_dq(*args, causal=True)
    e = _grad_err(dq, flash_dq_reference(*args, causal=True))
    same = torch.equal(dq, flash_dq(*args, causal=True))
    print(f"[kernel] flash_dq B={b} T={t} H={h} D={d} causal: max|err| {e:.3e} (|err| <= "
          f"{GRAD_ATOL:g} + {GRAD_RTOL:g}·|plain|); repeat call bitwise equal: {same}")
    check(same, "flash dQ is not bitwise repeatable")
    del dq
    q, k, v, do = args[:4]
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    lib_ms = (cuda_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), iters=20)
              - cuda_ms(sdpa, iters=20))
    pairs = b * h * t * (t + 1) // 2
    io = b * t * h * d
    rows = []
    for kernel, fn, ref, err, nbytes, flops in (
        (FLASH_DQ, flash_dq, flash_dq_reference, err_dq,
         4 * (5 * io + 2 * b * h * t), 6 * d * pairs),
        (FLASH_DKDV, flash_dkdv, flash_dkdv_reference, err_dkdv,
         4 * (6 * io + 2 * b * h * t), 8 * d * pairs),
    ):
        ms = cuda_ms(lambda: fn(*args, causal=True), iters=20)
        plain_ms = cuda_ms(lambda: ref(*args, causal=True), iters=10)
        bnd, by = bound(nbytes, flops)
        rate = tflops(flops, ms)
        print(f"[kernel] {kernel.name} B={b} T={t} H={h} D={d} causal: kernel {ms:.4f} ms "
              f"({rate:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa backward (dq+dk+dv) "
              f"{lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms, tflops=rate,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                         library_ms=lib_ms, library="sdpa fwd+bwd minus fwd (dq, dk, dv)",
                         shape=f"B={b} T={t} H={h} D={d} causal (training)"))
    return rows


def add_ln_phase(gen) -> list[dict]:
    """add+LN forward (#8) and backward (#9) against their plain versions
    at the training shape (N = B·T = 8192, d = 512) and at N = 1000 (not a
    multiple of a block), the backward with and without ds; then timed
    beside the bound and ``F.layer_norm(x + r)`` (its backward: forward+
    backward minus forward)."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        ADD_LN_BACKWARD, ADD_LN_FORWARD, add_layernorm_backward,
        add_layernorm_backward_reference, add_layernorm_forward,
        add_layernorm_forward_reference,
    )

    err_f = err_b = 0.0
    main = None
    for n, d in ((8192, 512), (1000, 512)):
        x, r, dy, ds = (torch.randn((n, d), generator=gen).cuda() for _ in range(4))
        scale = (1 + 0.1 * torch.randn((d,), generator=gen)).cuda()
        bias = (0.1 * torch.randn((d,), generator=gen)).cuda()
        got = add_layernorm_forward(x, r, scale, bias)
        want = add_layernorm_forward_reference(x, r, scale, bias)
        ef = max((a - w).abs().max().item() for a, w in zip(got, want))
        check(ef <= LN_ROW_TOL, f"add+LN forward disagrees with its plain version "
              f"(N={n}, max |err| {ef:.3e})")
        s, _, mean, rstd = want
        for dsv in (ds, None):
            gdx, gdg, gdb = add_layernorm_backward(s, scale, dy, dsv, mean, rstd)
            wdx, wdg, wdb = add_layernorm_backward_reference(s, scale, dy, dsv, mean, rstd)
            edx = (gdx - wdx).abs().max().item()
            ecol = max(((a - w).abs().max() / w.abs().max()).item()
                       for a, w in ((gdg, wdg), (gdb, wdb)))
            print(f"[kernel] add_layernorm N={n} d={d} ds={'None' if dsv is None else 'given'}: "
                  f"fwd max|err| {ef:.3e}, dx max|err| {edx:.3e} (tol {LN_ROW_TOL:g} each), "
                  f"dgamma/dbeta max|err|/max|plain| {ecol:.3e} (tol {LN_COL_RTOL:g})")
            check(edx <= LN_ROW_TOL and ecol <= LN_COL_RTOL,
                  f"add+LN backward disagrees with its plain version (N={n})")
            err_b = max(err_b, edx, (gdg - wdg).abs().max().item(),
                        (gdb - wdb).abs().max().item())
        err_f = max(err_f, ef)
        if main is None:
            main = (x, r, scale, bias, dy, ds, s, mean, rstd, n, d)
    x, r, scale, bias, dy, ds, s, mean, rstd, n, d = main
    leaves = [t.clone().requires_grad_() for t in (x, r, scale, bias)]

    def lib_fwd():
        s_ = leaves[0] + leaves[1]
        return s_, F.layer_norm(s_, (d,), leaves[2], leaves[3], 1e-5)

    lib_f = cuda_ms(lib_fwd)
    lib_b = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, (ds, dy))) - lib_f
    dev_f = device_ms(lib_fwd)
    dev_b = device_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, (ds, dy))) - dev_f
    rows = []
    for kernel, fn, ref, err, nbytes, flops, lib, lib_dev in (
        (ADD_LN_FORWARD, lambda: add_layernorm_forward(x, r, scale, bias),
         lambda: add_layernorm_forward_reference(x, r, scale, bias), err_f,
         4 * (4 * n * d + 2 * d + 2 * n), 8 * n * d, lib_f, dev_f),
        (ADD_LN_BACKWARD, lambda: add_layernorm_backward(s, scale, dy, ds, mean, rstd),
         lambda: add_layernorm_backward_reference(s, scale, dy, ds, mean, rstd), err_b,
         4 * (4 * n * d + 3 * d + 2 * n), 12 * n * d, lib_b, dev_b),
    ):
        ms = cuda_ms(fn)
        dev = device_ms(fn)
        plain_ms = cuda_ms(ref)
        bnd, by = bound(nbytes, flops)
        print(f"[kernel] {kernel.name} N={n} d={d}: kernel {ms:.4f} ms (device {dev:.4f}), "
              f"plain {plain_ms:.4f} ms, F.layer_norm(x + r) {lib:.4f} ms (device "
              f"{lib_dev:.4f}), bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms, device_ms=dev,
                         library_device_ms=lib_dev,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                         library="F.layer_norm(x + r)" + (" fwd+bwd minus fwd"
                                                          if kernel is ADD_LN_BACKWARD else ""),
                         shape=f"N={n} d={d} f32 (training)"))
    return rows


def flash_bf16_phase(gen) -> list[dict]:
    """The bf16 twins of the flash forward (#1), dQ (#2) and dK/dV (#3) at
    the training shape (B=8, T=1024, H=4, D=128, causal), also T=1000
    non-causal: agreement with the plain versions and times beside the
    bf16 bound and SDPA in bf16."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        FLASH_DKDV_BF16, FLASH_DQ_BF16, FLASH_FORWARD_BF16, flash_block_grads,
        flash_block_grads_reference, flash_dkdv, flash_dkdv_reference, flash_dq,
        flash_dq_reference, flash_forward_lse, flash_forward_lse_reference,
    )

    errs = {"fwd": 0.0, "dq": 0.0, "dkdv": 0.0}
    main = None
    for b, t, h, d, causal in ((8, 1024, 4, 128, True), (2, 1000, 4, 128, False)):
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda().bfloat16()
                       for _ in range(4))
        o, lse = flash_forward_lse(q, k, v, causal=causal)
        ro, rlse = flash_forward_lse_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        eo, el = rel_to_max(o, ro), (lse - rlse).abs().max().item()
        check(o.dtype == torch.bfloat16 and eo <= BF16_REL and el <= FLASH_TOL,
              f"bf16 flash forward disagrees with its plain version (T={t})")
        delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, rlse, delta)
        got = flash_block_grads(*args, causal=causal)
        want = flash_block_grads_reference(*args, causal=causal)
        torch.cuda.synchronize()
        e = [rel_to_max(g, w) for g, w in zip(got, want)]
        print(f"[kernel] bf16 flash B={b} T={t} H={h} D={d} causal={causal}: O "
              f"max|err|/max|plain| {eo:.3e}, max|dlse| {el:.3e}; dq/dk/dv "
              f"{e[0]:.3e}/{e[1]:.3e}/{e[2]:.3e} (tol {BF16_REL:g} of max; lse {FLASH_TOL:g})")
        check(max(e) <= BF16_REL and all(g.dtype == torch.bfloat16 for g in got),
              f"bf16 flash backward disagrees with its plain version (T={t})")
        errs["fwd"] = max(errs["fwd"], (o.float() - ro.float()).abs().max().item(), el)
        errs["dq"] = max(errs["dq"], (got[0].float() - want[0].float()).abs().max().item())
        errs["dkdv"] = max(errs["dkdv"], *((g.float() - w.float()).abs().max().item()
                                           for g, w in zip(got[1:], want[1:])))
        if main is None:
            main = (args, b, t, h, d)
        del got, want
    args, b, t, h, d = main
    same = torch.equal(flash_dq(*args, causal=True), flash_dq(*args, causal=True))
    print(f"[kernel] flash_dq_bf16 B={b} T={t} H={h} D={d} causal: repeat call bitwise "
          f"equal: {same}")
    check(same, "bf16 flash dQ is not bitwise repeatable")
    q, k, v, do = args[:4]
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa(), (qh, kh, vh), doh)

    lib_f = cuda_ms(sdpa, iters=20)
    lib_b = cuda_ms(sdpa_bwd, iters=20) - lib_f
    dev_f = device_ms(sdpa)
    dev_b = device_ms(sdpa_bwd) - dev_f
    pairs = b * h * t * (t + 1) // 2
    io = b * t * h * d
    rows = []
    for kernel, fn, ref, err, nbytes, flops, lib, lib_dev, lib_name in (
        (FLASH_FORWARD_BF16, lambda: flash_forward_lse(q, k, v, causal=True),
         lambda: flash_forward_lse_reference(q, k, v, causal=True), errs["fwd"],
         2 * 4 * io + 4 * b * h * t, 4 * d * pairs, lib_f, dev_f, "sdpa bf16 forward"),
        (FLASH_DQ_BF16, lambda: flash_dq(*args, causal=True),
         lambda: flash_dq_reference(*args, causal=True), errs["dq"],
         2 * 5 * io + 8 * b * h * t, 6 * d * pairs, lib_b, dev_b,
         "sdpa bf16 fwd+bwd minus fwd (dq, dk, dv)"),
        (FLASH_DKDV_BF16, lambda: flash_dkdv(*args, causal=True),
         lambda: flash_dkdv_reference(*args, causal=True), errs["dkdv"],
         2 * 6 * io + 8 * b * h * t, 8 * d * pairs, lib_b, dev_b,
         "sdpa bf16 fwd+bwd minus fwd (dq, dk, dv)"),
    ):
        ms = cuda_ms(fn, iters=20)
        dev = device_ms(fn)
        plain_ms = cuda_ms(ref, iters=10)
        bnd, by = bound(nbytes, flops, H100_BF16_FLOPS)
        rate = tflops(flops, ms)
        print(f"[kernel] {kernel.name} B={b} T={t} H={h} D={d} causal: kernel {ms:.4f} ms "
              f"({rate:.1f} TFLOP/s; device {dev:.4f}), plain {plain_ms:.4f} ms, {lib_name} "
              f"{lib:.4f} ms (device {lib_dev:.4f}), bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms, tflops=rate,
                         device_ms=dev, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                         library_ms=lib, library_device_ms=lib_dev, library=lib_name,
                         shape=f"B={b} T={t} H={h} D={d} causal bf16 (flagship)"))
    return rows


def flash_head_dim_phase(gen, rows: dict) -> None:
    """Kernels 1–3 (f32 and bf16) at head dims between their compiled widths
    and at the widest, D = 48, 80, 200 and 256, at small T: causal T=200
    (not a multiple of a tile) and non-causal T=77, against their plain
    versions with the tolerances above. Adds ``at_head_dims`` to the rows
    and folds the errors into their ``max_abs_err``; then times dQ and
    dK/dV at D = 256 (``at_d256``)."""
    import torch

    from tpudml_torch.ops import (
        flash_dkdv, flash_dkdv_reference, flash_dq, flash_dq_reference, flash_forward_lse,
        flash_forward_lse_reference,
    )

    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        errs = {"flash_forward_lse": {}, "flash_dkdv": {}, "flash_dq": {}}
        for d in (48, 80, 200, 256):
            for b, t, h, causal in ((2, 200, 3, True), (1, 77, 2, False)):
                q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda().to(dtype)
                               for _ in range(4))
                o, lse = flash_forward_lse(q, k, v, causal=causal)
                ro, rlse = flash_forward_lse_reference(q, k, v, causal=causal)
                torch.cuda.synchronize()
                el = (lse - rlse).abs().max().item()
                if dtype == torch.float32:
                    eo = (o - ro).abs().max().item()
                    ok = eo <= FLASH_TOL and el <= FLASH_TOL
                else:
                    eo = rel_to_max(o, ro)
                    ok = o.dtype == dtype and eo <= BF16_REL and el <= FLASH_TOL
                check(ok, f"flash forward disagrees with its plain version at D={d} "
                      f"({dtype}, T={t}, causal={causal})")
                fe = errs["flash_forward_lse"]
                fe[d] = max(fe.get(d, 0.0), (o.float() - ro.float()).abs().max().item(), el)
                delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
                args = (q, k, v, do, rlse, delta)
                got = (flash_dq(*args, causal=causal), *flash_dkdv(*args, causal=causal))
                want = (flash_dq_reference(*args, causal=causal),
                        *flash_dkdv_reference(*args, causal=causal))
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    e = [_grad_err(g_, w) for g_, w in zip(got, want)]
                    tol = (f"tol {FLASH_TOL:g}; grads |err| <= {GRAD_ATOL:g} + "
                           f"{GRAD_RTOL:g}·|plain|")
                else:
                    e = [rel_to_max(g_, w) for g_, w in zip(got, want)]
                    check(max(e) <= BF16_REL and all(g_.dtype == dtype for g_ in got),
                          f"bf16 flash backward disagrees with its plain version at D={d}")
                    tol = f"tol {BF16_REL:g} of max; lse {FLASH_TOL:g}"
                for name, gs, ws in (("flash_dq", got[:1], want[:1]),
                                     ("flash_dkdv", got[1:], want[1:])):
                    errs[name][d] = max(errs[name].get(d, 0.0), *(
                        (g_.float() - w.float()).abs().max().item() for g_, w in zip(gs, ws)))
                print(f"[kernel] flash head dim D={d} {str(dtype)[6:]} B={b} T={t} H={h} "
                      f"causal={causal}: O {eo:.3e}, lse {el:.3e}; dq/dk/dv "
                      f"{e[0]:.3e}/{e[1]:.3e}/{e[2]:.3e} ({tol})")
        for name, by_d in errs.items():
            row = rows[name + suffix]
            row["at_head_dims"] = {f"D={d}": e for d, e in by_d.items()}
            row["max_abs_err"] = max(row["max_abs_err"], *by_d.values())
        flash_d256_times(gen, dtype, rows["flash_dq" + suffix], rows["flash_dkdv" + suffix])
    torch.cuda.empty_cache()


def flash_d256_times(gen, dtype, dq_row: dict, dkdv_row: dict) -> None:
    """dQ and dK/dV at the training shape with D = 256 (B=8, T=1024, H=4,
    causal): kernel, plain and SDPA-backward ms, the bound and the rate,
    into ``at_d256`` of the two rows."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        flash_dkdv, flash_dkdv_reference, flash_dq, flash_dq_reference,
        flash_forward_lse_reference,
    )

    b, t, h, d = FLASH_D256_SHAPE
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda().to(dtype)
                   for _ in range(4))
    o, lse = flash_forward_lse_reference(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    lib_b = (cuda_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), iters=10)
             - cuda_ms(sdpa, iters=10))
    bf16 = dtype == torch.bfloat16
    e, peak = (2, H100_BF16_FLOPS) if bf16 else (4, H100_F32_FLOPS)
    pairs = b * h * t * (t + 1) // 2
    io = b * t * h * d
    for row, fn, ref, nbytes, flops in (
        (dq_row, flash_dq, flash_dq_reference, e * 5 * io + 8 * b * h * t, 6 * d * pairs),
        (dkdv_row, flash_dkdv, flash_dkdv_reference, e * 6 * io + 8 * b * h * t,
         8 * d * pairs),
    ):
        r = timed(lambda: fn(*args, causal=True), lambda: ref(*args, causal=True),
                  nbytes, flops, peak, iters=10)
        r.update(library_ms=lib_b, library="sdpa fwd+bwd minus fwd (dq, dk, dv)",
                 tflops=tflops(flops, r["ms"]),
                 shape=f"B={b} T={t} H={h} D={d} causal {str(dtype)[6:]}")
        print(f"[kernel] {row['name']} B={b} T={t} H={h} D={d} causal: kernel {r['ms']:.4f} "
              f"ms ({r['tflops']:.1f} TFLOP/s), plain {r['plain_ms']:.4f} ms, sdpa backward "
              f"{lib_b:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
        row["at_d256"] = r
    del qh, kh, vh, doh


def add_ln_bf16_phase(gen) -> list[dict]:
    """The bf16 twins of add+LN forward (#8) and backward (#9) at N=8192,
    d=512 (also N=1000, and ds=None): agreement and times beside the bound
    and ``F.layer_norm(x + r)`` in bf16."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        ADD_LN_BACKWARD_BF16, ADD_LN_FORWARD_BF16, add_layernorm_backward,
        add_layernorm_backward_reference, add_layernorm_forward,
        add_layernorm_forward_reference,
    )

    err_f = err_b = 0.0
    main = None
    for n, d in ((8192, 512), (1000, 512)):
        x, r, dy, ds = (torch.randn((n, d), generator=gen).cuda().bfloat16() for _ in range(4))
        scale = (1 + 0.1 * torch.randn((d,), generator=gen)).cuda()
        bias = (0.1 * torch.randn((d,), generator=gen)).cuda()
        s, y, mean, rstd = add_layernorm_forward(x, r, scale, bias)
        rs, ry, rmean, rrstd = add_layernorm_forward_reference(x, r, scale, bias)
        ey = rel_to_max(y, ry)
        estat = max((mean - rmean).abs().max().item(), (rstd - rrstd).abs().max().item())
        check(torch.equal(s, rs) and ey <= BF16_REL and estat <= LN_ROW_TOL,
              f"bf16 add+LN forward disagrees with its plain version (N={n})")
        for dsv in (ds, None):
            dx, dg, db = add_layernorm_backward(rs, scale, dy, dsv, rmean, rrstd)
            rdx, rdg, rdb = add_layernorm_backward_reference(rs, scale, dy, dsv, rmean, rrstd)
            edx = rel_to_max(dx, rdx)
            ecol = max(rel_to_max(dg, rdg), rel_to_max(db, rdb))
            print(f"[kernel] bf16 add_layernorm N={n} d={d} ds={'None' if dsv is None else 'given'}: "
                  f"s equal, y {ey:.3e}, dx {edx:.3e} of max (tol {BF16_REL:g}); mean/rstd "
                  f"{estat:.3e} (tol {LN_ROW_TOL:g}); dgamma/dbeta {ecol:.3e} of max "
                  f"(tol {LN_COL_RTOL:g})")
            check(edx <= BF16_REL and ecol <= LN_COL_RTOL,
                  f"bf16 add+LN backward disagrees with its plain version (N={n})")
            err_b = max(err_b, (dx.float() - rdx.float()).abs().max().item(),
                        (dg - rdg).abs().max().item(), (db - rdb).abs().max().item())
        err_f = max(err_f, (y.float() - ry.float()).abs().max().item(), estat)
        if main is None:
            main = (x, r, scale, bias, dy, ds, rs, rmean, rrstd, n, d)
    x, r, scale, bias, dy, ds, s, mean, rstd, n, d = main
    leaves = [t.clone().requires_grad_() for t in (x, r, scale, bias)]

    def lib_fwd():  # F.layer_norm takes γ, β in the rows' dtype
        s_ = leaves[0] + leaves[1]
        return s_, F.layer_norm(s_, (d,), leaves[2].bfloat16(), leaves[3].bfloat16(), 1e-5)

    lib_f = cuda_ms(lib_fwd)
    lib_b = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, (ds, dy))) - lib_f
    dev_f = device_ms(lib_fwd)
    dev_b = device_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, (ds, dy))) - dev_f
    rows = []
    for kernel, fn, ref, err, nbytes, lib, lib_dev in (
        (ADD_LN_FORWARD_BF16, lambda: add_layernorm_forward(x, r, scale, bias),
         lambda: add_layernorm_forward_reference(x, r, scale, bias), err_f,
         2 * 4 * n * d + 4 * (2 * d + 2 * n), lib_f, dev_f),
        (ADD_LN_BACKWARD_BF16, lambda: add_layernorm_backward(s, scale, dy, ds, mean, rstd),
         lambda: add_layernorm_backward_reference(s, scale, dy, ds, mean, rstd), err_b,
         2 * 4 * n * d + 4 * (3 * d + 2 * n), lib_b, dev_b),
    ):
        ms = cuda_ms(fn)
        dev = device_ms(fn)
        plain_ms = cuda_ms(ref)
        flops = (8 if kernel is ADD_LN_FORWARD_BF16 else 12) * n * d
        bnd, by = bound(nbytes, flops, H100_BF16_FLOPS)
        print(f"[kernel] {kernel.name} N={n} d={d}: kernel {ms:.4f} ms (device {dev:.4f}), "
              f"plain {plain_ms:.4f} ms, F.layer_norm(x + r) bf16 {lib:.4f} ms (device "
              f"{lib_dev:.4f}), bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms, device_ms=dev,
                         library_device_ms=lib_dev,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                         library="F.layer_norm(x + r) bf16" + (
                             " fwd+bwd minus fwd" if kernel is ADD_LN_BACKWARD_BF16 else ""),
                         shape=f"N={n} d={d} bf16 (flagship)"))
    return rows


def _xent_inputs(gen, n, d, v, dtype, bad_labels):
    import torch

    dev = gen.device  # a CUDA generator makes large inputs on the card
    x = torch.randn((n, d), generator=gen, device=dev).cuda().to(dtype)
    w = ((torch.rand((d, v), generator=gen, device=dev) * 2 - 1) / d ** 0.5).cuda().to(dtype)
    b = ((torch.rand((v,), generator=gen, device=dev) * 2 - 1) / d ** 0.5).cuda().to(dtype)
    y = torch.randint(0, v, (n,), generator=gen, dtype=torch.int32, device=dev)
    if bad_labels:
        y[0], y[-1] = -1, v
    return x, w, b, y.cuda()


def xent_check(gen, n, d, v, dtype, bad_labels) -> dict:
    """Kernels 10–13 against their plain versions at one shape: returns
    max |err| per kernel."""
    import torch

    from tpudml_torch.ops import (
        xent_dw, xent_dw_reference, xent_dx, xent_dx_reference, xent_forward,
        xent_forward_save, xent_forward_save_reference,
    )

    x, w, b, y = _xent_inputs(gen, n, d, v, dtype, bad_labels)
    lse0, picked0 = xent_forward(x, w, b, y)
    lse, picked, s = xent_forward_save(x, w, b, y)
    rlse, rpicked, rs = xent_forward_save_reference(x, w, b, y)
    torch.cuda.synchronize()

    def row_err(got, want, what):
        err = (got - want).abs()
        check(bool((err <= XENT_ROW_TOL * (1 + want.abs())).all()),
              f"xent {what} disagrees with its plain version (N={n}, V={v}, {dtype})")
        return err.max().item()

    e10 = max(row_err(lse0, rlse, "fwd lse"), row_err(picked0, rpicked, "fwd picked"))
    e11 = max(row_err(lse, rlse, "fwd-save lse"), row_err(picked, rpicked, "fwd-save picked"),
              row_err(s, rs, "saved scores"))
    if bad_labels:
        check(picked[0].item() == picked[-1].item() == 0.0, "an out-of-range label picked")
    del s
    rel = XENT_GRAD_REL if dtype == torch.float32 else BF16_REL
    dx = xent_dx(rs, w, y, rlse, 1.0 / n)
    rdx = xent_dx_reference(rs, w, y, rlse, 1.0 / n)
    dw, db = xent_dw(rs, x, y, rlse, 1.0 / n)
    rdw, rdb = xent_dw_reference(rs, x, y, rlse, 1.0 / n)
    torch.cuda.synchronize()
    r_dx, r_dw, r_db = rel_to_max(dx, rdx), rel_to_max(dw, rdw), rel_to_max(db, rdb)
    tag = "f32" if dtype == torch.float32 else "bf16"
    print(f"[kernel] xent N={n} d={d} V={v} {tag}{' labels -1, V' if bad_labels else ''}: "
          f"fwd max|dlse|,|dpicked| {e10:.3e}, fwd-save (+scores) {e11:.3e} "
          f"(|err| <= {XENT_ROW_TOL:g}·(1+|plain|)); dx {r_dx:.3e}, dw {r_dw:.3e}, "
          f"db {r_db:.3e} of max (tol {rel:g}; db {XENT_GRAD_REL:g})")
    check(r_dx <= rel and r_dw <= rel and r_db <= XENT_GRAD_REL,
          f"xent backward disagrees with its plain version (N={n}, V={v}, {tag})")
    return {"xent_fwd": e10, "xent_fwd_save": e11,
            "xent_dx_s": (dx.float() - rdx.float()).abs().max().item(),
            "xent_dw_s": max((dw.float() - rdw.float()).abs().max().item(),
                             (db - rdb).abs().max().item())}


PRODUCT_NAME = "cuBLAS product alone on a dlog materialized in the operand dtype"


def xent_times(gen, dtype, shape=XENT_SHAPE, label="flagship head", only=None) -> dict:
    """Kernels 10–13 (or the names in ``only``) at ``shape`` (N, d, V; the
    flagship head's by default) in ``dtype``: kernel, plain and library ms
    and the bound, by kernel name. Library: the forward is
    ``torch.logsumexp(x@W+b)`` plus the label pick; the backward the
    autograd of ``F.cross_entropy`` over the materialized logits minus its
    forward (dx, dW, db together: the whole head's backward, not one
    kernel). Every row gives its rate at 2·N·d·V, and rows 12 and 13, as a
    yardstick of their product that is not their function (the port never
    calls it), ``product_ms``: cuBLAS's dlog·Wᵀ or xᵀ·dlog on a dlog that
    is already materialized in the operand dtype."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        XENT_DW, XENT_DX, XENT_FORWARD, XENT_FORWARD_SAVE, xent_dw, xent_dw_reference,
        xent_dx, xent_dx_reference, xent_forward, xent_forward_reference,
        xent_forward_save, xent_forward_save_reference,
    )
    from tpudml_torch.ops.xent_kernel import _dlog

    n, d, v = shape
    x, w, b, y = _xent_inputs(gen, n, d, v, dtype, bad_labels=False)
    yl = y.long()
    lse, _, s = xent_forward_save(x, w, b, y)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    dlog = _dlog(s, y, lse, 1.0 / n).to(dtype)
    product = {XENT_DX: lambda: dlog @ w.T, XENT_DW: lambda: x.T @ dlog}

    def lib_fwd():
        logits = torch.addmm(b, x, w)
        return torch.logsumexp(logits, dim=-1), logits.gather(1, yl[:, None])

    def ce():
        return F.cross_entropy(torch.addmm(leaves[2], leaves[0], leaves[1]), yl)

    lib_f = cuda_ms(lib_fwd, iters=10)
    lib_b = cuda_ms(lambda: torch.autograd.grad(ce(), leaves), iters=10) - cuda_ms(ce, iters=10)
    e = x.element_size()
    io = n * d * e + d * v * e + v * e + 4 * n  # x, W, b, labels
    mm = 2 * n * d * v
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    out = {}
    cases = (
        (XENT_FORWARD, lambda: xent_forward(x, w, b, y),
         lambda: xent_forward_reference(x, w, b, y), io + 8 * n, mm + 4 * n * v,
         lib_f, "logsumexp(x@W+b) + pick"),
        (XENT_FORWARD_SAVE, lambda: xent_forward_save(x, w, b, y),
         lambda: xent_forward_save_reference(x, w, b, y), io + 8 * n + 4 * n * v,
         mm + 4 * n * v, lib_f, "logsumexp(x@W+b) + pick"),
        (XENT_DX, lambda: xent_dx(s, w, y, lse, 1.0 / n),
         lambda: xent_dx_reference(s, w, y, lse, 1.0 / n),
         4 * n * v + d * v * e + 8 * n + n * d * e, mm + 4 * n * v, lib_b,
         "F.cross_entropy fwd+bwd minus fwd (dx, dW, db)"),
        (XENT_DW, lambda: xent_dw(s, x, y, lse, 1.0 / n),
         lambda: xent_dw_reference(s, x, y, lse, 1.0 / n),
         4 * n * v + n * d * e + 8 * n + d * v * e + 4 * v, mm + 5 * n * v, lib_b,
         "F.cross_entropy fwd+bwd minus fwd (dx, dW, db)"),
    )
    tag = str(dtype)[6:]
    for kernel, fn, ref, nbytes, flops, lib, lib_name in cases:
        if only is not None and kernel.name not in only:
            continue
        ms = cuda_ms(fn, iters=10, warmup=2)
        plain_ms = cuda_ms(ref, iters=5, warmup=1)
        bnd, by = bound(nbytes, flops, peak)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                   library=f"{lib_name}, {tag}", shape=f"N={n} d={d} V={v} {tag} ({label})")
        row["tflops"] = tflops(mm, ms)
        extra = f" ({row['tflops']:.1f} TFLOP/s at 2·N·d·V)"
        if kernel in product:
            row.update(product_ms=cuda_ms(product[kernel], iters=10, warmup=2),
                       product=f"{PRODUCT_NAME} (a yardstick, not this kernel's function)")
            extra += f"; yardstick {PRODUCT_NAME}: {row['product_ms']:.3f} ms"
        print(f"[kernel] {kernel.name} N={n} d={d} V={v} {tag}: kernel {ms:.3f} ms{extra}, "
              f"plain {plain_ms:.3f} ms, {lib_name} {lib:.3f} ms, bound {bnd:.5f} ms ({by})")
        out[kernel.name] = row
    del s, dlog
    torch.cuda.empty_cache()
    return out


def xent_phase(gen) -> list[dict]:
    """The fused linear-xent kernels 10–13: agreement with their plain
    versions at the flagship head's shape, at N=V=1000 and at
    XENT_FWD_EDGES with labels −1 and V, in f32 and bf16; times at the
    flagship shape in bf16 (the row) and f32 (``at_f32``), and for 11–13
    in f32 at the long context's N=32768 with saved scores
    (``at_long_context``)."""
    import torch

    from tpudml_torch.ops import XENT_DW, XENT_DX, XENT_FORWARD, XENT_FORWARD_SAVE

    n, d, v = XENT_SHAPE
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, bad in (((1000, d, 1000), True), ((n, d, v), False),
                           *((edge, True) for edge in XENT_FWD_EDGES)):
            for name, e in xent_check(gen, *shape, dtype, bad).items():
                worst[name] = max(worst.get(name, 0.0), e)
            torch.cuda.empty_cache()
    times = {dt: xent_times(gen, dt) for dt in (torch.bfloat16, torch.float32)}
    long = xent_times(gen, torch.float32, (LEAN_PATH_N, d, v), "long context, saved scores",
                      only=(XENT_FORWARD_SAVE.name, XENT_DX.name, XENT_DW.name))
    rows = []
    for kernel in (XENT_FORWARD, XENT_FORWARD_SAVE, XENT_DX, XENT_DW):
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=worst[kernel.name],
                         **times[torch.bfloat16][kernel.name],
                         at_f32=times[torch.float32][kernel.name]))
        if kernel.name in long:
            rows[-1]["at_long_context"] = long[kernel.name]
    torch.cuda.empty_cache()
    return rows


def xent_lean_check(gen, n, d, v, dtype, bad_labels, chunk=None) -> dict:
    """Kernels 14 and 15, and kernel 10 that gives them lse, against their
    plain versions at one shape, the plain versions applied in row chunks
    of ``chunk`` rows when given (their [N, V] scores would not fit
    otherwise): returns max |err| per kernel."""
    import torch

    from tpudml_torch.ops import (
        xent_dw_lean, xent_dw_lean_reference, xent_dx_lean, xent_dx_lean_reference,
        xent_forward, xent_forward_reference,
    )

    x, w, b, y = _xent_inputs(gen, n, d, v, dtype, bad_labels)
    step = chunk or n
    rows = [slice(i, i + step) for i in range(0, n, step)]
    ref = [xent_forward_reference(x[r], w, b, y[r]) for r in rows]
    lse, picked = (torch.cat([p[i] for p in ref]) for i in (0, 1))
    del ref
    klse, kpicked = xent_forward(x, w, b, y)
    dx = xent_dx_lean(x, w, b, y, lse, 1.0 / n)
    dw, db = xent_dw_lean(x, w, b, y, lse, 1.0 / n)
    torch.cuda.synchronize()
    e10 = 0.0
    for got, want in ((klse, lse), (kpicked, picked)):
        err = (got - want).abs()
        check(bool((err <= XENT_ROW_TOL * (1 + want.abs())).all()),
              f"xent_fwd disagrees with its plain version (N={n}, V={v}, {dtype})")
        e10 = max(e10, err.max().item())
    e_dx = m_dx = 0.0
    rdw = rdb = 0.0
    for r in rows:
        rdx = xent_dx_lean_reference(x[r], w, b, y[r], lse[r], 1.0 / n).float()
        e_dx = max(e_dx, (dx[r].float() - rdx).abs().max().item())
        m_dx = max(m_dx, rdx.abs().max().item())
        pw, pb = xent_dw_lean_reference(x[r], w, b, y[r], lse[r], 1.0 / n)
        rdw, rdb = rdw + pw.float(), rdb + pb
    del rdx, pw, pb
    rdw = rdw.to(dtype)
    rel = XENT_GRAD_REL if dtype == torch.float32 else BF16_REL
    r_dx, r_dw, r_db = e_dx / max(m_dx, 1e-30), rel_to_max(dw, rdw), rel_to_max(db, rdb)
    tag = "f32" if dtype == torch.float32 else "bf16"
    print(f"[kernel] xent lean N={n} d={d} V={v} {tag}{' labels -1, V' if bad_labels else ''}"
          f"{f' (plain in {step}-row chunks)' if chunk else ''}: fwd max|dlse|,|dpicked| "
          f"{e10:.3e} (|err| <= {XENT_ROW_TOL:g}·(1+|plain|)); dx {r_dx:.3e}, dw "
          f"{r_dw:.3e}, db {r_db:.3e} of max (tol {rel:g}; db {XENT_GRAD_REL:g})")
    check(dx.dtype == dw.dtype == dtype and db.dtype == torch.float32,
          "lean xent gradients in the wrong dtype")
    check(r_dx <= rel and r_dw <= rel and r_db <= XENT_GRAD_REL,
          f"lean xent backward disagrees with its plain version (N={n}, V={v}, {tag})")
    return {"xent_fwd": e10, "xent_dx_lean": e_dx,
            "xent_dw_lean": max((dw.float() - rdw.float()).abs().max().item(),
                                (db - rdb).abs().max().item())}


def xent_lean_times(gen, n, dtype, iters=3, with_fwd=False, dv=XENT_SHAPE[1:]) -> dict:
    """Kernels 14 and 15 (and with ``with_fwd`` kernel 10, which runs
    before them) at N rows of width d and vocabulary V (``dv``, the
    flagship head's by default) in ``dtype``:
    kernel, plain and library ms and the bound, by kernel name. Library:
    the autograd of ``F.cross_entropy`` over the materialized logits minus
    its forward (dx, dW, db together), as rows 12 and 13 use; for kernel
    10, ``torch.logsumexp(x@W+b)`` plus the label pick. The bound counts
    both products each backward kernel does (the recompute and the
    gradient)."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        XENT_DW_LEAN, XENT_DX_LEAN, XENT_FORWARD, xent_dw_lean, xent_dw_lean_reference,
        xent_dx_lean, xent_dx_lean_reference, xent_forward, xent_forward_reference,
    )

    d, v = dv
    x, w, b, y = _xent_inputs(gen, n, d, v, dtype, bad_labels=False)
    yl = y.long()
    lse, _ = xent_forward_reference(x, w, b, y)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]

    def ce():
        return F.cross_entropy(torch.addmm(leaves[2], leaves[0], leaves[1]), yl)

    def lib_fwd():
        logits = torch.addmm(b, x, w)
        return torch.logsumexp(logits, dim=-1), logits.gather(1, yl[:, None])

    lib_b = (cuda_ms(lambda: torch.autograd.grad(ce(), leaves), iters=iters, warmup=1)
             - cuda_ms(ce, iters=iters, warmup=1))
    lib_f = cuda_ms(lib_fwd, iters=iters, warmup=1) if with_fwd else None
    del leaves
    e = x.element_size()
    io = n * d * e + d * v * e + v * e + 8 * n  # x, W, b, labels, lse
    mm = 4 * n * d * v  # the recompute and the gradient product
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    tag = str(dtype)[6:]
    lib_name = "F.cross_entropy fwd+bwd minus fwd (dx, dW, db)"
    cases = [
        (XENT_DX_LEAN, lambda: xent_dx_lean(x, w, b, y, lse, 1.0 / n),
         lambda: xent_dx_lean_reference(x, w, b, y, lse, 1.0 / n),
         io + n * d * e, mm + 4 * n * v, lib_b, lib_name),
        (XENT_DW_LEAN, lambda: xent_dw_lean(x, w, b, y, lse, 1.0 / n),
         lambda: xent_dw_lean_reference(x, w, b, y, lse, 1.0 / n),
         io + d * v * e + 4 * v, mm + 5 * n * v, lib_b, lib_name),
    ]
    if with_fwd:  # x, W, b, labels in; lse, picked out
        cases.insert(0, (XENT_FORWARD, lambda: xent_forward(x, w, b, y),
                         lambda: xent_forward_reference(x, w, b, y), io,
                         mm // 2 + 4 * n * v, lib_f, "logsumexp(x@W+b) + pick"))
    out = {}
    for kernel, fn, ref, nbytes, flops, lib, name in cases:
        ms = cuda_ms(fn, iters=iters, warmup=1)
        plain_ms = cuda_ms(ref, iters=2, warmup=1)
        bnd, by = bound(nbytes, flops, peak)
        rate = tflops(mm if kernel is not XENT_FORWARD else mm // 2, ms)
        print(f"[kernel] {kernel.name} N={n} d={d} V={v} {tag}: kernel {ms:.3f} ms "
              f"({rate:.1f} TFLOP/s at {'2' if kernel is XENT_FORWARD else '4'}·N·d·V), plain "
              f"{plain_ms:.3f} ms, {name} {lib:.3f} ms, bound {bnd:.5f} ms ({by})")
        out[kernel.name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                                library_ms=lib, library=f"{name}, {tag}", tflops=rate,
                                shape=f"N={n} d={d} V={v} {tag}")
        torch.cuda.empty_cache()
    return out


def xent_lean_phase(gen, fwd_row: dict) -> list[dict]:
    """The lean head's kernels 14 and 15, with kernel 10 that feeds them:
    agreement with their plain versions at the flagship head's shape and
    at N=V=1000 with labels −1 and V (f32 and bf16), and in f32 at the
    long-context path's N=32768, at N=131072 and at LEAN_WIDE (N·d > 2³¹);
    times at the path's shape in f32 (the rows of 14 and 15, kernel 10's
    ``at_long_context``) and at the flagship's N=8192 in bf16 and f32."""
    import torch

    from tpudml_torch.ops import XENT_DW_LEAN, XENT_DX_LEAN

    n, d, v = XENT_SHAPE
    worst = {}
    cases = [((1000, d, 1000), torch.float32, True, None),
             ((n, d, v), torch.float32, False, None),
             ((1000, d, 1000), torch.bfloat16, True, None),
             ((n, d, v), torch.bfloat16, False, None),
             ((LEAN_PATH_N, d, v), torch.float32, False, None),
             ((LEAN_BIG_N, d, v), torch.float32, False, LEAN_CHUNK),
             (LEAN_WIDE, torch.float32, False, LEAN_WIDE_CHUNK)]
    for shape, dtype, bad, chunk in cases:
        g = torch.Generator(device="cuda").manual_seed(1) if shape == LEAN_WIDE else gen
        for name, e in xent_lean_check(g, *shape, dtype, bad, chunk).items():
            worst[name] = max(worst.get(name, 0.0), e)
        torch.cuda.empty_cache()
    path = xent_lean_times(gen, LEAN_PATH_N, torch.float32, with_fwd=True)
    fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], worst["xent_fwd"])
    fwd_row["at_long_context"] = path["xent_fwd"]
    fwd_row["at_long_context"]["shape"] += " (long-context head)"
    flagship = {dt: xent_lean_times(gen, n, dt, iters=5) for dt in (torch.bfloat16,
                                                                    torch.float32)}
    rows = []
    for kernel in (XENT_DX_LEAN, XENT_DW_LEAN):
        row = dict(name=kernel.name, route="cuda", source=kernel.source,
                   replaces=kernel.replaces, max_abs_err=worst[kernel.name],
                   **path[kernel.name])
        row["shape"] += " (long-context head)"
        row["at_flagship_bf16"] = flagship[torch.bfloat16][kernel.name]
        row["at_flagship_f32"] = flagship[torch.float32][kernel.name]
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def ln_phase(gen) -> list[dict]:
    """The plain LayerNorm forward (#6) and backward (#7) and their bf16
    twins against their plain versions at N=8192 and N=1000, d=512; then
    timed at N=8192 beside the bound and ``F.layer_norm`` (its backward:
    forward+backward minus forward)."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        LN_BACKWARD, LN_BACKWARD_BF16, LN_FORWARD, LN_FORWARD_BF16, layernorm_backward,
        layernorm_backward_reference, layernorm_forward, layernorm_forward_reference,
    )

    rows = []
    for dtype, fwd_k, bwd_k in ((torch.float32, LN_FORWARD, LN_BACKWARD),
                                (torch.bfloat16, LN_FORWARD_BF16, LN_BACKWARD_BF16)):
        tag = str(dtype)[6:]
        bf16 = dtype == torch.bfloat16
        err_f = err_b = 0.0
        main = None
        for n, d in (LN_SHAPE, (1000, LN_SHAPE[1])):
            x, dy = (torch.randn((n, d), generator=gen).cuda().to(dtype) for _ in range(2))
            scale = (1 + 0.1 * torch.randn((d,), generator=gen)).cuda()
            bias = (0.1 * torch.randn((d,), generator=gen)).cuda()
            y, mean, rstd = layernorm_forward(x, scale, bias)
            ry, rmean, rrstd = layernorm_forward_reference(x, scale, bias)
            dx, dg, db = layernorm_backward(x, scale, dy, rmean, rrstd)
            rdx, rdg, rdb = layernorm_backward_reference(x, scale, dy, rmean, rrstd)
            torch.cuda.synchronize()
            estat = max((mean - rmean).abs().max().item(), (rstd - rrstd).abs().max().item())
            ey = rel_to_max(y, ry) if bf16 else (y - ry).abs().max().item()
            edx = rel_to_max(dx, rdx) if bf16 else (dx - rdx).abs().max().item()
            ecol = max(rel_to_max(dg, rdg), rel_to_max(db, rdb))
            row_tol = BF16_REL if bf16 else LN_ROW_TOL
            print(f"[kernel] layernorm N={n} d={d} {tag}: y {ey:.3e}, dx {edx:.3e} "
                  f"({'of max, ' if bf16 else ''}tol {row_tol:g}); mean/rstd {estat:.3e} "
                  f"(tol {LN_ROW_TOL:g}); dgamma/dbeta {ecol:.3e} of max (tol {LN_COL_RTOL:g})")
            check(y.dtype == dx.dtype == dtype and ey <= row_tol and edx <= row_tol
                  and estat <= LN_ROW_TOL and ecol <= LN_COL_RTOL,
                  f"LayerNorm kernels disagree with their plain versions (N={n}, {tag})")
            err_f = max(err_f, (y.float() - ry.float()).abs().max().item(), estat)
            err_b = max(err_b, (dx.float() - rdx.float()).abs().max().item(),
                        (dg - rdg).abs().max().item(), (db - rdb).abs().max().item())
            if main is None:
                main = (x, scale, bias, dy, rmean, rrstd, n, d)
        x, scale, bias, dy, mean, rstd, n, d = main
        leaves = [t.clone().requires_grad_() for t in (x, scale.to(dtype), bias.to(dtype))]

        def lib_fwd():  # F.layer_norm takes γ, β in the rows' dtype
            return F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)

        lib_f = cuda_ms(lib_fwd)
        lib_b = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, dy)) - lib_f
        dev_f = device_ms(lib_fwd)
        dev_b = device_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, dy)) - dev_f
        e = x.element_size()
        peak = H100_BF16_FLOPS if bf16 else H100_F32_FLOPS
        for kernel, fn, ref, err, nbytes, flops, lib, lib_dev in (
            (fwd_k, lambda: layernorm_forward(x, scale, bias),
             lambda: layernorm_forward_reference(x, scale, bias), err_f,
             2 * n * d * e + 4 * (2 * d + 2 * n), 8 * n * d, lib_f, dev_f),
            (bwd_k, lambda: layernorm_backward(x, scale, dy, mean, rstd),
             lambda: layernorm_backward_reference(x, scale, dy, mean, rstd), err_b,
             3 * n * d * e + 4 * (3 * d + 2 * n), 12 * n * d, lib_b, dev_b),
        ):
            ms = cuda_ms(fn)
            dev = device_ms(fn)
            plain_ms = cuda_ms(ref)
            bnd, by = bound(nbytes, flops, peak)
            lib_name = f"F.layer_norm {tag}" + (" fwd+bwd minus fwd" if kernel is bwd_k else "")
            print(f"[kernel] {kernel.name} N={n} d={d}: kernel {ms:.4f} ms (device {dev:.4f}), "
                  f"plain {plain_ms:.4f} ms, {lib_name} {lib:.4f} ms (device {lib_dev:.4f}), "
                  f"bound {bnd:.5f} ms ({by})")
            rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                             replaces=kernel.replaces, max_abs_err=err, ms=ms, device_ms=dev,
                             library_device_ms=lib_dev,
                             plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                             library=lib_name, shape=f"N={n} d={d} {tag} (op path)"))
    return rows


def _top2_gap(logits):
    import torch

    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def head_phase(gen) -> list[dict]:
    import torch

    from tpudml_torch.ops import (
        DECODE_HEAD, DECODE_HEAD_INT8, fused_decode_head, fused_decode_head_int8,
        reference_head, reference_head_int8,
    )
    from tpudml_torch.serve.fleet.quant import _dequant_kernel, _quant_kernel

    b, d, v = 8, 512, 32768
    x = torch.randn((b, d), generator=gen).cuda()
    w = ((torch.rand((d, v), generator=gen) * 2 - 1) / d ** 0.5).cuda()
    bias = ((torch.rand((v,), generator=gen) * 2 - 1) / d ** 0.5).cuda()
    wq, scale = _quant_kernel(w)
    rows = []
    for kernel, fn, ref, weights, wbytes in (
        (DECODE_HEAD, fused_decode_head, reference_head, (w,), 4 * d * v),
        (DECODE_HEAD_INT8, fused_decode_head_int8, reference_head_int8,
         (wq, scale), d * v + 4 * v),
    ):
        tok, mx, lse = fn(x, *weights, bias)
        rt, rm, rl = ref(x, *weights, bias)
        torch.cuda.synchronize()
        wf = weights[0] if len(weights) == 1 else _dequant_kernel(*weights)
        gap = _top2_gap(x @ wf + bias)
        diff = (tok != rt).nonzero().flatten().tolist()
        for i in diff:
            print(f"[kernel] {kernel.name}: row {i} picked {tok[i].item()} vs plain "
                  f"{rt[i].item()} at plain top-2 gap {gap[i].item():.3e}")
            check(gap[i].item() < TIE_GAP, f"{kernel.name}: token differs off a near-tie")
        em = (mx - rm).abs().max().item()
        el = (lse - rl).abs().max().item()
        print(f"[kernel] {kernel.name} B={b} d={d} V={v}: tokens {b - len(diff)}/{b} "
              f"equal, max|dmax|={em:.3e} max|dlse|={el:.3e} (tol {HEAD_TOL:g} each)")
        check(em <= HEAD_TOL and el <= HEAD_TOL,
              f"{kernel.name} statistics disagree with the plain version")
        ms = cuda_ms(lambda: fn(x, *weights, bias))
        plain_ms = cuda_ms(lambda: ref(x, *weights, bias))

        def library(wf=wf):
            logits = torch.addmm(bias, x, wf)
            return torch.argmax(logits, dim=-1), torch.logsumexp(logits, dim=-1)

        lib_ms = cuda_ms(library)
        dev, per_call = device_profile(lambda: fn(x, *weights, bias))
        check(one_a_call(per_call), f"{kernel.name}: {per_call} device operations a call")
        lib_dev = device_ms(library)
        cold = cold_ms(lambda: fn(x, *weights, bias))
        bnd, by = bound(wbytes + 4 * (b * d + v) + 12 * b, 2 * b * d * v + b * v)
        print(f"[kernel] {kernel.name}: kernel {ms:.4f} ms (device {dev:.4f}, "
              f"{per_call:g} device kernel a call; cold L2 {cold:.4f}), plain "
              f"{plain_ms:.4f} ms, addmm+argmax+logsumexp {lib_ms:.4f} ms (device "
              f"{lib_dev:.4f}), bound {bnd:.5f} ms ({by}; {bnd / cold:.0%} of it cold, "
              f"{bnd / dev:.0%} warm)")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=max(em, el), ms=ms,
                         device_ms=dev, cold_ms=cold, plain_ms=plain_ms, bound_ms=bnd,
                         bound_by=by, library_ms=lib_ms, library_device_ms=lib_dev))
    return rows


def _router_groups(gen, m: int, e: int):
    """Group sizes [E] int32 on the card: a real router's top-1 over seeded
    features ([m, 512] @ [512, E], skewed toward expert 0 by a bias) for
    m − 192 rows, leaving 192 tail rows; and a set with empty groups and a
    collapsed one (every row but the tail in one expert)."""
    import torch

    used = m - 192
    feats = torch.randn((used, 512), generator=gen).cuda()
    router = (torch.randn((512, e), generator=gen) / 512 ** 0.5).cuda()
    bias = torch.linspace(1.0, 0.0, e, device=feats.device)
    top1 = torch.argmax(torch.softmax(feats @ router + bias, dim=-1), dim=-1)
    routed = torch.bincount(top1, minlength=e).to(torch.int32)
    empty = torch.zeros(e, dtype=torch.int32, device=feats.device)
    empty[::2] = used // ((e + 1) // 2)
    empty[0] += used - int(empty.sum())
    collapsed = torch.zeros(e, dtype=torch.int32, device=feats.device)
    collapsed[e - 1] = used
    return {"router": routed, "empty": empty, "collapsed": collapsed}


def _grouped_mm(x, g, gs, want):
    """``torch._grouped_mm(xᵀ, g, offs=cumsum(sizes))``, the one PyTorch call
    that computes the grouped dW: (call, output dtype, max|err|/max|plain|),
    or (None, why the card's torch refused it, None). A yardstick the port
    never calls; its output is in the operand dtype."""
    import torch

    offs = torch.cumsum(gs, 0).to(torch.int32)
    try:
        got = torch._grouped_mm(x.t(), g, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, AttributeError, NotImplementedError) as err:
        return None, f"{type(err).__name__}: {str(err).splitlines()[0][:160]}", None
    return (lambda: torch._grouped_mm(x.t(), g, offs=offs)), str(got.dtype)[6:], \
        rel_to_max(got, want)


def grouped_dw_phase(gen) -> list[dict]:
    """Kernel 16 and its bf16 twin against ``grouped_dw_reference`` at the
    MoE step's shapes (module docstring, phase 3), bitwise equal on a
    repeat; times at E = 8 and E = 4, dW1 and dW2 shapes, on the router's
    groups and on the collapsed set (every routed row in one expert: the
    case the row split is for; its ratio to the router's time), beside the
    bound (data-dependent: the routed rows' bytes and products; the tail
    rows are never read), the plain version, per-expert ``torch.matmul``
    and ``torch._grouped_mm`` (``library_ms`` where the card's torch takes
    it, else the per-expert chain); then one slab of 60000 rows (GDW_LONG),
    past the bf16 twin's 2048-row chunk cap."""
    import torch

    from tpudml_torch.ops import (
        GROUPED_DW, GROUPED_DW_BF16, grouped_dw, grouped_dw_plan, grouped_dw_reference,
    )

    rows = []
    for dtype, kernel in ((torch.float32, GROUPED_DW), (torch.bfloat16, GROUPED_DW_BF16)):
        tag = str(dtype)[6:]
        worst, times = 0.0, {}
        for e in MOE_EXPERTS:
            sets = _router_groups(gen, GDW_M, e)
            for k, n in GDW_SHAPES:
                x = torch.randn((GDW_M, k), generator=gen).cuda().to(dtype)
                g = (torch.randn((GDW_M, n), generator=gen) / GDW_M ** 0.5).cuda().to(dtype)
                for name, gs in sets.items():
                    got = grouped_dw(x, g, gs)
                    again = grouped_dw(x, g, gs)
                    want = grouped_dw_reference(x, g, gs)
                    torch.cuda.synchronize()
                    err = rel_to_max(got, want)
                    print(f"[kernel] {kernel.name} M={GDW_M} k={k} n={n} E={e} {name} groups "
                          f"{gs.tolist()}: max|err|/max|plain| {err:.3e} (tol {GDW_TOL:g}); "
                          f"repeat bitwise equal: {torch.equal(got, again)}")
                    check(err <= GDW_TOL and got.dtype == torch.float32,
                          f"{kernel.name} disagrees with its plain version (E={e}, k={k}, "
                          f"{name} groups)")
                    check(torch.equal(got, again), f"{kernel.name} is not bitwise repeatable")
                    worst = max(worst, (got - want).abs().max().item())
                gs = sets["router"]
                sizes = gs.tolist()
                slabs, lo = [], 0
                for size in sizes:
                    slabs.append((lo, lo + size))
                    lo += size
                ms = cuda_ms(lambda: grouped_dw(x, g, gs), iters=20)
                collapsed = sets["collapsed"]
                collapsed_ms = cuda_ms(lambda: grouped_dw(x, g, collapsed), iters=20)
                plain_ms = cuda_ms(lambda: grouped_dw_reference(x, g, gs), iters=10)
                chain_ms = cuda_ms(lambda: [torch.matmul(x[a:b].T, g[a:b]) for a, b in slabs],
                                   iters=10)
                gmm, gmm_dtype, gmm_err = _grouped_mm(x, g, gs, grouped_dw_reference(x, g, gs))
                gmm_ms = None if gmm is None else cuda_ms(gmm, iters=20)
                esz = x.element_size()
                nbytes = sum(sizes) * (k + n) * esz + e * k * n * 4 + 4 * e
                flops = 2 * sum(sizes) * k * n
                peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
                bnd, by = bound(nbytes, flops, peak)
                gmm_text = (f"torch._grouped_mm {gmm_ms:.4f} ms ({gmm_dtype} out, max|err|/max "
                            f"{gmm_err:.2e})" if gmm is not None else
                            f"torch._grouped_mm refused ({gmm_dtype})")
                print(f"[kernel] {kernel.name} M={GDW_M} k={k} n={n} E={e} {tag} router groups: "
                      f"kernel {ms:.4f} ms ({tflops(flops, ms):.1f} TFLOP/s), collapsed "
                      f"{collapsed_ms:.4f} ms ({collapsed_ms / ms:.3f}x router), plain "
                      f"{plain_ms:.4f} ms, per-expert torch.matmul {chain_ms:.4f} ms, "
                      f"{gmm_text}, bound {bnd:.5f} ms ({by})")
                row = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                    library_ms=chain_ms if gmm is None else gmm_ms,
                    library=(f"per-expert torch.matmul(x[slab].T, g[slab]), {tag} "
                             f"(torch._grouped_mm refused: {gmm_dtype})" if gmm is None else
                             f"torch._grouped_mm(x.T, g, offs), {gmm_dtype} out"),
                    chain_ms=chain_ms, collapsed_ms=collapsed_ms,
                    shape=f"M={GDW_M} k={k} n={n} E={e} {tag} (router groups {sizes})")
                if dtype == torch.bfloat16:  # near 0.1 ms: the device's own time too
                    row["device_ms"] = device_ms(lambda: grouped_dw(x, g, gs))
                    row["collapsed_device_ms"] = device_ms(lambda: grouped_dw(x, g, collapsed))
                    if gmm is not None:
                        row["library_device_ms"] = device_ms(gmm)
                    print(f"[kernel] {kernel.name} M={GDW_M} k={k} n={n} E={e} {tag} device: "
                          f"router {row['device_ms']:.4f} ms, collapsed "
                          f"{row['collapsed_device_ms']:.4f} ms, torch._grouped_mm "
                          f"{row.get('library_device_ms')}")
                times[(e, k, n)] = row
            torch.cuda.empty_cache()
        # A slab past the bf16 twin's chunk cap: R = 2048 rows in bf16 (one
        # wgmma chain a chunk), 8000 in f32.
        m, k, n = GDW_LONG
        x = torch.randn((m, k), generator=gen).cuda().to(dtype)
        g = torch.randn((m, n), generator=gen).cuda().to(dtype)
        gs = torch.tensor([0, m - 5536, 0, 0], dtype=torch.int32).cuda()
        got, want = grouped_dw(x, g, gs), grouped_dw_reference(x, g, gs)
        err = rel_to_max(got, want)
        rows_r = grouped_dw_plan(m, k, n, 4, dtype)["rows"]
        print(f"[kernel] {kernel.name} M={m} k={k} n={n} one slab of {m - 5536} rows in "
              f"chunks of <= {rows_r}: max|err|/max|plain| {err:.3e} (tol {GDW_TOL:g})")
        check(err <= GDW_TOL and torch.equal(got, grouped_dw(x, g, gs)),
              f"{kernel.name} disagrees with its plain version on a long slab")
        del x, g, got, want
        torch.cuda.empty_cache()
        main = (8, *GDW_SHAPES[0])
        row = dict(name=kernel.name, route="cuda", source=kernel.source,
                   replaces=kernel.replaces, max_abs_err=worst, **times[main])
        row["shape"] += " (MoE dW1)"
        row["at"] = [t for key, t in times.items() if key != main]
        rows.append(row)
    return rows


def _fold_width(row: dict, key: str, err: float, times: dict | None = None) -> None:
    """Record a wide instance's error (and times) under ``at_widths[key]``
    of ``row`` and fold the error into its ``max_abs_err``."""
    at = row.setdefault("at_widths", {}).setdefault(key, {"max_abs_err": 0.0})
    at["max_abs_err"] = max(at["max_abs_err"], err)
    if times:
        at.update(times)
    row["max_abs_err"] = max(row["max_abs_err"], err)


def _ln_wide_check(gen, n: int, d: int, dtype, offset: int = 0) -> tuple:
    """Kernels 6–9 (the twin of ``dtype``) at rows [n, d] whose base lies
    ``offset`` elements into their buffers, against their plain versions
    with the tolerances of the main shapes; the backward (ds given and
    None) bitwise equal on a repeat. Returns (errors by kernel name, the
    rows, the forward and backward plans)."""
    import torch

    from tpudml_torch.ops import (
        add_layernorm_backward, add_layernorm_backward_reference, add_layernorm_forward,
        add_layernorm_forward_reference, layernorm_backward, layernorm_backward_reference,
        layernorm_forward, layernorm_forward_reference,
    )
    from tpudml_torch.ops.layernorm_kernel import plan_for

    bf16 = dtype == torch.bfloat16
    row_tol = BF16_REL if bf16 else LN_ROW_TOL
    tag = f"N={n} d={d} {'bf16' if bf16 else 'f32'}" + (f" base+{offset}" if offset else "")

    def err_of(got, want):  # stored in the rows' dtype: of max in bf16
        return rel_to_max(got, want) if bf16 else (got - want).abs().max().item()

    def rows_():
        buf = torch.randn((n * d + offset,), generator=gen).to(dtype).cuda()
        return buf[offset:].view(n, d)

    x, r, dy, ds = rows_(), rows_(), rows_(), rows_()
    scale = (1 + 0.1 * torch.randn((d,), generator=gen)).cuda()
    bias = (0.1 * torch.randn((d,), generator=gen)).cuda()
    s, y, mean, rstd = add_layernorm_forward(x, r, scale, bias)
    rs, ry, rmean, rrstd = add_layernorm_forward_reference(x, r, scale, bias)
    estat = max((mean - rmean).abs().max().item(), (rstd - rrstd).abs().max().item())
    ef = max(err_of(s, rs), err_of(y, ry))
    check(ef <= row_tol and estat <= LN_ROW_TOL,
          f"add+LN forward disagrees with its plain version at {tag}")
    eb = 0.0
    for dsv in (ds, None):
        got = add_layernorm_backward(rs, scale, dy, dsv, rmean, rrstd)
        again = add_layernorm_backward(rs, scale, dy, dsv, rmean, rrstd)
        rdx, rdg, rdb = add_layernorm_backward_reference(rs, scale, dy, dsv, rmean, rrstd)
        ecol = max(rel_to_max(got[1], rdg), rel_to_max(got[2], rdb))
        check(err_of(got[0], rdx) <= row_tol and ecol <= LN_COL_RTOL,
              f"add+LN backward disagrees with its plain version at {tag}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"add+LN backward is not bitwise equal on a repeat at {tag}")
        eb = max(eb, err_of(got[0], rdx), ecol)
    ly, lmean, lrstd = layernorm_forward(x, scale, bias)
    rly, _, _ = layernorm_forward_reference(x, scale, bias)
    lx, lg, lb = layernorm_backward(x, scale, dy, lmean, lrstd)
    rlx, rlg, rlb = layernorm_backward_reference(x, scale, dy, lmean, lrstd)
    el = err_of(ly, rly)
    elcol = max(rel_to_max(lg, rlg), rel_to_max(lb, rlb))
    check(el <= row_tol and err_of(lx, rlx) <= row_tol and elcol <= LN_COL_RTOL,
          f"LayerNorm kernels disagree with their plain versions at {tag}")
    fplan, bplan = plan_for(x, r, scale, bias, backward=False), plan_for(x, scale, dy, ds,
                                                                         backward=True)
    print(f"[kernel] wide LayerNorm {tag}: forward {fplan.instance}"
          f"{'' if fplan.vector else ' scalar'} ({fplan.threads} threads), backward "
          f"{bplan.instance}{'' if bplan.vector else ' scalar'} ({bplan.threads} threads, "
          f"G={bplan.blocks}, {bplan.rows_per_block} rows a block); add+LN s, y {ef:.3e}, "
          f"mean/rstd {estat:.3e}, dx and dgamma/dbeta {eb:.3e}; LN y {el:.3e}, dx and "
          f"dgamma/dbeta {max(err_of(lx, rlx), elcol):.3e} (rows tol {row_tol:g}"
          f"{' of max' if bf16 else ''}, stats {LN_ROW_TOL:g}, columns {LN_COL_RTOL:g} of "
          f"max); backward bitwise equal on a repeat")
    errs = {"add_layernorm_fwd": max(ef, estat), "add_layernorm_bwd": eb,
            "layernorm_fwd": el, "layernorm_bwd": max(err_of(lx, rlx), elcol)}
    return errs, (x, r, dy, ds, scale, bias, rs, rmean, rrstd, lmean, lrstd), fplan, bplan


def ln_wide_phase(gen, rows: dict) -> None:
    """Kernels 6–9 and their bf16 twins at widths past the 1024 columns a
    warp holds in registers (their wide instances): at each width of
    LN_SWEEP, N·d = LN_SWEEP_ELEMS, add+LN forward and backward (ds given
    and None) and the plain LayerNorm against the plain versions, then
    timed beside the bound and ``F.layer_norm`` (forward, and
    forward+backward minus forward), with device times; then at each of
    LN_CHECKS against the plain versions only."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        add_layernorm_backward, add_layernorm_backward_reference, add_layernorm_forward,
        add_layernorm_forward_reference, layernorm_backward, layernorm_backward_reference,
        layernorm_forward, layernorm_forward_reference,
    )

    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        sfx, tag = ("_bf16", "bf16") if bf16 else ("", "f32")
        e = 2 if bf16 else 4
        peak = H100_BF16_FLOPS if bf16 else H100_F32_FLOPS
        for d in LN_SWEEP:
            n = LN_SWEEP_ELEMS // d
            errs, held, fplan, bplan = _ln_wide_check(gen, n, d, dtype)
            x, r, dy, ds, scale, bias, rs, rmean, rrstd, lmean, lrstd = held
            # F.layer_norm with γ, β in the rows' dtype; its backward is
            # forward+backward minus forward, as at the main shapes.
            leaves = [t.clone().requires_grad_() for t in (x, r, scale.to(dtype),
                                                           bias.to(dtype))]
            ln_leaves = [leaves[0], leaves[2], leaves[3]]

            def lib_add():
                s_ = leaves[0] + leaves[1]
                return s_, F.layer_norm(s_, (d,), leaves[2], leaves[3], 1e-5)

            def lib_ln():
                return F.layer_norm(ln_leaves[0], (d,), ln_leaves[1], ln_leaves[2], 1e-5)

            lib = {}
            for name, lib_fwd, lib_grad in (
                ("add_layernorm", lib_add,
                 lambda: torch.autograd.grad(lib_add(), leaves, (ds, dy))),
                ("layernorm", lib_ln, lambda: torch.autograd.grad(lib_ln(), ln_leaves, dy)),
            ):
                f_ms, f_dev = cuda_ms(lib_fwd, iters=20), device_ms(lib_fwd)
                lib[name + "_fwd"] = (f_ms, f_dev)
                lib[name + "_bwd"] = (cuda_ms(lib_grad, iters=20) - f_ms,
                                      device_ms(lib_grad) - f_dev)
            cases = (
                ("add_layernorm_fwd", lambda: add_layernorm_forward(x, r, scale, bias),
                 lambda: add_layernorm_forward_reference(x, r, scale, bias),
                 4 * n * d * e + 4 * (2 * d + 2 * n), 8 * n * d),
                ("add_layernorm_bwd",
                 lambda: add_layernorm_backward(rs, scale, dy, ds, rmean, rrstd),
                 lambda: add_layernorm_backward_reference(rs, scale, dy, ds, rmean, rrstd),
                 4 * n * d * e + 4 * (3 * d + 2 * n), 12 * n * d),
                ("layernorm_fwd", lambda: layernorm_forward(x, scale, bias),
                 lambda: layernorm_forward_reference(x, scale, bias),
                 2 * n * d * e + 4 * (2 * d + 2 * n), 8 * n * d),
                ("layernorm_bwd", lambda: layernorm_backward(x, scale, dy, lmean, lrstd),
                 lambda: layernorm_backward_reference(x, scale, dy, lmean, lrstd),
                 3 * n * d * e + 4 * (3 * d + 2 * n), 12 * n * d),
            )
            for name, fn, ref, nbytes, flops in cases:
                lib_name = ("F.layer_norm(x + r)" if name.startswith("add") else
                            "F.layer_norm") + (" fwd+bwd minus fwd" if name.endswith("bwd")
                                               else "")
                plan = bplan if name.endswith("bwd") else fplan
                t = timed(fn, ref, nbytes, flops, peak, iters=20)
                t.update(device_ms=device_ms(fn), library_ms=lib[name][0],
                         library_device_ms=lib[name][1], library=f"{lib_name} {tag}",
                         shape=f"N={n} d={d} {tag}",
                         instance=plan.instance + ("" if plan.vector else " scalar"))
                print(f"[kernel] {name}{sfx} N={n} d={d} ({t['instance']}): kernel "
                      f"{t['ms']:.4f} ms (device {t['device_ms']:.5f}, "
                      f"{t['bound_ms'] / t['device_ms']:.0%} of the bound), plain "
                      f"{t['plain_ms']:.4f} ms, {lib_name} {t['library_ms']:.4f} ms (device "
                      f"{t['library_device_ms']:.5f}), bound {t['bound_ms']:.5f} ms "
                      f"({t['bound_by']})")
                _fold_width(rows[name + sfx], f"d={d}", errs[name], t)
            del leaves, ln_leaves, held, x, r, dy, ds, rs
            torch.cuda.empty_cache()
        for n, d, offset in LN_CHECKS:
            errs, *_ = _ln_wide_check(gen, n, d, dtype, offset)
            key = f"d={d}" + (f" base+{offset}" if offset else "")
            for name, err in errs.items():
                _fold_width(rows[name + sfx], key, err)
        torch.cuda.empty_cache()


def xent_wide_phase(gen, rows: dict) -> None:
    """Kernels 10–15 at widths no multiple of the forward's 8-deep stage and
    past the lean kernels' 512-column chunk (XENT_WIDE), f32
    and bf16, N = V = 1000 with labels −1 and V, against their plain
    versions with the tolerances of the main shapes; then timed in f32 at
    XENT_WIDE_TIMED (all six) and at d = 12 (the forward's ragged
    instance)."""
    import torch

    for d in XENT_WIDE:
        for dtype in (torch.float32, torch.bfloat16):
            errs = xent_check(gen, 1000, d, 1000, dtype, True)
            for name, e in xent_lean_check(gen, 1000, d, 1000, dtype, True).items():
                errs[name] = max(errs.get(name, 0.0), e)
            for name, e in errs.items():
                _fold_width(rows[name], f"d={d}", e)
        torch.cuda.empty_cache()
    n, d, v = XENT_WIDE_TIMED
    times = xent_times(gen, torch.float32, (n, d, v), "wide head")
    times.update(xent_lean_times(gen, n, torch.float32, dv=(d, v)))
    for name, t in times.items():
        _fold_width(rows[name], f"d={d}", 0.0, t)
    n, _, v = XENT_SHAPE
    for name, t in xent_times(gen, torch.float32, (n, XENT_WIDE[0], v), "ragged d").items():
        if name in ("xent_fwd", "xent_fwd_save"):
            _fold_width(rows[name], f"d={XENT_WIDE[0]}", 0.0, t)
    torch.cuda.empty_cache()


def head_wide_phase(gen, rows: dict) -> None:
    """Kernels 4 and 5 at d = 8192 (HEAD_WIDE), where each warp stages its
    1024 (f32) or 2048 (int8) rows of x in chunks of 128 or 256, against
    the plain version, one launch and one device kernel a call, timed
    (wrapper and device) beside the bound and the library call."""
    import torch

    from tpudml_torch.ops import (
        DECODE_HEAD, DECODE_HEAD_INT8, fused_decode_head, fused_decode_head_int8,
        reference_head, reference_head_int8,
    )
    from tpudml_torch.serve.fleet.quant import _dequant_kernel, _quant_kernel

    b, d, v = HEAD_WIDE
    x = torch.randn((b, d), generator=gen).cuda()
    w = ((torch.rand((d, v), generator=gen) * 2 - 1) / d ** 0.5).cuda()
    bias = ((torch.rand((v,), generator=gen) * 2 - 1) / d ** 0.5).cuda()
    wq, scale = _quant_kernel(w)
    for kernel, fn, ref, weights, wbytes in (
        (DECODE_HEAD, fused_decode_head, reference_head, (w,), 4 * d * v),
        (DECODE_HEAD_INT8, fused_decode_head_int8, reference_head_int8,
         (wq, scale), d * v + 4 * v),
    ):
        before = kernel.launches
        tok, mx, lse = fn(x, *weights, bias)
        rt, rm, rl = ref(x, *weights, bias)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"{kernel.name} at d={d}: not one launch")
        wf = weights[0] if len(weights) == 1 else _dequant_kernel(*weights)
        gap = _top2_gap(x @ wf + bias)
        diff = (tok != rt).nonzero().flatten().tolist()
        for i in diff:
            check(gap[i].item() < TIE_GAP, f"{kernel.name}: token differs off a near-tie at d={d}")
        em, el = (mx - rm).abs().max().item(), (lse - rl).abs().max().item()
        check(em <= HEAD_TOL and el <= HEAD_TOL,
              f"{kernel.name} statistics disagree with the plain version at d={d}")

        def library(wf=wf):
            logits = torch.addmm(bias, x, wf)
            return torch.argmax(logits, dim=-1), torch.logsumexp(logits, dim=-1)

        t = timed(lambda: fn(x, *weights, bias), lambda: ref(x, *weights, bias),
                  wbytes + 4 * (b * d + v) + 12 * b, 2 * b * d * v + b * v, lib=library,
                  iters=20)
        dev, per_call = device_profile(lambda: fn(x, *weights, bias), calls=50)
        check(one_a_call(per_call), f"{kernel.name} at d={d}: {per_call} device operations a call")
        t.update(shape=f"B={b} d={d} V={v}", library="addmm+argmax+logsumexp",
                 device_ms=dev, library_device_ms=device_ms(library, calls=50))
        print(f"[kernel] {kernel.name} B={b} d={d} V={v} (x staged in chunks): tokens "
              f"{b - len(diff)}/{b} equal, max|dmax| {em:.3e}, max|dlse| {el:.3e} (tol "
              f"{HEAD_TOL:g}); kernel {t['ms']:.4f} ms (device {dev:.4f}, {per_call:g} "
              f"device kernel a call), plain {t['plain_ms']:.4f} ms, addmm+argmax+logsumexp "
              f"{t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f}), bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}; {t['bound_ms'] / dev:.0%} of it)")
        _fold_width(rows[kernel.name], f"d={d}", max(em, el), t)
        del wf
    del x, w, wq
    torch.cuda.empty_cache()


def grid_edge_phase(gen) -> None:
    """Kernels 10–13 and the flash forward, dQ and dK/dV past the old
    grid-y edges (module docstring, phase 3), against their plain versions
    in row chunks (xent; kernel 13's plain dW and db summed over the
    chunks) or on the whole batch (flash)."""
    import torch

    from tpudml_torch.ops import (
        flash_dkdv, flash_dkdv_reference, flash_dq, flash_dq_reference, flash_forward_lse,
        flash_forward_lse_reference, xent_dw, xent_dw_reference, xent_dx, xent_dx_reference,
        xent_forward, xent_forward_save, xent_forward_save_reference,
    )

    n, d, v = XENT_EDGE
    cgen = torch.Generator(device="cuda").manual_seed(2)
    x, w, b, y = _xent_inputs(cgen, n, d, v, torch.float32, bad_labels=True)
    lse0, picked0 = xent_forward(x, w, b, y)
    lse, picked, s = xent_forward_save(x, w, b, y)
    dx = xent_dx(s, w, y, lse, 1.0 / n)
    dw, db = xent_dw(s, x, y, lse, 1.0 / n)
    torch.cuda.synchronize()
    e_fwd = e_dx = m_dx = 0.0
    rdw = rdb = 0.0
    for r in (slice(i, i + XENT_EDGE_CHUNK) for i in range(0, n, XENT_EDGE_CHUNK)):
        rlse, rpicked, rs = xent_forward_save_reference(x[r], w, b, y[r])
        for got, want in ((lse0[r], rlse), (lse[r], rlse), (picked0[r], rpicked),
                          (picked[r], rpicked), (s[r], rs)):
            err = (got - want).abs()
            check(bool((err <= XENT_ROW_TOL * (1 + want.abs())).all()),
                  f"xent forward disagrees with its plain version at N={n}")
            e_fwd = max(e_fwd, err.max().item())
        rdx = xent_dx_reference(rs, w, y[r], rlse, 1.0 / n)
        e_dx = max(e_dx, (dx[r] - rdx).abs().max().item())
        m_dx = max(m_dx, rdx.abs().max().item())
        pw, pb = xent_dw_reference(rs, x[r], y[r], rlse, 1.0 / n)
        rdw, rdb = rdw + pw, rdb + pb
    del x, s, dx
    torch.cuda.empty_cache()
    r_dw, r_db = rel_to_max(dw, rdw), rel_to_max(db, rdb)
    print(f"[kernel] xent N={n} d={d} V={v} f32 (65,537 row tiles, plain in "
          f"{XENT_EDGE_CHUNK}-row chunks): kernels 10, 11 max|dlse|,|dpicked|,|ds| {e_fwd:.3e} "
          f"(|err| <= {XENT_ROW_TOL:g}·(1+|plain|)); kernel 12 dx {e_dx / m_dx:.3e}, kernel 13 "
          f"dw {r_dw:.3e}, db {r_db:.3e} of max (tol {XENT_GRAD_REL:g}; plain dW, db summed "
          f"over the chunks)")
    check(e_dx <= XENT_GRAD_REL * m_dx, f"xent dx disagrees with its plain version at N={n}")
    check(r_dw <= XENT_GRAD_REL and r_db <= XENT_GRAD_REL,
          f"xent dw/db disagree with their plain version at N={n}")

    bsz, t, h, hd = FLASH_EDGE
    q, k, v_, do = (torch.randn((bsz, t, h, hd), generator=gen).cuda() for _ in range(4))
    o, lse = flash_forward_lse(q, k, v_, causal=True)
    ro, rlse = flash_forward_lse_reference(q, k, v_, causal=True)
    torch.cuda.synchronize()
    e_f = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
    check(e_f <= FLASH_TOL, f"flash forward disagrees with its plain version at B·H={bsz * h}")
    delta = (do * ro).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v_, do, rlse, delta)
    e_dq = _grad_err(flash_dq(*args, causal=True), flash_dq_reference(*args, causal=True))
    e_kv = max(_grad_err(a, c) for a, c in zip(flash_dkdv(*args, causal=True),
                                               flash_dkdv_reference(*args, causal=True)))
    print(f"[kernel] flash B={bsz} T={t} H={h} D={hd} causal (B·H = {bsz * h}): fwd max|err| "
          f"{e_f:.3e} (tol {FLASH_TOL:g}); dq {e_dq:.3e}, dk/dv {e_kv:.3e} (|err| <= "
          f"{GRAD_ATOL:g} + {GRAD_RTOL:g}·|plain|)")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 4


def teacher_forced_check(model, requests, streams, label: str) -> int:
    """Hold every generated token against the argmax of a full forward
    (plain attention, no cache, no kernel) over prompt + the tokens
    before it; a mismatch must be a near-tie. Returns the mismatches."""
    import torch

    mismatches = 0
    with torch.inference_mode():
        for req in requests:
            toks = streams[req.rid]
            seq = torch.tensor(list(req.prompt) + toks[:-1], device=model.device)
            logits = model(seq[None])[0, len(req.prompt) - 1:]
            pick = torch.argmax(logits, dim=-1).tolist()
            gap = _top2_gap(logits)
            for i, (a, r) in enumerate(zip(toks, pick)):
                if a != r:
                    mismatches += 1
                    print(f"[serve] {label}: request {req.rid} token {i}: "
                          f"{a} vs full-forward {r}, top-2 gap {gap[i].item():.3e}")
                    check(gap[i].item() < TIE_GAP,
                          f"{label}: stream disagrees with the full forward off a near-tie")
    return mismatches


def compare_streams(model, requests, a, b, label: str) -> None:
    """Streams of two runs must match; a divergence is allowed only where
    the plain logits at the first differing token are a near-tie."""
    import torch

    for req in requests:
        sa, sb = a[req.rid], b[req.rid]
        if sa == sb:
            continue
        i = next(j for j, (x, y) in enumerate(zip(sa, sb)) if x != y)
        seq = torch.tensor(list(req.prompt) + sa[:i], device=model.device)
        with torch.inference_mode():
            gap = _top2_gap(model(seq[None])[0, -1]).item()
        print(f"[serve] {label}: request {req.rid} diverges at token {i} "
              f"({sa[i]} vs {sb[i]}), plain top-2 gap {gap:.3e}")
        check(gap < TIE_GAP, f"{label}: streams diverge off a near-tie")


def expected_flash_calls(requests, chunk: int, layers: int) -> int:
    """Flash launches one prefill of these requests needs: chunk j of a
    prompt runs j+1 window blocks per layer (its last token is decoded,
    not prefilled)."""
    n = 0
    for req in requests:
        chunks = -(-(len(req.prompt) - 1) // chunk)
        n += layers * chunks * (chunks + 1) // 2
    return n


def serve_phase(gen) -> dict[str, int]:
    import torch

    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.serve import ServeConfig, ServingEngine, poisson_workload

    model = TransformerLM(**SERVE_MODEL, device="cuda", generator=gen)
    requests, ledger = poisson_workload(
        WORKLOAD["n_requests"], float("inf"), 0, vocab_size=SERVE_MODEL["vocab_size"],
        prompt_len=WORKLOAD["prompt_len"], new_tokens=WORKLOAD["new_tokens"],
    )
    runs = (("unfused", {}), ("fused_head", {"fused_head": True}),
            ("fused_head_int8", {"fused_head": True, "weight_quant": "int8"}),
            ("unfused_int8_sim", {"weight_quant": "int8_sim"}))
    engines = {name: ServingEngine(model, ServeConfig(**SERVE_CFG, **kw), device="cuda")
               for name, kw in runs}
    for eng in engines.values():  # warm-up (library handles, allocator); not counted
        eng.run(requests[:2])
    torch.cuda.synchronize()

    reset_launch_counts()  # ---- the main path starts here
    reports, per_run = {}, {}
    for name, _ in runs:
        before = {k.name: k.launches for k in KERNELS}
        reports[name] = engines[name].run(requests)
        per_run[name] = {k.name: k.launches - before[k.name] for k in KERNELS}
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here

    streams = {}
    for name, _ in runs:
        rep = reports[name]
        lat = rep.latency_summary()
        print(f"[serve] {name}: {rep.generated_tokens} tokens, {rep.decode_steps} decode "
              f"steps, {rep.tokens_per_sec:.1f} tok/s, per-token p50/p99 "
              f"{lat['per_token_p50_s'] * 1e3:.3f}/{lat['per_token_p99_s'] * 1e3:.3f} ms, "
              f"ttft p50/p99 {lat['ttft_p50_s'] * 1e3:.1f}/{lat['ttft_p99_s'] * 1e3:.1f} ms, "
              f"launches {per_run[name]}")
        owed = sum(o["max_new_tokens"] for o in ledger.values())
        check(rep.generated_tokens == owed, f"{name}: generated {rep.generated_tokens} "
              f"tokens, the workload owes {owed}")
        streams[name] = {rid: st.tokens for rid, st in rep.requests.items()}
        check(all(0 <= t < SERVE_MODEL["vocab_size"] for s in streams[name].values()
                  for t in s), f"{name}: token out of range")

    flash_need = expected_flash_calls(requests, SERVE_CFG["prefill_chunk"],
                                      SERVE_MODEL["num_layers"])
    for name, _ in runs:
        got = per_run[name]
        check(got["flash_forward_lse"] == flash_need,
              f"{name}: {got['flash_forward_lse']} flash launches, prefill needs {flash_need}")
    steps = {name: reports[name].decode_steps for name, _ in runs}
    check(per_run["fused_head"]["fused_decode_head"] == steps["fused_head"],
          "fused f32 head must launch once per decode step")
    check(per_run["fused_head_int8"]["fused_decode_head_int8"] == steps["fused_head_int8"],
          "fused int8 head must launch once per decode step")
    check(launches["fused_decode_head"] == steps["fused_head"]
          and launches["fused_decode_head_int8"] == steps["fused_head_int8"],
          "head kernels launched outside their runs")
    print(f"[serve] launches on the main path: {launches} (flash per run {flash_need}, "
          f"one head launch = both passes of one decode step)")

    mism = teacher_forced_check(engines["unfused"].model, requests, streams["unfused"], "unfused")
    mism += teacher_forced_check(engines["fused_head"].model, requests,
                                 streams["fused_head"], "fused_head")
    mism += teacher_forced_check(engines["fused_head_int8"].model, requests,
                                 streams["fused_head_int8"], "fused_head_int8")
    compare_streams(model, requests, streams["unfused"], streams["fused_head"],
                    "fused_head vs unfused")
    compare_streams(engines["unfused_int8_sim"].model, requests,
                    streams["unfused_int8_sim"], streams["fused_head_int8"],
                    "fused_head_int8 vs unfused_int8_sim")
    print(f"[serve] streams hold against the teacher-forced full forward "
          f"({mism} near-tie mismatches) and across fused/unfused runs")
    return launches


# ------------------------------------------------------------ phase 5


def _grads(loss_fn, model, tokens, labels):
    """(loss, {name: f32 gradient}) of one loss evaluation."""
    import torch

    from tpudml_torch.train import params_of

    params = params_of(model)
    loss, _ = loss_fn(tokens, labels)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), {n: g.float() for n, g in zip(params, grads)}


def _worst(got: dict, want: dict, scale: dict) -> tuple[float, str]:
    """(largest max |got − want| / max |scale|, its parameter's name)."""
    return max((((got[n] - want[n]).abs().max()
                 / scale[n].abs().max().clamp_min(1e-30)).item(), n) for n in want)


def _train_run(ts, step, batches):
    """One step per batch ([B, T+1] token rows): (losses, ms/step over the
    steps after the first, the warm-up)."""
    import torch

    losses, t0 = [], None
    for i, batch in enumerate(batches):
        ts, metrics = step(ts, batch[:, :-1], batch[:, 1:])
        losses.append(metrics["loss"])
        if i == 0:  # warm-up step done
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    return [float(x) for x in losses], ms


def train_phase(config: dict = TRAIN_MODEL, per_step: dict = PER_STEP,
                tag: str = "train") -> dict[str, int]:
    """Main path 2: the training slice at full width (module docstring,
    phase 5), or the same path on another ``config`` with its launches
    ``per_step`` (phase 5b, the wide trunk). Returns the launch counts of
    the kernel run."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam
    from tpudml_torch.train import TrainState, make_loss_fn, make_train_step

    kernel_model = TransformerLM(**config, impl="flash", fused_ln=True, device="cuda",
                                 generator=torch.Generator().manual_seed(1))
    plain_model = TransformerLM(**config, impl="full", fused_ln=False, device="cuda",
                                generator=torch.Generator().manual_seed(2))
    plain_model.load_state_dict(kernel_model.state_dict())  # one initial state
    n_params = sum(p.numel() for p in kernel_model.parameters())
    t, v = config["max_len"], config["vocab_size"]
    seqs = synthetic_lm(4 * TRAIN_BATCH, t, v, seed=0)
    rng = np.random.default_rng(0)  # task5's row sampling
    batches = [seqs[rng.integers(0, len(seqs), size=TRAIN_BATCH)] for _ in range(TRAIN_STEPS)]

    # Step-1 gradients of both models from the initial state (before the
    # counted run; the optimizer is not involved).
    tokens, labels = (torch.from_numpy(x).long().cuda()
                      for x in (batches[0][:, :-1], batches[0][:, 1:]))
    grads = {name: _grads(make_loss_fn(model), model, tokens, labels)[1]
             for name, model in (("kernel", kernel_model), ("plain", plain_model))}
    worst, worst_name = _worst(grads["kernel"], grads["plain"], grads["plain"])
    print(f"[{tag}] step-1 gradients, kernel vs plain run: worst max|err|/max|plain| "
          f"{worst:.3e} ({worst_name}; tol {STEP_GRAD_RTOL:g}) over {len(grads['plain'])} "
          f"parameters, {n_params} values")
    check(worst <= STEP_GRAD_RTOL, f"step-1 gradient {worst_name} disagrees with the plain run")
    del grads, tokens, labels

    def train(model):
        opt = Adam(lr=TRAIN_LR)
        return _train_run(TrainState.create(model, opt), make_train_step(model, opt), batches)

    reset_launch_counts()  # ---- the main path starts here
    k_losses, k_ms = train(kernel_model)
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    p_losses, p_ms = train(plain_model)
    check({k.name: k.launches for k in KERNELS} == launches,
          "the plain run launched a kernel")
    for name, n in launches.items():
        need = TRAIN_STEPS * per_step.get(name, 0)
        check(n == need, f"{tag} launched {name} {n} times, {TRAIN_STEPS} steps need {need}")
    tok = TRAIN_BATCH * t
    for label, losses, ms in (("kernel (flash + fused add+LN)", k_losses, k_ms),
                              ("plain (full attention, unfused LN)", p_losses, p_ms)):
        print(f"[{tag}] {label}: losses {' '.join(f'{x:.6f}' for x in losses)}; "
              f"{ms:.2f} ms/step, {tok / ms * 1e3:.0f} tokens/s (steady state, "
              f"{TRAIN_STEPS - 1} steps after one warm-up)")
    check(all(np.isfinite(k_losses + p_losses)), "a training loss is not finite")
    diffs = [abs(a - b) for a, b in zip(k_losses, p_losses)]
    print(f"[{tag}] per-step |loss difference| {' '.join(f'{x:.2e}' for x in diffs)} "
          f"(tol {LOSS_TOL:g}); launches {launches} = {TRAIN_STEPS} x {per_step}")
    check(max(diffs) <= LOSS_TOL, "training losses disagree with the plain run")
    return launches


def train_wide_phase() -> dict[str, int]:
    """Phase 5b: phase 5's path on the wide trunk (WIDE_MODEL), whose
    add+LN rows are wider than the narrow instances hold."""
    import torch

    from tpudml_torch.ops.layernorm_kernel import REGISTER_DIM, layernorm_plan

    d, tokens = WIDE_MODEL["embed_dim"], TRAIN_BATCH * WIDE_MODEL["max_len"]
    check(d > REGISTER_DIM, f"the wide trunk's d={d} takes the narrow LayerNorm instances")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = layernorm_plan(tokens, d, 4, True, sms, backward=True)
    print(f"[train_wide] d={d} > {REGISTER_DIM}: add+LN rows [{tokens}, {d}] take the "
          f"{plan.instance} instances (backward G={plan.blocks} on {sms} SMs)")
    return train_phase(WIDE_MODEL, WIDE_PER_STEP, "train_wide")


# ------------------------------------------------------------ phase 6


def flagship_phase() -> dict[str, dict[str, int]]:
    """Main path 3: the flagship step (module docstring, phase 6). Returns
    the launch counts of the bf16 kernel run ("flagship") and of the
    no-grad evaluation ("eval")."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import AdamW
    from tpudml_torch.train import (
        TrainState, make_lm_fused_loss_fn, make_lm_fused_train_step, make_loss_fn,
        make_train_step,
    )

    t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
    batch = synthetic_lm(TRAIN_BATCH, t, v, seed=1)  # bench.py:351-352
    tokens, labels = (torch.from_numpy(x).long().cuda() for x in (batch[:, :-1], batch[:, 1:]))

    def model(seed, **kw):
        return TransformerLM(**TRAIN_MODEL, **kw, device="cuda",
                             generator=torch.Generator().manual_seed(seed))

    kernel_model = model(3, impl="flash", fused_ln=True, compute_dtype=torch.bfloat16)
    state = kernel_model.state_dict()

    # (a) f32 gradients through the fused head vs the materialized logits.
    f32_model = model(4, impl="flash", fused_ln=True)
    f32_model.load_state_dict(state)
    lf, g_fused = _grads(make_lm_fused_loss_fn(f32_model, save_scores=True), f32_model,
                         tokens, labels)
    lm, g_f32 = _grads(make_loss_fn(f32_model), f32_model, tokens, labels)
    worst, name = _worst(g_fused, g_f32, g_f32)
    print(f"[flagship] (a) f32 step-1 gradients, fused head vs materialized logits: worst "
          f"max|err|/max|plain| {worst:.3e} ({name}; tol {STEP_GRAD_RTOL:g}); losses "
          f"{lf:.6f} vs {lm:.6f} (tol {LOSS_TOL:g})")
    check(worst <= STEP_GRAD_RTOL, f"f32 fused-head gradient {name} disagrees")
    check(abs(lf - lm) <= LOSS_TOL, "f32 fused-head loss disagrees")
    del f32_model, g_fused
    torch.cuda.empty_cache()

    # (b) the bf16 flagship against the kernel-free bf16 step.
    plain_model = model(5, impl="full", fused_ln=False, compute_dtype=torch.bfloat16)
    plain_model.load_state_dict(state)
    _, g_kernel = _grads(make_lm_fused_loss_fn(kernel_model, save_scores=True), kernel_model,
                         tokens, labels)
    _, g_plain = _grads(make_loss_fn(plain_model), plain_model, tokens, labels)
    wk, nk = _worst(g_kernel, g_f32, g_f32)
    wp, np_ = _worst(g_plain, g_f32, g_f32)
    wkp, nkp = _worst(g_kernel, g_plain, g_plain)
    print(f"[flagship] (b) bf16 step-1 gradients vs the f32 ones: kernel run {wk:.3e} ({nk}), "
          f"plain run {wp:.3e} ({np_}) of max (tol {BF16_STEP_GRAD_RTOL:g}); kernel vs plain "
          f"{wkp:.3e} ({nkp}; tol {BF16_PAIR_GRAD_RTOL:g})")
    check(max(wk, wp) <= BF16_STEP_GRAD_RTOL, "a bf16 step-1 gradient is off the f32 one")
    check(wkp <= BF16_PAIR_GRAD_RTOL, f"bf16 gradient {nkp}: kernel and plain runs disagree")
    del g_kernel, g_plain, g_f32
    torch.cuda.empty_cache()

    def run(m, fused):
        opt = AdamW(lr=FLAGSHIP_LR)
        step = (make_lm_fused_train_step(m, opt, save_scores=True) if fused
                else make_train_step(m, opt))
        return _train_run(TrainState.create(m, opt), step, [batch] * FLAGSHIP_STEPS)

    reset_launch_counts()  # ---- main path 3 starts here
    k_losses, k_ms = run(kernel_model, True)
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    p_losses, p_ms = run(plain_model, False)
    check({k.name: k.launches for k in KERNELS} == launches, "the plain bf16 run launched a kernel")
    for name, n in launches.items():
        need = FLAGSHIP_STEPS * FLAGSHIP_PER_STEP.get(name, 0)
        check(n == need, f"the flagship launched {name} {n} times, {FLAGSHIP_STEPS} steps "
              f"need {need}")
    tok = TRAIN_BATCH * t
    for label, losses, ms in (("kernel (bf16 flash, fused add+LN, fused xent head)",
                               k_losses, k_ms),
                              ("plain (bf16 full attention, unfused LN, materialized logits)",
                               p_losses, p_ms)):
        print(f"[flagship] {label}: losses {' '.join(f'{x:.6f}' for x in losses)}; "
              f"{ms:.2f} ms/step, {tok / ms * 1e3:.0f} tokens/s (steady state, "
              f"{FLAGSHIP_STEPS - 1} steps after one warm-up)")
    check(all(np.isfinite(k_losses + p_losses)), "a flagship loss is not finite")
    diffs = [abs(a - b) for a, b in zip(k_losses, p_losses)]
    print(f"[flagship] per-step |loss difference| {' '.join(f'{x:.2e}' for x in diffs)} "
          f"(tol {BF16_LOSS_TOL:g}); launches {launches} = {FLAGSHIP_STEPS} x "
          f"{FLAGSHIP_PER_STEP}")
    check(max(diffs) <= BF16_LOSS_TOL, "flagship losses disagree with the plain bf16 run")
    del plain_model
    torch.cuda.empty_cache()

    # (c) an evaluation loss under no_grad: kernel 10.
    reset_launch_counts()  # ---- the evaluation path starts here
    with torch.no_grad():
        fused_eval, _ = make_lm_fused_loss_fn(kernel_model, save_scores=True)(tokens, labels)
    eval_launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    with torch.no_grad():
        mat_eval, _ = make_loss_fn(kernel_model)(tokens, labels)
    diff = abs(fused_eval.item() - mat_eval.item())
    print(f"[flagship] (c) no-grad loss through kernel 10 {fused_eval.item():.6f} vs "
          f"materialized bf16 logits {mat_eval.item():.6f}: |diff| {diff:.2e} (tol "
          f"{BF16_LOSS_TOL:g}); launches {dict((k, n) for k, n in eval_launches.items() if n)}")
    check(eval_launches["xent_fwd"] == 1 and eval_launches["xent_fwd_save"] == 0,
          "the no-grad loss did not run kernel 10 alone")
    check(diff <= BF16_LOSS_TOL, "kernel 10's loss disagrees with the materialized loss")
    return {"flagship": launches, "eval": eval_launches}


# ------------------------------------------------------------ phase 6b


DP_SPLIT_STEPS = 3  # the split step's run; every step's comm span is checked
DP_TASK5 = ["--parallel", "dp", "--n_devices", "1", "--vocab", "32768", "--embed_dim", "512",
            "--num_heads", "4", "--num_layers", "6", "--seq_len", "1024", "--batch_size", "8",
            "--attn", "flash", "--fused_ln", "--rope", "--fused_xent", "--steps", "8",
            "--log_every", "1", "--lr", "1e-3"]
DP_BENCH = ["--device", "cuda", "--iters", "20"]
# Where the single-card step does not repeat itself, the world-1 DP run
# may differ from it by at most this many times the gap between two
# single-card runs (in losses and in parameters).
DP_GAP_MULT = 4


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _bitwise(a: dict, b: dict) -> bool:
    import torch

    return all(torch.equal(a[n], b[n]) for n in a)


def dp_phase() -> dict[str, dict[str, int]]:
    """Main path 3b: the flagship step data-parallel at world 1 over NCCL
    (module docstring, phase 6b). Returns the launch counts of the DP
    flagship run ("dp") and of the split step ("dp_split")."""
    import contextlib
    import io
    import math
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch.comm import AGGREGATORS, bench
    from tpudml_torch.core import DistributedConfig, process_count, process_group
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam, AdamW
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.tasks import task5_longcontext as task5
    from tpudml_torch.tools.profile_train import collective_breakdown, describe_aggregation
    from tpudml_torch.train import TrainState, make_lm_fused_train_step

    t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
    batch = synthetic_lm(TRAIN_BATCH, t, v, seed=1)  # the flagship phase's
    bf16 = dict(compute_dtype=torch.bfloat16)

    def model(seed, **kw):
        return TransformerLM(**TRAIN_MODEL, **kw, device="cuda",
                             generator=torch.Generator().manual_seed(seed))

    with tempfile.TemporaryDirectory() as tmp, process_group(
            DistributedConfig(coordinator_address=f"file://{tmp}/store", num_processes=1),
            device="cuda") as group:
        check(torch.distributed.get_backend(group) == "nccl", "the DP group is not NCCL's")
        check(process_count(group) == 1, "the DP group is not one rank")
        print(f"[dp] world 1: a one-rank NCCL group (torch.distributed, file store); "
              f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}")

        # (1) Does the single-card flagship step repeat itself bitwise?
        def single():
            m = model(3, impl="flash", fused_ln=True, **bf16)
            opt = AdamW(lr=FLAGSHIP_LR)
            losses, ms = _train_run(TrainState.create(m, opt),
                                    make_lm_fused_train_step(m, opt, save_scores=True),
                                    [batch] * FLAGSHIP_STEPS)
            return losses, ms, _params(m)

        s1_losses, s1_ms, s1_params = single()
        s2_losses, s2_ms, s2_params = single()
        repeats = s1_losses == s2_losses and _bitwise(s1_params, s2_params)
        print(f"[dp] single-card flagship step repeats itself bitwise over {FLAGSHIP_STEPS} "
              f"steps: {repeats}")
        torch.cuda.empty_cache()

        # (2) The DP flagship: the launches of its run are the path's.
        dp_model = model(3, impl="full", fused_ln=True, **bf16)
        check(_bitwise(_params(dp_model), _params(model(3, impl="flash", fused_ln=True, **bf16))),
              "the DP and single-card models start apart")
        dp = DataParallel(dp_model, AdamW(lr=FLAGSHIP_LR), group, fused_xent=True,
                          save_scores=True, flash_attn=True)
        check(dp_model.impl == "flash", "flash_attn did not swap the trunk")
        ts = dp.create_state()
        reset_launch_counts()  # ---- main path 3b starts here
        d_losses, d_ms = _train_run(ts, dp.make_train_step(), [batch] * FLAGSHIP_STEPS)
        launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        d_params = _params(dp_model)
        for name, n in launches.items():
            need = FLAGSHIP_STEPS * FLAGSHIP_PER_STEP.get(name, 0)
            check(n == need, f"the DP flagship launched {name} {n} times, {FLAGSHIP_STEPS} "
                  f"steps need {need}")
        print(f"[dp] DP flagship losses {' '.join(f'{x:.6f}' for x in d_losses)}; single-card "
              f"{' '.join(f'{x:.6f}' for x in s1_losses)}; launches {launches} = "
              f"{FLAGSHIP_STEPS} x {FLAGSHIP_PER_STEP}")
        if repeats:
            check(d_losses == s1_losses, "world-1 DP losses differ from the single-card step's")
            check(_bitwise(d_params, s1_params), "world-1 DP parameters differ from the "
                  "single-card step's")
            print("[dp] world-1 DP step equals the single-card step bitwise (losses and all "
                  f"{len(d_params)} parameters)")
        else:
            def gaps(losses, params):
                return (max(abs(a - b) for a, b in zip(losses, s1_losses)),
                        max((params[n] - s1_params[n]).abs().max().item() for n in params))

            (ldiff, worst), (lgap, pgap) = gaps(d_losses, d_params), gaps(s2_losses, s2_params)
            print(f"[dp] the single-card step is not deterministic (two runs differ by "
                  f"|loss| {lgap:.2e}, |param| {pgap:.2e}): world-1 DP vs single |loss diff| "
                  f"{ldiff:.2e}, max |param diff| {worst:.2e} (tol {DP_GAP_MULT} x the gap)")
            check(ldiff <= DP_GAP_MULT * lgap and worst <= DP_GAP_MULT * pgap,
                  "world-1 DP disagrees with the single-card step")
        check(all(np.isfinite(d_losses)), "a DP flagship loss is not finite")

        # The collective alone on the flagship's gradients (52.5M f32).
        grads, _ = dp.local_grads(ts, batch[:, :-1], batch[:, 1:])
        nbytes = sum(g.numel() * g.element_size() for g in grads.values())
        for name, aggregator in AGGREGATORS.items():
            agg = lambda aggregator=aggregator: aggregator(grads, group)  # noqa: E731
            wall = cuda_ms(agg, iters=20, warmup=3)
            p = collective_breakdown(agg, 20)
            print(f"[dp] world 1 {name} of the flagship gradients ({len(grads)} tensors, "
                  f"{nbytes / 1e6:.1f} MB f32): {wall:.4f} ms a call (CUDA events); "
                  f"{describe_aggregation(p)}")
            check(p["dispatched"] >= 1, f"the world-1 {name} dispatched no collective")
        print(f"[dp] world 1 flagship step: DP {d_ms:.2f} ms/step vs single-card "
              f"{s1_ms:.2f}, {s2_ms:.2f} ms/step (steady state, {FLAGSHIP_STEPS - 1} steps)")
        del dp, dp_model, ts, grads, s1_params, s2_params, d_params
        torch.cuda.empty_cache()

        # (3) The split step (measure_comm, materialized logits, f32) against
        # the fused one on the training phase's config and batches.
        seqs = synthetic_lm(4 * TRAIN_BATCH, t, v, seed=0)
        rng = np.random.default_rng(0)
        batches = [seqs[rng.integers(0, len(seqs), size=TRAIN_BATCH)]
                   for _ in range(DP_SPLIT_STEPS)]

        def dp_run(measure_comm):
            m = model(1, impl="full", fused_ln=True)
            eng = DataParallel(m, Adam(lr=TRAIN_LR), group, measure_comm=measure_comm,
                               flash_attn=True)
            losses, ms = _train_run(eng.create_state(), eng.make_train_step(), batches)
            return losses, ms, eng.comm_stats, _params(m)

        reset_launch_counts()  # ---- the split step's path starts here
        sp_losses, sp_ms, stats, sp_params = dp_run(True)
        split_launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        fu_losses, fu_ms, _, fu_params = dp_run(False)
        for name, n in split_launches.items():
            need = DP_SPLIT_STEPS * PER_STEP.get(name, 0)
            check(n == need, f"the split step launched {name} {n} times, need {need}")
        print(f"[dp] split step (measure_comm, f32, flash, fused add+LN): losses "
              f"{' '.join(f'{x:.6f}' for x in sp_losses)} vs fused DP step "
              f"{' '.join(f'{x:.6f}' for x in fu_losses)}; {stats.calls} comm spans "
              f"{' '.join(f'{x * 1e3:.3f}' for x in stats.per_call_s)} ms; {sp_ms:.2f} vs "
              f"{fu_ms:.2f} ms/step; {stats.report()}")
        check(stats.calls == DP_SPLIT_STEPS, "the split step did not record a span a step")
        check(all(x > 0 for x in stats.per_call_s), "a comm span is not positive")
        check(sp_losses == fu_losses, "split-step losses differ from the fused step's")
        check(_bitwise(sp_params, fu_params), "split-step parameters differ from the fused "
              "step's")
        print(f"[dp] split step equals the fused DP step bitwise (losses and all "
              f"{len(sp_params)} parameters)")
        del sp_params, fu_params
        torch.cuda.empty_cache()

        # (4) task5 --parallel dp at world 1.
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = task5.main(DP_TASK5 + ["--log_dir", f"{tmp}/logs"])
        steps = [float(line.split()[-1]) for line in out.getvalue().splitlines()
                 if line.startswith("step ")]
        print(f"[dp] task5 --parallel dp: {out.getvalue().splitlines()[-1]}; losses "
              f"{' '.join(f'{x:.4f}' for x in steps)}")
        check(res["devices"] == 1, "task5 --parallel dp did not report one device")
        check(len(steps) == 8 and steps[-1] < steps[0] and math.isfinite(steps[-1]),
              "task5 --parallel dp did not learn")
        torch.cuda.empty_cache()

        # (5) comm.bench at world 1, every aggregator.
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            recs = bench.main(DP_BENCH)
        for rec in recs:
            print(f"[dp] comm.bench world {rec['world']} {rec['strategy']} "
                  f"{rec['elements']} f32: {rec['mean_ms']:.4f} ms")
        check({r["strategy"] for r in recs} == {"allreduce", "allgather", "reducescatter"}
              and all(r["world"] == 1 and r["mean_ms"] > 0 for r in recs),
              "comm.bench did not time every aggregator at world 1")
    check(not torch.distributed.is_initialized(), "the DP group outlived its phase")
    return {"dp": launches, "dp_split": split_launches}


# ------------------------------------------------------------ phase 7


def long_phase() -> dict[str, int]:
    """Main path 4: long-context training through task5's engine with the
    lean head (module docstring, phase 7). Returns the launch counts of
    the lean run."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.ops.xent_kernel import _auto_save_s
    from tpudml_torch.tasks import task5_longcontext as task5
    from tpudml_torch.train import make_lm_fused_loss_fn, make_loss_fn

    args = task5.parse_args(LONG_TASK5)
    b, t, v = args.batch_size, args.seq_len, args.vocab
    ts, step = task5.build_engine(args, torch.device("cuda"))
    lean_auto = args._save_scores is None and not _auto_save_s(b * t, v, 256, 2048)
    print(f"[long] task5 {' '.join(LONG_TASK5)}: N = B·T = {b * t}, V = {v}; save_scores "
          f"{args._save_scores} resolves to {'lean' if lean_auto else 'saved scores'}")
    check(lean_auto, "the long-context --fused_xent did not resolve to the lean head")
    sargs = task5.parse_args(LONG_TASK5 + ["--fused_xent_scores"])
    sts, sstep = task5.build_engine(sargs, torch.device("cuda"))
    sts.model.load_state_dict(ts.model.state_dict())  # one initial state
    seqs = synthetic_lm(4 * b, t, v, seed=args.seed)
    rng = np.random.default_rng(args.seed)  # task5's row sampling
    batches = [seqs[rng.integers(0, len(seqs), size=b)] for _ in range(LONG_STEPS)]

    # Step-1 gradients from the initial state, before the counted run.
    tokens, labels = (torch.from_numpy(x).long().cuda()
                      for x in (batches[0][:, :-1], batches[0][:, 1:]))
    l_lean, g_lean = _grads(make_lm_fused_loss_fn(ts.model, args._save_scores), ts.model,
                            tokens, labels)
    l_saved, g_saved = _grads(make_lm_fused_loss_fn(sts.model, True), sts.model,
                              tokens, labels)
    worst, name = _worst(g_lean, g_saved, g_saved)
    print(f"[long] step-1 gradients, lean vs saved-scores head: worst max|err|/max|saved| "
          f"{worst:.3e} ({name}; tol {STEP_GRAD_RTOL:g}); losses {l_lean:.6f} vs "
          f"{l_saved:.6f}")
    check(worst <= STEP_GRAD_RTOL, f"lean step-1 gradient {name} disagrees with saved scores")
    check(abs(l_lean - l_saved) <= LOSS_TOL, "lean and saved-scores losses disagree")
    del g_saved
    torch.cuda.empty_cache()
    l_mat, g_mat = _grads(make_loss_fn(ts.model), ts.model, tokens, labels)
    head = [n for n in g_mat if n.startswith("head.")]
    w_head, n_head = _worst({n: g_lean[n] for n in head}, {n: g_mat[n] for n in head}, g_mat)
    w_all, n_all = _worst(g_lean, g_mat, g_mat)
    print(f"[long] step-1 gradients, lean vs materialized logits: head worst "
          f"{w_head:.3e} ({n_head}), all parameters {w_all:.3e} ({n_all}; tol "
          f"{STEP_GRAD_RTOL:g}); losses {l_lean:.6f} vs {l_mat:.6f} (tol {LOSS_TOL:g})")
    check(w_all <= STEP_GRAD_RTOL, f"lean step-1 gradient {n_all} disagrees with the "
          "materialized logits")
    check(abs(l_lean - l_mat) <= LOSS_TOL, "lean and materialized-logits losses disagree")
    del g_lean, g_mat, tokens, labels
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # ---- main path 4 starts here
    l_losses, l_ms = _train_run(ts, step, batches)
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    lean_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s_losses, s_ms = _train_run(sts, sstep, batches)
    saved_peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        need = LONG_STEPS * LONG_PER_STEP.get(name, 0)
        check(n == need, f"long-context training launched {name} {n} times, "
              f"{LONG_STEPS} steps need {need}")
    tok = b * t
    for label, losses, ms, peak in (("lean head (kernels 10, 14, 15)", l_losses, l_ms,
                                     lean_peak),
                                    ("saved-scores head (kernels 11, 12, 13)", s_losses,
                                     s_ms, saved_peak)):
        print(f"[long] {label}: losses {' '.join(f'{x:.6f}' for x in losses)}; {ms:.2f} "
              f"ms/step, {tok / ms * 1e3:.0f} tokens/s (steady state, {LONG_STEPS - 1} "
              f"steps after one warm-up); peak {peak / 2**30:.3f} GiB")
    check(all(np.isfinite(l_losses + s_losses)), "a long-context loss is not finite")
    diffs = [abs(a - c) for a, c in zip(l_losses, s_losses)]
    gap = saved_peak - lean_peak
    print(f"[long] per-step |loss difference| {' '.join(f'{x:.2e}' for x in diffs)} (tol "
          f"{LOSS_TOL:g}); peak gap {gap / 2**30:.3f} GiB (need >= "
          f"{LEAN_MEM_GAP / 2**30:g}); launches {launches} = {LONG_STEPS} x {LONG_PER_STEP}")
    check(max(diffs) <= LOSS_TOL, "lean and saved-scores training losses disagree")
    check(gap >= LEAN_MEM_GAP, "the lean run's peak memory is not 3 GiB under the "
          "saved-scores run's: the O(N) contract does not hold")
    return launches


# ------------------------------------------------------------ phase 8


def ln_op_phase(gen) -> dict[str, int]:
    """The plain LayerNorm op path (module docstring, phase 8). Returns
    its launch counts."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import KERNELS, fused_layernorm, reset_launch_counts

    n, d = LN_SHAPE
    x, dy = (torch.randn((n, d), generator=gen).cuda() for _ in range(2))
    scale = (1 + 0.1 * torch.randn((d,), generator=gen)).cuda()
    bias = (0.1 * torch.randn((d,), generator=gen)).cuda()
    got = {}
    reset_launch_counts()  # ---- the op path starts here
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [x.to(dtype).requires_grad_(), scale.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
        y = fused_layernorm(*leaves)
        got[dtype] = (y, *torch.autograd.grad(y, leaves, dy.to(dtype)))
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    need = {"layernorm_fwd": 1, "layernorm_bwd": 1, "layernorm_fwd_bf16": 1,
            "layernorm_bwd_bf16": 1}
    check(launches == {k.name: need.get(k.name, 0) for k in KERNELS},
          f"the LayerNorm op path launched {launches}, not {need}")
    for dtype, (y, dx, dg, db) in got.items():
        leaves = [x.to(dtype).float().requires_grad_(), scale.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
        ry = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)
        rdx, rdg, rdb = torch.autograd.grad(ry, leaves, dy.to(dtype).float())
        bf16 = dtype == torch.bfloat16
        ey, edx = ((rel_to_max(y, ry), rel_to_max(dx, rdx)) if bf16 else
                   ((y - ry).abs().max().item(), (dx - rdx).abs().max().item()))
        ecol = max(rel_to_max(dg, rdg), rel_to_max(db, rdb))
        tol = BF16_REL if bf16 else LN_ROW_TOL
        print(f"[ln_op] fused_layernorm [{n}, {d}] {str(dtype)[6:]} vs F.layer_norm: y "
              f"{ey:.3e}, dx {edx:.3e} ({'of max, ' if bf16 else ''}tol {tol:g}); "
              f"dgamma/dbeta {ecol:.3e} of max (tol {LN_COL_RTOL:g})")
        check(y.dtype == dx.dtype == dtype and ey <= tol and edx <= tol
              and ecol <= LN_COL_RTOL, f"fused_layernorm disagrees with F.layer_norm "
              f"({dtype})")
    print(f"[ln_op] launches {dict((k, c) for k, c in launches.items() if c)}")
    return launches


# ------------------------------------------------------------ phase 9


def _set_ragged_dw(model, ragged_dw: str) -> None:
    for block in model.blocks():
        block.moe.ragged_dw = ragged_dw


def moe_phase() -> dict[str, int]:
    """Main path 5: bench_moe's six rows (module docstring, phase 9).
    Returns the launch counts of the six runs together."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import AdamW
    from tpudml_torch.tools.profile_train import MOE_VARIANTS
    from tpudml_torch.train import TrainState, make_loss_fn, make_train_step_body

    t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
    batch = torch.from_numpy(synthetic_lm(TRAIN_BATCH, t, v, seed=3)).long().cuda()  # bench.py:604
    tokens, labels = batch[:, :-1], batch[:, 1:]

    def model(e, **kw):
        return TransformerLM(**MOE_MODEL, moe_experts=e, **kw, compute_dtype=torch.bfloat16,
                             device="cuda", generator=torch.Generator().manual_seed(6))

    # Step-1 gradients: grouped-dW backward vs the stock one, same weights.
    for e in MOE_EXPERTS:
        m = model(e, moe_dispatch="ragged")
        lg, gg = _grads(make_loss_fn(m), m, tokens, labels)
        _set_ragged_dw(m, "stock")
        ls, gs = _grads(make_loss_fn(m), m, tokens, labels)
        worst, name = _worst(gg, gs, gs)
        dw = [n for n in gg if ".moe.experts.w" in n]
        wdw, ndw = _worst({n: gg[n] for n in dw}, {n: gs[n] for n in dw}, gs)
        print(f"[moe] E={e} step-1, ragged grouped-dW vs stock backward: losses {lg:.6f} vs "
              f"{ls:.6f}; gradients worst max|err|/max|stock| {worst:.3e} ({name}; tol "
              f"{BF16_PAIR_GRAD_RTOL:g}), of dW1/dW2 {wdw:.3e} ({ndw})")
        check(lg == ls, "grouped and stock ragged losses differ: the forward is the same code")
        check(worst <= BF16_PAIR_GRAD_RTOL, f"grouped-dW gradient {name} disagrees with stock")
        del m, gg, gs
        torch.cuda.empty_cache()

    reset_launch_counts()  # ---- main path 5 starts here
    per_run, results = {}, {}
    for e in MOE_EXPERTS:
        for variant, kw in MOE_VARIANTS.items():
            m = model(e, **kw)
            opt = AdamW(lr=MOE_LR)
            step = make_train_step_body(m, opt)
            before = {k.name: k.launches for k in KERNELS}
            results[(e, variant)] = _train_run(TrainState.create(m, opt), step,
                                               [batch] * MOE_STEPS)
            per_run[(e, variant)] = {k.name: k.launches - before[k.name] for k in KERNELS}
            del m, opt, step
            torch.cuda.empty_cache()
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    tok = TRAIN_BATCH * t
    for (e, variant), (losses, ms) in results.items():
        got = per_run[(e, variant)]
        per_step = dict(MOE_PER_STEP)
        if variant == "ragged_grouped":  # dW1 and dW2 of every layer
            per_step["grouped_dw_bf16"] = 2 * TRAIN_MODEL["num_layers"]
        need = {name: MOE_STEPS * n for name, n in per_step.items()}
        print(f"[moe] E={e} {variant}: losses {' '.join(f'{x:.6f}' for x in losses)}; "
              f"{ms:.2f} ms/step, {tok / ms * 1e3:.0f} tokens/s (eager, one card, no fori; "
              f"{MOE_STEPS - 1} steps after one warm-up); launches "
              f"{dict((k, c) for k, c in got.items() if c)}")
        check(all(np.isfinite(losses)), f"a MoE loss is not finite (E={e}, {variant})")
        check(got == {k.name: need.get(k.name, 0) for k in KERNELS},
              f"MoE E={e} {variant} launched {got}, {MOE_STEPS} steps need {need}")
    return launches


# ------------------------------------------------------------ phase 10


def moe_f32_phase() -> dict[str, int]:
    """Main path 6: f32 MoE training through task5 (module docstring,
    phase 10). Returns its launch counts."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.tasks import task5_longcontext as task5
    from tpudml_torch.train import make_loss_fn

    args = task5.parse_args(MOE_F32_TASK5)
    b, t, v = args.batch_size, args.seq_len, args.vocab
    ts, step = task5.build_engine(args, torch.device("cuda"))
    seqs = synthetic_lm(4 * b, t, v, seed=args.seed)
    rng = np.random.default_rng(args.seed)  # task5's row sampling
    batches = [seqs[rng.integers(0, len(seqs), size=b)] for _ in range(MOE_F32_STEPS)]
    tokens, labels = (torch.from_numpy(x).long().cuda()
                      for x in (batches[0][:, :-1], batches[0][:, 1:]))
    lg, gg = _grads(make_loss_fn(ts.model), ts.model, tokens, labels)
    _set_ragged_dw(ts.model, "stock")
    ls, gs = _grads(make_loss_fn(ts.model), ts.model, tokens, labels)
    _set_ragged_dw(ts.model, "grouped")
    worst, name = _worst(gg, gs, gs)
    print(f"[moe_f32] task5 {' '.join(MOE_F32_TASK5)}: step-1 grouped-dW vs stock backward: "
          f"losses {lg:.6f} vs {ls:.6f}; gradients worst max|err|/max|stock| {worst:.3e} "
          f"({name}; tol {STEP_GRAD_RTOL:g})")
    check(lg == ls, "f32 grouped and stock ragged losses differ")
    check(worst <= STEP_GRAD_RTOL, f"f32 grouped-dW gradient {name} disagrees with stock")
    del gg, gs, tokens, labels
    torch.cuda.empty_cache()

    reset_launch_counts()  # ---- main path 6 starts here
    losses, ms = _train_run(ts, step, batches)
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    need = {k.name: MOE_F32_STEPS * MOE_F32_PER_STEP.get(k.name, 0) for k in KERNELS}
    print(f"[moe_f32] losses {' '.join(f'{x:.6f}' for x in losses)}; {ms:.2f} ms/step, "
          f"{b * t / ms * 1e3:.0f} tokens/s (eager, one card; {MOE_F32_STEPS - 1} steps after "
          f"one warm-up); launches {dict((k, c) for k, c in launches.items() if c)}")
    check(all(np.isfinite(losses)), "an f32 MoE loss is not finite")
    check(launches == need, f"the f32 MoE path launched {launches}, not {need}")
    return launches


# ------------------------------------------------------------ phase 11

# The north star (tasks/north_star.py; bench.py:200-246 bench_resnet):
# ResNet-18 at CIFAR width, bf16 compute over f32 masters, SGD 0.1 / 0.9.
RESNET_BATCH = 1024  # bench.py:215, the per-chip batch
RESNET_CHECK_BATCH = 16  # card against the CPU (step 2), bf16 against f32 (step 3)
RESNET_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
RESNET_SGD = dict(lr=0.1, momentum=0.9)
# Step 1: an f32 3x3 conv at 512 input channels (4608-term sums) against the
# same conv in f64, within TF32_CONV_REL of max |f64|; TF32 keeps 10 bits
# of each operand and misses that by about 100 times.
TF32_CONV_REL = 1e-5
# Steps 2 and 3 compare two runs of the model with the second replaying the
# first's ReLU masks (``relu_masks``): an input that rounds to the other
# side of 0 in one run moves a gradient by that element's share (on the
# CPU, two such flips between the port's f32 and f64 runs move one conv
# kernel's gradient by 5.6% of its max), and the replay leaves the
# rounding alone to compare.
# Step 2 (f32, the card against the port's CPU run): logits and the BN
# statistics after the forward within RESNET_F32_REL of max |CPU|, each
# parameter's step-1 gradient within STEP_GRAD_RTOL of its max |CPU| (f32
# sums over up to 16·32·32 rows a channel and 4608-term windows in another
# order; on the CPU the port's f32 run lies within 6.1e-6 of its f64 run).
RESNET_F32_REL = 1e-4
# Step 3 (bf16 against f32 on the card, the f32 run replaying the bf16
# run's masks): each parameter's step-1 gradient within
# RESNET_BF16_GRAD_REL of the f32 one in norm, all of them together within
# RESNET_BF16_ALL_REL (on the CPU 0.051 and 0.024: bf16 rounds every
# activation to 8 bits, and a BatchNorm parameter's gradient is a sum that
# mostly cancels); logits within RESNET_BF16_LOGIT_REL of max |f32| (CPU:
# 1.6e-2).
RESNET_BF16_GRAD_REL = 0.1
RESNET_BF16_ALL_REL = 0.05
RESNET_BF16_LOGIT_REL = 3e-2
# Step 6: the north star's entry at its defaults for one epoch (390 steps
# of 128 on the 50000-image synthetic CIFAR split); chance is 0.1.
NORTH_STAR_EPOCH_STEPS = 50000 // 128
NORTH_STAR_ACC_FLOOR = 0.5


@contextlib.contextmanager
def relu_masks(replay=None):
    """Record each ``F.relu`` the model calls as its ``x > 0`` mask, into the
    yielded list; or, given ``replay`` (such a list), apply those masks
    instead: ``x · mask``, whose gradient is the mask."""
    import torch.nn.functional as F

    relu, masks = F.relu, []
    masks_in = None if replay is None else iter(replay)

    def patched(x, *args, **kw):
        if masks_in is not None:
            return x * next(masks_in).to(x.device)
        masks.append(x.detach() > 0)
        return relu(x, *args, **kw)

    F.relu = patched
    try:
        yield masks
    finally:
        F.relu = relu


def _image_run(ts, step, images, labels, steps: int):
    """``steps`` steps on one batch: (losses, ms/step over the steps after
    the first, the warm-up)."""
    import torch

    losses, t0 = [], None
    for i in range(steps):
        ts, metrics = step(ts, images, labels)
        losses.append(metrics["loss"])
        if i == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    return [float(x) for x in losses], (time.perf_counter() - t0) * 1e3 / (steps - 1)


def _state(model) -> dict:
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


def resnet_phase() -> dict[str, int]:
    """Main path 7, the north star (module docstring, phase 11). Returns its
    launch counts: none, as no kernel of the port lies on it."""
    import io
    import math
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from tpudml_torch.core import DistributedConfig, process_count, process_group
    from tpudml_torch.data import synthetic_classification
    from tpudml_torch.models import ResNet18
    from tpudml_torch.nn import Conv2D
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Sgd
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.tasks import north_star
    from tpudml_torch.train import TrainState, make_loss_fn, make_train_step, params_of

    reset_launch_counts()  # ---- the resnet path starts here
    gen = torch.Generator().manual_seed(11)

    # (1) TF32 is off for convolutions.
    conv = Conv2D(512, 512, 3, 1, "SAME", use_bias=False, generator=gen).cuda()
    x = torch.randn(8, 512, 16, 16, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        want = F.conv2d(x.double(), conv.kernel.double(), padding=1)
        err = rel_to_max(conv(x), want)
        torch.backends.cudnn.allow_tf32 = True
        tf32_err = rel_to_max(conv(x), want)
        torch.backends.cudnn.allow_tf32 = False
    print(f"[resnet] f32 3x3 conv, 512 -> 512 channels, 16x16: max|err|/max|f64| {err:.3e} "
          f"(tol {TF32_CONV_REL:g}); with cuDNN's TF32 allowed {tf32_err:.3e}")
    check(err <= TF32_CONV_REL, "an f32 convolution runs in TF32")
    del conv, x, want

    # (2) The card against the port's CPU run, f32.
    images, labels = synthetic_classification(RESNET_CHECK_BATCH, (32, 32, 3), 10, seed=0)

    def model(device, dtype=torch.float32):
        return ResNet18(compute_dtype=dtype, device=device,
                        generator=torch.Generator().manual_seed(3))

    def step1(m, replay=None):
        """(logits, BN buffers after the forward, step-1 gradients, masks)."""
        dev = next(m.parameters()).device
        x, y = torch.from_numpy(images).to(dev), torch.from_numpy(labels).long().to(dev)
        with relu_masks(replay) as masks:
            loss, logits = make_loss_fn(m)(x, y)
            grads = torch.autograd.grad(loss, list(params_of(m).values()))
        return (logits.detach().float().cpu(),
                {n: b.detach().cpu() for n, b in m.named_buffers()},
                {n: g.float().cpu() for n, g in zip(params_of(m), grads)}, masks)

    card = step1(model("cuda"))
    with torch.no_grad(), relu_masks() as cpu_masks:
        model("cpu")(torch.from_numpy(images))
    flips = sum(int((a.cpu() != b).sum()) for a, b in zip(card[3], cpu_masks))
    cpu = step1(model("cpu"), replay=card[3])
    logit_err = rel_to_max(card[0], cpu[0])
    buf_err, buf_name = _worst(card[1], cpu[1], cpu[1])
    grad_err, grad_name = _worst(card[2], cpu[2], cpu[2])
    n_masked = sum(m.numel() for m in card[3])
    print(f"[resnet] ResNet-18 f32, batch {RESNET_CHECK_BATCH}, card vs the port's CPU run "
          f"(the card's ReLU masks replayed; {flips} of {n_masked} ReLU inputs round to the "
          f"other side of 0 unreplayed): logits {logit_err:.3e}, BN statistics {buf_err:.3e} "
          f"({buf_name}) (tol {RESNET_F32_REL:g}); step-1 gradients worst max|err|/max|cpu| "
          f"{grad_err:.3e} ({grad_name}; tol {STEP_GRAD_RTOL:g}) over {len(cpu[2])} parameters")
    check(logit_err <= RESNET_F32_REL, "f32 logits on the card disagree with the CPU's")
    check(buf_err <= RESNET_F32_REL, f"BN statistic {buf_name} disagrees with the CPU's")
    check(grad_err <= STEP_GRAD_RTOL, f"step-1 gradient {grad_name} disagrees with the CPU's")
    del cpu, cpu_masks

    # (3) bf16 against f32 on the card.
    bf = step1(model("cuda", torch.bfloat16))
    f32 = step1(model("cuda"), replay=bf[3])

    def norm_rel(got, want):
        return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()

    per = {n: norm_rel(bf[2][n], f32[2][n]) for n in f32[2]}
    worst_name = max(per, key=per.get)
    flat = lambda g: torch.cat([t.flatten() for t in g.values()])  # noqa: E731
    all_rel = norm_rel(flat(bf[2]), flat(f32[2]))
    natural = norm_rel(flat(bf[2]), flat(card[2]))
    logit_err = rel_to_max(bf[0], card[0])
    print(f"[resnet] bf16 vs f32 on the card (the bf16 run's ReLU masks replayed in f32): "
          f"step-1 gradients |err|/|f32| worst {per[worst_name]:.3e} ({worst_name}; tol "
          f"{RESNET_BF16_GRAD_REL:g}), all {all_rel:.3e} (tol {RESNET_BF16_ALL_REL:g}; "
          f"unreplayed {natural:.3e}); logits {logit_err:.3e} (tol {RESNET_BF16_LOGIT_REL:g})")
    check(per[worst_name] <= RESNET_BF16_GRAD_REL, f"bf16 gradient {worst_name} is off f32")
    check(all_rel <= RESNET_BF16_ALL_REL, "bf16 gradients are off f32")
    check(logit_err <= RESNET_BF16_LOGIT_REL, "bf16 logits are off f32")
    del card, bf, f32
    torch.cuda.empty_cache()

    # (4) The single-card bf16 step at bench_resnet's batch, twice from one seed.
    x, y = synthetic_classification(RESNET_BATCH, (32, 32, 3), 10, seed=0)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).long().cuda()

    def single():
        m = model("cuda", torch.bfloat16)
        opt = Sgd(**RESNET_SGD)
        torch.cuda.reset_peak_memory_stats()
        losses, ms = _image_run(TrainState.create(m, opt), make_train_step(m, opt), x, y,
                                RESNET_STEPS)
        return losses, ms, _state(m), torch.cuda.max_memory_allocated() / 1e9

    s1_losses, s1_ms, s1_state, peak = single()
    s2_losses, s2_ms, s2_state, _ = single()
    repeats = s1_losses == s2_losses and _bitwise(s1_state, s2_state)
    print(f"[resnet] single-card bf16 step, batch {RESNET_BATCH}, SGD 0.1 / 0.9: losses "
          f"{' '.join(f'{v:.6f}' for v in s1_losses)}; {s1_ms:.2f}, {s2_ms:.2f} ms/step, "
          f"{RESNET_BATCH / s1_ms * 1e3:.0f}, {RESNET_BATCH / s2_ms * 1e3:.0f} imgs/s (steady "
          f"state, {RESNET_STEPS - 1} steps after one warm-up), peak {peak:.2f} GB; repeats "
          f"itself bitwise: {repeats}")
    check(all(np.isfinite(s1_losses)), "a single-card ResNet loss is not finite")

    # (5) DataParallel at world 1, from the same weights and batch.
    with tempfile.TemporaryDirectory() as tmp, process_group(
            DistributedConfig(coordinator_address=f"file://{tmp}/store", num_processes=1),
            device="cuda") as group:
        check(torch.distributed.get_backend(group) == "nccl" and process_count(group) == 1,
              "the DP group is not a one-rank NCCL group")
        m = model("cuda", torch.bfloat16)
        dp = DataParallel(m, Sgd(**RESNET_SGD), group, stacked_batches=True)
        d_losses, d_ms = _image_run(dp.create_state(), dp.make_train_step(), x[None], y[None],
                                    RESNET_STEPS)
        d_state = _state(m)
        del dp, m
    print(f"[resnet] DataParallel world 1 (one-rank NCCL group): losses "
          f"{' '.join(f'{v:.6f}' for v in d_losses)}; {d_ms:.2f} ms/step, "
          f"{RESNET_BATCH / d_ms * 1e3:.0f} imgs/s at world 1")
    if repeats:
        check(d_losses == s1_losses, "world-1 DP losses differ from the single-card step's")
        check(_bitwise(d_state, s1_state), "world-1 DP parameters or BN buffers differ from "
              "the single-card step's")
        print(f"[resnet] world-1 DP step equals the single-card step bitwise (losses, "
              f"{len(d_state)} parameters and buffers)")
    else:
        def gaps(losses, state):
            return (max(abs(a - b) for a, b in zip(losses, s1_losses)),
                    max((state[n].float() - s1_state[n].float()).abs().max().item()
                        for n in state))

        (ldiff, worst), (lgap, pgap) = gaps(d_losses, d_state), gaps(s2_losses, s2_state)
        print(f"[resnet] the single-card step is not deterministic (two runs differ by |loss| "
              f"{lgap:.2e}, |param or buffer| {pgap:.2e}): world-1 DP vs single |loss diff| "
              f"{ldiff:.2e}, max |diff| {worst:.2e} (tol {DP_GAP_MULT} x the gap)")
        check(ldiff <= DP_GAP_MULT * lgap and worst <= DP_GAP_MULT * pgap,
              "world-1 DP disagrees with the single-card step")
    del x, y, s1_state, s2_state, d_state
    torch.cuda.empty_cache()

    # (6) The north star's entry, one epoch at its defaults.
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
        metrics = north_star.main(["--epochs", "1", "--log_dir", f"{tmp}/logs"])
    lines = out.getvalue().splitlines()
    losses = [float(ln.split()[-1]) for ln in lines if ln.startswith("epoch ")]
    print(f"[resnet] north star (python -m tpudml_torch.tasks.north_star --epochs 1, world "
          f"{metrics['world']}): {lines[-1]}; {metrics['steps']} steps in "
          f"{metrics['train_time_s']:.1f} s; logged losses {losses[0]:.4f} ... "
          f"{losses[-1]:.4f} (every 20 steps)")
    check(metrics["steps"] == NORTH_STAR_EPOCH_STEPS, "the north star's epoch is not 390 steps")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          "the north star's loss did not fall")
    check(metrics["test_accuracy"] >= NORTH_STAR_ACC_FLOOR,
          f"the north star's test accuracy {metrics['test_accuracy']} is under "
          f"{NORTH_STAR_ACC_FLOOR}")
    check(not torch.distributed.is_initialized(), "the north star's group outlived its run")

    # (7) No kernel of the port lies on this path.
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    print(f"[resnet] launches on the path: {sum(launches.values())} (every kernel 0)")
    check(not any(launches.values()), f"the resnet path launched a kernel: {launches}")
    return launches


def ptxas_usage(log: str) -> dict[str, dict]:
    """{mangled entry function: {registers, spill, stack}} from a ``-Xptxas
    -v`` build log (spill: bytes stored plus bytes loaded; stack: the
    frame's bytes, where arrays the registers do not hold live)."""
    usage: dict[str, dict] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = usage.setdefault(m.group(1), {"registers": None, "spill": None,
                                                  "stack": None})
        elif entry is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                entry["spill"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"(\d+) bytes stack frame", line)
            if m:
                entry["stack"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
    return usage


SASS_OPS = r"\b(HGMMA\.[\w.]+|HMMA\.[\w.]+|FFMA)\b"


def sass_opcodes(lib_path, ops: str = SASS_OPS) -> dict[str, dict[str, int]]:
    """{mangled kernel: {opcode: count}} of the instructions ``ops`` matches
    in a built library, from ``cuobjdump -sass``; by default the
    tensor-core (``HMMA`` from mma.sync, ``HGMMA`` from wgmma, by full
    opcode, so a TF32 product shows as ``...TF32``) and f32 FMA (``FFMA``)
    instructions."""
    from tpudml_torch.ops.cuda_lib import find_nvcc

    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = counts.setdefault(m.group(1), {})
            continue
        m = re.search(ops, line)
        if cur is not None and m:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return counts


# Instances of the redesigned flash kernels: (source, kernel, head-dim widths).
FLASH_INSTANCES = (
    ("flash_fwd.cu", "flash_fwd_bf16_kernel", (32, 64, 128, 256)),
    ("flash_fwd.cu", "flash_fwd_f32_kernel", (32, 64, 128, 256)),
    ("flash_bwd.cu", "flash_dq_bf16_kernel", (32, 64, 128, 256)),
    ("flash_bwd.cu", "flash_dq_f32_kernel", (32, 64, 128, 256)),
    ("flash_dkdv.cu", "flash_dkdv_bf16_kernel", (32, 64, 128, 256)),
    ("flash_dkdv.cu", "flash_dkdv_f32_kernel", (32, 64, 128, 256)),
)
BF16_MMA = "HMMA.16816.F32.BF16"  # mma.sync m16n8k16, bf16 in, f32 sums
# Kernels of xent_lean.cu (the lean head's 14 and 15) and xent_saved.cu (the
# saved-scores 12 and 13), each with its range sum, with whether their bf16
# twin must run on the tensor cores; XENT_TWINS: the twins' template
# arguments in the mangled names.
LEAN_INSTANCES = (
    ("xent_dx_lean_kernel", True),
    ("xent_dw_lean_kernel", True),
    ("xent_dw_range_sum_kernel", False),
)
SAVED_INSTANCES = (
    ("xent_dx_saved_kernel", True),
    ("xent_dw_saved_kernel", True),
    ("xent_dw_range_sum_kernel", False),
)
XENT_TWINS = (("f32", "If"), ("bf16", "I13__nv_bfloat16"))
LEAN_PLAN_WIDTHS = (512, 1024, 2048, 4096, 8192)


# The forward kernels 10, 11 (xent.cu): f32 and bf16, without and with the
# score store (SAVE), for a d that is a multiple of the stage depth and not
# (RAGGED), as (label, mangled template arguments).
FWD_TWINS = tuple((f"{tag}{', save' if save else ''}{', ragged' if ragged else ''}",
                   f"{arg}Lb{save}ELb{ragged}E")
                  for tag, arg in (("f32", "If"), ("bf16", "I13__nv_bfloat16"))
                  for save in (0, 1) for ragged in (0, 1))
# (N, d, V) at which phase 2 holds the forward's cut against ``fwd_plan``:
# the flagship head, the long context, the wide timed head, the grid edge.
FWD_PLAN_SHAPES = ((8192, 512, 32768), (32768, 512, 32768), (4096, 2048, 8192),
                   (8_388_609, 8, 128))


def xent_instances(lib, instances, twins=XENT_TWINS) -> None:
    """Hold every instance of one pair of the fused head's kernels (with
    its range sum) to its design: no spill and no stack frame (its f32
    tiles live in registers), no TF32 instruction, and
    ``HMMA.16816.F32.BF16`` in each bf16 twin of the pair; print registers
    and SASS counts."""
    usage = ptxas_usage(lib.ptxas_log())
    sass = sass_opcodes(lib.target())
    source = lib.source.name
    for kernel, mma_twin in instances:
        for tag, arg in twins:
            names = [n for n in sass if re.search(rf"\d{kernel}{arg}E", n)]
            check(len(names) == 1, f"{source}: no single {kernel}<{tag}> in the SASS")
            ops, use = sass[names[0]], usage.get(names[0])
            check(use is not None, f"no ptxas -v report of {kernel}<{tag}>: the library was "
                  f"built without its log; empty tpudml_torch/_build and rerun")
            mma = ops.get(BF16_MMA, 0)
            tf32 = sum(c for op, c in ops.items() if "TF32" in op)
            print(f"[build] {source} {kernel}<{tag}>: {use.get('registers')} registers, "
                  f"spill {use.get('spill')} B, stack {use.get('stack')} B, {BF16_MMA} {mma}, "
                  f"TF32 {tf32}, FFMA {ops.get('FFMA', 0)}")
            check(use.get("spill") == 0 and use.get("stack") == 0,
                  f"{kernel}<{tag}> spills or keeps a stack frame ({use})")
            check(tf32 == 0, f"{kernel}<{tag}> holds TF32 instructions ({ops})")
            if mma_twin and tag.startswith("bf16"):
                check(mma > 0, f"{kernel}<bf16> runs no bf16 mma on the tensor cores")


def fwd_instances(lib) -> None:
    """The forward kernels 10, 11 (xent.cu) as ``xent_instances`` holds
    them, every instance of FWD_TWINS; then, in f32 and bf16, the cut the
    built kernels make (rows a block, vocabulary slices, blocks) at
    FWD_PLAN_SHAPES against ``fwd_plan``."""
    import torch

    from tpudml_torch.ops import fwd_plan, fwd_plan_built

    xent_instances(lib, (("xent_fwd_kernel", True),), FWD_TWINS)
    for shape in FWD_PLAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = fwd_plan_built(*shape, dtype)
            print(f"[build] forward kernels at N={shape[0]} d={shape[1]} V={shape[2]} "
                  f"{str(dtype)[6:]}: {plan['blocks']} blocks of {plan['rows']} rows, "
                  f"{plan['slices']} slice(s) of {plan['slice_steps']} steps of {plan['cols']} "
                  f"columns, partials {plan['partials']}")
            check(plan == fwd_plan(*shape, dtype),
                  f"fwd_plan{shape} {fwd_plan(*shape, dtype)} is not the kernels' {plan}")


def lean_instances(lib) -> None:
    """The lean kernels 14, 15 (xent_lean.cu) as ``xent_instances`` holds
    them; then the cut of d the built kernels choose (chunk, cluster, S
    passes) against ``lean_plan``."""
    from tpudml_torch.ops import lean_plan, lean_plan_built

    xent_instances(lib, LEAN_INSTANCES)
    for d in LEAN_PLAN_WIDTHS:
        plan = lean_plan_built(d)
        print(f"[build] lean kernels at d={d}: {plan['cluster']} block(s) of {plan['chunk']} "
              f"columns a cluster, scores computed {plan['s_passes']}x a tile")
        check(plan == lean_plan(d), f"lean_plan({d}) {lean_plan(d)} is not the kernels' {plan}")


# (N, d, V) at which phase 2 holds the saved-scores kernels' cut against
# ``saved_plan``: the flagship head, the long-context saved config, the
# wide timed head, and dW's ranges at the grid-edge check.
SAVED_PLAN_SHAPES = ((8192, 512, 32768), (32768, 512, 32768), (4096, 2048, 8192),
                     (8_388_609, 8, 128))


def saved_instances(lib) -> None:
    """The saved-scores kernels 12, 13 (xent_saved.cu) as ``xent_instances``
    holds them; then, in f32 and bf16, the cut the built kernels make
    (rows or columns a block, reads of s, ranges, blocks) at
    SAVED_PLAN_SHAPES against ``saved_plan``."""
    import torch

    from tpudml_torch.ops import saved_plan, saved_plan_built

    xent_instances(lib, SAVED_INSTANCES)
    for shape in SAVED_PLAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = saved_plan_built(*shape, dtype)
            print(f"[build] saved-scores kernels at N={shape[0]} d={shape[1]} V={shape[2]} "
                  f"{str(dtype)[6:]}: dX {plan['dx_blocks']} blocks of {plan['dx_rows']} rows, "
                  f"dW {plan['dw_blocks']} blocks of {plan['dw_cols']} columns "
                  f"({plan['ranges']} range(s) of {plan['range_rows']} rows), s read "
                  f"{plan['s_reads']}x ({plan['chunk']}-column chunks of d)")
            check(plan == saved_plan(*shape, dtype),
                  f"saved_plan{shape} {saved_plan(*shape, dtype)} is not the kernels' {plan}")


# Kernel 16 (grouped_dw.cu): f32 and bf16, with 16-byte row copies (VEC) and
# without (a k or n that is no multiple of 16 bytes), as (label, mangled
# template arguments); (M, k, n, E) at which phase 2 holds its cut against
# ``grouped_dw_plan``: the MoE step's dW1 and dW2 at E = 4 and 8, the card
# tests' multi-chunk, long-chunk and many-expert cases, M = 0, a wide k·n.
GDW_TWINS = tuple((f"{tag}{'' if vec else ', ragged'}", f"{arg}Lb{vec}E")
                  for tag, arg in (("f32", "If"), ("bf16", "I13__nv_bfloat16"))
                  for vec in (1, 0))
GDW_PLAN_SHAPES = ((8192, 512, 2048, 8), (8192, 2048, 512, 8), (8192, 512, 2048, 4),
                   (8192, 2048, 512, 4), (5000, 64, 96, 4), (20000, 512, 1024, 2),
                   (300, 130, 257, 64), (0, 12, 1, 3), (65536, 4096, 4096, 8))


WGMMA_SERIALIZED = "wgmma.mma_async instructions are serialized"  # ptxas's warning


def gdw_instances(lib) -> None:
    """Hold every instance of kernel 16 (grouped_dw.cu, GDW_TWINS) to its
    design: no spill and no stack frame, no TF32 instruction, the bf16
    twins' products on wgmma (``HGMMA.*.F32.BF16`` in their SASS, never
    serialized by ptxas); print registers and SASS counts. Then the cut the
    built kernel makes (R, slots, blocks, workspace) at GDW_PLAN_SHAPES
    against ``grouped_dw_plan``."""
    import torch

    from tpudml_torch.ops import grouped_dw_plan, grouped_dw_plan_built

    log = lib.ptxas_log()
    usage = ptxas_usage(log)
    sass = sass_opcodes(lib.target())
    check(WGMMA_SERIALIZED not in log, f"ptxas serialized kernel 16's wgmma: {log[-2000:]}")
    for tag, arg in GDW_TWINS:
        names = [n for n in sass if re.search(rf"\dgrouped_dw_kernel{arg}E", n)]
        check(len(names) == 1, f"grouped_dw.cu: no single grouped_dw_kernel<{tag}> in the SASS")
        ops, use = sass[names[0]], usage.get(names[0])
        check(use is not None, "no ptxas -v report of grouped_dw.cu: the library was built "
              "without its log; empty tpudml_torch/_build and rerun")
        wgmma = sum(c for op, c in ops.items() if op.startswith("HGMMA") and op.endswith("BF16"))
        tf32 = sum(c for op, c in ops.items() if "TF32" in op)
        print(f"[build] grouped_dw.cu grouped_dw_kernel<{tag}>: {use.get('registers')} "
              f"registers, spill {use.get('spill')} B, stack {use.get('stack')} B, "
              f"{', '.join(f'{op} {c}' for op, c in sorted(ops.items()))}")
        check(use.get("spill") == 0 and use.get("stack") == 0,
              f"grouped_dw_kernel<{tag}> spills or keeps a stack frame ({use})")
        check(tf32 == 0, f"grouped_dw_kernel<{tag}> holds TF32 instructions ({ops})")
        if tag.startswith("bf16"):
            check(wgmma > 0, f"grouped_dw_kernel<{tag}> runs no bf16 wgmma")
    for shape in GDW_PLAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = grouped_dw_plan_built(*shape, dtype)
            print(f"[build] grouped dW at M={shape[0]} k={shape[1]} n={shape[2]} E={shape[3]} "
                  f"{str(dtype)[6:]}: chunks of <= {plan['rows']} rows, {plan['slots']} slots, "
                  f"{plan['blocks']} blocks of {plan['tile']}, {plan['stage_rows']} rows a "
                  f"stage, workspace {plan['workspace_bytes']} B")
            check(plan == grouped_dw_plan(*shape, dtype),
                  f"grouped_dw_plan{shape} {grouped_dw_plan(*shape, dtype)} is not the "
                  f"kernel's {plan}")


# The decode head (decode_head.cu, kernels 4 and 5): f32 and int8 weights,
# with 16-byte loads or one scalar load a column, as (label, mangled template
# arguments); (B, d, V) at which phase 2 holds its cut against ``head_plan``:
# serving, HEAD_WIDE, the card tests' 200 slots, a chunked ragged d and V,
# and one of everything.
HEAD_TWINS = (("f32", "IfLb1E"), ("f32, unaligned", "IfLb0E"), ("int8", "IaLb1E"),
              ("int8, unaligned", "IaLb0E"))
HEAD_PLAN_SHAPES = ((8, 512, 32768), (8, 8192, 32768), (200, 512, 1000), (9, 6401, 32773),
                    (1, 1, 1))
HEAD_OPS = r"\b(HGMMA\.[\w.]+|HMMA\.[\w.]+|FFMA|FMUL|FADD|PRMT|I2F[\w.]*|LDG[\w.]*)\b"


def head_instances(lib) -> None:
    """Hold the decode head's instances (HEAD_TWINS) to no spill, no stack
    frame and no TF32 instruction; print registers and SASS counts (int8:
    PRMT and FADD convert the codes, no I2F). Then the cut the built kernel
    makes at HEAD_PLAN_SHAPES against ``head_plan``."""
    from tpudml_torch.ops import head_plan, head_plan_built

    usage = ptxas_usage(lib.ptxas_log())
    sass = sass_opcodes(lib.target(), HEAD_OPS)
    for tag, arg in HEAD_TWINS:
        names = [n for n in sass if re.search(rf"\dhead_kernel{arg}E", n)]
        check(len(names) == 1, f"decode_head.cu: no single head_kernel<{tag}> in the SASS")
        ops, use = sass[names[0]], usage.get(names[0])
        check(use is not None, "no ptxas -v report of decode_head.cu: the library was built "
              "without its log; empty tpudml_torch/_build and rerun")
        tf32 = sum(c for op, c in ops.items() if "TF32" in op)
        print(f"[build] decode_head.cu head_kernel<{tag}>: {use.get('registers')} registers, "
              f"spill {use.get('spill')} B, stack {use.get('stack')} B, TF32 {tf32}, "
              f"{', '.join(f'{op} {c}' for op, c in sorted(ops.items()))}")
        check(use.get("spill") == 0 and use.get("stack") == 0,
              f"head_kernel<{tag}> spills or keeps a stack frame ({use})")
        check(tf32 == 0, f"head_kernel<{tag}> holds TF32 instructions ({ops})")
    for shape in HEAD_PLAN_SHAPES:
        for int8 in (False, True):
            plan = head_plan_built(*shape, int8)
            print(f"[build] decode head at B={shape[0]} d={shape[1]} V={shape[2]} "
                  f"{'int8' if int8 else 'f32'}: {plan.tiles} blocks of {plan.warps} warps, "
                  f"{'16-byte' if plan.aligned else 'scalar'} loads, {plan.slice} rows of d a "
                  f"warp in chunks of {plan.chunk}, {plan.smem_bytes} B shared, "
                  f"{plan.groups} row group(s), buffer {4 * plan.scratch} B")
            check(plan == head_plan(*shape, int8),
                  f"head_plan{shape} {head_plan(*shape, int8)} is not the kernel's {plan}")


def ln_instances(lib) -> None:
    """Print each LayerNorm kernel instance's registers and spills (ptxas)
    and hold the wide ones (``*_wide_*``, ``*_loop_*``) to no spills."""
    usage = ptxas_usage(lib.ptxas_log())
    check(bool(usage), "no ptxas -v report of add_layernorm.cu: empty tpudml_torch/_build "
          "and rerun")
    for name, use in sorted(usage.items()):
        m = re.search(r"(add_ln_[a-z_]+?_kernel)(I\w+?EE)?(?:Ev|E)", name)
        if not m:
            continue
        args = m.group(2) or ""
        inst = (m.group(1) + "<" + ", ".join(
            a for a in re.findall(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16|If)", args)
            for a in a if a).replace("13__nv_bfloat16", "bf16").replace("If", "f32") + ">")
        print(f"[build] add_layernorm.cu {inst}: {use['registers']} registers, "
              f"spill {use['spill']} B")
        if "_wide_" in name or "_loop_" in name:
            check(use["spill"] == 0, f"{inst} spills ({use})")


def build_phase() -> None:
    """Build every kernel source (one nvcc each, all started together) and
    print what ptxas reports. Hold kernels 1–3 to their design in every
    instance: the bf16 twins on the tensor cores (``HMMA.16816.F32.BF16`` in
    their SASS), no TF32 instruction in any twin, and no spills; the wide
    instances of the LayerNorm kernels 6–9 to no spills; and the
    forward kernels 10, 11, the saved-scores kernels 12, 13 and the lean
    kernels 14, 15 as ``fwd_instances``, ``saved_instances`` and
    ``lean_instances`` say, the grouped dW 16 as ``gdw_instances`` and the
    decode head 4, 5 as ``head_instances``."""
    from tpudml_torch.ops import (
        ADD_LN_FORWARD, DECODE_HEAD, FLASH_DKDV, FLASH_DQ, FLASH_FORWARD, GROUPED_DW,
        KERNELS, XENT_DX, XENT_DX_LEAN, XENT_FORWARD, build_kernels,
    )

    t_build = build_kernels()
    for lib in dict.fromkeys(k.library for k in KERNELS):
        usage = [ln.strip() for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {lib.source.name}: {' | '.join(usage) or 'cached'}")
    print(f"[build] {len(KERNELS)} kernels built in {t_build:.1f} s")

    for lib in (FLASH_FORWARD.library, FLASH_DQ.library, FLASH_DKDV.library):
        usage = ptxas_usage(lib.ptxas_log())
        sass = sass_opcodes(lib.target())
        for source, kernel, widths in FLASH_INSTANCES:
            if source != lib.source.name:
                continue
            for dp in widths:
                pat = re.compile(rf"{kernel}ILi{dp}E")
                names = [n for n in sass if pat.search(n)]
                check(len(names) == 1, f"{source}: no single {kernel}<{dp}> in the SASS")
                ops, use = sass[names[0]], usage.get(names[0])
                check(use is not None, f"no ptxas -v report of {kernel}<{dp}>: the library "
                      f"was built without its log; empty tpudml_torch/_build and rerun")
                mma = ops.get(BF16_MMA, 0)
                tf32 = sum(c for op, c in ops.items() if "TF32" in op)
                print(f"[build] {source} {kernel}<{dp}>: {use.get('registers')} registers, "
                      f"spill {use.get('spill')} B, {BF16_MMA} {mma}, TF32 {tf32}, "
                      f"FFMA {ops.get('FFMA', 0)}")
                check(use.get("spill") == 0, f"{kernel}<{dp}> spills ({use})")
                check(tf32 == 0, f"{kernel}<{dp}> holds TF32 instructions ({ops})")
                if "bf16" in kernel:
                    check(mma > 0, f"{kernel}<{dp}> runs no bf16 mma on the tensor cores")
    ln_instances(ADD_LN_FORWARD.library)
    fwd_instances(XENT_FORWARD.library)
    saved_instances(XENT_DX.library)
    lean_instances(XENT_DX_LEAN.library)
    gdw_instances(GROUPED_DW.library)
    head_instances(DECODE_HEAD.library)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this script runs only on the card", file=sys.stderr)
        return 1
    from tpudml_torch.ops import KERNELS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s); "
          f"nvidia-smi: {smi}")

    build_phase()

    gen = torch.Generator().manual_seed(0)
    flash_rows = [flash_phase(gen), *flash_bwd_phase(gen)]
    flash_long_phase(gen, *flash_rows)
    xent_rows = xent_phase(gen)
    rows = [*flash_rows, *head_phase(gen), *add_ln_phase(gen), *flash_bf16_phase(gen),
            *add_ln_bf16_phase(gen), *xent_rows, *xent_lean_phase(gen, xent_rows[0]),
            *ln_phase(gen), *grouped_dw_phase(gen)]
    by_name = {row["name"]: row for row in rows}
    flash_head_dim_phase(gen, by_name)
    ln_wide_phase(gen, by_name)
    xent_wide_phase(gen, by_name)
    head_wide_phase(gen, by_name)
    grid_edge_phase(gen)
    torch.cuda.empty_cache()
    paths = {"serve": serve_phase(gen)}
    torch.cuda.empty_cache()
    paths["train"] = train_phase()
    torch.cuda.empty_cache()
    paths["train_wide"] = train_wide_phase()
    torch.cuda.empty_cache()
    paths.update(flagship_phase())
    torch.cuda.empty_cache()
    paths.update(dp_phase())
    torch.cuda.empty_cache()
    paths["long"] = long_phase()
    torch.cuda.empty_cache()
    paths["ln_op"] = ln_op_phase(gen)
    torch.cuda.empty_cache()
    paths["moe"] = moe_phase()
    torch.cuda.empty_cache()
    paths["moe_f32"] = moe_f32_phase()
    torch.cuda.empty_cache()
    paths["resnet"] = resnet_phase()
    for row in rows:
        by_path = {path: counts[row["name"]] for path, counts in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        check(row["launches"] > 0, f"{row['name']} never launched on a main path")
    check(len(rows) == len(KERNELS), "a kernel has no row")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"[done] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
