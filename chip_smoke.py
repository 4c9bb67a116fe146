"""Drive the PyTorch port (``tpudml_torch``) end to end on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero without one (it never runs on
the CPU). Phases, each printing its own line(s):

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN, so f32 means f32.
2. build: every CUDA kernel source of the port, one nvcc each, together.
3. kernel vs plain version on the card at the main paths' shapes, with
   the tolerances stated: the flash forward (serving: B=1, T=128, H=8,
   D=64: causal, non-causal, odd T, k_shift=1; training: B=8, T=1024,
   H=4, D=128, causal), the fused decode head (B=8, d=512, V=32768, f32
   and int8 weights), the flash backward dQ and dK/dV (B=8, T=1024, H=4,
   D=128 causal; also non-causal, T=1000 and k_shift=1 through
   ``flash_block_grads``), the fused add+LayerNorm forward and
   backward (N=8192, d=512; also N=1000 and ds=None), the bf16 twins of
   the flash and add+LN kernels at the training shapes, and the fused
   linear-xent kernels 10–13 (N=8192, d=512, V=32768 and the ragged
   N=1000, V=1000 with labels −1 and V; f32 and bf16); times of the
   kernel, the plain version and a library call computing the same
   function, beside the bound (bf16 rows against the bf16 tensor-core
   rate).
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
7. one JSON line of per-kernel numbers (launches summed over the main
   paths, and by path), the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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


def bound(nbytes: float, flops: float, peak: float = H100_F32_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak`` (f32 by default; the
    bf16 tensor-core rate for bf16 work)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True))
    pairs = t * (t + 1) // 2
    bnd, by = bound(4 * (4 * b * t * h * d + b * h * t), 4 * d * pairs * b * h)
    print(f"[kernel] flash_forward_lse B={b} T={t} H={h} D={d} causal: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
          f"bound {bnd:.5f} ms ({by})")
    row = dict(name=FLASH_FORWARD.name, route="cuda", source=FLASH_FORWARD.source,
               replaces=FLASH_FORWARD.replaces, max_abs_err=worst, ms=ms,
               plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
               shape=f"B={b} T={t} H={h} D={d} causal (serving)")
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
    print(f"[kernel] flash_forward_lse B={b} T={t} H={h} D={d} causal: max|err| "
          f"{err:.3e} (tol {FLASH_TOL:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
    return dict(shape=f"B={b} T={t} H={h} D={d} causal (training)", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib_ms)


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
        print(f"[kernel] {kernel.name} B={b} T={t} H={h} D={d} causal: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa backward (dq+dk+dv) {lib_ms:.4f} ms, "
              f"bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms,
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
    rows = []
    for kernel, fn, ref, err, nbytes, flops, lib in (
        (ADD_LN_FORWARD, lambda: add_layernorm_forward(x, r, scale, bias),
         lambda: add_layernorm_forward_reference(x, r, scale, bias), err_f,
         4 * (4 * n * d + 2 * d + 2 * n), 8 * n * d, lib_f),
        (ADD_LN_BACKWARD, lambda: add_layernorm_backward(s, scale, dy, ds, mean, rstd),
         lambda: add_layernorm_backward_reference(s, scale, dy, ds, mean, rstd), err_b,
         4 * (4 * n * d + 3 * d + 2 * n), 12 * n * d, lib_b),
    ):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(ref)
        bnd, by = bound(nbytes, flops)
        print(f"[kernel] {kernel.name} N={n} d={d}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, F.layer_norm(x + r) {lib:.4f} ms, bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms,
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
    q, k, v, do = args[:4]
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    lib_f = cuda_ms(sdpa, iters=20)
    lib_b = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), iters=20) - lib_f
    pairs = b * h * t * (t + 1) // 2
    io = b * t * h * d
    rows = []
    for kernel, fn, ref, err, nbytes, flops, lib, lib_name in (
        (FLASH_FORWARD_BF16, lambda: flash_forward_lse(q, k, v, causal=True),
         lambda: flash_forward_lse_reference(q, k, v, causal=True), errs["fwd"],
         2 * 4 * io + 4 * b * h * t, 4 * d * pairs, lib_f, "sdpa bf16 forward"),
        (FLASH_DQ_BF16, lambda: flash_dq(*args, causal=True),
         lambda: flash_dq_reference(*args, causal=True), errs["dq"],
         2 * 5 * io + 8 * b * h * t, 6 * d * pairs, lib_b,
         "sdpa bf16 fwd+bwd minus fwd (dq, dk, dv)"),
        (FLASH_DKDV_BF16, lambda: flash_dkdv(*args, causal=True),
         lambda: flash_dkdv_reference(*args, causal=True), errs["dkdv"],
         2 * 6 * io + 8 * b * h * t, 8 * d * pairs, lib_b,
         "sdpa bf16 fwd+bwd minus fwd (dq, dk, dv)"),
    ):
        ms = cuda_ms(fn, iters=20)
        plain_ms = cuda_ms(ref, iters=10)
        bnd, by = bound(nbytes, flops, H100_BF16_FLOPS)
        print(f"[kernel] {kernel.name} B={b} T={t} H={h} D={d} causal: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, {lib_name} {lib:.4f} ms, bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                         library=lib_name, shape=f"B={b} T={t} H={h} D={d} causal bf16 "
                         "(flagship)"))
    return rows


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
    rows = []
    for kernel, fn, ref, err, nbytes, lib in (
        (ADD_LN_FORWARD_BF16, lambda: add_layernorm_forward(x, r, scale, bias),
         lambda: add_layernorm_forward_reference(x, r, scale, bias), err_f,
         2 * 4 * n * d + 4 * (2 * d + 2 * n), lib_f),
        (ADD_LN_BACKWARD_BF16, lambda: add_layernorm_backward(s, scale, dy, ds, mean, rstd),
         lambda: add_layernorm_backward_reference(s, scale, dy, ds, mean, rstd), err_b,
         2 * 4 * n * d + 4 * (3 * d + 2 * n), lib_b),
    ):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(ref)
        flops = (8 if kernel is ADD_LN_FORWARD_BF16 else 12) * n * d
        bnd, by = bound(nbytes, flops, H100_BF16_FLOPS)
        print(f"[kernel] {kernel.name} N={n} d={d}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, F.layer_norm(x + r) bf16 {lib:.4f} ms, bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                         library="F.layer_norm(x + r) bf16" + (
                             " fwd+bwd minus fwd" if kernel is ADD_LN_BACKWARD_BF16 else ""),
                         shape=f"N={n} d={d} bf16 (flagship)"))
    return rows


def _xent_inputs(gen, n, d, v, dtype, bad_labels):
    import torch

    x = torch.randn((n, d), generator=gen).cuda().to(dtype)
    w = ((torch.rand((d, v), generator=gen) * 2 - 1) / d ** 0.5).cuda().to(dtype)
    b = ((torch.rand((v,), generator=gen) * 2 - 1) / d ** 0.5).cuda().to(dtype)
    y = torch.randint(0, v, (n,), generator=gen, dtype=torch.int32)
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


def xent_times(gen, dtype) -> dict:
    """Kernels 10–13 at the flagship head's shape in ``dtype``: kernel,
    plain and library ms and the bound, by kernel name. Library: the
    forward is ``torch.logsumexp(x@W+b)`` plus the label pick; the
    backward the autograd of ``F.cross_entropy`` over the materialized
    logits minus its forward (dx, dW, db together)."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        XENT_DW, XENT_DX, XENT_FORWARD, XENT_FORWARD_SAVE, xent_dw, xent_dw_reference,
        xent_dx, xent_dx_reference, xent_forward, xent_forward_reference,
        xent_forward_save, xent_forward_save_reference,
    )

    n, d, v = XENT_SHAPE
    x, w, b, y = _xent_inputs(gen, n, d, v, dtype, bad_labels=False)
    yl = y.long()
    lse, _, s = xent_forward_save(x, w, b, y)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]

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
    for kernel, fn, ref, nbytes, flops, lib, lib_name in (
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
    ):
        ms = cuda_ms(fn, iters=10, warmup=2)
        plain_ms = cuda_ms(ref, iters=5, warmup=1)
        bnd, by = bound(nbytes, flops, peak)
        print(f"[kernel] {kernel.name} N={n} d={d} V={v} {str(dtype)[6:]}: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, {lib_name} {lib:.3f} ms, bound {bnd:.5f} ms ({by})")
        out[kernel.name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                                library_ms=lib, library=f"{lib_name}, {str(dtype)[6:]}",
                                shape=f"N={n} d={d} V={v} {str(dtype)[6:]} (flagship head)")
    return out


def xent_phase(gen) -> list[dict]:
    """The fused linear-xent kernels 10–13: agreement with their plain
    versions at the flagship head's shape and at N=V=1000 with labels −1
    and V, in f32 and bf16; times at the flagship shape in bf16 (the
    row) and f32 (``at_f32``)."""
    import torch

    from tpudml_torch.ops import XENT_DW, XENT_DX, XENT_FORWARD, XENT_FORWARD_SAVE

    n, d, v = XENT_SHAPE
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, bad in (((1000, d, 1000), True), ((n, d, v), False)):
            for name, e in xent_check(gen, *shape, dtype, bad).items():
                worst[name] = max(worst.get(name, 0.0), e)
            torch.cuda.empty_cache()
    times = {dt: xent_times(gen, dt) for dt in (torch.bfloat16, torch.float32)}
    rows = []
    for kernel in (XENT_FORWARD, XENT_FORWARD_SAVE, XENT_DX, XENT_DW):
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=worst[kernel.name],
                         **times[torch.bfloat16][kernel.name],
                         at_f32=times[torch.float32][kernel.name]))
    torch.cuda.empty_cache()
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
        bnd, by = bound(wbytes + 4 * (b * d + v) + 12 * b, 2 * b * d * v + b * v)
        print(f"[kernel] {kernel.name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"addmm+argmax+logsumexp {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=max(em, el), ms=ms,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                         library_ms=lib_ms))
    return rows


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


def train_phase() -> dict[str, int]:
    """Main path 2: the training slice at full width (module docstring,
    phase 5). Returns the launch counts of the kernel run."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam
    from tpudml_torch.train import TrainState, make_loss_fn, make_train_step

    kernel_model = TransformerLM(**TRAIN_MODEL, impl="flash", fused_ln=True, device="cuda",
                                 generator=torch.Generator().manual_seed(1))
    plain_model = TransformerLM(**TRAIN_MODEL, impl="full", fused_ln=False, device="cuda",
                                generator=torch.Generator().manual_seed(2))
    plain_model.load_state_dict(kernel_model.state_dict())  # one initial state
    n_params = sum(p.numel() for p in kernel_model.parameters())
    t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
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
    print(f"[train] step-1 gradients, kernel vs plain run: worst max|err|/max|plain| "
          f"{worst:.3e} ({worst_name}; tol {STEP_GRAD_RTOL:g}) over {len(grads['plain'])} "
          f"parameters, {n_params} values")
    check(worst <= STEP_GRAD_RTOL, f"step-1 gradient {worst_name} disagrees with the plain run")
    del grads, tokens, labels

    def train(model):
        opt = Adam(lr=TRAIN_LR)
        return _train_run(TrainState.create(model, opt), make_train_step(model, opt), batches)

    reset_launch_counts()  # ---- main path 2 starts here
    k_losses, k_ms = train(kernel_model)
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    p_losses, p_ms = train(plain_model)
    check({k.name: k.launches for k in KERNELS} == launches,
          "the plain run launched a kernel")
    for name, n in launches.items():
        need = TRAIN_STEPS * PER_STEP.get(name, 0)
        check(n == need, f"training launched {name} {n} times, {TRAIN_STEPS} steps need {need}")
    tok = TRAIN_BATCH * t
    for label, losses, ms in (("kernel (flash + fused add+LN)", k_losses, k_ms),
                              ("plain (full attention, unfused LN)", p_losses, p_ms)):
        print(f"[train] {label}: losses {' '.join(f'{x:.6f}' for x in losses)}; "
              f"{ms:.2f} ms/step, {tok / ms * 1e3:.0f} tokens/s (steady state, "
              f"{TRAIN_STEPS - 1} steps after one warm-up)")
    check(all(np.isfinite(k_losses + p_losses)), "a training loss is not finite")
    diffs = [abs(a - b) for a, b in zip(k_losses, p_losses)]
    print(f"[train] per-step |loss difference| {' '.join(f'{x:.2e}' for x in diffs)} "
          f"(tol {LOSS_TOL:g}); launches {launches} = {TRAIN_STEPS} x {PER_STEP}")
    check(max(diffs) <= LOSS_TOL, "training losses disagree with the plain run")
    return launches


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this script runs only on the card", file=sys.stderr)
        return 1
    from tpudml_torch.ops import KERNELS, build_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s); "
          f"nvidia-smi: {smi}")

    t_build = build_kernels()
    for lib in dict.fromkeys(k.library for k in KERNELS):
        usage = [ln.strip() for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {lib.source.name}: {' | '.join(usage) or 'cached'}")
    print(f"[build] {len(KERNELS)} kernels built in {t_build:.1f} s")

    gen = torch.Generator().manual_seed(0)
    rows = [flash_phase(gen), *flash_bwd_phase(gen), *head_phase(gen), *add_ln_phase(gen),
            *flash_bf16_phase(gen), *add_ln_bf16_phase(gen), *xent_phase(gen)]
    torch.cuda.empty_cache()
    paths = {"serve": serve_phase(gen)}
    torch.cuda.empty_cache()
    paths["train"] = train_phase()
    torch.cuda.empty_cache()
    paths.update(flagship_phase())
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
