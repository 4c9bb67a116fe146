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
   ``flash_block_grads``) and the fused add+LayerNorm forward and
   backward (N=8192, d=512; also N=1000 and ds=None); times of the
   kernel, the plain version and a library call computing the same
   function, beside the bound.
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
6. one JSON line of per-kernel numbers (launches summed over both main
   paths), the card's name and power limit, and, last,
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
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet

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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def train_phase() -> dict[str, int]:
    """Main path 2: the training slice at full width (module docstring,
    phase 5). Returns the launch counts of the kernel run."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam
    from tpudml_torch.train import TrainState, make_loss_fn, make_train_step, params_of

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
    grads = {}
    for name, model in (("kernel", kernel_model), ("plain", plain_model)):
        params = params_of(model)
        loss, _ = make_loss_fn(model)(tokens, labels)
        grads[name] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        del loss
    worst, worst_name = 0.0, ""
    for name, g in grads["plain"].items():
        rel = ((grads["kernel"][name] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"[train] step-1 gradients, kernel vs plain run: worst max|err|/max|plain| "
          f"{worst:.3e} ({worst_name}; tol {STEP_GRAD_RTOL:g}) over {len(grads['plain'])} "
          f"parameters, {n_params} values")
    check(worst <= STEP_GRAD_RTOL, f"step-1 gradient {worst_name} disagrees with the plain run")
    del grads, tokens, labels

    def train(model):
        opt = Adam(lr=TRAIN_LR)
        ts, step = TrainState.create(model, opt), make_train_step(model, opt)
        losses = []
        t0 = None
        for i, batch in enumerate(batches):
            ts, metrics = step(ts, batch[:, :-1], batch[:, 1:])
            losses.append(metrics["loss"])
            if i == 0:  # warm-up step done
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
        return [float(x) for x in losses], ms

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
    rows = [flash_phase(gen), *flash_bwd_phase(gen), *head_phase(gen), *add_ln_phase(gen)]
    torch.cuda.empty_cache()
    paths = {"serve": serve_phase(gen)}
    torch.cuda.empty_cache()
    paths["train"] = train_phase()
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
