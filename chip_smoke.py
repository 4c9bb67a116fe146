"""Drive the PyTorch port (``tpudml_torch``) end to end on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero without one (it never runs on
the CPU). Phases, each printing its own line(s):

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN, so f32 means f32.
2. build: every CUDA kernel source of the port, one nvcc each, together.
3. kernel vs plain version on the card at the serving path's shapes, with
   the tolerances stated: the flash forward (B=1, T=128, H=8, D=64:
   causal, non-causal, odd T, k_shift=1) and the fused decode head
   (B=8, d=512, V=32768, f32 and int8 weights); times of the kernel, the
   plain version and a library call computing the same function.
4. the main path: the serving engine at full width (V=32768, d=512, H=8,
   kv_heads=2, L=6, RoPE, f32, random weights from a seeded generator;
   8 slots, max_len 1024, prefill chunks of 128; 16 requests at qps=inf,
   prompts 64-512, 64 new tokens at most), served unfused, with the fused
   f32 head, with the fused int8 head and with the int8_sim oracle.
   Launch counts are zeroed just before and read just after; every
   kernel must have launched, as often as the path requires. Streams are
   checked against a teacher-forced full forward (plain attention) and
   between the fused and unfused runs; a divergence is allowed only at a
   near-tie of the plain logits (top-2 gap < 1e-5), and is printed.
5. one JSON line of per-kernel numbers, the card's name and power limit,
   and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

TIE_GAP = 1e-5  # plain top-2 logit gap under which a pick may differ
FLASH_TOL = 1e-5  # max |err| of O and of lse, kernel vs plain (f32 sums in another order)
HEAD_TOL = 1e-4  # max |err| of max logit and lse (512-term f32 dots in another order; lse ~ 10)
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet

SERVE_MODEL = dict(vocab_size=32768, embed_dim=512, num_heads=8,
                   num_kv_heads=2, num_layers=6, max_len=1024, rope=True)
SERVE_CFG = dict(slots=8, max_len=1024, prefill_chunk=128)
WORKLOAD = dict(n_requests=16, prompt_len=(64, 512), new_tokens=(16, 64))


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
    return dict(name=FLASH_FORWARD.name, route="cuda", source=FLASH_FORWARD.source,
                replaces=FLASH_FORWARD.replaces, max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib_ms)


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
    rows = [flash_phase(gen), *head_phase(gen)]
    launches = serve_phase(gen)
    for row in rows:
        row["launches"] = launches[row["name"]]
        check(row["launches"] > 0, f"{row['name']} never launched on the main path")
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
