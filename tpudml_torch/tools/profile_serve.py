"""Where the serving path's time goes on the card.

Builds the full-width serving model of ``chip_smoke.py`` (V=32768, d=512,
H=8, kv_heads=2, L=6, RoPE, f32; 8 slots, max_len 1024) and measures, for
the unfused and the fused-head decode step and for one 128-token prefill
chunk at a 512-token window:

- wall ms per call (host clock around N back-to-back calls ending in a
  synchronize) and the CUDA-event span per call;
- a ``torch.profiler`` breakdown: device time by kernel, the kernel
  count and the sum of kernel time per call, and the device's busy share
  (kernel time over wall time) while the host drives it.

Run on the card: ``python -m tpudml_torch.tools.profile_serve`` (one JSON
line at the end; ``--out FILE`` also writes it to FILE).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

MODEL = dict(vocab_size=32768, embed_dim=512, num_heads=8, num_kv_heads=2,
             num_layers=6, max_len=1024, rope=True)


def _wall_and_event_ms(fn, iters: int) -> tuple[float, float]:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    return wall, start.elapsed_time(end) / iters


def _measure(fn, iters: int) -> dict:
    wall, event = _wall_and_event_ms(fn, iters)
    r = {"wall_ms": wall, "event_ms": event, **_kernel_breakdown(fn, 5)}
    r["busy_share"] = r["kernel_ms_per_call"] / wall
    return r


def _kernel_breakdown(fn, calls: int, top: int = 8) -> dict:
    """Device time by kernel name over ``calls`` calls, per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.name, ev.time_range.elapsed_us()))
    by_name: dict[str, list[float]] = {}
    for name, us in kernels:
        by_name.setdefault(name, []).append(us)
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    total_us = sum(us for _, us in kernels)
    return {
        "kernels_per_call": len(kernels) / calls,
        "kernel_ms_per_call": total_us / 1e3 / calls,
        "top": [
            {"kernel": name[:90], "ms_per_call": sum(us) / 1e3 / calls,
             "launches_per_call": len(us) / calls}
            for name, us in rows[:top]
        ],
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device; this measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import build_kernels
    from tpudml_torch.serve import ServeConfig, ServingEngine

    build_kernels()
    model = TransformerLM(**MODEL, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    slots = 8
    tokens = torch.arange(slots, device="cuda") * 7
    pos = torch.full((slots,), 511, device="cuda")  # every slot 512 tokens deep
    result = {"device": torch.cuda.get_device_name(0), "model": MODEL,
              "slots": slots, "decode_pos": 511}
    for name, fused in (("decode_unfused", False), ("decode_fused_head", True)):
        eng = ServingEngine(model, ServeConfig(slots=slots, max_len=1024,
                                               prefill_chunk=128, fused_head=fused),
                            device="cuda")
        step = lambda eng=eng: eng._decode(eng.caches, tokens, pos)  # noqa: E731
        result[name] = _measure(step, args.iters)
    chunk = torch.arange(128, device="cuda")[None] % MODEL["vocab_size"]
    eng = ServingEngine(model, ServeConfig(slots=slots, max_len=1024,
                                           prefill_chunk=128), device="cuda")

    @torch.inference_mode()
    def prefill():
        model.apply_prefill(eng.caches, chunk, 0, 384)  # window of 512 rows

    result["prefill_chunk_start384"] = _measure(prefill, args.iters)
    for key in ("decode_unfused", "decode_fused_head", "prefill_chunk_start384"):
        r = result[key]
        print(f"[profile] {key}: wall {r['wall_ms']:.3f} ms, events {r['event_ms']:.3f} ms, "
              f"{r['kernels_per_call']:.0f} kernels summing {r['kernel_ms_per_call']:.3f} ms "
              f"(busy {r['busy_share']:.2f})")
        for row in r["top"]:
            print(f"    {row['ms_per_call']:.4f} ms x{row['launches_per_call']:.0f}  "
                  f"{row['kernel']}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return result


if __name__ == "__main__":
    main()
