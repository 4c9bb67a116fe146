"""Where the serving path's time goes on the card.

Builds the full-width serving model of ``chip_smoke.py`` (V=32768, d=512,
H=8, kv_heads=2, L=6, RoPE, f32; 8 slots, max_len 1024) and measures, for
the unfused decode step, the fused-head one with f32 and with int8 head
weights (``weight_quant="int8"``), and one 128-token prefill chunk at a
512-token window (every slot 512 tokens deep):

- wall ms per call (host clock around N back-to-back calls ending in a
  synchronize) and the CUDA-event span per call;
- a ``torch.profiler`` breakdown: device time by kernel, the kernel
  count and the sum of kernel time per call, and the device's busy share
  (kernel time over wall time) while the host drives it.

The serving levers add their rows: ``--paged`` the paged decode step and
paged prefill chunk (``--page_size``, default 16; each slot maps its own
pages), ``--spec_k K`` the speculative decode step with the default trunk
draft (dense, and paged with ``--paged``), ``--bf16`` the decode steps,
unfused and fused-head, and the prefill chunk of the
``compute_dtype=torch.bfloat16`` model, ``--tp`` the tensor-parallel
engine's decode step and prefill chunk at world 1 (``mesh={"model": 1}``
on a one-rank NCCL group) and one reading of its shared clock (rank 0's,
broadcast).

Run on the card: ``python -m tpudml_torch.tools.profile_serve [--paged]
[--spec_k 3] [--bf16] [--tp]`` (one JSON line at the end; ``--out FILE``
also writes it to FILE).
"""

from __future__ import annotations

import argparse
import json
import tempfile
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
    p.add_argument("--paged", action="store_true", help="add the paged rows")
    p.add_argument("--page_size", type=int, default=16)
    p.add_argument("--spec_k", type=int, default=0, help="add the spec-decode rows")
    p.add_argument("--bf16", action="store_true", help="add the bf16-compute rows")
    p.add_argument("--tp", action="store_true",
                   help="add the tensor-parallel rows at world 1 (one-rank NCCL group)")
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
    chunk = torch.arange(128, device="cuda")[None] % MODEL["vocab_size"]

    def engine(m, **kw):
        return ServingEngine(m, ServeConfig(slots=slots, max_len=1024, prefill_chunk=128,
                                            **kw), device="cuda")

    def decode_row(eng):
        """The engine's step over every slot 512 tokens deep; paged, slot b
        maps pages 1 + b·max_pages onwards."""
        table = ()
        if eng._table is not None:
            m = eng.cfg.max_pages
            table = (1 + torch.arange(slots * m, device="cuda").reshape(slots, m),)
        if eng._spec is not None:
            return lambda: eng._spec(eng.caches, eng._dcaches, *table, tokens, pos)
        return lambda: eng._decode(eng.caches, *table, tokens, pos)

    def prefill_row(eng):
        """One 128-token chunk at start 384 (a window of 512 rows)."""
        m = eng.model

        @torch.inference_mode()
        def prefill():
            if eng._table is None:
                m.apply_prefill(eng.caches, chunk, 0, 384)
            else:
                row = 1 + torch.arange(eng.cfg.max_pages, device="cuda")
                m.apply_prefill_paged(eng.caches, row, chunk, 384)

        return prefill

    rows = {
        "decode_unfused": decode_row(engine(model)),
        "decode_fused_head": decode_row(engine(model, fused_head=True)),
        "decode_fused_head_int8": decode_row(engine(model, fused_head=True,
                                                    weight_quant="int8")),
        "prefill_chunk_start384": prefill_row(engine(model)),
    }
    paged = dict(cache_layout="paged", page_size=args.page_size)
    if args.paged:
        rows["decode_paged"] = decode_row(engine(model, **paged))
        rows["prefill_chunk_paged_start384"] = prefill_row(engine(model, **paged))
    if args.spec_k:
        rows[f"decode_spec{args.spec_k}"] = decode_row(engine(model, spec_k=args.spec_k))
        if args.paged:
            rows[f"decode_spec{args.spec_k}_paged"] = decode_row(
                engine(model, spec_k=args.spec_k, **paged))
    if args.bf16:
        model_bf16 = TransformerLM(**MODEL, device="cuda", compute_dtype=torch.bfloat16,
                                   generator=torch.Generator().manual_seed(0))
        rows["decode_bf16_unfused"] = decode_row(engine(model_bf16))
        rows["decode_bf16_fused_head"] = decode_row(engine(model_bf16, fused_head=True))
        rows["prefill_chunk_bf16_start384"] = prefill_row(engine(model_bf16))
    for key, fn in rows.items():
        result[key] = _measure(fn, args.iters)
    if args.tp:
        from tpudml_torch.core import DistributedConfig, process_group

        with tempfile.TemporaryDirectory() as tmp, process_group(
                DistributedConfig(coordinator_address=f"file://{tmp}/store", num_processes=1),
                device="cuda"):
            eng = ServingEngine(model, ServeConfig(slots=slots, max_len=1024, prefill_chunk=128),
                                device="cuda", mesh={"model": 1})
            tp_rows = {
                "decode_tp1": decode_row(eng),
                "prefill_chunk_tp1_start384": lambda: eng.tp.prefill(eng.caches, chunk, 0, 384),
                "shared_clock_tp1": lambda: eng._shared_clock(0.0),
            }
            for key, fn in tp_rows.items():
                result[key] = _measure(fn, args.iters)
        rows.update(tp_rows)
    for key in rows:
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
