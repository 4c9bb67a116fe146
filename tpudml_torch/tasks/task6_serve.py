"""Task 6 — prefill/decode LM serving with continuous batching, on the port.

Drives ``tpudml_torch.serve.ServingEngine`` over a decoder-only
``TransformerLM`` with a seeded Poisson arrival stream (open-loop: arrival
times are fixed before the run, so queueing delay shows up in the
latencies). Same flags as ``tasks/task6_serve.py`` plus ``--device``
(default ``cuda``; ``cpu`` runs the plain versions of the kernels). The
levers not ported yet — ``--tp``, ``--paged``, ``--spec_k``,
``--slo_tpot_ms`` and ``--obs`` — raise ``NotImplementedError``.

Reports generated tokens/sec and p50/p99 per-token, time-to-first-token
and end-to-end latency, then cross-checks the workload ledger's
per-request TTFT/TPOT annotations against the raw timing ledger.

Run: ``python -m tpudml_torch.tasks.task6_serve --n_requests 16 --qps 4``
"""

from __future__ import annotations

import argparse

import torch

from tpudml_torch.device import resolve_device
from tpudml_torch.metrics import MetricsWriter
from tpudml_torch.models import TransformerLM
from tpudml_torch.serve import ServeConfig, ServingEngine, poisson_workload
from tpudml_torch.serve.engine import NOT_PORTED


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    # model
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--embed_dim", type=int, default=128)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--num_kv_heads", type=int, default=None, help="GQA/MQA")
    p.add_argument("--no_rope", action="store_true",
                   help="learned position table instead of rotary")
    # serving
    p.add_argument("--slots", type=int, default=4,
                   help="fixed decode batch: concurrent in-flight sequences")
    p.add_argument("--max_len", type=int, default=256,
                   help="cache rows per slot (prompt + generation bound)")
    p.add_argument("--prefill_chunk", type=int, default=32)
    p.add_argument("--cache_kind", choices=("f32", "bf16", "int8"),
                   default="f32")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel ways (0 = single device)")
    # multi-tenant levers
    p.add_argument("--paged", action="store_true",
                   help="page-pool KV cache layout")
    p.add_argument("--page_size", type=int, default=16)
    p.add_argument("--num_pages", type=int, default=None,
                   help="pool size (default: dense-equivalent capacity)")
    p.add_argument("--prefix_sharing", action="store_true",
                   help="reuse pages across equal prompt heads (paged only)")
    p.add_argument("--spec_k", type=int, default=0,
                   help="draft tokens per target step (0 = off)")
    p.add_argument("--draft_layers", type=int, default=None,
                   help="trunk-draft depth (default: num_layers // 2)")
    p.add_argument("--slo_tpot_ms", type=float, default=None,
                   help="per-token budget for SLO-priced admission")
    p.add_argument("--weight_quant", choices=("int8", "int8_sim"),
                   default=None,
                   help="int8 per-channel weight quantization; int8_sim = "
                        "f32-storage oracle")
    # workload
    p.add_argument("--n_requests", type=int, default=16)
    p.add_argument("--qps", type=str, default="4",
                   help="Poisson arrival rate; 'inf' = all at t=0")
    p.add_argument("--prompt_len", type=int, nargs=2, default=(8, 48),
                   metavar=("MIN", "MAX"))
    p.add_argument("--new_tokens", type=int, nargs=2, default=(8, 32),
                   metavar=("MIN", "MAX"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", type=str, default="./logs")
    # observability
    p.add_argument("--obs", action="store_true",
                   help="write run_dir/trace.json from the event log")
    p.add_argument("--step_time_s", type=float, default=None,
                   help="virtual decode-step clock (deterministic runs)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain versions)")
    return p.parse_args(argv)


def build_engine(args) -> ServingEngine:
    device = resolve_device(args.device)
    for flag, on in (("--tp", args.tp), ("--paged", args.paged),
                     ("--spec_k", args.spec_k),
                     ("--slo_tpot_ms", args.slo_tpot_ms is not None),
                     ("--obs", args.obs)):
        if on:
            raise NotImplementedError(f"{flag} {NOT_PORTED}")
    model = TransformerLM(
        vocab_size=args.vocab,
        embed_dim=args.embed_dim,
        num_heads=args.num_heads,
        num_layers=args.num_layers,
        num_kv_heads=args.num_kv_heads,
        max_len=args.max_len,
        rope=not args.no_rope,
        device=device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    cfg = ServeConfig(
        slots=args.slots, max_len=args.max_len,
        prefill_chunk=args.prefill_chunk, cache_kind=args.cache_kind,
        page_size=args.page_size, num_pages=args.num_pages,
        step_time_s=args.step_time_s, weight_quant=args.weight_quant,
    )
    return ServingEngine(model, cfg, device=device)


def run(args) -> dict:
    qps = float(args.qps)
    engine = build_engine(args)
    requests, ledger = poisson_workload(
        args.n_requests, qps, args.seed, vocab_size=args.vocab,
        prompt_len=tuple(args.prompt_len),
        new_tokens=tuple(args.new_tokens),
    )
    report = engine.run(requests)

    owed = sum(o["max_new_tokens"] for o in ledger.values())
    if report.generated_tokens != owed:
        raise RuntimeError(
            f"token accounting mismatch: generated {report.generated_tokens}, "
            f"ledger owes {owed}")
    # Exact accounting: the ledger's per-request TTFT/TPOT annotations
    # must replay bit-for-bit from the raw timing ledger.
    report.annotate_ledger(ledger)
    for rid, row in ledger.items():
        st = report.requests[rid]
        if len(st.token_times) >= 2:
            span = st.token_times[-1] - st.token_times[0]
            tpot = span / (len(st.token_times) - 1)
        else:
            tpot = None
        if row["ttft_s"] != st.first_token - st.arrival or row["tpot_s"] != tpot:
            raise RuntimeError(f"ledger annotation mismatch for request {rid}")
    lat = report.latency_summary()
    writer = MetricsWriter(args.log_dir, run_name="task6-serve-torch")
    writer.add_scalar("Serve Tokens Per Sec", report.tokens_per_sec, 0)
    writer.add_scalar("Per-Token p50 (ms)", lat["per_token_p50_s"] * 1e3, 0)
    writer.add_scalar("Per-Token p99 (ms)", lat["per_token_p99_s"] * 1e3, 0)
    writer.add_scalar("E2E p99 (s)", lat["e2e_p99_s"], 0)
    writer.close()

    refills = sum(1 for e in report.events if e[0] == "admit" and e[3] > 0)
    mode = f"/w{args.weight_quant}" if args.weight_quant else ""
    print(
        f"[serve{mode}/{args.cache_kind}/{engine.device}] {args.n_requests} "
        f"requests @ qps={args.qps}, {args.slots} slots: "
        f"{report.generated_tokens} tokens in {report.wall_time:.2f}s "
        f"({report.tokens_per_sec:,.1f} tok/s, {report.decode_steps} decode "
        f"steps, {refills} mid-flight refills)"
    )
    print(
        f"  per-token p50/p99: {lat['per_token_p50_s'] * 1e3:.2f}/"
        f"{lat['per_token_p99_s'] * 1e3:.2f} ms | ttft p50/p99: "
        f"{lat['ttft_p50_s'] * 1e3:.1f}/{lat['ttft_p99_s'] * 1e3:.1f} ms | "
        f"e2e p50/p99: {lat['e2e_p50_s']:.3f}/{lat['e2e_p99_s']:.3f} s"
    )
    return {
        "tokens_per_sec": report.tokens_per_sec,
        "decode_steps": report.decode_steps,
        "generated_tokens": report.generated_tokens,
        "mid_flight_refills": refills,
        **lat,
    }


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
