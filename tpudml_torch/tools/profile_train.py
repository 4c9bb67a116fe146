"""Where the training step's time goes on the card.

Builds the training slice's full-width model (the repo's chip training
config: V=32768, d=512, H=4, L=6, T=1024, B=8, RoPE, f32, Adam) twice
from one seeded initial state — the kernel configuration
(``impl="flash", fused_ln=True``) and the plain one (``impl="full",
fused_ln=False``; parameters are drawn in the same order, so the two
start equal) — and measures one ``make_train_step`` step of each:

- wall ms per step (host clock around N back-to-back steps ending in a
  synchronize) and the CUDA-event span per step;
- a ``torch.profiler`` breakdown: device time by kernel, the kernel
  count and the sum of kernel time per step, and the device's busy share
  (kernel time over wall time) while the host drives it;
- the peak device memory of a step.

Batches follow task5 (``synthetic_lm(4·B, T, V, 0)`` rows drawn by
``np.random.default_rng(0)``), handed to the step as numpy arrays.

``--flagship`` profiles the flagship step instead (``bench.py``
``bench_transformer``): ``compute_dtype=bfloat16`` with f32 master
weights, AdamW lr 3e-4, bench's one batch (``synthetic_lm(8, 1024, 32768,
seed=1)``) every step; the kernel configuration trains through
``make_lm_fused_train_step(save_scores=True)`` (the fused linear-xent
head), the plain one through ``make_train_step`` (materialized logits).

``--long`` profiles the long-context step instead (BASELINE.md:45: T=16384,
B=2, the same widths, f32, Adam lr 1e-3, flash attention, RoPE, unfused
LayerNorm, task5's batches): the lean fused head that ``--fused_xent``
resolves to there (``save_scores=None``: kernels 10, 14, 15) against the
saved-scores head (``save_scores=True``: kernels 11, 12, 13 and a 4 GiB
f32 score residual). No kernel-free configuration: full attention would
hold 8 GiB of scores a layer. Its default is 3 timed steps.

``--wide`` profiles the same f32 step on the wide trunk of
``chip_smoke.py``'s ``train_wide`` phase (d=2048, H=16, L=2: the width of
a GPT-3 1.3B trunk, whose add+LN rows take the wide LayerNorm instances).

``--moe E --moe_variant {gather, ragged_stock, ragged_grouped}`` profiles
one step of ``bench.py --moe`` (``bench_moe``) instead: the training
config in bf16 compute over f32 master weights with flash attention,
fused add+LN, RoPE, top-1 MoE FFNs of E experts at capacity factor 1.25
(the variant's dispatch and dW backward), AdamW lr 3e-4, bench's one batch
(``synthetic_lm(8, 1024, 32768, seed=3)``) every step, through
``make_train_step`` (materialized logits). One configuration, "moe".

Run on the card: ``python -m tpudml_torch.tools.profile_train [--flagship | --long |
--wide | --moe 8 --moe_variant ragged_grouped]`` (one JSON line at the end; ``--out FILE``
also writes it to FILE).
"""

from __future__ import annotations

import argparse
import itertools
import json

import numpy as np
import torch

from tpudml_torch.tools.profile_serve import _measure

MODEL = dict(vocab_size=32768, embed_dim=512, num_heads=4, num_layers=6,
             max_len=1024, rope=True)
WIDE = dict(embed_dim=2048, num_heads=16, num_layers=2)  # chip_smoke.py's WIDE_MODEL
BATCH = 8
LONG_T, LONG_BATCH = 16384, 2  # BASELINE.md:45
# bench_moe's variants (bench.py:586-661), also driven by chip_smoke.py.
MOE_VARIANTS = {"gather": dict(moe_dispatch="gather"),
                "ragged_stock": dict(moe_dispatch="ragged", moe_ragged_dw="stock"),
                "ragged_grouped": dict(moe_dispatch="ragged", moe_ragged_dw="grouped")}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=None,
                   help="timed steps (default 10; 3 with --long)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--flagship", action="store_true",
                      help="the bf16 fused-head flagship step instead of the f32 one")
    mode.add_argument("--long", action="store_true",
                      help="the T=16384 long-context step, lean vs saved-scores head")
    mode.add_argument("--wide", action="store_true",
                      help="the f32 step on the wide trunk (d=2048, H=16, L=2)")
    mode.add_argument("--moe", type=int, default=0, metavar="E",
                      help="one bench_moe step with E experts (bf16, top-1, capacity 1.25)")
    p.add_argument("--moe_variant", choices=sorted(MOE_VARIANTS), default="ragged_grouped")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    iters = args.iters or (3 if args.long else 10)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device; this measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import build_kernels
    from tpudml_torch.optim import Adam, AdamW
    from tpudml_torch.train import TrainState, make_lm_fused_train_step, make_train_step

    build_kernels()
    model_cfg, batch = MODEL, BATCH
    if args.long:
        model_cfg, batch = dict(MODEL, max_len=LONG_T), LONG_BATCH
    if args.wide:
        model_cfg = dict(MODEL, **WIDE)
    t = model_cfg["max_len"]
    if args.flagship or args.moe:
        seed = 3 if args.moe else 1  # bench.py:604 / :351
        batches = itertools.repeat(synthetic_lm(BATCH, t, MODEL["vocab_size"], seed=seed))
        bf16 = dict(compute_dtype=torch.bfloat16)
        configs = ((("moe", dict(impl="flash", fused_ln=True, moe_experts=args.moe,
                                 moe_capacity_factor=1.25, **MOE_VARIANTS[args.moe_variant],
                                 **bf16), False),) if args.moe else
                   (("kernel", dict(impl="flash", fused_ln=True, **bf16), True),
                    ("plain", dict(impl="full", fused_ln=False, **bf16), False)))
    else:
        seqs = synthetic_lm(4 * batch, t, MODEL["vocab_size"], seed=0)
        rng = np.random.default_rng(0)
        batches = itertools.cycle(
            [seqs[rng.integers(0, len(seqs), size=batch)] for _ in range(8)])
        configs = ((("lean", dict(impl="flash"), None), ("saved", dict(impl="flash"), True))
                   if args.long else
                   (("kernel", dict(impl="flash", fused_ln=True), False),
                    ("plain", dict(impl="full", fused_ln=False), False)))
    step_name = (f"MoE E={args.moe} {args.moe_variant} bf16 (AdamW 3e-4)" if args.moe else
                 "flagship bf16 (fused xent head, AdamW 3e-4)" if args.flagship else
                 "long-context f32 T=16384 (fused xent head, Adam 1e-3)" if args.long
                 else "wide-trunk f32 d=2048 (materialized logits, Adam 1e-3)" if args.wide
                 else "f32 (materialized logits, Adam 1e-3)")
    result = {"device": torch.cuda.get_device_name(0), "model": model_cfg,
              "batch": batch, "tokens_per_step": batch * t, "step": step_name}
    for name, kw, save_scores in configs:
        model = TransformerLM(**model_cfg, **kw, device="cuda",
                              generator=torch.Generator().manual_seed(0))
        opt = AdamW(lr=3e-4) if args.flagship or args.moe else Adam(lr=1e-3)
        fused_head = args.long or save_scores
        step = (make_lm_fused_train_step(model, opt, save_scores=save_scores) if fused_head
                else make_train_step(model, opt))
        ts = TrainState.create(model, opt)

        def one_step(ts=ts, step=step):
            batch = next(batches)
            step(ts, batch[:, :-1], batch[:, 1:])

        torch.cuda.reset_peak_memory_stats()
        r = _measure(one_step, iters)
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["tokens_per_sec"] = batch * t / r["wall_ms"] * 1e3
        result[name] = r
        del model, ts, step
        torch.cuda.empty_cache()
    for key, _, _ in configs:
        r = result[key]
        print(f"[profile] {result['step']} step, {key}: wall {r['wall_ms']:.3f} ms, events "
              f"{r['event_ms']:.3f} ms, {r['kernels_per_call']:.0f} kernels summing "
              f"{r['kernel_ms_per_call']:.3f} ms (busy {r['busy_share']:.2f}), "
              f"{r['tokens_per_sec']:.0f} tokens/s, peak {r['peak_mem_gb']:.2f} GB")
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
