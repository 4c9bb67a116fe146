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

Run on the card: ``python -m tpudml_torch.tools.profile_train [--flagship]``
(one JSON line at the end; ``--out FILE`` also writes it to FILE).
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
BATCH = 8


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--flagship", action="store_true",
                   help="the bf16 fused-head flagship step instead of the f32 one")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device; this measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import build_kernels
    from tpudml_torch.optim import Adam, AdamW
    from tpudml_torch.train import TrainState, make_lm_fused_train_step, make_train_step

    build_kernels()
    t = MODEL["max_len"]
    if args.flagship:
        batches = itertools.repeat(synthetic_lm(BATCH, t, MODEL["vocab_size"], seed=1))
        bf16 = dict(compute_dtype=torch.bfloat16)
        configs = (("kernel", dict(impl="flash", fused_ln=True, **bf16), True),
                   ("plain", dict(impl="full", fused_ln=False, **bf16), False))
    else:
        seqs = synthetic_lm(4 * BATCH, t, MODEL["vocab_size"], seed=0)
        rng = np.random.default_rng(0)
        batches = itertools.cycle(
            [seqs[rng.integers(0, len(seqs), size=BATCH)] for _ in range(8)])
        configs = (("kernel", dict(impl="flash", fused_ln=True), False),
                   ("plain", dict(impl="full", fused_ln=False), False))
    result = {"device": torch.cuda.get_device_name(0), "model": MODEL,
              "batch": BATCH, "tokens_per_step": BATCH * t,
              "step": "flagship bf16 (fused xent head, AdamW 3e-4)" if args.flagship
              else "f32 (materialized logits, Adam 1e-3)"}
    for name, kw, fused_head in configs:
        model = TransformerLM(**MODEL, **kw, device="cuda",
                              generator=torch.Generator().manual_seed(0))
        opt = AdamW(lr=3e-4) if args.flagship else Adam(lr=1e-3)
        step = (make_lm_fused_train_step(model, opt, save_scores=True) if fused_head
                else make_train_step(model, opt))
        ts = TrainState.create(model, opt)

        def one_step(ts=ts, step=step):
            batch = next(batches)
            step(ts, batch[:, :-1], batch[:, 1:])

        torch.cuda.reset_peak_memory_stats()
        r = _measure(one_step, args.iters)
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["tokens_per_sec"] = BATCH * t / r["wall_ms"] * 1e3
        result[name] = r
        del model, ts, step
        torch.cuda.empty_cache()
    for key in ("kernel", "plain"):
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
