"""Task 5 — long-context transformer training, on the port.

Trains a decoder-only ``TransformerLM`` on deterministic synthetic
next-token data (``synthetic_lm``) with Adam, through
``tpudml_torch.train.make_train_step`` (``--fused_xent``:
``make_lm_fused_train_step``, the fused linear-cross-entropy head). Same
flags as ``tasks/task5_longcontext.py`` plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions of the kernels). Ported:
``--parallel single`` with ``--attn full|flash``, ``--fused_ln``,
``--rope``, ``--num_kv_heads``, ``--target_loss``, ``--fused_xent`` and
``--fused_xent_scores`` (validated as in JAX). ``--fused_xent_lean``, and
``--fused_xent`` alone when its auto mode resolves to the lean backward,
raise ``NotImplementedError`` (kernels 14 and 15); so do every other
``--parallel`` value, ``--moe_experts``, ``--dropout``, ``--sentinel``
and ``--ckpt_dir``, naming their ROADMAP item.

Same row sampling (``np.random.default_rng(seed)`` over
``synthetic_lm(4·B, …)``) and steady-state clock as the JAX entry point;
reports steady-state tokens/sec and the final loss. The model's initial
weights come from ``torch.Generator().manual_seed(seed)``, not from
JAX's threefry keys, so the numbers differ from the JAX run's.

Run: ``python -m tpudml_torch.tasks.task5_longcontext --attn flash --fused_ln --rope``
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from tpudml_torch.data import synthetic_lm
from tpudml_torch.device import resolve_device
from tpudml_torch.metrics import MetricsWriter
from tpudml_torch.models import TransformerLM
from tpudml_torch.ops.xent_kernel import LEAN_NOT_PORTED, _auto_save_s
from tpudml_torch.optim import make_optimizer
from tpudml_torch.train import TrainState, make_lm_fused_train_step, make_train_step

NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item {})"
PARALLEL_ITEMS = {
    "dp": "5 (data parallel)",
    "fsdp": "7 (sharded training engines)",
    "tp": "7 (sharded training engines)",
    "pp": "7 (sharded training engines)",
    "cp": "8 (context parallel)",
    "ep": "9 (MoE)",
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--parallel",
                   choices=["single", "dp", "fsdp", "cp", "tp", "pp", "ep"],
                   default="single")
    p.add_argument("--microbatches", type=int, default=4, help="pp micro-batches")
    p.add_argument("--fused_ln", action="store_true",
                   help="fused residual-add+LayerNorm junction kernels")
    p.add_argument("--fused_xent_scores", action="store_true",
                   help="fused-xent head, saved-scores backward")
    p.add_argument("--fused_xent_lean", action="store_true",
                   help="fused-xent head, lean backward (not ported)")
    p.add_argument("--fused_xent", action="store_true",
                   help="fused linear-cross-entropy head")
    p.add_argument("--target_loss", type=float, default=None,
                   help="stop when train loss reaches this value (checked on "
                   "--log_every steps; every 10 steps when --log_every 0)")
    p.add_argument("--v_chunks", type=int, default=2, help="pp interleaved only")
    p.add_argument("--pp_data", type=int, default=1, help="pp only")
    p.add_argument("--schedule", choices=["gpipe", "1f1b", "interleaved"],
                   default="gpipe", help="pp only")
    p.add_argument("--attn", choices=["full", "flash", "ring", "ulysses"],
                   default=None, help="attention impl; default full")
    p.add_argument("--cp_layout", choices=["contiguous", "striped"],
                   default="contiguous", help="cp only")
    p.add_argument("--n_devices", type=int, default=None)
    p.add_argument("--seq_len", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8, help="global batch (sequences)")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--embed_dim", type=int, default=128)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--num_kv_heads", type=int, default=None, help="GQA/MQA")
    p.add_argument("--rope", action="store_true", help="rotary positions")
    p.add_argument("--remat", action="store_true",
                   help="accepted for compatibility (ring backward only)")
    p.add_argument("--moe_experts", type=int, default=0, help="MoE FFN experts")
    p.add_argument("--moe_top_k", type=int, default=1)
    p.add_argument("--moe_dispatch", choices=("gather", "einsum", "ragged"),
                   default="gather")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--log_dir", type=str, default="./logs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sentinel", action="store_true", help="not ported")
    p.add_argument("--ckpt_dir", type=str, default=None, help="not ported")
    p.add_argument("--ckpt_every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain versions)")
    args = p.parse_args(argv)
    if (args.resume or args.ckpt_every) and not args.ckpt_dir:
        p.error("--resume/--ckpt_every need --ckpt_dir")
    return args


def _save_scores(args) -> bool | None:
    """The fused head's mode flags, validated as the JAX entry point does:
    the tristate save_scores (True / False = lean / None = auto)."""
    scores, lean = args.fused_xent_scores, args.fused_xent_lean
    if (scores or lean) and not args.fused_xent:
        raise ValueError("--fused_xent_scores/--fused_xent_lean require --fused_xent")
    if scores and lean:
        raise ValueError("--fused_xent_scores and --fused_xent_lean are exclusive")
    return True if scores else (False if lean else None)


def _reject_unported(args) -> None:
    if args.parallel != "single":
        raise NotImplementedError(
            f"--parallel {args.parallel} {NOT_PORTED.format(PARALLEL_ITEMS[args.parallel])}")
    args._save_scores = _save_scores(args)
    if args.fused_xent and (args._save_scores is False or (
            args._save_scores is None and not _auto_save_s(
                args.batch_size * args.seq_len, args.vocab, 256, 2048))):
        # linear_cross_entropy's default tiles decide the auto mode.
        raise NotImplementedError(f"--fused_xent in its lean mode: {LEAN_NOT_PORTED}")
    for flag, on, item in (
        ("--moe_experts", args.moe_experts, "9 (MoE)"),
        ("--dropout", args.dropout, "3 (Dropout)"),
        ("--sentinel", args.sentinel, "6 (resilience)"),
        ("--ckpt_dir", args.ckpt_dir, "6 (checkpoint)"),
    ):
        if on:
            raise NotImplementedError(f"{flag} {NOT_PORTED.format(item)}")
    if args.attn in ("ring", "ulysses"):
        raise ValueError(f"--attn {args.attn} requires --parallel cp")
    if args.cp_layout != "contiguous":
        raise ValueError("--cp_layout striped requires --parallel cp")


def build_engine(args, device: torch.device):
    """(train_state, step_fn) for ``--parallel single``."""
    _reject_unported(args)
    model = TransformerLM(
        vocab_size=args.vocab,
        embed_dim=args.embed_dim,
        num_heads=args.num_heads,
        num_layers=args.num_layers,
        max_len=args.seq_len,
        num_kv_heads=args.num_kv_heads,
        rope=args.rope,
        impl=args.attn or "full",
        fused_ln=args.fused_ln,
        device=device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    opt = make_optimizer("adam", args.lr)
    if args.fused_xent:
        step = make_lm_fused_train_step(model, opt, save_scores=args._save_scores)
    else:
        step = make_train_step(model, opt)
    return TrainState.create(model, opt), step


def run(args) -> dict:
    if args.steps < 1:
        raise ValueError("--steps must be >= 1")
    device = resolve_device(args.device)
    ts, step = build_engine(args, device)
    seqs = synthetic_lm(args.batch_size * 4, args.seq_len, args.vocab, seed=args.seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    writer = MetricsWriter(args.log_dir, run_name=f"task5-{args.parallel}-torch")
    rng = np.random.default_rng(args.seed)
    t0 = None
    loss = float("nan")
    hit_target = None
    time_to_target = None
    final_step = args.steps
    steady_from = 1
    # Steady state: past the first (warm-up) steps, capped at 5 so a run
    # that hits its target at the earliest check still has a window.
    steady_mark = min(max(args.steps // 5, 1), 5)
    for i in range(1, args.steps + 1):
        rows = rng.integers(0, len(seqs), size=args.batch_size)
        batch = seqs[rows]
        ts, metrics = step(ts, batch[:, :-1], batch[:, 1:])
        if i == steady_mark:
            sync()
            t0, steady_from = time.time(), i
        logged = args.log_every and i % args.log_every == 0
        if logged:
            loss = float(metrics["loss"])
            writer.add_scalar("Train Loss", loss, i)
            print(f"step {i}: loss {loss:.4f}")
        if args.target_loss is not None and t0 is not None and (logged or (
            not args.log_every and i % 10 == 0
        )):
            checked = loss if logged else float(metrics["loss"])
            if checked <= args.target_loss:
                hit_target, final_step = i, i
                time_to_target = time.time() - t0
                print(f"target loss {args.target_loss} reached at step {i} "
                      f"({time_to_target:.1f}s after steady-state step {steady_from})")
                break
    sync()
    loss = float(metrics["loss"])
    elapsed = time.time() - t0 if t0 else float("nan")
    tokens = (final_step - steady_from) * args.batch_size * args.seq_len
    tok_per_s = (
        tokens / elapsed if tokens > 0 and elapsed and elapsed > 0 else float("nan")
    )
    ppl = math.exp(min(loss, 700.0))
    print(
        f"[{args.parallel}/{args.attn or 'default'}/{device.type}] 1 device(s), "
        f"T={args.seq_len}: {tok_per_s:,.0f} tokens/sec, final loss {loss:.4f} "
        f"(ppl {ppl:.2f})"
    )
    writer.add_scalar("Tokens Per Sec", tok_per_s, final_step)
    writer.add_scalar("Perplexity", ppl, final_step)
    writer.close()
    return {
        "tokens_per_sec": tok_per_s,
        "final_loss": loss,
        "perplexity": ppl,
        "devices": 1,
        "device": str(device),
        "steps_run": final_step,
        "target_reached_at": hit_target,
        "time_to_target_s": time_to_target,
    }


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
