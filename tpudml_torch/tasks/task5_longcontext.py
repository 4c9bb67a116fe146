"""Task 5 — long-context transformer training, on the port.

Trains a decoder-only ``TransformerLM`` on deterministic synthetic
next-token data (``synthetic_lm``) with Adam, through
``tpudml_torch.train.make_train_step`` (``--fused_xent``:
``make_lm_fused_train_step``, the fused linear-cross-entropy head). Same
flags as ``tasks/task5_longcontext.py`` plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions of the kernels). Ported:
``--parallel single`` with ``--attn full|flash``, ``--fused_ln``,
``--rope``, ``--num_kv_heads``, ``--target_loss``, ``--fused_xent``,
``--fused_xent_scores`` and ``--fused_xent_lean`` (validated as in JAX;
``--fused_xent`` alone takes the saved-scores backward while its f32
score residual fits 2 GiB and the lean O(N) one beyond, as at the
long-context recording T=16384, B=2, V=32768), and ``--moe_experts``
with ``--moe_top_k`` and ``--moe_dispatch`` (MoE FFN blocks; the step
adds the Switch aux term at α = 0.01, as JAX's does), and ``--parallel
dp``: ``tpudml_torch.parallel.DataParallel`` over the process group, one
process per replica (``torchrun --nproc_per_node N``; a process started
alone builds a one-rank group), world = the process count
(``--n_devices``, if given, must equal it), and ``--parallel ep``:
``tpudml_torch.parallel.ExpertParallel`` over the same group, the MoE
blocks' experts split over the ranks (it needs ``--moe_experts``
divisible by the world, rejects ``--dropout`` with JAX's wording, and
the ragged dispatch raises, as in JAX), and ``--parallel fsdp`` and
``tp``: ``tpudml_torch.parallel.FSDP`` over ``{"data": world}`` and
``GSPMDParallel`` with ``tensor_parallel_rules("model")`` over ``{"model":
world}``, both taking ``--fused_xent`` (the vocab-sharded head, with
``--fused_xent_scores``/``--fused_xent_lean``) and ``--sentinel``. Every rank draws the same
global batch from the same ``rng`` and trains on its rows; only rank 0
prints and writes metrics. ``--dropout`` (``--parallel single`` and
``dp``) drops the blocks' branches with the dropout keys of JAX's entry,
``key(seed ^ 0xD0)`` folded with the step (and, under ``dp``, the rank).
``--sentinel`` wraps the ``dp``, ``fsdp`` and ``tp`` optimizers in
``GradSentinel`` (non-finite steps skipped on the device;
``SentinelTripped`` past its budget) and, as in JAX, raises
``ValueError`` with ``single`` and ``ep``.
``--ckpt_dir`` saves every ``--ckpt_every`` steps and at the end, in the
format-2 store of ``tpudml_torch.checkpoint``; ``--resume`` restores the
latest valid checkpoint and continues: the loop counter is the global
step, and the row stream is drawn on past the restored step's rows, so a
resumed run takes the batches the uninterrupted run took (JAX's loop
restarts the stream at the seed; ROADMAP.md queue 3). Under ``ep``,
``fsdp`` and ``tp`` a checkpoint holds whole leaves at any world, as
JAX's task5 writes its global arrays: the ranks gather their blocks,
rank 0 writes, and a resume cuts them back (the engines' ``full_state``).
``--parallel pp``: the pipelines of ``tpudml_torch.parallel.pp``, one
``TransformerBlock`` a stage (``TransformerEmbed`` and ``TransformerHead``
replicated), ``--schedule gpipe | 1f1b | interleaved`` with
``--microbatches``, ``--v_chunks``, ``--pp_data`` (PP×DP), ``--remat``
(GPipe), ``--dropout`` (1f1b and interleaved, with JAX's message
otherwise), ``--sentinel`` and ``--ckpt_dir``; ``--moe_experts`` and
``--fused_xent`` are rejected with JAX's keys. ``--parallel cp``:
``tpudml_torch.parallel.ContextParallel`` over ``{"seq": world}``, the
time axis split over the ranks, ``--attn ring`` (default) or ``ulysses``,
``--cp_layout contiguous | striped`` (striped needs ring), taking
``--fused_xent`` (with ``--fused_xent_scores``/``--fused_xent_lean``),
``--fused_ln``, ``--rope``, ``--num_kv_heads``, ``--moe_experts``,
``--dropout`` (keys folded with the step and the seq index, as in JAX) and
``--ckpt_dir`` (the state is replicated); ``--remat`` is accepted and
implied (the ring's backward recomputes), ``--sentinel`` is rejected with
JAX's wording.

Same row sampling (``np.random.default_rng(seed)`` over
``synthetic_lm(4·B, …)``) and steady-state clock as the JAX entry point;
``run(args, hooks=...)`` calls each hook after every step as
``hook(step=, train_state=, metrics=)`` (``train_loop``'s contract; the
kill/resume drill's ``rank_kill_hook``);
reports steady-state tokens/sec and the final loss. The model's initial
weights come from ``torch.Generator().manual_seed(seed)``, not from
JAX's threefry keys, so the numbers differ from the JAX run's.

Run: ``python -m tpudml_torch.tasks.task5_longcontext --attn flash --fused_ln --rope``;
long context on the lean head: ``--attn flash --seq_len 16384 --batch_size 2
--vocab 32768 --embed_dim 512 --num_heads 4 --num_layers 6 --rope --steps 30
--lr 0.001 --fused_xent``; MoE with the grouped-dW kernel: add
``--moe_experts 8 --moe_dispatch ragged``; data parallel over gloo on the
CPU: ``torchrun --nproc_per_node 2 -m tpudml_torch.tasks.task5_longcontext
--parallel dp --device cpu``; expert parallel: ``--parallel ep
--moe_experts 8`` (one process: a one-rank group; ``torchrun`` for more);
FSDP and tensor parallel: ``--parallel fsdp`` / ``--parallel tp`` (add
``--fused_xent`` for the vocab-sharded head); pipelines: ``torchrun
--nproc_per_node 2 -m tpudml_torch.tasks.task5_longcontext --parallel pp
--schedule 1f1b --device cpu``; context parallel: ``torchrun
--nproc_per_node 2 -m tpudml_torch.tasks.task5_longcontext --parallel cp
--attn ring --cp_layout striped --device cpu``
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from tpudml_torch.capabilities import reject
from tpudml_torch.checkpoint import CheckpointManager
from tpudml_torch.core import assert_same_program, process_count, process_group, process_index
from tpudml_torch.core.prng import seed_key
from tpudml_torch.data import synthetic_lm
from tpudml_torch.device import default_device, resolve_device
from tpudml_torch.metrics import MetricsWriter
from tpudml_torch.models import TransformerLM
from tpudml_torch.optim import make_optimizer
from tpudml_torch.parallel import (
    FSDP, ContextParallel, DataParallel, ExpertParallel, GSPMDParallel, tensor_parallel_rules,
)
from tpudml_torch.resilience import sentinel_hook
from tpudml_torch.train import TrainState, make_lm_fused_train_step, make_train_step

# The engines that run inside a process group (one process a rank).
GROUP_ENGINES = ("dp", "ep", "fsdp", "tp", "pp", "cp")


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
                   help="fused-xent head, lean (recompute) backward")
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
                   help="pp --schedule gpipe: recompute each tick's block in the backward")
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
    p.add_argument("--sentinel", action="store_true",
                   help="step sentinel: skip non-finite updates (--parallel dp/fsdp/tp/pp)")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="checkpoint directory (enables --ckpt_every/--resume)")
    p.add_argument("--ckpt_every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", type=str, default=default_device(),
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
    if args.parallel == "ep":
        # MoE decoder trained expert-parallel (the world is checked in
        # build_engine, inside the group).
        if not args.moe_experts:
            raise ValueError("--parallel ep needs --moe_experts N")
        if args.dropout:
            reject("ep_dropout")
        if args.fused_xent:
            # JAX's ExpertParallel trains through materialized logits and its
            # task5 drops the flag without a word; the port says so.
            raise ValueError("--parallel ep trains through materialized logits; "
                             "--fused_xent composes with --parallel single, dp, fsdp and tp")
    if args.parallel == "pp" and args.fused_xent:
        # The pipeline's epilogue takes the last stage's output whole:
        # there is no pre-head feature tensor for the fused head.
        reject("pp_fused_xent")
    args._save_scores = _save_scores(args)
    if args.sentinel and args.parallel not in ("dp", "fsdp", "tp", "pp"):
        # single's step and the ep engine have no sentinel slot in their
        # optimizer chain (JAX's wording).
        raise ValueError(f"--sentinel composes with --parallel dp/fsdp/tp/pp, not "
                         f"{args.parallel!r}")
    if args.parallel != "cp" and args.attn in ("ring", "ulysses"):
        raise ValueError(f"--attn {args.attn} requires --parallel cp")
    if args.cp_layout != "contiguous" and args.parallel != "cp":
        raise ValueError("--cp_layout striped requires --parallel cp")
    if args.parallel == "cp":
        if (args.attn or "ring") not in ("ring", "ulysses"):
            raise ValueError("cp needs --attn ring|ulysses")
        if args.cp_layout == "striped" and (args.attn or "ring") != "ring":
            raise ValueError("--cp_layout striped requires --attn ring")


def build_engine(args, device: torch.device):
    """(train_state, step_fn) for ``--parallel single``, ``dp``, ``ep``,
    ``fsdp``, ``tp``, ``pp`` or ``cp`` (all but the first inside a process
    group)."""
    _reject_unported(args)
    args._sentinel = None  # the engine's GradSentinel, for the escalation hook
    args._sharded = None  # the EP, FSDP, TP or pipeline engine: checkpoints hold whole leaves
    if args.parallel == "ep" and args.moe_experts % process_count():
        raise ValueError(f"--moe_experts {args.moe_experts} must divide over "
                         f"{process_count()} devices")
    opt = make_optimizer("adam", args.lr)
    rng_root = seed_key(args.seed ^ 0xD0) if args.dropout else None
    if args.parallel == "pp":
        pipe = _pipeline(args, device, opt, rng_root)
        args._sentinel = pipe.sentinel
        args._sharded = pipe
        return pipe.create_state(args.seed), pipe.make_train_step()
    cp = args.parallel == "cp"
    model = TransformerLM(
        vocab_size=args.vocab,
        embed_dim=args.embed_dim,
        num_heads=args.num_heads,
        num_layers=args.num_layers,
        max_len=args.seq_len,
        num_kv_heads=args.num_kv_heads,
        rope=args.rope,
        impl=args.attn or ("ring" if cp else "full"),
        seq_sharded=cp,
        seq_layout=args.cp_layout,
        fused_ln=args.fused_ln,
        moe_experts=args.moe_experts,
        moe_top_k=args.moe_top_k,
        moe_dispatch=args.moe_dispatch,
        moe_axis="expert" if args.parallel == "ep" else None,
        dropout=args.dropout,
        device=device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    if args.parallel == "dp":
        # [B, T] token batches are never the stacked-loader form.
        engine = DataParallel(model, opt, rng_root=rng_root, stacked_batches=False,
                              fused_xent=args.fused_xent, save_scores=args._save_scores,
                              sentinel=args.sentinel)
        args._sentinel = engine.sentinel
        return engine.create_state(), engine.make_train_step()
    if cp:
        engine = ContextParallel(model, opt, {"seq": process_count()}, rng_root=rng_root,
                                 layout=args.cp_layout, fused_xent=args.fused_xent,
                                 save_scores=args._save_scores)
        return engine.create_state(), engine.make_train_step()
    if args.parallel == "ep":
        engine = ExpertParallel(model, opt)
        args._sharded = engine
        return engine.create_state(), engine.make_train_step()
    if args.parallel in ("fsdp", "tp"):
        world = process_count()
        common = dict(rng_root=rng_root, fused_xent=args.fused_xent,
                      save_scores=args._save_scores, sentinel=args.sentinel)
        if args.parallel == "fsdp":  # ZeRO-3: params, grads, opt state over data too
            engine = FSDP(model, opt, {"data": world}, **common)
        else:
            engine = GSPMDParallel(model, opt, {"model": world},
                                   rule=tensor_parallel_rules("model"), axis_name="model",
                                   **common)
        args._sentinel = engine.sentinel
        args._sharded = engine
        return engine.create_state(), engine.make_train_step()
    if args.fused_xent:
        step = make_lm_fused_train_step(model, opt, rng_root, save_scores=args._save_scores)
    else:
        step = make_train_step(model, opt, rng_root)
    return TrainState.create(model, opt), step


def _pipeline(args, device: torch.device, opt, rng_root):
    """``--parallel pp`` (JAX's task5 pipeline branch): one decoder block a
    stage (depth S, or V·S under interleaved; ``--num_layers`` is ignored),
    the embedding and the head replicated, over ``{"stage": world}`` or,
    with ``--pp_data D``, ``{"data": D, "stage": world/D}``. The blocks are
    drawn from ``--seed`` (``GPipe.create_state``), the embedding and the
    head from ``torch.Generator().manual_seed(seed)``. ``--remat`` is
    GPipe's per-tick recompute (JAX's task5 drops the flag here)."""
    from tpudml_torch.models import TransformerBlock, TransformerEmbed, TransformerHead
    from tpudml_torch.parallel import GPipe, Interleaved1F1B, OneFOneB

    if args.moe_experts:
        reject("pp_moe")
    if args.dropout and args.schedule not in ("1f1b", "interleaved"):
        raise ValueError("--dropout pipelines need --schedule 1f1b or interleaved")
    n, d = process_count(), args.pp_data
    if d < 1 or n % d:
        raise ValueError(f"--pp_data {d} must be >= 1 and divide n_devices {n}")
    mesh = {"data": d, "stage": n // d} if d > 1 else {"stage": n}
    g = torch.Generator().manual_seed(args.seed)
    common = dict(
        n_microbatches=args.microbatches, mesh=mesh, optimizer=opt,
        prologue=TransformerEmbed(args.vocab, args.embed_dim, args.seq_len,
                                  use_pos_embed=not args.rope, generator=g),
        epilogue=TransformerHead(args.embed_dim, args.vocab, fused_ln=args.fused_ln,
                                 generator=g),
        batch_axis="data" if d > 1 else None, sentinel=args.sentinel, device=device)

    def block(gen):
        return TransformerBlock(args.embed_dim, args.num_heads, impl=args.attn or "full",
                                num_kv_heads=args.num_kv_heads, rope=args.rope,
                                dropout=args.dropout, fused_ln=args.fused_ln, generator=gen)

    if args.schedule == "interleaved":
        return Interleaved1F1B(block, rng_root=rng_root, v_chunks=args.v_chunks, **common)
    if args.schedule == "1f1b":
        return OneFOneB(block, rng_root=rng_root, **common)
    return GPipe(block, remat=args.remat, **common)


def run(args, hooks=()) -> dict:
    if args.steps < 1:
        raise ValueError("--steps must be >= 1")
    device = resolve_device(args.device)
    _reject_unported(args)
    if args.parallel not in GROUP_ENGINES:
        return _train(args, device, hooks=hooks)
    with process_group(device=device) as group:
        world = process_count(group)
        if args.n_devices and args.n_devices != world:
            raise ValueError(f"--n_devices {args.n_devices} != the {world} processes of "
                             "the group (one device each)")
        # All ranks must agree on argv (minus host-local paths).
        rank_invariant = {k: v for k, v in vars(args).items()
                          if k not in ("log_dir", "ckpt_dir")}
        assert_same_program(repr(sorted(rank_invariant.items())), "task5 args", group)
        return _train(args, device, world, lead=process_index(group) == 0, hooks=hooks)


def _train(args, device: torch.device, world: int = 1, lead: bool = True,
           hooks=()) -> dict:
    """The training loop; under a group engine every rank runs it on the
    same global batches, and rank 0 (``lead``) prints and writes the
    metrics."""
    ts, step = build_engine(args, device)
    seqs = synthetic_lm(args.batch_size * 4, args.seq_len, args.vocab, seed=args.seed)
    mgr = None
    start = 0
    # Under ep, fsdp, tp and pp past world 1 a rank holds blocks: the
    # checkpoint holds the leaves whole (gathered over their groups, rank 0
    # writing JAX's global arrays), and a resume cuts them back. A pipeline
    # always writes through its full_state: its stacked [S, V, d, d] stage
    # kernels are no conv kernels to turn HWIO.
    whole = args._sharded is not None and (world > 1 or args.parallel == "pp")

    def save(i):
        mgr.save(args._sharded.full_state(ts) if whole else ts, i,
                 metadata={"parallel": args.parallel})

    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume:
            # The latest VALID checkpoint: CRCs verified, corrupt or partial
            # step dirs walked past.
            if whole:
                view = args._sharded.full_state(ts)
                restored = mgr.restore_latest(view)
                if restored is not view:
                    args._sharded.load_full_state(ts, restored)
            else:
                ts = mgr.restore_latest(ts)
            start = int(ts.step)
            if start >= args.steps:
                raise ValueError(f"--resume: latest checkpoint is already at step {start} "
                                 f">= --steps {args.steps}; nothing left to run")
            if start and lead:
                print(f"resumed from step {start} ({args.ckpt_dir})")
    guard = None
    if args._sentinel is not None:
        # Escalate past the consecutive-skip budget, naming the poisoned leaf.
        guard = sentinel_hook(args._sentinel, ts.model)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    writer = MetricsWriter(args.log_dir, run_name=f"task5-{args.parallel}-torch") if lead else None
    rng = np.random.default_rng(args.seed)
    for _ in range(start):  # the row stream continues past the restored steps
        rng.integers(0, len(seqs), size=args.batch_size)
    t0 = None
    loss = float("nan")
    hit_target = None
    time_to_target = None
    final_step = args.steps
    steady_from = start + 1
    # Steady state: past the first (warm-up) steps of this run, capped at 5
    # so a run that hits its target at the earliest check still has a window.
    steady_mark = start + min(max((args.steps - start) // 5, 1), 5)
    for i in range(start + 1, args.steps + 1):
        # The loop counter IS the global step: checkpoint keys and logging
        # continue where a killed run stopped.
        rows = rng.integers(0, len(seqs), size=args.batch_size)
        batch = seqs[rows]
        ts, metrics = step(ts, batch[:, :-1], batch[:, 1:])
        if guard is not None:
            guard(step=i, train_state=ts, metrics=metrics)
        if mgr is not None and args.ckpt_every and i % args.ckpt_every == 0:
            save(i)
        for hook in hooks:
            hook(step=i, train_state=ts, metrics=metrics)
        if i == steady_mark:
            sync()
            t0, steady_from = time.time(), i
        logged = args.log_every and i % args.log_every == 0
        if logged:
            loss = float(metrics["loss"])
            if lead:
                writer.add_scalar("Train Loss", loss, i)
                print(f"step {i}: loss {loss:.4f}")
        if args.target_loss is not None and t0 is not None and (logged or (
            not args.log_every and i % 10 == 0
        )):
            checked = loss if logged else float(metrics["loss"])
            if checked <= args.target_loss:
                hit_target, final_step = i, i
                time_to_target = time.time() - t0
                if lead:
                    print(f"target loss {args.target_loss} reached at step {i} "
                          f"({time_to_target:.1f}s after steady-state step {steady_from})")
                break
    sync()
    if mgr is not None and mgr.latest_step() != int(ts.step):  # the end-of-run save
        save(int(ts.step))
    loss = float(metrics["loss"])
    elapsed = time.time() - t0 if t0 else float("nan")
    tokens = (final_step - steady_from) * args.batch_size * args.seq_len
    tok_per_s = (
        tokens / elapsed if tokens > 0 and elapsed and elapsed > 0 else float("nan")
    )
    ppl = math.exp(min(loss, 700.0))
    if lead:
        print(
            f"[{args.parallel}/{args.attn or 'default'}/{device.type}] {world} device(s), "
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
        "devices": world,
        "device": str(device),
        "steps_run": final_step,
        "target_reached_at": hit_target,
        "time_to_target_s": time_to_target,
    }


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
