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

``--dp`` profiles the flagship step under ``tpudml_torch.parallel.DataParallel``
at world 1 (a one-rank NCCL group over a file store in a temporary
directory; ``fused_xent=True, save_scores=True, flash_attn=True`` on the
same model) against the single-card flagship step, interleaved in one
process: single_1, dp_1, dp_2, single_2. Each DP row adds the device ms a
call of the gradient aggregation alone (the all-reduce of the flat
gradients, on the step's own gradients): its NCCL kernels and the copies
around them (the flat buffer's cat, the ÷ world), from ``torch.profiler``.

``--ep`` profiles the slice-8 path, task5 ``--parallel ep --attn flash
--fused_ln --rope --moe_experts 8 --moe_dispatch gather`` (the training
config in f32, Adam lr 1e-3, task5's batches, capacity factor 2.0):
``tpudml_torch.parallel.ExpertParallel`` at world 1 (a one-rank NCCL
group over a file store in a temporary directory) against the
single-card step of the same model, interleaved in one process:
single_1, ep_1, ep_2, single_2. Each EP row adds the device ms a call of
the dispatch's ``all_to_all`` alone at its [E, C, d] = [8, 2048, 512]
(NCCL's kernels and the copies around them).

``--host`` profiles the slice-11 path, task5 ``--parallel dp`` at the f32
training config (flash, fused add+LN, RoPE, Adam lr 1e-3, task5's
batches) under ``DataParallel`` at world 1 (a one-rank NCCL group over a
file store in a temporary directory): plain, with ``sentinel=True`` and
with ``obs=True``, interleaved in one process: plain_1, sentinel, obs,
plain_2 (what the grad sentinel and the flight recorder cost a step).

``--fsdp`` profiles the slice-13 unfused path, task5 ``--parallel fsdp``
at the f32 training config (flash, fused add+LN, RoPE, Adam lr 1e-3,
task5's batches): ``tpudml_torch.parallel.FSDP`` at world 1 (a one-rank
NCCL group over a file store in a temporary directory; each weight
all-gathered and its gradient reduce-scattered, copies at one rank),
plain and with ``sentinel=True``, against the single-card step plain and
with its Adam in a ``GradSentinel``, interleaved in one process:
single_1, fsdp, fsdp_sentinel, single_sentinel, single_2.

``--resnet [--batch N]`` profiles the single-card bf16 step of ``bench.py``
``bench_resnet`` instead (the north star's model and optimizer):
ResNet-18 at CIFAR width (bf16 compute over f32 master weights), SGD lr
0.1 momentum 0.9 through ``make_train_step``, one batch
``synthetic_classification(N, (32, 32, 3), 10, seed=0)`` every step, N
default 1024 (bench's per-chip batch); it adds imgs/s. One configuration,
"resnet".

TF32 is off for matmuls and cuDNN's convolutions, so an f32 row means f32.

Run on the card: ``python -m tpudml_torch.tools.profile_train [--flagship | --long |
--wide | --dp | --ep | --host | --fsdp | --moe 8 --moe_variant ragged_grouped | --resnet
[--batch 128]]``
(one
JSON line at the end; ``--out FILE`` also writes it to FILE).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import tempfile

import numpy as np
import torch

from tpudml_torch.device import no_tf32
from tpudml_torch.tools.profile_serve import _measure

MODEL = dict(vocab_size=32768, embed_dim=512, num_heads=4, num_layers=6,
             max_len=1024, rope=True)
RESNET_BATCH = 1024  # bench.py:215, bench_resnet's per-chip batch
WIDE = dict(embed_dim=2048, num_heads=16, num_layers=2)  # chip_smoke.py's WIDE_MODEL
BATCH = 8
EP_EXPERTS = 8  # chip_smoke.py's EP_TASK5
LONG_T, LONG_BATCH = 16384, 2  # BASELINE.md:45
# bench_moe's variants (bench.py:586-661), also driven by chip_smoke.py.
MOE_VARIANTS = {"gather": dict(moe_dispatch="gather"),
                "ragged_stock": dict(moe_dispatch="ragged", moe_ragged_dw="stock"),
                "ragged_grouped": dict(moe_dispatch="ragged", moe_ragged_dw="grouped")}


def collective_breakdown(fn, calls: int = 10) -> dict:
    """What a call of ``fn`` (an aggregation) does, from ``torch.profiler``
    over ``calls`` calls: the collectives dispatched to the process group
    (the CPU ranges ``c10d::*``) and those NCCL took (``nccl:*``, recorded
    by ProcessGroupNCCL), NCCL's device kernels and their ms, and the other
    device work (the flat buffer's cat, the ÷ world, a copy) and its ms. At
    one rank NCCL may launch no kernel: the CPU ranges show that the
    collective ran."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    cpu = [ev.name for ev in events if ev.device_type == torch.autograd.DeviceType.CPU]
    dev = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [ev for ev in dev if "nccl" in ev.name.lower()]
    other = [ev for ev in dev if "nccl" not in ev.name.lower()]
    us = lambda evs: sum(ev.time_range.elapsed_us() for ev in evs)  # noqa: E731
    names = lambda prefix: [n for n in cpu if n.startswith(prefix)]  # noqa: E731
    return {"dispatched": len(names("c10d::")) / calls,
            "dispatched_names": sorted(set(names("c10d::"))),
            "issued": len(names("nccl:")) / calls, "issued_names": sorted(set(names("nccl:"))),
            "nccl_kernels": len(nccl) / calls, "nccl_ms": us(nccl) / 1e3 / calls,
            "other_kernels": len(other) / calls, "other_ms": us(other) / 1e3 / calls,
            "other_names": sorted({ev.name[:40] for ev in other})}


def describe_aggregation(p: dict) -> str:
    """One line of :func:`collective_breakdown`'s numbers."""
    return (f"a call dispatches {p['dispatched']:g} collective(s) {p['dispatched_names']}, "
            f"NCCL takes {p['issued']:g} {p['issued_names']}; device: NCCL "
            f"{p['nccl_ms']:.4f} ms in {p['nccl_kernels']:g} kernel(s), other "
            f"{p['other_ms']:.4f} ms in {p['other_kernels']:g} {p['other_names']}")


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
    mode.add_argument("--dp", action="store_true",
                      help="the flagship step under DataParallel at world 1 (NCCL) against "
                      "the single-card one, interleaved")
    mode.add_argument("--ep", action="store_true",
                      help="the f32 MoE gather step under ExpertParallel at world 1 (NCCL) "
                      "against the single-card one, interleaved")
    mode.add_argument("--host", action="store_true",
                      help="the f32 DP step at world 1 plain, with the sentinel and with obs, "
                      "interleaved")
    mode.add_argument("--fsdp", action="store_true",
                      help="the f32 step under FSDP at world 1 (NCCL), plain and with the "
                      "sentinel, against the single-card step, interleaved")
    mode.add_argument("--moe", type=int, default=0, metavar="E",
                      help="one bench_moe step with E experts (bf16, top-1, capacity 1.25)")
    mode.add_argument("--resnet", action="store_true",
                      help="the bf16 ResNet-18 step of bench_resnet (SGD 0.1 / 0.9)")
    p.add_argument("--moe_variant", choices=sorted(MOE_VARIANTS), default="ragged_grouped")
    p.add_argument("--batch", type=int, default=RESNET_BATCH,
                   help="--resnet's batch (images a step)")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    iters = args.iters or (3 if args.long else 10)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device; this measures the card")
    no_tf32("cuda")
    if args.resnet:
        return _emit(profile_resnet(args.batch, iters), ["resnet"], args.out)
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import build_kernels
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.optim import Adam, AdamW
    from tpudml_torch.comm import all_to_all
    from tpudml_torch.parallel import FSDP, DataParallel, ExpertParallel
    from tpudml_torch.resilience import attach_sentinel
    from tpudml_torch.train import TrainState, make_lm_fused_train_step, make_train_step

    build_kernels()
    model_cfg, batch = MODEL, BATCH
    if args.long:
        model_cfg, batch = dict(MODEL, max_len=LONG_T), LONG_BATCH
    if args.wide:
        model_cfg = dict(MODEL, **WIDE)
    t = model_cfg["max_len"]
    if args.flagship or args.moe or args.dp:
        seed = 3 if args.moe else 1  # bench.py:604 / :351
        batches = itertools.repeat(synthetic_lm(BATCH, t, MODEL["vocab_size"], seed=seed))
        bf16 = dict(compute_dtype=torch.bfloat16)
        flagship = dict(impl="flash", fused_ln=True, **bf16)
        configs = ((("moe", dict(impl="flash", fused_ln=True, moe_experts=args.moe,
                                 moe_capacity_factor=1.25, **MOE_VARIANTS[args.moe_variant],
                                 **bf16), False),) if args.moe else
                   tuple((name, flagship, True)
                         for name in ("single_1", "dp_1", "dp_2", "single_2")) if args.dp else
                   (("kernel", flagship, True),
                    ("plain", dict(impl="full", fused_ln=False, **bf16), False)))
    else:
        seqs = synthetic_lm(4 * batch, t, MODEL["vocab_size"], seed=0)
        rng = np.random.default_rng(0)
        batches = itertools.cycle(
            [seqs[rng.integers(0, len(seqs), size=batch)] for _ in range(8)])
        moe = dict(impl="flash", fused_ln=True, moe_experts=EP_EXPERTS, moe_dispatch="gather")
        configs = ((("lean", dict(impl="flash"), None), ("saved", dict(impl="flash"), True))
                   if args.long else
                   tuple((name, moe, False) for name in ("single_1", "ep_1", "ep_2", "single_2"))
                   if args.ep else
                   tuple((name, dict(impl="flash", fused_ln=True), False)
                         for name in ("plain_1", "sentinel", "obs", "plain_2"))
                   if args.host else
                   tuple((name, dict(impl="flash", fused_ln=True), False)
                         for name in ("single_1", "fsdp", "fsdp_sentinel", "single_sentinel",
                                      "single_2"))
                   if args.fsdp else
                   (("kernel", dict(impl="flash", fused_ln=True), False),
                    ("plain", dict(impl="full", fused_ln=False), False)))
    step_name = (f"MoE E={args.moe} {args.moe_variant} bf16 (AdamW 3e-4)" if args.moe else
                 "flagship bf16 (fused xent head, AdamW 3e-4)" if args.flagship else
                 "flagship bf16, single card vs DataParallel world 1 (NCCL)" if args.dp else
                 f"MoE E={EP_EXPERTS} gather f32, single card vs ExpertParallel world 1 (NCCL; "
                 "flash, fused add+LN, Adam 1e-3)" if args.ep else
                 "f32 DataParallel world 1 (NCCL; flash, fused add+LN, Adam 1e-3): plain, "
                 "sentinel=True, obs=True" if args.host else
                 "f32 FSDP world 1 (NCCL; flash, fused add+LN, Adam 1e-3) against the single "
                 "card, each plain and with the sentinel" if args.fsdp else
                 "long-context f32 T=16384 (fused xent head, Adam 1e-3)" if args.long
                 else "wide-trunk f32 d=2048 (materialized logits, Adam 1e-3)" if args.wide
                 else "f32 (materialized logits, Adam 1e-3)")
    result = {"device": torch.cuda.get_device_name(0), "model": model_cfg,
              "batch": batch, "tokens_per_step": batch * t, "step": step_name}
    tmp = stack = None
    if args.dp or args.ep or args.host or args.fsdp:
        stack = contextlib.ExitStack()
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        stack.enter_context(process_group(
            DistributedConfig(coordinator_address=f"file://{tmp}/store"), device="cuda"))
    for name, kw, save_scores in configs:
        dp, ep = name.startswith("dp"), name.startswith("ep")
        model = TransformerLM(**model_cfg, **dict(kw, impl="full") if dp else kw,
                              moe_axis="expert" if ep else None,
                              device="cuda", generator=torch.Generator().manual_seed(0))
        opt = AdamW(lr=3e-4) if args.flagship or args.moe or args.dp else Adam(lr=1e-3)
        fused_head = args.long or save_scores
        if dp:
            engine = DataParallel(model, opt, fused_xent=True, save_scores=True,
                                  flash_attn=True)
            step, ts = engine.make_train_step(), engine.create_state()
        elif ep:
            engine = ExpertParallel(model, opt)
            step, ts = engine.make_train_step(), engine.create_state()
        elif args.host:
            engine = DataParallel(model, opt, stacked_batches=False,
                                  sentinel=name == "sentinel", obs=name == "obs")
            step, ts = engine.make_train_step(), engine.create_state()
        elif name.startswith("fsdp"):
            engine = FSDP(model, opt, sentinel=name == "fsdp_sentinel")
            ts = engine.create_state()
            step = engine.make_train_step()
        elif name == "single_sentinel":
            opt = attach_sentinel(opt)
            step, ts = make_train_step(model, opt), TrainState.create(model, opt)
        else:
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
        if dp:
            rows = next(batches)
            grads, _ = engine.local_grads(ts, rows[:, :-1], rows[:, 1:])
            r["aggregation"] = collective_breakdown(lambda: engine.aggregator(grads))
            del engine, grads
        if ep:
            layer = model.block0.moe
            buf = torch.randn(EP_EXPERTS, layer._capacity(batch * t), model_cfg["embed_dim"],
                              device="cuda")
            r["all_to_all"] = collective_breakdown(
                lambda: all_to_all(buf, layer.group, split_axis=0, concat_axis=1))
            r["all_to_all"]["shape"] = list(buf.shape)
            del engine, buf
        result[name] = r
        del model, ts, step
        torch.cuda.empty_cache()
    if stack is not None:
        stack.close()
    return _emit(result, [key for key, _, _ in configs], args.out)


def _emit(result: dict, keys: list[str], out: str | None) -> dict:
    """Print each configuration's line and top device items, then the JSON
    line (also to ``out``)."""
    for key in keys:
        r = result[key]
        rate = (f"{r['imgs_per_sec']:.0f} imgs/s" if "imgs_per_sec" in r
                else f"{r['tokens_per_sec']:.0f} tokens/s")
        print(f"[profile] {result['step']} step, {key}: wall {r['wall_ms']:.3f} ms, events "
              f"{r['event_ms']:.3f} ms, {r['kernels_per_call']:.0f} kernels summing "
              f"{r['kernel_ms_per_call']:.3f} ms (busy {r['busy_share']:.2f}), "
              f"{rate}, peak {r['peak_mem_gb']:.2f} GB")
        if "aggregation" in r:
            print(f"    aggregation alone (world 1): {describe_aggregation(r['aggregation'])}")
        if "all_to_all" in r:
            print(f"    dispatch all_to_all alone {r['all_to_all']['shape']} f32 (world 1): "
                  f"{describe_aggregation(r['all_to_all'])}")
        for row in r["top"]:
            print(f"    {row['ms_per_call']:.4f} ms x{row['launches_per_call']:.0f}  "
                  f"{row['kernel']}")
    line = json.dumps(result)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line)
    return result


def profile_resnet(batch: int, iters: int) -> dict:
    """The ``--resnet`` measurement (module docstring)."""
    from tpudml_torch.data import synthetic_classification
    from tpudml_torch.models import ResNet18
    from tpudml_torch.optim import Sgd
    from tpudml_torch.train import TrainState, make_train_step

    images, labels = synthetic_classification(batch, (32, 32, 3), 10, seed=0)
    images, labels = torch.from_numpy(images).cuda(), torch.from_numpy(labels).long().cuda()
    model = ResNet18(compute_dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    opt = Sgd(lr=0.1, momentum=0.9)
    step = make_train_step(model, opt)
    ts = TrainState.create(model, opt)

    def one_step():
        step(ts, images, labels)

    result = {"device": torch.cuda.get_device_name(0), "model": "resnet18 CIFAR, bf16",
              "batch": batch, "step": "ResNet-18 bf16 (SGD 0.1 / 0.9, bench_resnet)"}
    torch.cuda.reset_peak_memory_stats()
    r = _measure(one_step, iters)
    r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["imgs_per_sec"] = batch / r["wall_ms"] * 1e3
    result["resnet"] = r
    return result


if __name__ == "__main__":
    main()
