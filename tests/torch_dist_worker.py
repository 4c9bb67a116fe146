"""One rank of the port's multi-process CPU tests (gloo), run as a script.

Imports torch and ``tpudml_torch`` only, never jax: the parent test
computes the JAX side and launches one process per rank with
:func:`spawn`, which waits for them under a deadline and kills them on
failure. Each rank joins the group through a ``file://`` store, runs the
cases of its suite and writes its results with ``torch.save`` to
``<job>/rank<r>.pt``; the parent compares them.

Suites: ``dp`` (DataParallel against the JAX engine's inputs in
``<job>/cases.pt``), ``resnet`` (DataParallel on the north star's
ResNet with SGD momentum, from ``<job>/cases.pt``), ``comm``
(collectives on seeded per-rank values) and ``task5`` (``--parallel dp``
of the port's task5).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def spawn(suite: str, job: Path, world: int = 2, deadline_s: float = 240.0) -> list[dict]:
    """Run ``suite`` on ``world`` ranks of this script; return each rank's
    results. A rank that fails or outlives the deadline fails the call,
    and every rank still running is killed."""
    job.mkdir(parents=True, exist_ok=True)
    store = job / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(job), str(store), str(r), str(world)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = [p.communicate()[0] for p in procs]
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {suite} ended with {p.returncode}:\n{logs[r]}")
    import torch

    return [torch.load(job / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ----------------------------------------------------------------- dp


def _dp_model(spec, state):
    from tpudml_torch.models import TransformerLM

    model = TransformerLM(**spec["model"], device="cpu")
    model.load_state_dict(state)
    return model


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _dp_case(spec, batches):
    """Train ``spec``'s DataParallel on the global batches: per-step losses
    (and accuracies), the final parameters and the engine's comm stats."""
    from tpudml_torch.interop import adam_state_from_tpudml
    from tpudml_torch.optim import Adam, GradientDescent
    from tpudml_torch.parallel import DataParallel

    model = _dp_model(spec, spec["params"])
    opt = Adam(lr=spec["lr"]) if spec["opt"] == "adam" else GradientDescent(lr=spec["lr"])
    dp = DataParallel(model, opt, **spec["engine"])
    ts = dp.create_state()
    if "adam_state" in spec:
        ts.opt_state = adam_state_from_tpudml(spec["adam_state"])
    step = dp.make_train_step()
    losses, accs = [], []
    for tokens, labels in batches:
        ts, m = step(ts, tokens, labels)
        losses.append(float(m["loss"]))
        if "accuracy" in m:
            accs.append(float(m["accuracy"]))
    out = {"losses": losses, "accs": accs, "params": _params(model),
           "comm_calls": dp.comm_stats.calls, "comm_s": dp.comm_stats.per_call_s,
           "comm_bytes": dp.comm_stats.comm_bytes}
    if "adam_state" in spec:
        out["opt_state"] = {k: ts.opt_state[k] for k in ("m", "v", "t")}
    return out


def suite_dp(job: Path, rank: int, world: int) -> dict:
    import torch

    from tpudml_torch.optim import GradientDescent
    from tpudml_torch.parallel import DataParallel

    cases = torch.load(job / "cases.pt", weights_only=False)
    out = {name: _dp_case(spec, cases["batches"][spec["batches"]])
           for name, spec in cases["specs"].items()}

    base = cases["specs"]["allreduce"]
    batches = cases["batches"][base["batches"]]

    # The split step against the fused one (materialized logits), and the
    # straggler: rank 1 enters each collective 0.2 s late.
    for name, kw in (("split", dict(measure_comm=True)),
                     ("straggler", dict(measure_comm=True, bottleneck_rank=1,
                                        bottleneck_delay_s=0.2))):
        spec = dict(base, engine=dict(base["engine"], **kw))
        out[name] = _dp_case(spec, batches)

    # broadcast_params after rank 1's parameters are perturbed.
    model = _dp_model(base, base["params"])
    dp = DataParallel(model, GradientDescent(lr=0.1))
    ts = dp.create_state()
    if rank == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    before = _params(model)
    dp.broadcast_params(ts)
    out["broadcast"] = {"before": before, "after": _params(model)}

    # shard_batch at this world: the LM batch is never mistaken for a
    # stacked one; the stacked form and an indivisible batch.
    tokens = torch.arange(world * 16).reshape(world, 16)
    x, y = dp.shard_batch(tokens, tokens)
    stacked = DataParallel(model, GradientDescent(lr=0.1), stacked_batches=True)
    xs, _ = stacked.shard_batch(tokens.reshape(world, 1, 16), tokens.reshape(world, 1, 16))
    try:
        dp.shard_batch(torch.zeros(2 * world + 1, 16), torch.zeros(2 * world + 1, 16))
        indivisible = None
    except ValueError as e:
        indivisible = str(e)
    out["shard"] = {"x": x, "y": y, "stacked": xs, "indivisible": indivisible}
    return out


# ------------------------------------------------------------- resnet


def suite_resnet(job: Path, rank: int, world: int) -> dict:
    """The small ResNet under DataParallel with SGD momentum on the stacked
    global batches: per-step losses, this rank's ReLU sign masks a step
    (NHWC, in call order), and the final parameters and BatchNorm
    buffers."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.models import ResNet
    from tpudml_torch.optim import Sgd
    from tpudml_torch.parallel import DataParallel

    case = torch.load(job / "cases.pt", weights_only=False)
    model = ResNet(**case["model"], device="cpu")
    model.load_state_dict(case["state"])
    dp = DataParallel(model, Sgd(**case["sgd"]), stacked_batches=True)
    ts = dp.create_state()
    step = dp.make_train_step()
    masks: list = []
    relu = F.relu

    def recording_relu(x, *args, **kw):
        masks[-1].append((x.detach() > 0).permute(0, 2, 3, 1).numpy())
        return relu(x, *args, **kw)

    F.relu = recording_relu
    losses = []
    try:
        for images, labels in case["batches"]:
            masks.append([])
            ts, m = step(ts, images, labels)
            losses.append(float(m["loss"]))
    finally:
        F.relu = relu
    return {"losses": losses, "masks": masks,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


# --------------------------------------------------------------- comm


def suite_comm(job: Path, rank: int, world: int) -> dict:
    """Every collective on rank-seeded values; the parent rebuilds all
    ranks' inputs from the same seeds and checks with numpy."""
    import numpy as np
    import torch

    from tpudml_torch.comm import collectives as c

    def value(shape, seed):
        return torch.from_numpy(
            np.random.default_rng((seed, rank)).standard_normal(shape).astype(np.float32))

    x = value((4, 3), 0)
    tree = {"a": value((4, 3), 1), "b": value((5,), 2), "c": value((), 3)}
    even = {"a": value((2 * world, 3), 4), "b": value((world,), 5)}
    out = {
        "psum": c.psum_tree(tree),
        "pmean": c.pmean_tree(tree),
        "pmax": c.pmax_tree(tree),
        "allreduce": c.allreduce_average_gradients(tree),
        "allgather": c.allgather_average_gradients(tree),
        "reducescatter": c.reduce_scatter_average_gradients(tree),
        "reducescatter_even": c.reduce_scatter_average_gradients(even),
        "all_gather": c.all_gather_tree(tree),
        "all_gather_tiled": c.all_gather_tree(even, tiled=True),
        "all_gather_axis1": c.all_gather_tree(x, axis=1),
        "psum_scatter": c.psum_scatter_tree(even),
        "psum_scatter_axis1": c.psum_scatter_tree(value((3, 2 * world), 6), axis=1),
        "broadcast": c.broadcast_from(tree, root=1 % world),
        "ppermute": c.ppermute_ring(x, shift=1),
        "all_to_all": c.all_to_all(value((world, world, 2), 7), split_axis=1, concat_axis=0),
        "bf16_f32": c.pmean_tree({"h": value((3,), 8).bfloat16(), "f": value((3,), 9)}),
    }
    lse_in = value((6,), 10).requires_grad_()
    lse = c.plogsumexp(lse_in)
    lse.sum().backward()
    out["plogsumexp"] = lse.detach()
    out["plogsumexp_grad"] = lse_in.grad
    try:
        c.psum_scatter_tree(value((world + 1,), 11))
        out["scatter_error"] = None
    except ValueError as e:
        out["scatter_error"] = str(e)

    # The aggregators on the inputs the parent's JAX mesh also sees.
    grads = torch.load(job / "grads.pt", weights_only=False)[rank]
    out["jax_inputs"] = {name: agg(grads) for name, agg in c.AGGREGATORS.items()}

    # comm.bench and the timing table inside the group, and the
    # same-program guard.
    from tpudml_torch.comm import bench, comm_time_table
    from tpudml_torch.core import assert_same_program

    out["table"] = comm_time_table(None, tree, iters=2, warmup=1)
    out["bench"] = bench.main(["--device", "cpu", "--sizes", "64", "256", "--iters", "2",
                               "--n_devices", str(world)])
    assert_same_program("same", "comm test")
    try:
        assert_same_program(f"rank {rank}", "comm test")
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)
    return out


# -------------------------------------------------------------- task5


def suite_task5(job: Path, rank: int, world: int) -> dict:
    from tpudml_torch.tasks import task5_longcontext as task5

    argv = ["--parallel", "dp", "--device", "cpu", "--vocab", "32", "--embed_dim", "32",
            "--num_heads", "4", "--num_layers", "2", "--seq_len", "16",
            "--batch_size", "4", "--lr", "0.01", "--steps", "8", "--log_every", "4",
            "--n_devices", str(world), "--attn", "flash", "--fused_ln", "--rope",
            "--fused_xent", "--log_dir", str(job / f"logs{rank}")]
    return task5.main(argv)


SUITES = {"dp": suite_dp, "resnet": suite_resnet, "comm": suite_comm,
          "task5": suite_task5}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("suite", choices=sorted(SUITES))
    p.add_argument("job", type=Path)
    p.add_argument("store", type=Path)
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    args = p.parse_args()
    sys.modules["jax"] = None  # the port must not need it
    import torch

    from tpudml_torch.core import DistributedConfig, distributed_init

    torch.set_num_threads(1)
    distributed_init(DistributedConfig(coordinator_address=f"file://{args.store}",
                                       num_processes=args.world, process_id=args.rank,
                                       initialize_timeout_s=120), device="cpu")
    try:
        out = SUITES[args.suite](args.job, args.rank, args.world)
        torch.save(out, args.job / f"rank{args.rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
