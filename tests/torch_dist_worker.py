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
(collectives on seeded per-rank values), ``task5`` (``--parallel dp``
of the port's task5) and ``ep`` (ExpertParallel, its MoE layer and the
differentiable all_to_all, from ``<job>/cases.pt``; task5 ``--parallel
ep``), ``labs`` (task2's DataParallel LeNet for each aggregation and
with ``accum_steps``, task3's samplers and ShardedDataLoader for each
division, the dropout LM with a ``rng_root`` stream per rank drawing the
JAX masks of ``<job>/cases.pt``, and the task2 entry at world 2), ``obs``
(``DataParallel(obs=True)``, fused and split, and obs off: StepStats,
spans), ``sentinel`` (``DataParallel(sentinel=...)`` on LeNet: a
clean run, a NaN step, a poisoned micro-batch under accumulation),
``gspmd`` and ``gspmd2d`` (``GSPMDParallel`` on LeNet's stages and the
tiny LM), ``task4`` (the task4 entry), ``zero1``
(``DataParallel(zero1=...)``, its sharded checkpoints, task2 ``--zero1``)
``task2_zero1_ckpt`` (task2 ``--zero1 --ckpt_dir`` resumed from a JAX
checkpoint, and resumed again from its own), ``sharded`` (the sharded
store on a GSPMD and an EP state, this
package's and JAX's files; task5 ``--parallel ep --ckpt_dir`` and
``--resume``), ``fsdp`` (FSDP on ForwardMLP, under the block-then-mean
gradient rule too, and FSDP×TP on the tiny LM), ``sharded_xent`` (the
vocab-sharded head under TP, 1-D FSDP and FSDP×TP, both routes; the
engines fused and unfused), ``overlap`` (``tp_overlap_matmul`` against
the plain all-reduce), ``mp_cli`` (task5 ``--parallel fsdp | tp``
from JAX's parameters, their checkpoints and resume, an FSDP state
through the sharded store), ``pp`` (the pipeline engines on the cases of
``<job>/cases.pt``, the open stage shifts, ExpertParallel's forward) and
``pp_cli`` (task5 ``--parallel pp`` from JAX's parameters, its
checkpoint and resume; task4 ``--schedule gpipe | 1f1b``), ``serve_tp``
(the tensor-parallel decode steps from JAX's parameters, task6 ``--tp``),
``cp`` (ring and Ulysses attention on the shards of ``<job>/cases.pt``'s
global q, k, v, the ``ContextParallel`` engine from JAX's parameters) and
``cp_cli`` (task5 ``--parallel cp`` from JAX's parameters, dropout masks
JAX's), ``plan`` (the planner's verification step of the base candidates,
a verified plan, a winner whose gradient all-reduce is removed on
purpose, and every survivor and capability-pruned candidate built) and
``plan_cli`` (task2 ``--plan`` from JAX's parameters).
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

    from tpudml_torch.models import ResNet
    from tpudml_torch.nn import layers
    from tpudml_torch.optim import Sgd
    from tpudml_torch.parallel import DataParallel

    case = torch.load(job / "cases.pt", weights_only=False)
    model = ResNet(**case["model"], device="cpu")
    model.load_state_dict(case["state"])
    dp = DataParallel(model, Sgd(**case["sgd"]), stacked_batches=True)
    ts = dp.create_state()
    step = dp.make_train_step()
    masks: list = []
    relu = layers.relu

    def recording_relu(x, *args, **kw):
        masks[-1].append((x.detach() > 0).permute(0, 2, 3, 1).numpy())
        return relu(x, *args, **kw)

    layers.relu = recording_relu
    losses = []
    try:
        for images, labels in case["batches"]:
            masks.append([])
            ts, m = step(ts, images, labels)
            losses.append(float(m["loss"]))
    finally:
        layers.relu = relu
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


# ----------------------------------------------------------------- ep


def _tap_optimizer():
    """An optimizer wrapper (jax-free) that records one parameter's
    gradient each update and defers to ``base``: around a clip and under
    it, the ratio of the two records is the clip's scale."""
    from dataclasses import dataclass, field

    from tpudml_torch.optim import Optimizer

    @dataclass(frozen=True)
    class Tap(Optimizer):
        base: Optimizer = None
        name: str = ""
        seen: list = field(default_factory=list, compare=False)

        def init(self, params):
            return self.base.init(params)

        def update(self, grads, state, params):
            self.seen.append(grads[self.name].detach().clone())
            return self.base.update(grads, state, params)

    return Tap


def _experts(model) -> dict:
    """A model's expert tensors, by name."""
    from tpudml_torch.parallel import is_expert_param

    return {n: p.detach().clone() for n, p in model.named_parameters() if is_expert_param(n)}


def _ep_engine(spec, model):
    from tpudml_torch.interop import ep_state_from_tpudml
    from tpudml_torch.optim import Adam, ClipByGlobalNorm, GradientDescent, Sgd
    from tpudml_torch.parallel import ExpertParallel

    taps = ()
    if spec["opt"] == "adam":
        opt = Adam(lr=spec["lr"])
    elif spec["opt"] == "clip":
        tap = _tap_optimizer()
        inner = tap(base=Sgd(lr=spec["lr"]), name=spec["tap"])
        opt = tap(base=ClipByGlobalNorm(base=inner, max_norm=spec["max_norm"]),
                  name=spec["tap"])
        taps = (opt, inner)
    elif spec["opt"] == "sgd":
        opt = Sgd(lr=spec["lr"])
    else:
        opt = GradientDescent(lr=spec["lr"])
    ep = ExpertParallel(model, opt, **spec.get("engine", {}))
    seeded = _experts(model)  # what the engine kept of the seeded draw
    state, opt_state = ep_state_from_tpudml(spec["params"], spec["opt_state"],
                                            ep.expert_index, ep.world)
    model.load_state_dict(state)
    ts = ep.create_state()
    if spec["opt"] == "adam":
        ts.opt_state = opt_state
    return ep, ts, taps, seeded


def _ep_model(spec, axis_name="expert"):
    """The model of an EP training case, drawn from its seed: with
    ``axis_name=None`` the same model without expert parallelism."""
    import torch

    from tpudml_torch.models import TransformerLM
    from tpudml_torch.nn import Activation, Dense, Flatten, Sequential
    from tpudml_torch.nn.moe import MoELayer

    if "lm" in spec:
        return TransformerLM(**spec["lm"], moe_axis=axis_name, device="cpu")
    d, e, n_in = spec["classifier"]
    g = torch.Generator().manual_seed(0)
    return Sequential((Flatten(), Dense(n_in, d, generator=g), Activation(),
                       MoELayer(d, e, mlp_ratio=2, capacity_factor=8.0, axis_name=axis_name,
                                generator=g),
                       Dense(d, 10, generator=g)))


def _ep_train(spec):
    """Train ``spec``'s EP engine on its global batches: per-step losses and
    accuracies, the final parameters (this rank's expert slices), the eval
    accuracy on the first batch, the clip's taps, the experts the engine
    kept of the seeded draw and those of the same model drawn without EP."""
    model = _ep_model(spec)
    ep, ts, taps, seeded = _ep_engine(spec, model)
    step = ep.make_train_step()
    losses, accs = [], []
    for x, y in spec["batches"]:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    out = {"losses": losses, "accs": accs, "params": _params(model),
           "expert_index": ep.expert_index, "seeded": seeded,
           "dense": _experts(_ep_model(spec, axis_name=None)),
           "eval": ep.evaluate(ts, spec["batches"][:1])}
    if taps:
        out["raw"], out["clipped"] = taps[0].seen, taps[1].seen
        out["clip_axes"] = ep.optimizer.base.axes == (ep.expert_group,)
    return out


def _ep_layer_case(spec, rank: int, world: int):
    """One MoE layer under EP on this rank's rows of the tokens: its
    output rows, d(Σ y·cot) wrt its rows, the router and its experts, the
    experts the engine kept of the seeded draw and the dense layer's."""
    import torch

    from tpudml_torch.interop import ep_state_from_tpudml
    from tpudml_torch.nn import Sequential
    from tpudml_torch.nn.moe import MoELayer
    from tpudml_torch.optim import GradientDescent
    from tpudml_torch.parallel import ExpertParallel

    layer = MoELayer(**spec["layer"], axis_name="expert",
                     generator=torch.Generator().manual_seed(0))
    dense = Sequential((MoELayer(**spec["layer"], generator=torch.Generator().manual_seed(0)),))
    seq = Sequential((layer,))
    ep = ExpertParallel(seq, GradientDescent())
    seeded = _experts(seq)
    state, _ = ep_state_from_tpudml({"layer0": spec["params"]}, (), ep.expert_index, ep.world)
    seq.load_state_dict(state)
    n = spec["tokens"].shape[0] // world
    x = spec["tokens"][rank * n:(rank + 1) * n].clone().requires_grad_()
    y, _ = layer(x)
    (y * spec["cot"][rank * n:(rank + 1) * n]).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "seeded": seeded, "dense": _experts(dense),
            "expert_index": ep.expert_index,
            "grads": {k: p.grad for k, p in seq.named_parameters()}}


def suite_ep(job: Path, rank: int, world: int) -> dict:
    """World 2: the MoE layer's forward and backward, the differentiable
    all_to_all, EP training (classifier, clip, the LM fused and unfused)
    and task5 ``--parallel ep``; world 4: EP×DP on a {data: 2, expert: 2}
    layout. Inputs from ``<job>/cases.pt``."""
    import numpy as np
    import torch

    from tpudml_torch.comm import collectives as c

    cases = torch.load(job / "cases.pt", weights_only=False)
    out = {name: _ep_train(spec) for name, spec in cases["train"].items()}
    for name, spec in cases.get("layer", {}).items():
        out[name] = _ep_layer_case(spec, rank, world)
    if world == 2:
        x = torch.from_numpy(np.random.default_rng((7, rank)).standard_normal(
            (4 * world, 3, 2)).astype(np.float64)).requires_grad_()
        w = torch.from_numpy(np.random.default_rng((8, rank)).standard_normal(
            (4, 3 * world, 2)).astype(np.float64))
        y = c.all_to_all(x, split_axis=0, concat_axis=1)
        (y * w).sum().backward()
        back = c.all_to_all(y, split_axis=1, concat_axis=0)
        out["a2a"] = {"y": y.detach(), "dx": x.grad, "back": back.detach()}
        from tpudml_torch.tasks import task5_longcontext as task5

        argv = ["--parallel", "ep", "--device", "cpu", "--vocab", "32", "--embed_dim", "32",
                "--num_heads", "4", "--num_layers", "2", "--seq_len", "16",
                "--batch_size", "4", "--lr", "0.01", "--steps", "8", "--log_every", "4",
                "--moe_experts", "4", "--attn", "flash", "--fused_ln", "--rope",
                "--log_dir", str(job / f"logs{rank}")]
        out["task5"] = task5.main(argv)
        try:
            task5.main(argv[:-2] + ["--moe_experts", "3"])
            out["indivisible"] = None
        except ValueError as e:
            out["indivisible"] = str(e)
    return out


# --------------------------------------------------------------- labs


def _lenet_run(case, spec, batches):
    """``spec``'s DataParallel LeNet over the stacked global ``batches``:
    per-step losses and accuracies and the final parameters."""
    from tpudml_torch.models import LeNet
    from tpudml_torch.optim import Sgd
    from tpudml_torch.parallel import DataParallel

    model = LeNet(device="cpu")
    model.load_state_dict(case["lenet"])
    dp = DataParallel(model, Sgd(**spec["sgd"]), aggregation=spec["aggregation"],
                      accum_steps=spec["accum"], stacked_batches=True)
    ts, step = dp.create_state(), dp.make_train_step()
    losses, accs = [], []
    for epoch, (images, labels) in batches:
        ts, m = step(ts, images, labels)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return {"losses": losses, "accs": accs, "params": _params(model)}


def suite_labs(job: Path, rank: int, world: int) -> dict:
    import torch

    from tpudml_torch.data import ArrayDataset, ShardedDataLoader, make_sampler
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.nn import layers
    from tpudml_torch.optim import GradientDescent
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.tasks import task2

    case = torch.load(job / "cases.pt", weights_only=False)
    out = {name: _lenet_run(case, spec, [(0, b) for b in case["batches"]])
           for name, spec in case["specs"].items()}

    # task3: each division's samplers (their index sets) and one epoch of
    # the sharded loader's batches through the engine.
    ds = ArrayDataset(*case["dataset"])
    for division in ("partition", "sampling"):
        samplers = [make_sampler(division, len(ds), world, r, seed=case["sampler_seed"])
                    for r in range(world)]
        sets = []
        for epoch in (0, 1):
            for s in samplers:
                s.set_epoch(epoch)
            sets.append([list(iter(s)) for s in samplers])
        loader = ShardedDataLoader(ds, case["task3_batch"], samplers)
        loader.set_epoch(0)
        out[division] = dict(_lenet_run(case, case["task3_spec"], [(0, b) for b in loader]),
                             index_sets=sets)

    # The dropout LM: every mask is the one JAX drew at the same key.
    masks = case["masks"]
    layers.dropout_mask = lambda key, keep, shape, device: torch.from_numpy(
        masks[key.path]).to(device)
    model = TransformerLM(**case["lm_model"], device="cpu")
    model.load_state_dict(case["lm_state"])
    dp = DataParallel(model, GradientDescent(lr=case["lm_lr"]), rng_root=case["lm_root"],
                      stacked_batches=False)
    ts, step = dp.create_state(), dp.make_train_step()
    losses = []
    for tokens, labels in case["lm_batches"]:
        ts, m = step(ts, tokens, labels)
        losses.append(float(m["loss"]))
    out["dropout"] = {"losses": losses, "params": _params(model)}

    out["task2"] = task2.main(["--device", "cpu", "--dataset", "synthetic", "--epochs", "1",
                               "--batch_size", "16", "--log_every", "0", "--log_dir",
                               str(job / f"logs{rank}")])
    return out


# ------------------------------------------------------ obs, sentinel


def _obs_run(case, **engine):
    """The LM of ``case`` under ``DataParallel(**engine)`` (GD): each step's
    StepStats as floats, the loss, the tracer's (cat, name) events and the
    comm bytes."""
    from tpudml_torch.optim import GradientDescent
    from tpudml_torch.parallel import DataParallel

    model = _dp_model(case, case["params"])
    dp = DataParallel(model, GradientDescent(lr=case["lr"]), stacked_batches=False, **engine)
    ts, step = dp.create_state(), dp.make_train_step()
    stats, losses = [], []
    for tokens, labels in case["batches"]:
        ts, m = step(ts, tokens, labels)
        losses.append(float(m["loss"]))
        stats.append({k: float(v) for k, v in m["step_stats"].to_scalars().items()}
                     if "step_stats" in m else None)
    events = [(e.cat, e.name, (e.args or {}).get("bytes")) for e in dp.tracer.events] \
        if dp.tracer is not None else None
    return {"stats": stats, "losses": losses, "events": events,
            "comm_bytes": dp.comm_stats.comm_bytes}


def suite_obs(job: Path, rank: int, world: int) -> dict:
    import torch

    from tpudml_torch.obs import tracer

    case = torch.load(job / "cases.pt", weights_only=False)
    out = {"fused": _obs_run(case, obs=True),
           "split": _obs_run(case, obs=True, measure_comm=True)}
    before = tracer.SPANS_ALLOCATED
    out["off"] = _obs_run(case)
    out["off_spans"] = tracer.SPANS_ALLOCATED - before
    return out


def _lenet_sentinel(case, opt, batches, **engine):
    """LeNet (the case's parameters) under ``DataParallel(sentinel=...)``:
    after each step the parameters, the base optimizer state's tensors,
    the sentinel's counters and ``bad_micro``."""
    from tpudml_torch.models import LeNet
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.resilience import param_leaf_names, sentinel_stats

    model = LeNet(device="cpu")
    model.load_state_dict(case["lenet"])
    dp = DataParallel(model, opt, stacked_batches=False, **engine)
    ts, step = dp.create_state(), dp.make_train_step()
    steps = []
    for x, y in batches:
        ts, m = step(ts, x, y)
        base = ts.opt_state["base"]
        steps.append({"params": _params(model), "loss": float(m["loss"]),
                      "base": {k: ({n: t.clone() for n, t in v.items()}
                                   if isinstance(v, dict) else v.clone())
                               for k, v in base.items()} if isinstance(base, dict) else None,
                      "stats": sentinel_stats(ts.opt_state), "bad_micro": int(m["bad_micro"])})
    return {"steps": steps, "names": param_leaf_names(model),
            "budget": dp.sentinel.skip_budget}


def suite_sentinel(job: Path, rank: int, world: int) -> dict:
    import torch

    from tpudml_torch.optim import Adam, Sgd

    case = torch.load(job / "cases.pt", weights_only=False)
    x, y, xbad, xacc = case["x"], case["y"], case["xbad"], case["xacc"]
    return {
        "clean": _lenet_sentinel(case, Adam(lr=1e-3), [(x, y), (x, y)], sentinel=True),
        "poisoned": _lenet_sentinel(case, Adam(lr=1e-3), [(x, y), (xbad, y), (x, y)],
                                    sentinel={"skip_budget": 2}),
        "accum": _lenet_sentinel(case, Sgd(lr=0.01), [(x, y), (xacc, y)], sentinel=True,
                                 accum_steps=2),
    }


# ------------------------------------------- gspmd, zero1, sharded store


def _staged(case, key="lenet"):
    from tpudml_torch.models import lenet_stages

    model = lenet_stages(device="cpu")
    model.load_state_dict(case[key])
    return model


def _mp_run(model, opt, batches, engine=None, **kw):
    """``engine(model, opt, **kw)`` (default ``GSPMDParallel``): per-step
    losses, the full parameters after, each local parameter's and
    optimizer tensor's shape."""
    from tpudml_torch.parallel import GSPMDParallel

    mp = (engine or GSPMDParallel)(model, opt, **kw)
    ts, step = mp.create_state(), mp.make_train_step()
    losses = []
    for x, y in batches:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
    opt_shapes = ({n: tuple(t.shape) for n, t in ts.opt_state.items()}
                  if isinstance(ts.opt_state, dict) and "m" not in ts.opt_state else
                  {f"{k}.{n}": tuple(t.shape) for k in ("m", "v")
                   for n, t in ts.opt_state[k].items()}
                  if isinstance(ts.opt_state, dict) else {})
    return {"losses": losses, "params": mp.gather_params(),
            "local": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "opt_local": opt_shapes, "specs": mp.param_specs}, mp, ts


def _lm(case, key="lm"):
    from tpudml_torch.models import TransformerLM

    model = TransformerLM(**case[key], device="cpu")
    model.load_state_dict(case[f"{key}_state"])
    return model


def suite_gspmd(job: Path, rank: int, world: int) -> dict:
    """World 2: LeNet's stages under the stage rule (SGD, then SGD momentum:
    the blocks and their momentum), the tiny LM under tensor_parallel_rules
    (SGD momentum)."""
    import torch

    from tpudml_torch.optim import Sgd
    from tpudml_torch.parallel import tensor_parallel_rules

    case = torch.load(job / "cases.pt", weights_only=False)
    batches = [(case["x"], case["y"])] * case["steps"]
    out = {}
    out["sgd"], _, _ = _mp_run(_staged(case), Sgd(lr=0.01), batches, mesh={"stage": world})
    out["momentum"], _, _ = _mp_run(_staged(case), Sgd(lr=0.01, momentum=0.9), batches[:1],
                                    mesh={"stage": world})

    tp = dict(mesh={"model": world}, rule=tensor_parallel_rules("model"), axis_name="model")
    tokens = [(case["tokens"], case["labels"])] * 2
    out["tp"], _, _ = _mp_run(_lm(case), Sgd(lr=0.1, momentum=0.9), tokens, **tp)
    return out


def suite_task4(job: Path, rank: int, world: int) -> dict:
    """The task4 entry (``--schedule gspmd``) at this world."""
    from tpudml_torch.tasks import task4

    return task4.main(["--device", "cpu", "--dataset", "synthetic", "--epochs", "1",
                       "--lr", "0.05", "--momentum", "0.9", "--log_every", "25",
                       "--log_dir", str(job / f"logs{rank}")])


def suite_gspmd2d(job: Path, rank: int, world: int) -> dict:
    """World 4 as {"data": 2, "stage": 2}: LeNet's stages with batch_axis."""
    import torch

    from tpudml_torch.optim import Sgd

    case = torch.load(job / "cases.pt", weights_only=False)
    run, _, _ = _mp_run(_staged(case), Sgd(lr=0.01), [(case["x"], case["y"])] * 2,
                        mesh={"data": 2, "stage": 2}, batch_axis="data")
    return run


def _zero1_run(case, opt, batches, **engine):
    """LeNet (the case's parameters) under ``DataParallel(**engine)``: per-step
    losses, the full parameters after, this rank's optimizer-state bytes
    and the engine's comm calls."""
    from tpudml_torch.models import LeNet
    from tpudml_torch.parallel import DataParallel

    model = LeNet(device="cpu")
    model.load_state_dict(case["lenet"])
    dp = DataParallel(model, opt, stacked_batches=False, **engine)
    ts, step = dp.create_state(), dp.make_train_step()
    losses, extra = [], {}
    for x, y in batches:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
    params = {n: t.clone() for n, t in dp.gather_params(ts).items()}

    def tensors(state):
        if isinstance(state, dict):
            return [t for v in state.values() for t in tensors(v)]
        return [state] if isinstance(state, __import__("torch").Tensor) else []

    opt_bytes = sum(t.numel() * t.element_size() for t in tensors(ts.opt_state)
                    if t.dim() > 0)
    if dp.sentinel is not None:
        from tpudml_torch.resilience import param_leaf_names, sentinel_stats

        extra = {"stats": sentinel_stats(ts.opt_state), "names": param_leaf_names(model)}
    return {"losses": losses, "params": params, "opt_bytes": opt_bytes,
            "comm_calls": dp.comm_stats.calls, **extra}, dp, ts


def suite_zero1(job: Path, rank: int, world: int) -> dict:
    """World 2: DataParallel(zero1=...) on LeNet (Adam, SGD momentum, with
    accumulation, a clip, the overlap variant, the split step, the
    sentinel on a NaN step), the sharded store of a ZeRO-1 state (the
    port's file, and JAX's restored), and task2 --zero1."""
    import torch

    from tpudml_torch.checkpoint import restore_sharded_checkpoint, save_sharded_checkpoint
    from tpudml_torch.models import LeNet
    from tpudml_torch.optim import Adam, ClipByGlobalNorm, Sgd
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.tasks import task2

    case = torch.load(job / "cases.pt", weights_only=False)
    b = [(case["x"], case["y"])] * 3
    out = {
        "adam": _zero1_run(case, Adam(lr=1e-2), b, zero1=True)[0],
        "adam_rep": _zero1_run(case, Adam(lr=1e-2), b)[0],
        "sgd": _zero1_run(case, Sgd(lr=1e-2, momentum=0.9), b, zero1=True)[0],
        "accum": _zero1_run(case, Sgd(lr=1e-2, momentum=0.9), b, zero1=True,
                            accum_steps=2)[0],
        "clip": _zero1_run(case, ClipByGlobalNorm(Adam(lr=1e-3), max_norm=0.05), b,
                           zero1=True)[0],
        "overlap": _zero1_run(case, Sgd(lr=1e-2, momentum=0.9), b, zero1=True,
                              zero1_overlap=True, accum_steps=2)[0],
        "split": _zero1_run(case, Adam(lr=1e-3), b, zero1=True, measure_comm=True)[0],
        "sentinel": _zero1_run(case, Sgd(lr=1e-2, momentum=0.9),
                               [b[0], (case["xbad"], case["y"]), b[0]],
                               zero1=True, sentinel=True)[0],
    }
    run, dp, ts = _zero1_run(case, Adam(lr=1e-3), b[:2], zero1=True)
    out["ckpt_run_losses"] = run["losses"]
    save_sharded_checkpoint(job / "zero1_ckpt", ts, 2, placement=dp.placement)
    model = LeNet(device="cpu", generator=torch.Generator().manual_seed(9))
    dp2 = DataParallel(model, Adam(lr=1e-3), stacked_batches=False, zero1=True)
    ts2 = dp2.create_state()
    restore_sharded_checkpoint(job / "zero1_ckpt" / "step_2", ts2, placement=dp2.placement)
    out["ckpt"] = {"m": {n: t.clone() for n, t in ts.opt_state["m"].items()},
                   "roundtrip": ts2.step == 2 and ts2.opt_state["t"] == ts.opt_state["t"]
                   and all(torch.equal(p, run["params"][n]) for n, p in model.named_parameters())
                   and all(torch.equal(t, ts.opt_state["v"][n])
                           for n, t in ts2.opt_state["v"].items())}
    # One Adam step's state through the store both ways (JAX's file is
    # <job>/jax_zero1): ZeRO-1 ravels the conv kernels' moments as JAX does.
    _, dp1, ts1 = _zero1_run(case, Adam(lr=1e-3), b[:1], zero1=True)
    save_sharded_checkpoint(job / "zero1_order", ts1, 1, placement=dp1.placement)
    dp3 = DataParallel(LeNet(device="cpu", generator=torch.Generator().manual_seed(9)),
                       Adam(lr=1e-3), stacked_batches=False, zero1=True)
    ts3 = dp3.create_state()
    restore_sharded_checkpoint(job / "jax_zero1" / "step_1", ts3, placement=dp3.placement)
    out["order"] = {
        who: {k: {n: t.clone() for n, t in st.opt_state[k].items()} for k in ("m", "v")}
        for who, st in (("own", ts1), ("from_jax", ts3))}
    out["task2"] = task2.main(["--device", "cpu", "--dataset", "synthetic", "--epochs", "1",
                               "--batch_size", "16", "--log_every", "0", "--zero1",
                               "--log_dir", str(job / f"logs{rank}")])
    return out


def suite_task2_zero1_ckpt(job: Path, rank: int, world: int) -> dict:
    """World 2: task2 --zero1 --ckpt_dir resumed from JAX's step-4
    checkpoint of the same run (``<job>/port_ckpt``), saving every 2 steps
    to the epoch's end; then a second run resumed from the first run's
    step-6 checkpoint (``<job>/resume_ckpt``)."""
    import shutil

    import torch.distributed as dist

    from tpudml_torch.tasks import task2

    base = ["--device", "cpu", "--dataset", "synthetic", "--epochs", "1", "--batch_size",
            "256", "--log_every", "0", "--zero1", "--ckpt_every", "2", "--resume",
            "--log_dir", str(job / f"logs{rank}")]
    out = {"first": task2.main(base + ["--ckpt_dir", str(job / "port_ckpt")])}
    if rank == 0:
        shutil.copytree(job / "port_ckpt" / "step_6", job / "resume_ckpt" / "step_6")
    dist.barrier()
    out["resumed"] = task2.main(base + ["--ckpt_dir", str(job / "resume_ckpt")])
    return out


def suite_sharded(job: Path, rank: int, world: int) -> dict:
    """World 2: the sharded store on a GSPMD state (the tiny LM under
    tensor_parallel_rules, Adam, after a step): saved, restored into a
    fresh engine's state (other weights) bitwise, JAX's file of the same
    state restored; an EP state likewise; then task5 --parallel ep
    --ckpt_dir (4 steps, a checkpoint every 2) and a resume from the step-2
    checkpoint to step 4."""
    import shutil

    import torch
    import torch.distributed as dist

    from tpudml_torch.checkpoint import (
        restore_latest_valid_sharded, restore_sharded_checkpoint, save_sharded_checkpoint,
        verify_sharded_checkpoint,
    )
    from tpudml_torch.interop import gspmd_state_from_tpudml
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.nn import Activation, Dense, Flatten, Sequential
    from tpudml_torch.nn.moe import MoELayer
    from tpudml_torch.optim import Adam, Sgd
    from tpudml_torch.parallel import ExpertParallel, GSPMDParallel, tensor_parallel_rules
    from tpudml_torch.tasks import task5_longcontext as task5

    case = torch.load(job / "cases.pt", weights_only=False)
    out = {}
    tp = dict(mesh={"model": world}, rule=tensor_parallel_rules("model"), axis_name="model")
    _, mp, ts = _mp_run(_lm(case), Adam(lr=1e-3), [(case["tokens"], case["labels"])], **tp)
    save_sharded_checkpoint(job / "port_tp", ts, 1, placement=mp.placement)
    out["verified_step"] = verify_sharded_checkpoint(job / "port_tp" / "step_1")
    out["full"] = mp.gather_params()
    with torch.no_grad():
        out["m_full"] = {n: t.clone() for n, t in mp.gather(ts.opt_state["m"]).items()}

    def fresh():
        model = TransformerLM(**case["lm"], device="cpu",
                              generator=torch.Generator().manual_seed(7))
        eng = GSPMDParallel(model, Adam(lr=1e-3), **tp)
        return eng, eng.create_state()

    mp2, ts2 = fresh()
    restore_latest_valid_sharded(job / "port_tp", ts2, placement=mp2.placement)
    out["roundtrip"] = (
        ts2.step == 1 and ts2.opt_state["t"] == ts.opt_state["t"]
        and all(torch.equal(p, q) for p, q in zip(ts.model.parameters(), ts2.model.parameters()))
        and all(torch.equal(t, ts2.opt_state[k][n]) for k in ("m", "v")
                for n, t in ts.opt_state[k].items()))
    mp3, ts3 = fresh()
    restore_sharded_checkpoint(job / "jax_tp" / "step_3", ts3, placement=mp3.placement)
    params, opt = gspmd_state_from_tpudml(case["jax_tp_params"], case["jax_tp_opt"],
                                          mp3.param_specs, mp3.mesh, mp3.coords)
    out["from_jax"] = (
        ts3.step == 1 and ts3.opt_state["t"] == opt["t"]
        and all(torch.equal(p, params[n]) for n, p in ts3.model.named_parameters())
        and all(torch.equal(t, opt[k][n]) for k in ("m", "v")
                for n, t in ts3.opt_state[k].items()))

    def ep_model(seed):
        g = torch.Generator().manual_seed(seed)
        return Sequential((Flatten(), Dense(16, 8, generator=g), Activation(),
                           MoELayer(8, 4, mlp_ratio=2, axis_name="expert", generator=g),
                           Dense(8, 4, generator=g))).to("cpu")

    ep = ExpertParallel(ep_model(2), Sgd(lr=0.1, momentum=0.9))
    ts = ep.create_state()
    ts, _ = ep.make_train_step()(ts, case["ep_x"], case["ep_y"])
    save_sharded_checkpoint(job / "ep_shards", ts, 1, placement=ep.placement)
    ep2 = ExpertParallel(ep_model(5), Sgd(lr=0.1, momentum=0.9))
    ts2 = ep2.create_state()
    restore_sharded_checkpoint(job / "ep_shards" / "step_1", ts2, placement=ep2.placement)
    out["ep_roundtrip"] = (
        ts2.step == 1
        and all(torch.equal(p, q) for p, q in zip(ts.model.parameters(), ts2.model.parameters()))
        and all(torch.equal(ts.opt_state[n], ts2.opt_state[n]) for n in ts.opt_state))

    flags = case["task5"] + ["--n_devices", str(world)]
    out["a"] = task5.main(flags + ["--ckpt_dir", str(job / "ref"),
                                   "--log_dir", str(job / f"a{rank}")])
    if rank == 0:
        shutil.copytree(job / "ref" / "step_2", job / "run" / "step_2")
    dist.barrier()
    out["b"] = task5.main(flags + ["--ckpt_dir", str(job / "run"), "--resume",
                                   "--log_dir", str(job / f"b{rank}")])
    return out


# ------------------------------------------- FSDP, the sharded head, overlap


def _mlp(case):
    from tpudml_torch.models import ForwardMLP

    model = ForwardMLP(device="cpu")
    model.load_state_dict(case["mlp"])
    return model


def _old_rule_run(case, batches) -> dict:
    """FSDP under the block-then-mean gradient rule: the gather's backward
    keeps this rank's block of the gradient whatever the axis, and the data
    mean then averages every gradient, blocks that differ by rank
    included."""
    import torch.distributed as dist

    from tpudml_torch.optim import Sgd
    from tpudml_torch.parallel import FSDP, mp

    def narrow_only(gs, dims, group, size):
        i = dist.get_rank(group)
        return [g.narrow(d, i * (g.shape[d] // size), g.shape[d] // size).contiguous()
                for g, d in zip(gs, dims)]

    model = _mlp(case)
    eng = FSDP(model, Sgd(lr=0.05, momentum=0.9))
    eng._batch_sharded = set()
    real, mp.reduce_scatter_blocks = mp.reduce_scatter_blocks, narrow_only
    try:
        ts, step = eng.create_state(), eng.make_train_step()
        losses = []
        for x, y in batches:
            ts, m = step(ts, x, y)
            losses.append(float(m["loss"]))
    finally:
        mp.reduce_scatter_blocks = real
    return {"losses": losses, "params": eng.gather_params()}


def _reduce_scatter_check(rank: int, world: int) -> float:
    """:func:`parallel.mp.reduce_scatter_blocks` against its plain version,
    an all-reduce then a narrow (W× the bytes): max |difference| over f32
    and f64 leaves cut along dims 0, 1 and 2."""
    import torch

    from tpudml_torch.parallel.mp import reduce_scatter_blocks

    g = torch.Generator().manual_seed(100 + rank)
    gs = [torch.randn(4 * world, 3, generator=g), torch.randn(5, 2 * world, generator=g),
          torch.randn(2, 3, world, generator=g).double(), torch.randn(world, generator=g)]
    dims = (0, 1, 2, 0)
    got = reduce_scatter_blocks(gs, dims, None, world)
    err = 0.0
    for t, d, mine in zip(gs, dims, got):
        full = t.clone()
        torch.distributed.all_reduce(full)
        b = t.shape[d] // world
        want = full.div_(world).narrow(d, rank * b, b)
        err = max(err, float((mine - want).abs().max()))
    return err


def suite_fsdp(job: Path, rank: int, world: int) -> dict:
    """FSDP at this world on ForwardMLP (SGD momentum: losses, the full
    parameters; Adam one step: each rank's blocks and moments); the same
    run under the block-then-mean gradient rule; the reduce-scatter
    against its plain version; at world 4 also FSDP×TP {data 2, model 2}
    on the tiny LM, without and with a global-norm clip."""
    import torch

    from tpudml_torch.optim import Adam, ClipByGlobalNorm, Sgd
    from tpudml_torch.parallel import FSDP, tensor_parallel_rules

    case = torch.load(job / "cases.pt", weights_only=False)
    batches = [(case["x"], case["y"])] * case["steps"]
    out = {"rs_err": _reduce_scatter_check(rank, world)}
    out["sgd"], _, _ = _mp_run(_mlp(case), Sgd(lr=0.05, momentum=0.9), batches,
                               engine=FSDP)
    out["adam"], _, _ = _mp_run(_mlp(case), Adam(lr=1e-3), batches[:1], engine=FSDP)
    out["old_rule"] = _old_rule_run(case, batches)
    if world == 4:
        tokens = [(case["tokens"], case["labels"])] * 3
        two_d = dict(engine=FSDP, mesh={"data": 2, "model": 2},
                     base_rule=tensor_parallel_rules("model"))
        out["fsdp_tp"], _, _ = _mp_run(_lm(case), Sgd(lr=0.1, momentum=0.9), tokens, **two_d)
        out["fsdp_tp_clip"], _, _ = _mp_run(
            _lm(case), ClipByGlobalNorm(Sgd(lr=0.1, momentum=0.9), max_norm=0.05), tokens,
            **two_d)
    return out


def suite_sharded_xent(job: Path, rank: int, world: int) -> dict:
    """World 4: ``sharded_linear_cross_entropy`` (the plain path the CPU
    runs, and the kernels' autograd function on their plain versions) under
    TP {model 4}, 1-D FSDP {data 4} (tokens gathered first) and FSDP×TP
    {data 2, model 2}, saved and lean: the loss and the full dX, dW, db;
    then the engines fused against unfused: TP, FSDP, FSDP×TP and TP at an
    indivisible vocabulary, each also through the kernels' function."""
    import torch

    from tpudml_torch.comm.collectives import gather_rows
    from tpudml_torch.ops import xent_kernel as xk
    from tpudml_torch.optim import Sgd
    from tpudml_torch.parallel import FSDP, GSPMDParallel, tensor_parallel_rules
    from tpudml_torch.parallel.ep import mesh_groups

    dist = torch.distributed
    case = torch.load(job / "cases.pt", weights_only=False)
    x0, w0, b0, labels0 = (torch.from_numpy(case[k]).clone() for k in ("x", "w", "b", "labels"))
    n, v = x0.shape[0], w0.shape[1]

    def via_function(x, w, labels, bias, *, group, save_s=None, reduce_dx=True, **_):
        xn, ln = x.reshape(-1, x.shape[-1]), labels.reshape(-1).to(torch.int32)
        if save_s is None:
            save_s = xk._auto_save_s(xn.shape[0], w.shape[1], 256, 2048)
        return xk._ShardedLinearXent.apply(xn, w, bias, ln, group, bool(save_s), reduce_dx)

    def grads(layout: str, op, save_s):
        """The loss and the FULL gradients (gathered back) under ``layout``."""
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        if layout == "tp":
            groups = mesh_groups({"model": world})
            group, index, size = groups["model"]
            vl = v // size
            loss = op(x, w[:, index * vl:(index + 1) * vl], labels0,
                      b[index * vl:(index + 1) * vl], group=group, save_s=save_s)
        elif layout == "fsdp":
            group, index, size = mesh_groups({"data": world})["data"]
            vl, nl = v // size, n // size
            xg = gather_rows(x[index * nl:(index + 1) * nl], group, grad_scale=1.0)
            lg = gather_rows(labels0[index * nl:(index + 1) * nl].contiguous(), group)
            loss = op(xg, w[:, index * vl:(index + 1) * vl], lg,
                      b[index * vl:(index + 1) * vl], group=group, save_s=save_s,
                      reduce_dx=False)
        else:  # fsdp_tp: tokens over data, vocab over model, a pmean of the token means
            groups = mesh_groups({"data": 2, "model": 2})
            dgroup, di, ds = groups["data"]
            mgroup, mi, ms = groups["model"]
            vl, nl = v // ms, n // ds
            loss = op(x[di * nl:(di + 1) * nl], w[:, mi * vl:(mi + 1) * vl],
                      labels0[di * nl:(di + 1) * nl], b[mi * vl:(mi + 1) * vl],
                      group=mgroup, save_s=save_s)
            loss = loss / ds  # the global loss is the data ranks' mean
            loss_value = loss.detach().clone()
            dist.all_reduce(loss_value, group=dgroup)
        loss.backward()
        g = [t.grad.clone() for t in (x, w, b)]
        for t in g:  # each rank computed its own part; the sum is the whole
            dist.all_reduce(t)
        if layout in ("tp", "fsdp_tp"):  # the model ranks hold the same rows' dX
            g[0] /= world if layout == "tp" else 2
        value = loss_value if layout == "fsdp_tp" else loss.detach()
        return float(value), g

    out = {}
    for layout in ("tp", "fsdp", "fsdp_tp"):
        for save_s in (False, True):
            out[f"{layout}/plain/{save_s}"] = grads(layout, xk.sharded_linear_cross_entropy,
                                                   save_s)
            out[f"{layout}/kernels/{save_s}"] = grads(layout, via_function, save_s)

    tp = dict(rule=tensor_parallel_rules("model"), axis_name="model")
    engines = {"tp": (GSPMDParallel, dict(mesh={"model": world}, **tp)),
               "fsdp": (FSDP, dict(mesh={"data": world})),
               "fsdp_tp": (FSDP, dict(mesh={"data": 2, "model": 2},
                                      base_rule=tensor_parallel_rules("model"))),
               "tp_v34": (GSPMDParallel, dict(mesh={"model": world}, **tp))}
    real = xk.sharded_linear_cross_entropy
    for name, (cls, kw) in engines.items():
        key = {"tp_v34": "lm34", "fsdp": "lm64"}.get(name, "lm")
        batches = [(case[f"{key}_tokens"], case[f"{key}_labels"])] * 3
        for mode in ("unfused", "fused", "fused_kernels"):
            xk.sharded_linear_cross_entropy = via_function if mode == "fused_kernels" else real
            run, eng, _ = _mp_run(_lm(case, key), Sgd(lr=0.05), batches, engine=cls,
                                  fused_xent=mode != "unfused", **kw)
            run["head_spec"] = eng.param_specs["head.kernel"]
            run["wire"] = eng.step_wire_bytes()
            run["head_wire"] = getattr(eng._fused_loss_fn, "wire_bytes", 0.0)
            out[f"engine/{name}/{mode}"] = run
        xk.sharded_linear_cross_entropy = real
    return out


def suite_overlap(job: Path, rank: int, world: int) -> dict:
    """``tp_overlap_matmul`` against the plain ``all_reduce(x @ w)`` (value
    and the gradients of sum(sin(·))), over the world (4 chunks) and, at
    world 4, over the model group of {data 2, model 2} (2 chunks); and its
    rejection of rows the chunks do not divide."""
    import torch

    from tpudml_torch.comm.collectives import _ReplicatedSum
    from tpudml_torch.parallel import tp_overlap_matmul
    from tpudml_torch.parallel.ep import mesh_groups

    def run(group, fn, seed):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(8, 16, generator=g, requires_grad=True)
        w = torch.randn(16, 8, generator=g, requires_grad=True)
        y = fn(x, w, group)
        torch.sin(y).sum().backward()
        return y.detach(), x.grad, w.grad

    def plain(x, w, group):
        return _ReplicatedSum.apply(x @ w, group)

    out = {}
    layouts = [("world", None, 4)]
    if world == 4:
        layouts.append(("fsdp_tp", mesh_groups({"data": 2, "model": 2})["model"][0], 2))
    for name, group, chunks in layouts:
        seed = 10 + rank
        out[name] = {"overlap": run(group, lambda x, w, gr: tp_overlap_matmul(
            x, w, group=gr, chunks=chunks), seed), "plain": run(group, plain, seed)}
    try:
        tp_overlap_matmul(torch.ones(6, 4), torch.ones(4, 2), chunks=4)
        out["rows_error"] = None
    except ValueError as e:
        out["rows_error"] = str(e)
    return out


def _task5_losses(task5, argv: list[str], state) -> tuple[dict, list[float]]:
    """task5 on ``argv`` with its model's initial parameters replaced by
    ``state`` (JAX's): the entry's result and every step's loss."""
    from tpudml_torch.models import TransformerLM

    class Loaded(TransformerLM):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.load_state_dict(state)

    losses = []
    real, task5.TransformerLM = task5.TransformerLM, Loaded
    try:
        out = task5.run(task5.parse_args(argv), hooks=[
            lambda step, train_state, metrics: losses.append(float(metrics["loss"]))])
    finally:
        task5.TransformerLM = real
    return out, losses


def suite_mp_cli(job: Path, rank: int, world: int) -> dict:
    """World 2: task5 ``--parallel fsdp`` and ``tp`` (plain, ``--fused_xent``,
    ``--sentinel``) from JAX's initial parameters; ``--ckpt_dir`` under both
    (4 steps, a checkpoint every 2) and a resume from the step-2
    checkpoint; an FSDP state (the small LM, Adam, one step) through the
    sharded store, restored into a fresh engine bitwise, then a step of
    each."""
    import shutil

    import torch
    import torch.distributed as dist

    from tpudml_torch.checkpoint import restore_sharded_checkpoint, save_sharded_checkpoint
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.optim import Adam
    from tpudml_torch.parallel import FSDP
    from tpudml_torch.tasks import task5_longcontext as task5

    case = torch.load(job / "cases.pt", weights_only=False)
    out = {}
    for name, extra in case["runs"].items():
        argv = case["task5"] + extra + ["--log_dir", str(job / f"l{rank}")]
        out[name] = _task5_losses(task5, argv, case["task5_state"])
    for par in ("fsdp", "tp"):
        flags = case["task5"] + ["--parallel", par, "--ckpt_every", "2"]
        out[f"{par}_a"] = task5.main(flags + ["--ckpt_dir", str(job / f"{par}_ref"),
                                              "--log_dir", str(job / f"a{rank}")])
        if rank == 0:
            shutil.copytree(job / f"{par}_ref" / "step_2", job / f"{par}_run" / "step_2")
        dist.barrier()
        out[f"{par}_b"] = task5.main(flags + ["--ckpt_dir", str(job / f"{par}_run"), "--resume",
                                              "--log_dir", str(job / f"b{rank}")])

    tokens = [(case["tokens"], case["labels"])]
    run, eng, ts = _mp_run(_lm(case), Adam(lr=1e-3), tokens, engine=FSDP)
    save_sharded_checkpoint(job / "port_fsdp", ts, 1, placement=eng.placement)
    out["fsdp_full"] = run["params"]
    with torch.no_grad():
        out["fsdp_m_full"] = {n: t.clone() for n, t in eng.gather(ts.opt_state["m"]).items()}
    model = TransformerLM(**case["lm"], device="cpu", generator=torch.Generator().manual_seed(7))
    eng2 = FSDP(model, Adam(lr=1e-3))
    ts2 = eng2.create_state()
    restore_sharded_checkpoint(job / "port_fsdp" / "step_1", ts2, placement=eng2.placement)
    out["fsdp_roundtrip"] = (
        ts2.step == 1 and ts2.opt_state["t"] == ts.opt_state["t"]
        and all(torch.equal(p, q) for p, q in zip(ts.model.parameters(), ts2.model.parameters()))
        and all(torch.equal(t, ts2.opt_state[k][n]) for k in ("m", "v")
                for n, t in ts.opt_state[k].items()))
    _, m = eng.make_train_step()(ts, *tokens[0])
    _, m2 = eng2.make_train_step()(ts2, *tokens[0])
    out["fsdp_resumed_losses"] = (float(m["loss"]), float(m2["loss"]))
    out["fsdp_resumed_equal"] = all(torch.equal(p, q) for p, q in
                                    zip(ts.model.parameters(), ts2.model.parameters()))
    return out


# ---------------------------------------------------------------- pipelines


def _pp_block(spec):
    """The block factory of a homogeneous pipeline case."""
    from tpudml_torch.models import TransformerBlock
    from tpudml_torch.nn import Activation, Dense, Dropout, Sequential

    if spec["kind"] == "transformer":
        return lambda g: TransformerBlock(**spec["args"], generator=g)
    w, rate = spec["width"], spec.get("dropout", 0.0)
    return lambda g: Sequential((Dense(w, w, generator=g), Activation())
                                + ((Dropout(rate),) if rate else ()))


def _pp_stages(spec) -> list:
    """The stages of a heterogeneous case: LeNet's split, or MLP stages
    ``(in, out, relu, dropout rate)``."""
    import torch

    from tpudml_torch.models import lenet_stages
    from tpudml_torch.nn import Activation, Dense, Dropout, Sequential

    if spec == "lenet":
        return [m for _, m in lenet_stages(device="cpu").named_children()]
    g = torch.Generator().manual_seed(0)
    return [Sequential((Dense(i, o, generator=g),) + ((Activation(),) if relu else ())
                       + ((Dropout(rate),) if rate else ())) for i, o, relu, rate in spec]


def _pp_optimizer(spec):
    from tpudml_torch.optim import Adam, ClipByGlobalNorm, Sgd, ZeRO1

    kind, lr, *rest = spec["opt"]
    opt = Adam(lr=lr) if kind == "adam" else Sgd(lr=lr, momentum=rest[0] if rest else 0.0)
    if spec.get("clip"):
        opt = ClipByGlobalNorm(base=opt, max_norm=spec["clip"])
    if spec.get("zero1"):
        opt = ZeRO1(base=opt, axis_name="data", world=spec["mesh"]["data"])
    return opt


def _pp_engine(spec):
    """(engine, ts) of a pipeline case, its parameters JAX's."""
    import torch

    from tpudml_torch.core.prng import seed_key
    from tpudml_torch.interop import hetero_stage_from_tpudml, pipeline_state_from_tpudml
    from tpudml_torch.models import TransformerEmbed, TransformerHead
    from tpudml_torch.nn import Dense
    from tpudml_torch.parallel import (
        GPipe, HeteroOneFOneB, HeteroPipeline, Interleaved1F1B, OneFOneB,
    )

    kw = dict(n_microbatches=spec["M"], mesh=spec["mesh"], optimizer=_pp_optimizer(spec),
              batch_axis=spec.get("batch_axis"))
    root = spec.get("rng_root")
    engine = spec["engine"]
    if engine.startswith("hetero"):
        if root is not None:
            kw["rng_root"] = seed_key(root)
        cls = HeteroOneFOneB if engine == "hetero_1f1b" else HeteroPipeline
        pipe = cls(_pp_stages(spec["stages"]), nhwc_input=spec["stages"] == "lenet", **kw)
        ts = pipe.create_state(0)
        stage = ts.model.stages
        stage.load_state_dict(hetero_stage_from_tpudml(spec["params"]["stages"][pipe.stage],
                                                       stage))
        return pipe, ts
    g = torch.Generator().manual_seed(0)

    def end(e):  # (in, out) a Dense; ("embed", V, d, T) or ("head", d, V)
        if e[0] == "embed":
            return TransformerEmbed(*e[1:], generator=g)
        if e[0] == "head":
            return TransformerHead(*e[1:], generator=g)
        return Dense(*e, generator=g)

    kw.update(prologue=end(spec["prologue"]), epilogue=end(spec["epilogue"]),
              remat=spec.get("remat", False), device="cpu")
    if engine == "gpipe":
        pipe = GPipe(_pp_block(spec["block"]), **kw)
    else:
        kw.pop("remat")
        kw["rng_root"] = None if root is None else seed_key(root)
        if engine == "interleaved":
            pipe = Interleaved1F1B(_pp_block(spec["block"]), v_chunks=spec["v"], **kw)
        else:
            pipe = OneFOneB(_pp_block(spec["block"]), **kw)
    ts = pipe.create_state(0)
    state, _ = pipeline_state_from_tpudml(spec["params"], (), pipe.stage)
    ts.model.load_state_dict(state)
    return pipe, ts


def _pp_case(spec) -> dict:
    """Train a pipeline case on its batches: per-step losses, the whole
    parameters after (a hetero stage: its row in JAX's layout), the
    forward's logits, each tick's bytes on the wire, the local leaves'
    shapes and the replicated leaves (to check them alike on every rank)."""
    import torch

    from tpudml_torch.interop import hetero_stage_from_tpudml, hetero_stage_to_tpudml
    from tpudml_torch.nn import layers

    masks = spec.get("masks")
    real = layers.dropout_mask
    if masks is not None:
        layers.dropout_mask = lambda key, keep, shape, device: torch.from_numpy(
            masks[key.path]).to(device)
    try:
        pipe, ts = _pp_engine(spec)
        out = {"stage": pipe.stage, "local": {n: tuple(p.shape)
                                              for n, p in ts.model.named_parameters()}}
        if "forward_x" in spec:
            out["forward"] = pipe.make_forward()(spec["forward_x"])
            if spec["engine"].startswith("hetero"):  # every stage from JAX's rows
                out["sequential"] = pipe.sequential_forward(
                    {s: hetero_stage_from_tpudml(spec["params"]["stages"][s], st)
                     for s, st in enumerate(pipe.stages)}, spec["forward_x"])
        step = pipe.make_train_step()
        losses, ticks = [], []
        for x, y in spec.get("batches", ()):
            ts, m = step(ts, x, y)
            losses.append(float(m["loss"]))
            ticks.append(list(pipe.tick_bytes))
        out.update(losses=losses, tick_bytes=ticks)
        if spec["engine"].startswith("hetero"):
            width = spec["params"]["stages"].shape[1]
            out["row"] = hetero_stage_to_tpudml(dict(ts.model.stages.named_parameters()),
                                                ts.model.stages, width)
        else:
            out["params"] = pipe.gather_params()
            out["replicated"] = {n: p.detach().clone() for n, p in ts.model.named_parameters()
                                 if not n.startswith("stages.")}
        state = ts.opt_state.get("m", ts.opt_state) if isinstance(ts.opt_state, dict) else {}
        out["opt_local"] = {n: tuple(t.shape) for n, t in state.items()}  # momentum / Adam's m
        return out
    finally:
        layers.dropout_mask = real


def _shift_case(rank: int, world: int) -> dict:
    """The open shifts on rank-seeded values: the values, the gradient of
    Σ shifted·cot, the bytes sent."""
    import torch

    from tpudml_torch.comm import shift_next, shift_prev

    g = torch.Generator().manual_seed(rank)
    out = {}
    for name, fn in (("next", shift_next), ("prev", shift_prev)):
        x = torch.randn(3, 5, generator=g).requires_grad_()
        cot = torch.randn(3, 5, generator=g)
        counter: list = []
        y = fn(x, None, counter)
        (grad,) = torch.autograd.grad(y, x, cot)
        out[name] = {"x": x.detach(), "y": y.detach(), "cot": cot, "grad": grad,
                     "bytes": counter}
    return out


def suite_pp(job: Path, rank: int, world: int) -> dict:
    """The pipeline cases of ``<job>/cases.pt`` at this world, plus the open
    shifts and, with an ``ep_forward`` case, ExpertParallel's forward."""
    import torch

    cases = torch.load(job / "cases.pt", weights_only=False)
    out = {name: _pp_case(spec) for name, spec in cases["pp"].items()}
    out["shift"] = _shift_case(rank, world)
    if "ep_forward" in cases:
        spec = cases["ep_forward"]
        ep, _, _, _ = _ep_engine(spec, _ep_model(spec))
        out["ep_forward"] = ep.make_forward()(spec["x"])
    return out


def suite_pp_cli(job: Path, rank: int, world: int) -> dict:
    """task5 ``--parallel pp`` (the case's runs, from JAX's initial
    parameters, dropout masks JAX's) and its checkpoint and resume; task4
    ``--schedule gpipe | 1f1b`` from JAX's initial rows, at this world."""
    import shutil

    import torch
    import torch.distributed as dist

    from tpudml_torch.interop import pipeline_state_from_tpudml
    from tpudml_torch.parallel import GPipe
    from tpudml_torch.tasks import task4
    from tpudml_torch.tasks import task5_longcontext as task5

    from tpudml_torch.interop import hetero_stage_from_tpudml
    from tpudml_torch.nn import layers
    from tpudml_torch.parallel import HeteroPipeline

    case = torch.load(job / "cases.pt", weights_only=False)
    out = {}
    real, real_mask = GPipe.create_state, layers.dropout_mask
    current = [None]  # the task5 run whose JAX state the engine loads

    def loaded(self, key=0):  # the engine's state, its parameters JAX's
        ts = real(self, key)
        if isinstance(self, HeteroPipeline):
            stage = ts.model.stages
            stage.load_state_dict(hetero_stage_from_tpudml(case["task4_rows"][self.stage], stage))
        else:
            ts.model.load_state_dict(pipeline_state_from_tpudml(case["states"][current[0]], (),
                                                                self.stage)[0])
        return ts

    GPipe.create_state = loaded
    masks = case.get("masks", {})
    layers.dropout_mask = lambda key, keep, shape, device: torch.from_numpy(
        masks[key.path]).to(device)
    try:
        for name, flags in case.get("task5", {}).items():
            current[0] = name
            losses = []
            args = task5.parse_args(case["base"] + flags + ["--log_dir", str(job / f"l{rank}")])
            res = task5.run(args, hooks=[lambda step, train_state, metrics: losses.append(
                float(metrics["loss"]))])
            out[name] = {"losses": losses, "final_loss": res["final_loss"]}
        if case.get("ckpt"):
            current[0] = case["ckpt"]
            flags = case["base"] + case["task5"][case["ckpt"]] + ["--ckpt_every", "2"]
            out["ckpt_a"] = task5.main(flags + ["--ckpt_dir", str(job / "ref"),
                                                "--log_dir", str(job / f"a{rank}")])
            if rank == 0:
                shutil.copytree(job / "ref" / "step_2", job / "run" / "step_2")
            dist.barrier()
            out["ckpt_b"] = task5.main(flags + ["--ckpt_dir", str(job / "run"), "--resume",
                                                "--log_dir", str(job / f"b{rank}")])
        for schedule in case.get("task4", ()):
            out[f"task4_{schedule}"] = task4.main(case["task4_flags"] + [
                "--schedule", schedule, "--log_dir", str(job / f"t4{rank}{schedule}")])
    finally:
        GPipe.create_state, layers.dropout_mask = real, real_mask
    return out


# ------------------------------------------------------ TP serving, CP


def _serve_tp_decode(spec, world: int) -> dict:
    """A TP engine over {"model": world} from ``spec``'s parameters: the
    prompt admitted into slot 0, then ``steps`` decode steps (slot 1 idle
    at position 0): each step's slot-0 logits and token."""
    import numpy as np
    import torch

    from tpudml_torch.models import TransformerLM
    from tpudml_torch.serve import Request, ServeConfig, ServingEngine

    model = TransformerLM(**spec["model"], device="cpu")
    model.load_state_dict(spec["state"])
    eng = ServingEngine(model, ServeConfig(**spec["cfg"]), device="cpu",
                        mesh={"model": world}, axis_name="model")
    pos0, last0 = eng._admit(0, Request(rid=0, prompt=spec["prompt"],
                                        max_new_tokens=spec["steps"]))
    pos, last = np.array([pos0, 0]), np.array([last0, 0])
    logits, tokens = [], []
    for _ in range(spec["steps"]):
        nxt, lg = eng._decode(eng.caches, torch.from_numpy(last), torch.from_numpy(pos))
        logits.append(lg[0].clone())
        tokens.append(int(nxt[0]))
        last, pos = np.array([tokens[-1], 0]), pos + np.array([1, 0])
    held = {n: tuple(p.shape) for n, p in eng.tp.local.named_parameters()}
    return {"logits": logits, "tokens": tokens, "held": held}


def suite_serve_tp(job: Path, rank: int, world: int) -> dict:
    """The TP decode cases of ``<job>/cases.pt`` at this world, and task6
    ``--tp`` on each of its argv lists (every rank's result)."""
    import torch

    from tpudml_torch.tasks import task6_serve

    case = torch.load(job / "cases.pt", weights_only=False)
    out = {name: _serve_tp_decode(spec, world) for name, spec in case["decode"].items()}
    for name, argv in case.get("task6", {}).items():
        res = task6_serve.main(argv + ["--log_dir", str(job / f"{name}{rank}")])
        out[name] = {k: res[k] for k in ("events", "streams", "decode_steps",
                                         "generated_tokens")}
    return out


def _cp_attention(c, rank: int, world: int) -> dict:
    """One attention case on this rank's T/W columns of the global q, k, v
    (already striped when the case is): the output shard and the
    gradients of sum(out · w) with respect to the shards."""
    import torch

    from tpudml_torch.parallel import ring_attention, ulysses_attention

    tl = c["q"].shape[1] // world
    cols = slice(rank * tl, (rank + 1) * tl)
    q, k, v = (torch.from_numpy(c[n][:, cols].copy()).requires_grad_() for n in "qkv")
    folds: list = []
    if c["impl"] == "ring":
        o = ring_attention(q, k, v, causal=c["causal"], layout=c["layout"],
                           use_flash=c["use_flash"], folds=folds)
    else:
        o = ulysses_attention(q, k, v, causal=c["causal"])
    (o * torch.from_numpy(c["w"][:, cols].copy())).sum().backward()
    return {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad, "folds": folds}


def _cp_engine(c) -> dict:
    """A ``ContextParallel`` case from JAX's parameters: every step's loss,
    the final parameters, and the accuracy or the forward's logits when
    the case asks."""
    import torch

    from tpudml_torch.models import TransformerLM
    from tpudml_torch.optim import make_optimizer
    from tpudml_torch.parallel import ContextParallel

    model = TransformerLM(**c["model"], device="cpu")
    model.load_state_dict(c["state"])
    eng = ContextParallel(model, make_optimizer(c["opt"], c["lr"]), c["mesh"],
                          batch_axis=c.get("batch_axis"), layout=c["model"].get(
                              "seq_layout", "contiguous"))
    out = {}
    if c.get("forward"):
        out["logits"] = eng.make_forward()(c["batches"][0][0])
    ts = eng.create_state()
    if c.get("evaluate"):
        out["accuracy"] = eng.evaluate(ts, c["batches"])
    step = eng.make_train_step()
    out["losses"] = []
    for x, y in c["batches"][:c.get("steps", len(c["batches"]))]:
        ts, m = step(ts, x, y)
        out["losses"].append(float(m["loss"]))
    out["params"] = _params(model)
    return out


def suite_cp(job: Path, rank: int, world: int) -> dict:
    """The attention cases of ``<job>/cases.pt`` (ring and Ulysses, forward
    and gradients, on this rank's shards; a NaN-poisoned v beyond shard 0
    under the causal ring), the engine cases at this world, and the
    Ulysses head-divisibility rejection."""
    import torch

    case = torch.load(job / "cases.pt", weights_only=False)
    out = {name: _cp_attention(c, rank, world) for name, c in case["attn"].items()}
    for name, c in case.get("engine", {}).items():
        out[name] = _cp_engine(c)
    from tpudml_torch.parallel import ulysses_attention

    q = torch.ones((1, 4, world + 1, 8))
    try:
        ulysses_attention(q, q, q)
        out["ulysses_error"] = None
    except ValueError as e:
        out["ulysses_error"] = str(e)
    return out


def suite_cp_cli(job: Path, rank: int, world: int) -> dict:
    """task5 ``--parallel cp`` on each run of ``<job>/cases.pt`` from JAX's
    initial parameters (dropout masks JAX's, by the port key's fold
    path): every step's loss."""
    import torch

    from tpudml_torch.nn import layers
    from tpudml_torch.tasks import task5_longcontext as task5

    case = torch.load(job / "cases.pt", weights_only=False)
    masks = case.get("masks", {})
    real_mask = layers.dropout_mask
    layers.dropout_mask = lambda key, keep, shape, device: torch.from_numpy(
        masks[key.path]).to(device)
    out = {}
    try:
        for name, flags in case["runs"].items():
            argv = case["base"] + flags + ["--log_dir", str(job / f"l{rank}{name}")]
            res, losses = _task5_losses(task5, argv, case["states"][name])
            out[name] = {"losses": losses, "final_loss": res["final_loss"]}
    finally:
        layers.dropout_mask = real_mask
    return out


# ----------------------------------------------------------------- plan


def _no_allreduce(build):
    """A test double of ``plan.emit.build_candidate``: the first candidate
    it builds gets a DataParallel whose gradient all-reduce is removed (each
    rank keeps its own gradient), every later one is built as it is."""
    state = {"first": None}

    def broken(spec, cand, device=None):
        eng, ts, step, batch = build(spec, cand, device)
        if state["first"] in (None, cand.key()):
            state["first"] = cand.key()
            eng.aggregator = lambda grads, group: grads
            step = eng.make_train_step()
        return eng, ts, step, batch

    return broken


def suite_plan(job: Path, rank: int, world: int) -> dict:
    """At this world on the flagship spec: the verification step of the
    base dp, zero1, fsdp and tp candidates; a verified plan; a dp plan whose
    winner loses its gradient all-reduce (demoted, the next survivor wins);
    every survivor built, and every capability-pruned candidate built or
    refused with the table's message."""
    from tpudml_torch.capabilities import TABLE, CompositionError
    from tpudml_torch.plan import emit
    from tpudml_torch.plan.space import Candidate, enumerate_candidates, flagship_lm
    from tpudml_torch.plan.prune import prune

    import time

    spec = flagship_lm()
    out = {"verify": {}, "engine_bytes": {}, "t": [time.perf_counter()]}
    for engine in ("dp", "zero1", "fsdp", "tp"):
        cand = Candidate(engine=engine, mesh=((("model" if engine == "tp" else "data"),
                                              world),),
                         zero1=engine == "zero1", zero1_overlap=False, accum_steps=1,
                         fused_xent=False, sentinel=False, obs=False)
        out["verify"][engine] = emit.verify_candidate(spec, cand, device="cpu")
        if engine in ("fsdp", "tp"):  # the engine's own count of its step's bytes
            eng, ts, step, (x, y) = emit.build_candidate(spec, cand, "cpu")
            step(ts, x, y)
            out["engine_bytes"][engine] = eng.step_wire_bytes()
    out["t"].append(time.perf_counter())
    if world == 4:  # a pipeline of two blocks a stage on {data: 2, stage: 2}
        from tpudml_torch.plan.space import ModelSpec

        deep = ModelSpec(**dict(spec.to_dict(), num_layers=4))
        cand = Candidate(engine="pp_dp", mesh=(("data", 2), ("stage", 2)), zero1=False,
                         zero1_overlap=False, accum_steps=1, fused_xent=False, sentinel=False,
                         obs=False)
        out["verify"]["pp_dp"] = emit.verify_candidate(deep, cand, device="cpu")
    log: list = []
    out["plan"] = emit.make_plan(spec, world, device="cpu", verify_log=log)
    out["log"] = log
    real = emit.build_candidate
    emit.build_candidate = _no_allreduce(real)
    try:
        out["broken"] = emit.make_plan(spec, world, engines=["dp"], device="cpu")
    finally:
        emit.build_candidate = real
    out["t"].append(time.perf_counter())
    survivors, dropped = prune(spec, enumerate_candidates(world))
    for cand in survivors:
        real(spec, cand, "cpu")
    out["built"] = len(survivors)
    out["pruned"] = []
    for rec in dropped:
        if not rec.rule.startswith("capability:"):
            continue
        try:
            real(spec, rec.candidate, "cpu")
            got = None
        except CompositionError as e:
            got = str(e)
        key = rec.rule.split(":", 1)[1]
        out["pruned"].append((rec.candidate.key(), key, got, TABLE[key].message))
    out["t"].append(time.perf_counter())
    return out


def suite_plan_cli(job: Path, rank: int, world: int) -> dict:
    """task2 at this world on ``<job>/plan.json`` (a plan the JAX planner
    emitted): with ``--plan`` alone, with the plan's knobs given as flags
    instead, and with ``--plan`` beside an explicit ``--accum_steps 4``;
    each run's metrics and the knobs its DataParallel was built with."""
    from tpudml_torch.parallel import dp as dp_module
    from tpudml_torch.tasks import task2

    built = []
    real = dp_module.DataParallel.__init__

    def record(self, *args, **kwargs):
        built.append({k: kwargs[k] for k in ("zero1", "accum_steps", "aggregation",
                                             "sentinel")})
        real(self, *args, **kwargs)

    base = ["--device", "cpu", "--dataset", "synthetic", "--epochs", "1", "--batch_size",
            "16", "--log_every", "0", "--log_dir", str(job / f"logs{rank}")]
    runs = {"plan": ["--plan", str(job / "plan.json")],
            "flags": ["--zero1", "--accum_steps", "2"],
            "plan_accum4": ["--plan", str(job / "plan.json"), "--accum_steps", "4"]}
    dp_module.DataParallel.__init__ = record
    try:
        out = {}
        for name, flags in runs.items():
            m = task2.main(base + flags)
            out[name] = {"engine": built[-1], "loss": m["loss"],
                         "test_accuracy": m["test_accuracy"], "world": m["world"]}
    finally:
        dp_module.DataParallel.__init__ = real
    return out


SUITES = {"dp": suite_dp, "resnet": suite_resnet, "comm": suite_comm,
          "task5": suite_task5, "ep": suite_ep, "labs": suite_labs, "obs": suite_obs,
          "sentinel": suite_sentinel, "gspmd": suite_gspmd, "gspmd2d": suite_gspmd2d,
          "task4": suite_task4,
          "zero1": suite_zero1, "task2_zero1_ckpt": suite_task2_zero1_ckpt,
          "sharded": suite_sharded, "fsdp": suite_fsdp,
          "sharded_xent": suite_sharded_xent, "overlap": suite_overlap,
          "mp_cli": suite_mp_cli, "pp": suite_pp, "pp_cli": suite_pp_cli,
          "serve_tp": suite_serve_tp, "cp": suite_cp, "cp_cli": suite_cp_cli,
          "plan": suite_plan, "plan_cli": suite_plan_cli}


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
