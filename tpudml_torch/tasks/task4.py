"""Task 4 — model-parallel training, on the port (the port of
``tasks/task4.py``).

LeNet split into a ``conv`` and an ``fc`` stage (codes/task4/model.py:
18-66, ``models.lenet_stages``), trained with each parameter's gradient
and update where its block lives (dist_autograd + DistributedOptimizer in
the reference, model.py:75-84, 126). Reference hyperparameters: batch 32,
SGD lr 0.01, momentum 0 (task4.tex:26).

``--schedule gspmd`` (the default): ``tpudml_torch.parallel.GSPMDParallel``
over a ``{"stage": world}`` mesh, one process a device (``torchrun
--nproc_per_node N``; a process started alone builds a one-rank group):
every rank holds its block of each weight's output dimension, the step
gathers the weights, and every rank trains on the same batch, as JAX's
replicated batches (the loss curve is single-device training's). Every
rank evaluates the test set with the gathered weights; rank 0 prints
``Test accuracy`` and writes the metrics under the run name
``task4-stage{world}``.

``--schedule gpipe | 1f1b`` (``run_gpipe``): the two stages as true
pipeline stages, ``HeteroPipeline`` or ``HeteroOneFOneB`` over
``--microbatches`` micro-batches, one process a stage; the world must be
a multiple of 2 and the extra ranks become data replicas (a ``{"data":
world/2, "stage": 2}`` mesh). ``--accum_steps`` is rejected, and the
batch must divide by data replicas × micro-batches, with JAX's messages.
Rank 0 prints the test accuracy of the pipeline's forward (the last
partial test batch padded to that multiple) and writes the metrics under
``task4-{schedule}{stages}x{replicas}``. Same flags as the JAX entry
point plus ``--device`` (default ``cuda``; ``cpu`` for the CPU, with
gloo).

Run: ``python -m tpudml_torch.tasks.task4 [--device cpu] [--dataset synthetic]``;
the pipeline: ``torchrun --nproc_per_node 2 -m tpudml_torch.tasks.task4 --schedule gpipe
--device cpu --dataset synthetic``
"""

from __future__ import annotations

import numpy as np
import torch

from tpudml_torch.core import TrainConfig, build_parser, config_from_args, process_index
from tpudml_torch.core.prng import seed_key
from tpudml_torch.data import DataLoader, make_sampler
from tpudml_torch.device import resolve_device
from tpudml_torch.metrics import MetricsWriter
from tpudml_torch.models import lenet_stages
from tpudml_torch.optim import make_optimizer
from tpudml_torch.parallel.mp import GSPMDParallel
from tpudml_torch.tasks.common import (
    add_device_flag, init_distributed, load_splits, select_devices,
)
from tpudml_torch.train import evaluate_counts, train_loop


def reference_defaults() -> TrainConfig:
    cfg = TrainConfig()
    cfg.epochs = 1
    cfg.optimizer = "sgd"
    cfg.lr = 0.01  # reference: codes/task4/model.py:126
    cfg.momentum = 0.0
    cfg.data.batch_size = 32
    return cfg


def run(cfg: TrainConfig, schedule: str = "gspmd", microbatches: int = 4,
        device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    if schedule in ("gpipe", "1f1b"):
        return run_gpipe(cfg, device, microbatches, schedule)
    with init_distributed(cfg, device) as group:
        world = select_devices(cfg, group)
        lead = process_index(group) == 0
        train_set, test_set = load_splits(cfg)
        # Every rank draws the same batches (the reference's rank-0 loading,
        # model.py:117-124; JAX's batches replicated over the stage devices).
        sampler = make_sampler(cfg.data.division, len(train_set), 1, 0,
                               shuffle=cfg.data.shuffle, seed=cfg.data.seed)
        train_loader = DataLoader(train_set, cfg.data.batch_size, sampler,
                                  drop_remainder=cfg.data.drop_remainder)
        test_loader = DataLoader(test_set, cfg.data.batch_size, drop_remainder=False)

        model = lenet_stages(in_channels=train_set.images.shape[-1], device=device,
                             generator=torch.Generator().manual_seed(cfg.seed))
        optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum)
        mp = GSPMDParallel(model, optimizer, {"stage": world}, accum_steps=cfg.accum_steps)
        ts = mp.create_state()
        writer = MetricsWriter(cfg.log_dir, run_name=f"task4-stage{world}") if lead else None
        ts, metrics = train_loop(
            model, mp.optimizer, train_loader, cfg.epochs, seed_key(cfg.seed),
            writer=writer, log_every=cfg.log_every if lead else 0,
            step_fn=mp.make_train_step(), state=ts)
        acc = evaluate_counts(mp.make_eval_step(), ts, test_loader)
        if lead:
            print(f"Test accuracy: {acc * 100:.2f}%")
            writer.add_scalar("Test Accuracy", acc, ts.step)
            writer.close()
            metrics["run_dir"] = str(writer.run_dir)
    metrics["test_accuracy"] = acc
    metrics["world"] = world
    return metrics


def run_gpipe(cfg: TrainConfig, device: torch.device, microbatches: int,
              schedule: str = "gpipe") -> dict:
    """The conv/fc split as micro-batched pipeline stages (module
    docstring; JAX's ``run_gpipe``)."""
    from tpudml_torch.parallel import HeteroOneFOneB, HeteroPipeline

    if cfg.accum_steps > 1:
        # Micro-batching IS this engine's accumulation axis.
        raise ValueError(f"--schedule {schedule} does not support --accum_steps; raise "
                         "--microbatches instead")
    with init_distributed(cfg, device) as group:
        world = select_devices(cfg, group)
        lead = process_index(group) == 0
        # Synthetic data and MNIST are single-channel.
        staged = lenet_stages(device=device, generator=torch.Generator().manual_seed(cfg.seed))
        stages = [m for _, m in staged.named_children()]
        n_stage = len(stages)
        if world % n_stage:
            raise ValueError(f"--schedule gpipe needs a multiple of {n_stage} devices, "
                             f"got {world}")
        n_data = world // n_stage
        divisor = n_data * microbatches
        if cfg.data.batch_size % divisor:
            raise ValueError(f"--batch_size {cfg.data.batch_size} must be divisible by data "
                             f"replicas × microbatches = {n_data} × {microbatches}")
        mesh = {"data": n_data, "stage": n_stage} if n_data > 1 else {"stage": n_stage}
        train_set, test_set = load_splits(cfg)
        sampler = make_sampler(cfg.data.division, len(train_set), 1, 0,
                               shuffle=cfg.data.shuffle, seed=cfg.data.seed)
        train_loader = DataLoader(train_set, cfg.data.batch_size, sampler,
                                  drop_remainder=cfg.data.drop_remainder)
        test_loader = DataLoader(test_set, cfg.data.batch_size, drop_remainder=False)
        optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum)
        # 1f1b: the same stages under the memory-bounded schedule.
        engine = HeteroOneFOneB if schedule == "1f1b" else HeteroPipeline
        pipe = engine(stages, n_microbatches=microbatches, mesh=mesh, optimizer=optimizer,
                      batch_axis="data" if n_data > 1 else None, nhwc_input=staged.nhwc_input)
        ts = pipe.create_state(cfg.seed)
        name = f"task4-{schedule}{n_stage}x{n_data}"
        writer = MetricsWriter(cfg.log_dir, run_name=name) if lead else None
        ts, metrics = train_loop(
            staged, pipe.optimizer, train_loader, cfg.epochs, seed_key(cfg.seed),
            writer=writer, log_every=cfg.log_every if lead else 0,
            step_fn=pipe.make_train_step(), state=ts)
        forward = pipe.make_forward()
        correct = total = 0
        for images, labels in test_loader:
            n = len(labels)
            if n % divisor:
                # Pad the last partial batch to the data × micro-batch
                # multiple; the padded rows' predictions are dropped.
                pad = divisor - n % divisor
                images = np.concatenate([images, np.zeros((pad, *images.shape[1:]),
                                                          images.dtype)])
            pred = forward(images)[:n].argmax(-1).cpu()
            correct += int((pred == torch.as_tensor(labels).long()).sum())
            total += n
        acc = correct / max(total, 1)
        if lead:
            print(f"Test accuracy: {acc * 100:.2f}%")
            writer.add_scalar("Test Accuracy", acc, ts.step)
            writer.close()
            metrics["run_dir"] = str(writer.run_dir)
    metrics["test_accuracy"] = acc
    metrics["world"] = world
    metrics["schedule"] = schedule
    return metrics


def main(argv=None):
    p = add_device_flag(build_parser(reference_defaults()))
    p.add_argument(
        "--schedule", choices=["gspmd", "gpipe", "1f1b"], default="gspmd",
        help="gspmd: sharded one-program split (default); gpipe, 1f1b: the "
        "micro-batched pipelines")
    p.add_argument("--microbatches", type=int, default=4)
    args = p.parse_args(argv)
    return run(config_from_args(args), schedule=args.schedule,
               microbatches=args.microbatches, device=args.device)


if __name__ == "__main__":
    main()
