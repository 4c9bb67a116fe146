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
``task4-stage{world}``. ``--schedule gpipe | 1f1b`` and
``--microbatches`` parse and raise ``NotImplementedError`` naming their
ROADMAP item (the pipelines). Same flags as the JAX entry point plus
``--device`` (default ``cuda``; ``cpu`` for the CPU, with gloo).

Run: ``python -m tpudml_torch.tasks.task4 [--device cpu] [--dataset synthetic]``
"""

from __future__ import annotations

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

NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item {})"


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
    if schedule in ("gpipe", "1f1b"):
        raise NotImplementedError(
            f"task4 --schedule {schedule} (--microbatches {microbatches}) "
            f"{NOT_PORTED.format('7 (7d, pipeline parallel)')}")
    device = resolve_device(device)
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


def main(argv=None):
    p = add_device_flag(build_parser(reference_defaults()))
    p.add_argument(
        "--schedule", choices=["gspmd", "gpipe", "1f1b"], default="gspmd",
        help="gspmd: sharded one-program split (default); gpipe, 1f1b: the "
        "pipelines (not ported yet)")
    p.add_argument("--microbatches", type=int, default=4)
    args = p.parse_args(argv)
    return run(config_from_args(args), schedule=args.schedule,
               microbatches=args.microbatches, device=args.device)


if __name__ == "__main__":
    main()
