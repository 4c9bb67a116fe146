"""Task 1 — the single-device optimizer lab, on the port (the port of
``tasks/task1.py``).

LeNet on MNIST (codes/task1/pytorch/model.py:83-111) with the
hand-written optimizers, the loss logged every 20 iterations, then the
test set's top-1 accuracy. Reference hyperparameters
(``reference_defaults``): batch 200, one epoch, the reference Adam
without bias correction at lr = 5e-4·√200. MNIST comes from its IDX files
under ``--data_dir``, else from the synthetic set of the same shapes.
Same flags as the JAX entry point plus ``--device`` (default ``cuda``;
``cpu`` runs on the CPU): ``--profile`` writes a ``torch.profiler``
Chrome trace under ``<run_dir>/profile``, ``--ckpt_dir`` checkpoints
(``--ckpt_every N`` steps and at the end) and ``--resume`` restores the
latest valid checkpoint first. The initial weights come from
``torch.Generator().manual_seed(seed)``, not JAX's threefry keys; the
dropout keys (LeNet draws none) from ``seed_key(seed)``, as JAX's.

Run: ``python -m tpudml_torch.tasks.task1 [--optimizer adam_ref] [--epochs 1]
[--device cpu]``
"""

from __future__ import annotations

import math

import torch

from tpudml_torch.core import TrainConfig, build_parser, config_from_args
from tpudml_torch.core.prng import seed_key
from tpudml_torch.data import DataLoader, make_sampler
from tpudml_torch.device import no_tf32, resolve_device
from tpudml_torch.metrics import MetricsWriter
from tpudml_torch.metrics.profiler import trace
from tpudml_torch.models import LeNet
from tpudml_torch.optim import make_optimizer
from tpudml_torch.tasks.common import (
    add_device_flag, final_checkpoint, load_splits, setup_checkpointing,
)
from tpudml_torch.train import TrainState, evaluate, train_loop


def reference_defaults() -> TrainConfig:
    cfg = TrainConfig()
    cfg.epochs = 1
    cfg.optimizer = "adam_ref"
    cfg.lr = 5e-4 * math.sqrt(200)  # reference lr rule (task1 model.py:96-98)
    cfg.data.batch_size = 200
    return cfg


def run(cfg: TrainConfig, device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    no_tf32(device)
    train_set, test_set = load_splits(cfg)
    sampler = make_sampler(cfg.data.division if cfg.data.shuffle else "sequential",
                           len(train_set), 1, 0, shuffle=cfg.data.shuffle, seed=cfg.data.seed)
    train_loader = DataLoader(train_set, cfg.data.batch_size, sampler,
                              drop_remainder=cfg.data.drop_remainder)
    test_loader = DataLoader(test_set, cfg.data.batch_size, drop_remainder=False)

    model = LeNet(in_channels=train_set.images.shape[-1], device=device,
                  generator=torch.Generator().manual_seed(cfg.seed))
    optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum)
    writer = MetricsWriter(cfg.log_dir, run_name=f"task1-epoch{cfg.epochs}")
    ts, hooks, ckpt_mgr = setup_checkpointing(cfg, TrainState.create(model, optimizer))
    with trace(writer.run_dir / "profile", enabled=cfg.profile):
        ts, metrics = train_loop(model, optimizer, train_loader, cfg.epochs,
                                 seed_key(cfg.seed), writer=writer, log_every=cfg.log_every,
                                 state=ts, hooks=hooks, accum_steps=cfg.accum_steps)
    final_checkpoint(ckpt_mgr, ts)
    acc = evaluate(model, ts, test_loader)
    print(f"Test accuracy: {acc * 100:.2f}%")
    writer.add_scalar("Test Accuracy", acc, ts.step)
    writer.close()
    metrics["test_accuracy"] = acc
    return metrics


def main(argv=None):
    args = add_device_flag(build_parser(reference_defaults())).parse_args(argv)
    return run(config_from_args(args), device=args.device)


if __name__ == "__main__":
    main()
