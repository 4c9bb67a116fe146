"""Task 1, the second-framework track — the MLP through the Model API, on
the port (the port of ``tasks/task1_mlp.py``).

The reference's MindSpore notebook (codes/task1/mindspore/model.ipynb):
MNIST in batches (cell 2), the ForwardNN 784→512→…→32→10 MLP (cell 4),
``Model(net, loss, opt, {"Accuracy"})`` with ``LossMonitor`` and sink-mode
training (cells 5-7), then ``model.eval``. Reference hyperparameters:
SGD lr 0.01, batch 32, 10 epochs. Same flags as the JAX entry point plus
``--device`` (default ``cuda``).

Run: ``python -m tpudml_torch.tasks.task1_mlp [--epochs 10] [--device cpu]``
"""

from __future__ import annotations

import torch

from tpudml_torch.api import LossMonitor, Model
from tpudml_torch.core import TrainConfig, build_parser, config_from_args
from tpudml_torch.data import DataLoader
from tpudml_torch.device import resolve_device
from tpudml_torch.metrics import MetricsWriter
from tpudml_torch.models import ForwardMLP
from tpudml_torch.optim import make_optimizer
from tpudml_torch.tasks.common import add_device_flag, load_splits


def reference_defaults() -> TrainConfig:
    cfg = TrainConfig()
    cfg.epochs = 10  # notebook: model.train(10, ...)
    cfg.optimizer = "sgd"
    cfg.lr = 0.01
    cfg.data.batch_size = 32
    return cfg


def run(cfg: TrainConfig, device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    train_set, test_set = load_splits(cfg)
    train_loader = DataLoader(train_set, cfg.data.batch_size)
    test_loader = DataLoader(test_set, cfg.data.batch_size, drop_remainder=False)

    model = Model(
        ForwardMLP(device=device, generator=torch.Generator().manual_seed(cfg.seed)),
        optimizer=make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum),
        metrics={"accuracy"},
        seed=cfg.seed,
    )
    callbacks = [LossMonitor(cfg.log_every)] if cfg.log_every else []
    model.train(cfg.epochs, train_loader, callbacks=callbacks)
    print(f"Training time: {model.train_time_s:.3f}s")
    results = model.eval(test_loader)
    print(results)

    writer = MetricsWriter(cfg.log_dir, run_name="task1-mlp")
    writer.add_scalar("Test Accuracy", results["Accuracy"], model.state.step)
    writer.close()
    return {"test_accuracy": results["Accuracy"], "train_time_s": model.train_time_s,
            "steps": model.state.step}


def main(argv=None):
    args = add_device_flag(build_parser(reference_defaults())).parse_args(argv)
    return run(config_from_args(args), device=args.device)


if __name__ == "__main__":
    main()
