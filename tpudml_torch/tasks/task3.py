"""Task 3 — data parallelism with a choice of dataset division, on the
port (the port of ``tasks/task3.py``).

The reference's task3 (codes/task3/model.py, codes/task3/sampler.py)
differs from task2 only in its sampler and lr: ``--division partition``
(a shared-seed shuffle cut into disjoint per-rank shards) or
``sampling`` (per-rank independent shuffles, examples may repeat across
ranks), alias ``--mode``. Reference hyperparameters: batch 32 a replica,
SGD lr 0.001, 2 epochs. It runs task2's engine (:func:`task2.run`).

Run: ``python -m tpudml_torch.tasks.task3 [--division sampling] [--device cpu]``
"""

from __future__ import annotations

import torch

from tpudml_torch.core import TrainConfig, build_parser, config_from_args
from tpudml_torch.tasks import task2
from tpudml_torch.tasks.common import add_device_flag


def reference_defaults() -> TrainConfig:
    cfg = TrainConfig()
    cfg.epochs = 2
    cfg.optimizer = "sgd"
    cfg.lr = 0.001  # reference: codes/task3/model.py:118
    cfg.momentum = 0.0
    cfg.data.batch_size = 32  # per-replica
    cfg.data.division = "partition"
    return cfg


def run(cfg: TrainConfig, device: str | torch.device = "cuda") -> dict:
    return task2.run(cfg, device)


def main(argv=None):
    args = add_device_flag(build_parser(reference_defaults())).parse_args(argv)
    return run(config_from_args(args), device=args.device)


if __name__ == "__main__":
    main()
