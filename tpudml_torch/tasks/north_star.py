"""North-star workload: CIFAR-10 ResNet-18 data-parallel training, on the
port (the port of ``tasks/north_star.py``).

BASELINE.json's headline metric: "CIFAR-10 ResNet-18 DDP: imgs/sec/chip +
val-acc parity vs 2xGPU NCCL". bf16 compute over f32 master weights, SGD
with momentum, ``tpudml_torch.parallel.DataParallel`` over the process
group (one process a device: ``torchrun --nproc_per_node N``; a process
started alone builds a one-rank group), fed the stacked ``[world, B,
...]`` batches of a ``ShardedDataLoader`` whose per-replica samplers are
JAX's. Every rank loads the splits and evaluates the whole test set;
rank 0 prints and writes the metrics.

Same flags and defaults as the JAX entry point (``reference_defaults``:
10 epochs, SGD lr 0.1 momentum 0.9, a per-replica batch of 128,
``cifar10`` with its synthetic fallback), ``--f32`` (f32 compute; TF32
is off for convolutions and matmuls whatever the dtype, so f32 means
f32), ``--model resnet18|resnet34|resnet50``, and ``--device`` (default
``cuda``; ``cpu`` for the CPU, with gloo). The initial weights come from
``torch.Generator().manual_seed(seed)``, not JAX's threefry keys.

Run: ``python -m tpudml_torch.tasks.north_star [--epochs 10] [--batch_size 128]
[--f32] [--device cpu]``
"""

from __future__ import annotations

import time

import torch

from tpudml_torch.core import TrainConfig, build_parser, config_from_args, process_index
from tpudml_torch.data import DataLoader, ShardedDataLoader, make_sampler
from tpudml_torch.device import resolve_device
from tpudml_torch.metrics import MetricsWriter
from tpudml_torch.models import ResNet18, ResNet34, ResNet50
from tpudml_torch.optim import make_optimizer
from tpudml_torch.parallel import DataParallel
from tpudml_torch.tasks.common import (
    add_device_flag, init_distributed, load_splits, select_devices,
)
from tpudml_torch.train import evaluate, train_loop

MODELS = {"resnet18": ResNet18, "resnet34": ResNet34, "resnet50": ResNet50}


def reference_defaults() -> TrainConfig:
    cfg = TrainConfig()
    cfg.epochs = 10
    cfg.optimizer = "sgd"
    cfg.lr = 0.1
    cfg.momentum = 0.9
    cfg.data.dataset = "cifar10"
    cfg.data.batch_size = 128  # per-replica
    return cfg


def run(cfg: TrainConfig, compute_dtype: torch.dtype = torch.bfloat16,
        model_name: str = "resnet18", device: str | torch.device = "cuda") -> dict:
    if model_name not in MODELS:
        raise ValueError(f"unknown model {model_name!r}; options: {sorted(MODELS)}")
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with init_distributed(cfg, device) as group:
        world = select_devices(cfg, group)
        lead = process_index(group) == 0
        train_set, test_set = load_splits(cfg)
        samplers = [
            make_sampler(cfg.data.division, len(train_set), world, r,
                         shuffle=cfg.data.shuffle, seed=cfg.data.seed)
            for r in range(world)
        ]
        train_loader = ShardedDataLoader(train_set, cfg.data.batch_size, samplers,
                                         drop_remainder=cfg.data.drop_remainder)
        test_loader = DataLoader(test_set, cfg.data.batch_size, drop_remainder=False)

        model = MODELS[model_name](compute_dtype=compute_dtype,
                                   in_channels=train_set.images.shape[-1], device=device,
                                   generator=torch.Generator().manual_seed(cfg.seed))
        optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum)
        dp = DataParallel(model, optimizer, group, accum_steps=cfg.accum_steps,
                          stacked_batches=True)  # ShardedDataLoader yields [world, B, ...]
        ts = dp.create_state()
        step = dp.make_train_step()

        writer = MetricsWriter(cfg.log_dir, run_name=f"north-star-w{world}") if lead else None
        t0 = time.time()
        ts, metrics = train_loop(model, optimizer, train_loader, cfg.epochs, writer=writer,
                                 log_every=cfg.log_every if lead else 0, step_fn=step,
                                 state=ts)
        train_time = time.time() - t0
        global_batch = cfg.data.batch_size * world
        imgs_per_sec = global_batch * metrics["steps"] / train_time
        metrics["imgs_per_sec_per_chip"] = imgs_per_sec / world

        acc = evaluate(model, ts, test_loader)
        if lead:
            print(f"Test accuracy: {acc * 100:.2f}% | "
                  f"{metrics['imgs_per_sec_per_chip']:.1f} imgs/sec/chip")
            writer.add_scalar("Test Accuracy", acc, ts.step)
            writer.add_scalar("Imgs/sec/chip", metrics["imgs_per_sec_per_chip"], ts.step)
            writer.close()
    metrics["test_accuracy"] = acc
    metrics["world"] = world
    return metrics


def main(argv=None):
    parser = build_parser(reference_defaults())
    parser.add_argument("--f32", action="store_true",
                        help="disable bf16 compute (numerics A/B)")
    parser.add_argument("--model", choices=sorted(MODELS), default="resnet18",
                        help="resnet50 = the BASELINE.json MindSpore auto-parallel parity "
                        "config (bottleneck blocks)")
    args = add_device_flag(parser).parse_args(argv)
    cfg = config_from_args(args)
    return run(cfg, compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
               model_name=args.model, device=args.device)


if __name__ == "__main__":
    main()
