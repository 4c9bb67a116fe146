"""Task 2 — collective-communication data-parallel training, on the port
(the port of ``tasks/task2.py``).

LeNet on MNIST trained data-parallel (codes/task2/model.py,
codes/task2/model-mp.py): gradients aggregated every step by the chosen
collective (``--aggregation allreduce|allgather|reducescatter``), the
wall clock and, with ``--measure_comm``, the communication time
(model-mp.py:48-79), and the straggler of ``--bottleneck_rank``
(model-mp.py:47, 64-65). Reference hyperparameters: batch 32 a replica,
SGD lr 0.01 momentum 0.9, 2 epochs. ``tpudml_torch.parallel.DataParallel``
over the process group, one process a device (``torchrun
--nproc_per_node N``; a process started alone builds a one-rank group),
fed the stacked ``[world, B, ...]`` batches of a ``ShardedDataLoader``
whose per-replica samplers are JAX's (``--division``). Every rank loads
the splits and evaluates the whole test set; rank 0 prints and writes
the metrics. Same flags as the JAX entry point plus ``--device`` (default
``cuda``; ``cpu`` for the CPU, with gloo): ``--sentinel`` skips non-finite
steps on the device (and raises ``SentinelTripped`` past its budget,
naming the poisoned leaf), ``--obs`` records the flight recorder (the
engine's step and comm spans, checkpoint and sentinel events) into
``<run_dir>/trace.json``, ``--profile`` writes a ``torch.profiler``
trace under ``<run_dir>/profile``, ``--ckpt_dir`` / ``--ckpt_every`` /
``--resume`` checkpoint and resume (under ``--zero1`` the ranks' chunks
of the optimizer state gathered into JAX's global leaves, as JAX's store
writes them), ``--zero1`` shards the optimizer state over the replicas
(``DataParallel(zero1=True)``).
``--plan plan.json`` fills the knobs left at their defaults (``--zero1``,
``--accum_steps``, ``--sentinel``, ``--obs``, ``--aggregation``) from a
plan of ``python -m tpudml_torch.plan``; explicit flags win.

Run: ``python -m tpudml_torch.tasks.task2 [--aggregation allgather] [--measure_comm]
[--bottleneck_rank 1] [--zero1] [--sentinel] [--obs] [--device cpu]``
"""

from __future__ import annotations

import torch

from tpudml_torch.core import TrainConfig, build_parser, config_from_args, process_index
from tpudml_torch.core.prng import seed_key
from tpudml_torch.data import DataLoader, ShardedDataLoader, make_sampler
from tpudml_torch.device import no_tf32, resolve_device
from tpudml_torch.metrics import MetricsWriter
from tpudml_torch.metrics.profiler import trace
from tpudml_torch.models import LeNet
from tpudml_torch.obs.tracer import Tracer, use_tracer
from tpudml_torch.optim import make_optimizer
from tpudml_torch.parallel import DataParallel
from tpudml_torch.resilience import sentinel_hook
from tpudml_torch.tasks.common import (
    add_device_flag, final_checkpoint, init_distributed, load_splits, select_devices,
    setup_checkpointing,
)
from tpudml_torch.train import evaluate, train_loop


def reference_defaults() -> TrainConfig:
    cfg = TrainConfig()
    cfg.epochs = 2
    cfg.optimizer = "sgd"
    cfg.lr = 0.01  # reference: model.py:131
    cfg.momentum = 0.9
    cfg.data.batch_size = 32  # per-replica, reference: model.py:126
    return cfg


def run(cfg: TrainConfig, device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    no_tf32(device)
    with init_distributed(cfg, device) as group:
        world = select_devices(cfg, group)
        lead = process_index(group) == 0
        train_set, test_set = load_splits(cfg)
        # DistributedSampler parity (reference model.py:124): one sampler a
        # replica, reshuffled each epoch by set_epoch.
        samplers = [make_sampler(cfg.data.division, len(train_set), world, r,
                                 shuffle=cfg.data.shuffle, seed=cfg.data.seed)
                    for r in range(world)]
        train_loader = ShardedDataLoader(train_set, cfg.data.batch_size, samplers,
                                         drop_remainder=cfg.data.drop_remainder)
        test_loader = DataLoader(test_set, cfg.data.batch_size, drop_remainder=False)

        model = LeNet(in_channels=train_set.images.shape[-1], device=device,
                      generator=torch.Generator().manual_seed(cfg.seed))
        optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum)
        # The flight recorder (--obs): one Tracer takes the engine's step
        # and comm spans and, as the ambient tracer, the checkpoint and
        # sentinel events; exported as <run_dir>/trace.json.
        tracer = Tracer() if cfg.obs else None
        dp = DataParallel(model, optimizer, group, aggregation=cfg.aggregation,
                          zero1=cfg.zero1, sentinel=cfg.sentinel, obs=tracer or False,
                          measure_comm=cfg.measure_comm or cfg.bottleneck_rank is not None,
                          bottleneck_rank=cfg.bottleneck_rank,
                          bottleneck_delay_s=cfg.bottleneck_delay_s,
                          accum_steps=cfg.accum_steps,
                          stacked_batches=True)  # ShardedDataLoader yields [world, B, ...]
        writer = (MetricsWriter(cfg.log_dir, run_name=f"task2-{cfg.aggregation}-w{world}")
                  if lead else None)
        with use_tracer(tracer):
            # Under ZeRO-1 each rank holds a chunk of the optimizer state:
            # the checkpoints gather it into JAX's global leaves.
            ts, hooks, ckpt_mgr = setup_checkpointing(cfg, dp.create_state(),
                                                      engine=dp if cfg.zero1 else None)
            if dp.sentinel is not None:
                # Escalate past the consecutive-skip budget, naming the
                # poisoned leaf and micro-batch.
                hooks.append(sentinel_hook(dp.sentinel, model))
            profile_dir = writer.run_dir / "profile" if lead else cfg.log_dir
            with trace(profile_dir, enabled=cfg.profile and lead):
                ts, metrics = train_loop(
                    model, optimizer, train_loader, cfg.epochs, seed_key(cfg.seed),
                    writer=writer, log_every=cfg.log_every if lead else 0,
                    step_fn=dp.make_train_step(), state=ts, hooks=hooks)
            final_checkpoint(ckpt_mgr, ts)
        if tracer is not None and lead:
            trace_path = tracer.export(writer.run_dir / "trace.json")
            print(f"[obs] trace: {trace_path}")
            metrics["trace_path"] = str(trace_path)
        if dp.comm_stats.calls:
            if lead:
                print(dp.comm_stats.report())  # reference print parity: model-mp.py:79
                writer.add_scalar("Comm Time", dp.comm_stats.comm_time_s, ts.step)
            metrics["comm_time_s"] = dp.comm_stats.comm_time_s
        acc = evaluate(model, ts, test_loader)
        if lead:
            print(f"Test accuracy: {acc * 100:.2f}%")
            writer.add_scalar("Test Accuracy", acc, ts.step)
            writer.close()
            metrics["run_dir"] = str(writer.run_dir)
    metrics["test_accuracy"] = acc
    metrics["world"] = world
    return metrics


def main(argv=None):
    args = add_device_flag(build_parser(reference_defaults())).parse_args(argv)
    return run(config_from_args(args), device=args.device)


if __name__ == "__main__":
    main()
