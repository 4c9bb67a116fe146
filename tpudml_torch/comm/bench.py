"""Collective aggregation micro-benchmark: ``python -m tpudml_torch.comm.bench``
(the port of ``tpudml/comm/bench.py``).

Times each gradient aggregation strategy (allreduce / allgather /
reducescatter) over payload sizes on the process group and prints one
JSON line per (strategy, size), with the JAX tool's keys, then a
comparison table labelled with the world size. The collective runs alone
between device synchronizations, the split step's comm span without the
training around it.

World = the processes of the group: ``torchrun --nproc_per_node N -m
tpudml_torch.comm.bench`` (``--device cpu`` over gloo), or one process
alone, which builds a one-rank group (NCCL on the card: "world 1").
"""

from __future__ import annotations

import argparse
import json

import torch

from tpudml_torch.comm.collectives import AGGREGATORS, get_aggregator
from tpudml_torch.comm.timing import comm_time_trial
from tpudml_torch.core.dist import process_count, process_group, process_index
from tpudml_torch.device import resolve_device


def bench_strategy(name: str, group, size: int, iters: int,
                   device: torch.device) -> dict:
    payload = {"grad": torch.ones((size,), dtype=torch.float32, device=device)}
    trial = comm_time_trial(group, payload, get_aggregator(name), iters=iters, warmup=1)
    return {
        "strategy": name,
        "elements": size,
        "bytes": size * 4,
        "world": process_count(group),
        "mean_ms": trial["mean_s"] * 1e3,
    }


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="tpudml_torch.comm.bench")
    p.add_argument(
        "--strategies", nargs="+", default=sorted(AGGREGATORS),
        choices=sorted(AGGREGATORS),
    )
    p.add_argument(
        "--sizes", nargs="+", type=int,
        default=[1 << 14, 1 << 18, 1 << 22],
        help="payload element counts (float32)",
    )
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--n_devices", type=int, default=None,
                   help="must equal the number of processes if given")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (NCCL) or 'cpu' (gloo)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    with process_group(device=device) as group:
        world = process_count(group)
        if args.n_devices and args.n_devices != world:
            raise ValueError(f"--n_devices {args.n_devices} != the {world} processes "
                             "of the group (one device each)")
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        lead = process_index(group) == 0
        results = []
        for size in args.sizes:
            for name in args.strategies:
                rec = bench_strategy(name, group, size, args.iters, device)
                results.append(rec)
                if lead:
                    print(json.dumps(rec))
    if lead:
        # Human-readable comparison (the lab's analysis table).
        print(f"\nworld {world} ({device.type})")
        print(f"{'elements':>10} | " + " | ".join(f"{n:>13}" for n in args.strategies))
        for size in args.sizes:
            cells = {r["strategy"]: r["mean_ms"] for r in results if r["elements"] == size}
            print(f"{size:>10} | "
                  + " | ".join(f"{cells[n]:>11.3f}ms" for n in args.strategies))
    return results


if __name__ == "__main__":
    main()
