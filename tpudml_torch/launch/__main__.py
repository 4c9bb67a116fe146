"""CLI: ``python -m tpudml_torch.launch [options] -- <command ...>`` (the
port of ``python -m tpudml.launch``).

The one-line replacement for the reference's three launch mechanisms
(N manual terminals / mp.spawn / docker compose up — SURVEY.md §4):

    # 2 ranks on the CPU over gloo, task2, bottleneck on rank 1:
    python -m tpudml_torch.launch --num_processes 2 --platform cpu \
        --bottleneck_rank 1 -- \
        python -m tpudml_torch.tasks.task2 --dataset synthetic --epochs 1

    # reference-style explicit per-rank flags via templating:
    python -m tpudml_torch.launch -n 2 --platform cpu -- \
        python -m tpudml_torch.tasks.task2 --n_devices {world} --rank {rank}

``--config cluster.json`` loads a ClusterSpec (the compose-file analogue);
CLI flags override it.
"""

from __future__ import annotations

import argparse
import sys

from tpudml_torch.launch.cluster import ClusterSpec
from tpudml_torch.launch.launcher import launch

# ``--check`` child: the smallest real cross-process collective. Each rank
# joins the group over gloo, all-reduces its rank, and checks the sum; a
# wrong wiring fails the child, which fails the check.
_CHECK_CHILD = """
import sys
sys.modules["jax"] = None  # the port needs none of it
import torch, torch.distributed as dist
from tpudml_torch.core import DistributedConfig, distributed_init
distributed_init(DistributedConfig.from_env(), device="cpu")
world, rank = dist.get_world_size(), dist.get_rank()
assert dist.get_backend() == "gloo", dist.get_backend()
x = torch.tensor([float(rank)])
dist.all_reduce(x)
expect = world * (world - 1) / 2
assert float(x) == expect, (float(x), expect)
print(f"[check] rank {rank}/{world} all_reduce {float(x)} OK", flush=True)
dist.destroy_process_group()
"""


def run_check(spec: ClusterSpec) -> int:
    """``python -m tpudml_torch.launch --check``: prove the multi-process
    wiring (rendezvous, gloo collectives, containment) with a
    ``num_processes``-rank all_reduce on the CPU (the card hidden); exit 0
    iff every rank computed the correct global sum."""
    if spec.timeout_s is None:
        spec.timeout_s = 120.0
    spec.platform = "cpu"
    result = launch([sys.executable, "-u", "-c", _CHECK_CHILD], spec)
    if result.success:
        print(
            f"launch --check: OK ({spec.num_processes}-process gloo "
            f"all_reduce in {result.elapsed_s:.1f}s)"
        )
        return 0
    print(
        f"launch --check: FAILED (rcs={result.returncodes}, "
        f"timed_out={result.timed_out})",
        file=sys.stderr,
    )
    return 1


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, cmd = argv[:split], argv[split + 1 :]
    else:
        argv, cmd = argv, []
    p = argparse.ArgumentParser(prog="tpudml_torch.launch")
    p.add_argument("--config", type=str, default=None, help="ClusterSpec JSON")
    p.add_argument("-n", "--num_processes", type=int, default=None)
    p.add_argument("--coordinator_host", type=str, default=None)
    p.add_argument("--coordinator_port", type=int, default=None)
    p.add_argument(
        "--platform",
        type=str,
        default=None,
        help='"cpu" = the ranks on the CPU over gloo, the card hidden; '
             '"none" (the default) = the card',
    )
    p.add_argument("--devices_per_process", type=int, default=None)
    p.add_argument("--timeout_s", type=float, default=None)
    p.add_argument("--bottleneck_rank", type=int, default=None)
    p.add_argument("--bottleneck_delay_s", type=float, default=None)
    p.add_argument("--max_restarts", type=int, default=None,
                   help="relaunch a failed job up to N times (pair the "
                        "command with --ckpt_dir/--resume to continue)")
    p.add_argument("--check", action="store_true",
                   help="no command: run a 2-process gloo all_reduce smoke test "
                        "of the multi-process wiring and exit 0/1")
    args = p.parse_args(argv)
    if not cmd and not args.check:
        p.error("no command given; usage: python -m tpudml_torch.launch [opts] -- cmd ...")

    spec = ClusterSpec.from_json(args.config) if args.config else ClusterSpec()
    for name in (
        "num_processes",
        "coordinator_host",
        "coordinator_port",
        "platform",
        "devices_per_process",
        "timeout_s",
        "bottleneck_rank",
        "bottleneck_delay_s",
        "max_restarts",
    ):
        val = getattr(args, name)
        if val is not None:
            setattr(spec, name, val)
    if spec.platform == "none":
        spec.platform = None

    if args.check:
        return run_check(spec)
    result = launch(cmd, spec)
    if result.timed_out:
        print(f"launch: TIMEOUT after {result.elapsed_s:.1f}s", file=sys.stderr)
    elif result.failed_rank is not None:
        print(
            f"launch: rank {result.failed_rank} failed "
            f"(rc={result.returncodes[result.failed_rank]}); job terminated",
            file=sys.stderr,
        )
    return 0 if result.success else 1


if __name__ == "__main__":
    sys.exit(main())
