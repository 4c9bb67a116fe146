"""CLI: ``python -m tpudml_torch.elastic`` — elastic supervision + the
drills (the port of ``python -m tpudml.elastic``).

Drill modes (the acceptance gates — exit 0 iff the verdict holds); the
ranks run on ``--device`` (default ``TPUDML_DEVICE``, else the card: one
card holds one NCCL rank, so there ``-n 1 --kill_rank 0``):

- restart drill (kill→re-form→resume, bit-exact vs uninterrupted)::

    python -m tpudml_torch.elastic --drill --device cpu
    python -m tpudml_torch.elastic --drill -n 1 --kill_rank 0   # the card

- shrink-re-plan drill (kill→shrink→planner consulted at the new world→
  resume under a DIFFERENT engine chain, bit-exact vs a reference run of
  that chain from the same checkpoint)::

    python -m tpudml_torch.elastic --drill --shrink --device cpu

- fixture replay (no processes spawned, no device — replays a
  pre-recorded membership/drift event stream through the Replanner and
  prints the re-plan/receipt/calibration report)::

    python -m tpudml_torch.elastic --drill --fixture tests/elastic_fixtures/shrink_then_drift.json

Supervision mode (the elastic counterpart of ``python -m
tpudml_torch.launch``: re-forms on failure instead of plain relaunch)::

    python -m tpudml_torch.elastic -n 4 --policy shrink --min_world 2 \
        --max_reforms 3 --backoff_s 1.0 -- \
        python -m tpudml_torch.tasks.task2 --ckpt_dir ckpts --resume
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from tpudml_torch.elastic.controller import ElasticController
from tpudml_torch.launch.cluster import ClusterSpec


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, cmd = argv[:split], argv[split + 1 :]
    else:
        cmd = []
    p = argparse.ArgumentParser(prog="python -m tpudml_torch.elastic")
    p.add_argument("--drill", action="store_true",
                   help="run the scripted failure drill; exit 0 iff the "
                        "resumed run is bit-identical to an uninterrupted one")
    p.add_argument("--shrink", action="store_true",
                   help="with --drill: the shrink-re-plan drill (planner "
                        "consulted at the new world, chain switch required)")
    p.add_argument("--fixture", type=str, default=None,
                   help="with --drill: replay a recorded membership/drift "
                        "event fixture through the Replanner — no processes, "
                        "no device (the CI-friendly mode)")
    p.add_argument("--naive", action="store_true",
                   help="with --drill --shrink: also run the A/B arm that "
                        "forces the OLD chain at the shrunken world")
    p.add_argument("--dir", type=str, default=None,
                   help="drill working dir (default: a fresh temp dir)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--ckpt_every", type=int, default=5)
    p.add_argument("--kill_step", type=int, default=13)
    p.add_argument("--kill_rank", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="with --drill: the ranks' device, cuda (NCCL) or cpu "
                        "(gloo); default TPUDML_DEVICE, else cuda")
    p.add_argument("-n", "--num_processes", type=int, default=2)
    p.add_argument("--policy", choices=("restart", "shrink"), default="restart")
    p.add_argument("--min_world", type=int, default=1)
    p.add_argument("--max_reforms", type=int, default=2)
    p.add_argument("--timeout_s", type=float, default=None)
    p.add_argument("--backoff_s", type=float, default=0.0)
    args = p.parse_args(argv)

    if args.drill and args.fixture:
        from tpudml_torch.elastic.replan import replay_fixture

        with open(args.fixture) as f:
            fixture = json.load(f)
        report = replay_fixture(fixture, sink=sys.stderr)
        print(json.dumps(report, sort_keys=True))
        return 0 if report["ok"] else 1

    if args.drill:
        base = args.dir or tempfile.mkdtemp(prefix="tpudml_torch_drill_")
        if args.shrink:
            from tpudml_torch.elastic.drill import run_shrink_drill

            report = run_shrink_drill(
                base,
                world=args.num_processes,
                steps=args.steps,
                ckpt_every=args.ckpt_every,
                kill_step=args.kill_step,
                kill_rank=args.kill_rank,
                seed=args.seed,
                device=args.device,
                backoff_s=args.backoff_s or 0.25,
                include_naive=args.naive,
            )
        else:
            from tpudml_torch.elastic.drill import run_drill

            report = run_drill(
                base,
                world=args.num_processes,
                steps=args.steps,
                ckpt_every=args.ckpt_every,
                kill_step=args.kill_step,
                kill_rank=args.kill_rank,
                seed=args.seed,
                device=args.device,
                backoff_s=args.backoff_s or 0.25,
            )
        print(json.dumps(report, sort_keys=True))
        return 0 if report["ok"] else 1

    if not cmd:
        p.error("no command given; usage: python -m tpudml_torch.elastic [opts] -- cmd ...")
    spec = ClusterSpec(
        num_processes=args.num_processes,
        timeout_s=args.timeout_s,
        restart_backoff_s=args.backoff_s,
        restart_backoff_seed=args.seed,
    )
    ctrl = ElasticController(
        cmd,
        spec,
        policy=args.policy,
        min_world=args.min_world,
        max_reforms=args.max_reforms,
    )
    res = ctrl.run()
    print(
        f"[elastic] {res.stop_reason}: {len(res.records)} round(s), "
        f"final world {res.final_world}, {res.total_elapsed_s:.1f}s",
        file=sys.stderr,
    )
    return 0 if res.success else 1


if __name__ == "__main__":
    sys.exit(main())
