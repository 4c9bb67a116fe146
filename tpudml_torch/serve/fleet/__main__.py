"""CLI: ``python -m tpudml_torch.serve.fleet`` — fleet drills and fixture
replay (the port of ``tpudml/serve/fleet/__main__.py``).

Modes (exit 0 iff the verdict holds, mirroring ``tpudml_torch.elastic``):

- fixture replay (no processes spawned: the deterministic router re-runs
  the recorded workload + kill script and checks the event-log CRC and
  token accounting)::

    python -m tpudml_torch.serve.fleet \\
        --fixture tests/fleet_fixtures/kill_drain.json --device cpu

- spawned fleet drill (replica children under ElasticController, one
  SIGKILLed mid-serve; tokens must match an uninterrupted reference)::

    python -m tpudml_torch.serve.fleet --drill [--device cpu]

- replica child (spawned by the controller, not by hand)::

    python -m tpudml_torch.serve.fleet --child --dir D --rank R --world W ...

``--device`` is the card (``cuda``) unless ``TPUDML_DEVICE`` or the flag
says ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile


def main(argv: list[str] | None = None) -> int:
    from tpudml_torch.device import default_device

    p = argparse.ArgumentParser(prog="tpudml_torch.serve.fleet")
    p.add_argument("--fixture", type=str, default=None,
                   help="replay a committed fleet fixture through the "
                        "deterministic router (no processes)")
    p.add_argument("--drill", action="store_true",
                   help="spawned fleet drill: replica children under "
                        "ElasticController, one SIGKILLed mid-serve")
    p.add_argument("--child", action="store_true",
                   help=argparse.SUPPRESS)  # controller-spawned only
    p.add_argument("--dir", type=str, default=None)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--kill_rank", type=int, default=1)
    p.add_argument("--requests", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout_s", type=float, default=300.0)
    p.add_argument("--device", type=str, default=default_device(),
                   help="cuda or cpu (default TPUDML_DEVICE, else cuda)")
    args = p.parse_args(argv)

    if args.fixture:
        from tpudml_torch.serve.fleet.router import replay_fleet_fixture

        with open(args.fixture) as f:
            fixture = json.load(f)
        report = replay_fleet_fixture(fixture, sink=sys.stderr, device=args.device)
        print(json.dumps(report, sort_keys=True))
        return 0 if report["ok"] else 1

    if args.child:
        if args.dir is None:
            p.error("--child requires --dir")
        from tpudml_torch.serve.fleet.drill import child_main

        return child_main(args)

    if args.drill:
        from tpudml_torch.serve.fleet.drill import run_fleet_drill

        base = args.dir or tempfile.mkdtemp(prefix="tpudml_fleet_")
        report = run_fleet_drill(
            base, world=args.world, requests=args.requests,
            kill_rank=args.kill_rank, seed=args.seed,
            timeout_s=args.timeout_s, sink=sys.stderr, device=args.device,
        )
        print(json.dumps(report, sort_keys=True))
        return 0 if report["ok"] else 1

    p.error("pick a mode: --fixture FILE.json | --drill | --child")


if __name__ == "__main__":
    sys.exit(main())
