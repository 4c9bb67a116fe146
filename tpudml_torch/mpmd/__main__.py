"""CLI: ``python -m tpudml_torch.mpmd`` — the MPMD drills (the port of
``python -m tpudml.mpmd``, the same flags and last-line JSON, plus
``--device``).

- re-mesh drill (SIGKILL one stage rank → drain → fail-open re-plan →
  re-form in place → bit-exact resume against an uninterrupted reference
  of the re-meshed pipeline; exit 0 iff the verdict holds). The stage
  processes run on ``--device`` (default ``TPUDML_DEVICE``, else the
  card, which all four share)::

    python -m tpudml_torch.mpmd --drill --device cpu

- with ``--naive``: also run the whole-world-restart A/B arm (peers abort
  on peer death instead of draining, so every group's containment fires)
  and compare MTTRs;

- fixture replay (no processes, no sockets, no device — replays a
  recorded membership/transfer event stream and checks the
  byte-deterministic event log's CRC against the fixture's golden)::

    python -m tpudml_torch.mpmd --fixture tests/mpmd_fixtures/steady.json

  The planner scores under the card's constants, where the goldens were
  made under the JAX package's: ``steady.json`` matches its golden, and
  ``shrink_stage.json``'s re-plan names another winner, so its replay
  misses its golden and exits 1 (a defined difference).

The last stdout line is always the JSON report; the event stream and the
children's output go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile


def main(argv: list[str] | None = None) -> int:
    from tpudml_torch.device import default_device

    p = argparse.ArgumentParser(prog="python -m tpudml_torch.mpmd")
    p.add_argument("--drill", action="store_true",
                   help="run the 2-stage×2-dp re-mesh drill; exit 0 iff the resumed "
                        "pipeline is CRC-identical to an uninterrupted reference")
    p.add_argument("--fixture", type=str, default=None,
                   help="replay a recorded membership/transfer event fixture — no "
                        "processes, no mesh")
    p.add_argument("--naive", action="store_true",
                   help="with --drill: also run the whole-world-restart A/B arm and "
                        "compare MTTRs")
    p.add_argument("--dir", type=str, default=None,
                   help="drill working dir (default: a fresh temp dir)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--ckpt_every", type=int, default=5)
    p.add_argument("--kill_step", type=int, default=13)
    p.add_argument("--kill_stage", type=int, default=1)
    p.add_argument("--kill_rank", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backoff_s", type=float, default=0.25)
    p.add_argument("--timeout_s", type=float, default=600.0)
    p.add_argument("--device", type=str, default=default_device(),
                   help="with --drill: the stage programs' device, cuda or cpu")
    args = p.parse_args(argv)

    if args.fixture:
        from tpudml_torch.mpmd.fixture import replay_fixture

        report = replay_fixture(
            args.fixture, emit=lambda line: print(f"[replay] {line}", file=sys.stderr))
        report.pop("lines", None)
        print(json.dumps(report, sort_keys=True))
        return 0 if report["ok"] else 1

    if args.drill:
        from tpudml_torch.mpmd.drill import run_mpmd_drill

        base = args.dir or tempfile.mkdtemp(prefix="tpudml_torch_mpmd_")
        report = run_mpmd_drill(
            base, steps=args.steps, ckpt_every=args.ckpt_every, kill_step=args.kill_step,
            kill_stage=args.kill_stage, kill_rank=args.kill_rank, seed=args.seed,
            backoff_s=args.backoff_s, timeout_s=args.timeout_s, include_naive=args.naive,
            sink=sys.stderr, device=args.device)
        print(json.dumps(report, sort_keys=True))
        return 0 if report["ok"] else 1

    p.error("one of --drill / --fixture is required")
    return 2


if __name__ == "__main__":
    sys.exit(main())
