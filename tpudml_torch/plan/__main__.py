"""CLI: ``python -m tpudml_torch.plan [--world N] [--out plan.json] [...]``
(the port of ``python -m tpudml.plan``).

Emits the winning candidate as a runnable ``plan.json`` (v2 schema) and
prints the ranked candidate table. ``--format``: ``text`` (human table),
``json`` (the full plan), ``github`` (workflow-annotation lines —
``notice`` for the winner, ``warning`` per demoted candidate, ``error``
when planning fails).

Verification runs one train step of the winner in a job of ``--world``
ranks: every rank plans, and rank 0 alone prints and writes. At
``--world 1`` no job is needed (a one-rank group is formed, on the card
unless ``TPUDML_DEVICE=cpu``); past it, run the CLI under the launcher::

    python -m tpudml_torch.launch -n 4 --platform cpu -- \
        python -m tpudml_torch.plan --world 4

``--no-verify`` plans without building anything. ``--check`` is the CI
smoke: it launches the CLI itself as two jobs of 4 and 8 CPU ranks over
gloo, each planning the flagship spec at its world, and requires a
verified winner at both.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PLAN_OUT_PATH = os.path.join("analysis", "plan.json")
CHECK_WORLDS = (4, 8)
CHECK_TIMEOUT_S = 300.0


def _spec_from_args(args):
    from tpudml_torch.plan.space import ModelSpec, flagship_lm

    if args.spec:
        with open(args.spec) as fh:
            return ModelSpec.from_dict(json.load(fh))
    return flagship_lm()


def _fmt_row(rank: int, entry: dict) -> str:
    c, s = entry["candidate"], entry["score"]
    return (f"{rank:3d}  {s['per_token_s']:.3e}  {s['step_time_s']:.3e}  "
            f"{s['exposed_comm_s']:.2e}  {s['est_hbm_bytes']:>12d}  "
            f"{c['key']}")


def _print_text(plan: dict, top: int, log: list) -> None:
    w = plan["winner"]
    print(f"plan v{plan['version']}  world={plan['world']}  "
          f"spec={plan['spec']['embed_dim']}d/"
          f"{plan['spec']['num_layers']}L/"
          f"{plan['spec']['num_heads']}h/v{plan['spec']['vocab_size']}")
    print(f"winner: {w['candidate']['key']}")
    ver = plan["verification"]
    walls = {r["key"]: r["step_wall_s"] for r in log}
    wall = walls.get(w["candidate"]["key"])
    print(f"verified: entrypoint={ver['entrypoint']} ok={ver['ok']} "
          f"findings={len(ver['findings'])} demoted={len(ver['demoted'])}"
          + (f" step_wall_s={wall:.6f}" if wall is not None else ""))
    print(f"predicted: comm_wire_bytes={plan['predicted']['comm_wire_bytes']:.0f} "
          f"peak_hbm_bytes={plan['predicted']['peak_hbm_bytes']} "
          f"est_hbm_bytes={w['score']['est_hbm_bytes']}")
    print("\nrank  per_token_s  step_time_s  exposed_s   est_hbm_bytes"
          "  candidate")
    for i, entry in enumerate(plan["ranking"][:top], 1):
        print(_fmt_row(i, entry))
    shown = min(top, len(plan["ranking"]))
    print(f"\n{len(plan['ranking'])} ranked ({shown} shown), "
          f"{len(plan['pruned'])} pruned")
    if plan["pruned"]:
        by_rule: dict = {}
        for r in plan["pruned"]:
            by_rule[r["rule"]] = by_rule.get(r["rule"], 0) + 1
        for rule in sorted(by_rule):
            print(f"  {by_rule[rule]:4d}  {rule}")


def _print_github(plan: dict) -> None:
    # '::' inside a message would end the annotation early.
    def msg(s: str) -> str:
        return s.replace("::", ":")

    w = plan["winner"]
    print(f"::notice ::PLAN[world={plan['world']}]: winner "
          + msg(w["candidate"]["key"])
          + f" per_token_s={w['score']['per_token_s']:.3e}")
    for d in plan["verification"]["demoted"]:
        rules = ",".join(sorted({f["rule"] for f in d["findings"]}))
        print(f"::warning ::PLAN[world={plan['world']}]: demoted "
              + msg(d["candidate"]["key"]) + f" ({rules})")


def _check_job(world: int, rank: int) -> int:
    """One rank of a ``--check`` job: plan the flagship spec at this
    world, verified; rank 0 prints the verdict line."""
    from tpudml_torch.plan.emit import make_plan
    from tpudml_torch.plan.space import flagship_lm

    try:
        plan = make_plan(flagship_lm(), world)
    except Exception as exc:  # noqa: BLE001 — CI smoke reports, never raises
        if rank == 0:
            print(f"::error ::PLAN[world={world}]: {exc}", flush=True)
        return 1
    ver = plan["verification"]
    ok = ver["ok"] and not ver["demoted"]
    if rank == 0:
        print(f"plan --check world={world}: {'ok' if ok else 'FAIL'} winner="
              f"{plan['winner']['candidate']['key']} "
              f"findings={len(ver['findings'])} demoted={len(ver['demoted'])}", flush=True)
    return 0 if ok else 1


def _check() -> int:
    """CI smoke: a job of W CPU ranks over gloo for each W of
    CHECK_WORLDS, each of which must emit a verified winner."""
    from tpudml_torch.launch import ClusterSpec, launch

    failures = 0
    for world in CHECK_WORLDS:
        spec = ClusterSpec(num_processes=world, platform="cpu", timeout_s=CHECK_TIMEOUT_S,
                           env={"OMP_NUM_THREADS": "1"})
        res = launch([sys.executable, "-u", "-m", "tpudml_torch.plan", "--check",
                      "--world", str(world)], spec)
        if not res.success:
            print(f"::error ::PLAN[world={world}]: the check job failed "
                  f"(returncodes {res.returncodes})")
            failures += 1
    return 1 if failures else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpudml_torch.plan",
        description="Autosharding planner: enumerate, prune, score, and "
                    "emit a verified runnable plan.json.",
    )
    parser.add_argument("--world", type=int, default=8,
                        help="device count to plan for (default: 8); past 1, "
                             "verification runs in a job of that many ranks")
    parser.add_argument("--spec", default=None, metavar="JSON",
                        help="ModelSpec json file (default: the flagship LM)")
    parser.add_argument("--hbm_budget", type=float, default=None,
                        metavar="MB",
                        help="prune candidates whose static peak-live "
                             "estimate exceeds this many megabytes (and "
                             "hold the verified step's peak to it on the card)")
    parser.add_argument("--engines", default=None, metavar="A,B",
                        help="restrict the engine chains enumerated "
                             "(default: all)")
    parser.add_argument("--out", default=PLAN_OUT_PATH, metavar="PATH",
                        help=f"plan.json output path (default: "
                             f"{PLAN_OUT_PATH}; '-' to skip writing)")
    parser.add_argument("--format", default="text", dest="fmt",
                        choices=("text", "json", "github"),
                        help="stdout format (default: text)")
    parser.add_argument("--top", type=int, default=10,
                        help="ranked-table rows to print (default: 10)")
    parser.add_argument("--no-verify", action="store_true",
                        help="skip the verification step (the plan carries "
                             "the analytic estimates instead)")
    parser.add_argument("--check", action="store_true",
                        help="CI smoke: plan the flagship spec at world 4 and "
                             "8 in CPU jobs of that many ranks, exit non-zero "
                             "unless both verify")
    args = parser.parse_args(argv)

    from tpudml_torch.core import DistributedConfig
    from tpudml_torch.core.dist import distributed_init, process_index
    from tpudml_torch.device import default_device

    job = DistributedConfig.from_env()
    in_job = job.coordinator_address is not None
    if not in_job:
        return _check() if args.check else _plan(args)
    import torch.distributed as dist

    distributed_init(job, device=default_device())
    try:
        return _check_job(args.world, process_index()) if args.check else _plan(args)
    finally:
        dist.destroy_process_group()


def _plan(args) -> int:
    """Plan, and on rank 0 print and write the plan."""
    from tpudml_torch.core.dist import process_index
    from tpudml_torch.plan.emit import make_plan, plan_to_json

    rank = process_index()
    verify = not args.no_verify

    engines = None
    if args.engines:
        engines = [e.strip() for e in args.engines.split(",") if e.strip()]
    hbm_budget_bytes = None
    if args.hbm_budget is not None:
        hbm_budget_bytes = int(args.hbm_budget * 1e6)

    log: list = []
    try:
        plan = make_plan(
            _spec_from_args(args),
            args.world,
            hbm_budget_bytes=hbm_budget_bytes,
            engines=engines,
            verify=verify,
            verify_log=log,
        )
    except (RuntimeError, ValueError) as exc:
        if rank == 0:
            if args.fmt == "github":
                print(f"::error ::PLAN[world={args.world}]: {exc}")
            else:
                print(f"planning failed: {exc}", file=sys.stderr)
        return 1
    if rank != 0:
        return 0

    if args.out != "-":
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(plan_to_json(plan))

    if args.fmt == "json":
        print(plan_to_json(plan), end="")
    elif args.fmt == "github":
        _print_github(plan)
    else:
        _print_text(plan, args.top, log)
        if args.out != "-":
            print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
