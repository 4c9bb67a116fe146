"""The elastic failure drills: kill → backoff → re-form → bit-exact resume
(the port of ``tpudml/elastic/drill.py``).

Three pieces:

- :func:`child_main` — the per-rank training program the drills supervise
  (``python -m tpudml_torch.elastic.drill``). A deliberately small but
  *real* multi-process job: a ``ForwardMLP`` under the port's
  ``DataParallel`` on ``{"data": W}`` (gloo on the CPU, NCCL on the card;
  ``--device``, default the card), batches that are a pure function of the
  step index (so any incarnation replays the same trajectory), sharded
  CRC-verified checkpoints every k steps, and resume from the newest
  valid step. The child speaks the planner's language: ``--plan
  plan.json`` picks the engine chain (plain DP, or ZeRO-1 through
  ``DataParallel(zero1=True)``) and accumulation with the same
  explicit-CLI-wins precedence the tasks use, and its checkpoints are
  **chain-agnostic**: always the canonical ``{params, mom, step}``
  full-parameter layout (ZeRO-1's chunks of the momentum are gathered to
  parameter shape at save and re-split at restore), so any chain at any
  world restores any other chain's checkpoint. A seeded
  :func:`~tpudml_torch.resilience.faults.rank_kill_hook` plays the
  adversary. Each rank prints its final parameter CRC, its
  executed-loss-history CRC, and its measured steps/s, and exports its
  own flight-recorder track.

- :func:`run_drill` — the restart drill: run the job once uninterrupted,
  once under :class:`ElasticController` (restart policy) with the
  adversary armed, then require the two final parameter CRCs to be
  **bit-identical** and report the MTTR evidence.

- :func:`run_shrink_drill` — the adaptive-recovery drill: SIGKILL a rank
  under the ``shrink`` policy with a
  :class:`~tpudml_torch.elastic.replan.Replanner` attached. The controller
  consults the planner at the new world, the planner picks a *different*
  engine chain (world 2 ZeRO-1+accum → world 1 plain DP — ZeRO-1 shards
  nothing on one device), and the next incarnation resumes from the
  CRC-valid sharded checkpoint under the new chain. The verdict requires
  the continued run to be bit-exact (params CRC *and* loss-history CRC)
  against an uninterrupted run of the new chain started from the same
  checkpoint, and the re-plan receipts to say *why* the old chain lost.
  Optionally an A/B "naive" arm re-runs the old chain at the shrunken
  world (explicit ``--engine``/``--accum_steps`` flags overriding the
  plan — the precedence demo) so "re-planned beats naive" is a measured
  row.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import re
import shutil
import sys
import time
import zlib
from pathlib import Path

import numpy as np

CHILD = "tpudml_torch.elastic.drill"


# --------------------------------------------------------------- child


def _params_crc(params: dict) -> int:
    """CRC-32 over the concatenated little-endian bytes of every parameter,
    in the model's order — the drill's bit-exactness witness."""
    crc = 0
    for p in params.values():
        crc = zlib.crc32(np.ascontiguousarray(p.detach().cpu().numpy()).tobytes(), crc)
    return crc


def child_main(argv: list[str] | None = None) -> int:
    """One rank of the drill job (rank/world/coordinator via the
    launcher's TPUDML_* env contract)."""
    from tpudml_torch.device import default_device

    ap = argparse.ArgumentParser(prog=f"python -m {CHILD}")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt_dir", type=str, required=True)
    ap.add_argument("--ckpt_every", type=int, default=5)
    ap.add_argument("--global_batch", type=int, default=16)
    ap.add_argument("--feature_dim", type=int, default=16)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill_step", type=int, default=-1)
    ap.add_argument("--kill_rank", type=int, default=1)
    ap.add_argument("--kill_marker", type=str, default=None)
    ap.add_argument("--obs_dir", type=str, default=None)
    ap.add_argument("--device", type=str, default=default_device(),
                    help="cuda (NCCL) or cpu (gloo); default TPUDML_DEVICE, else cuda")
    # Engine-chain knobs: the plan fills whatever the CLI leaves unset —
    # the same explicit-flags-win precedence core/config.py applies for
    # the tasks' --plan wiring.
    ap.add_argument("--plan", type=str, default=None,
                    help="planner plan.json; its engine_config fills "
                         "engine/accum_steps unless given explicitly")
    ap.add_argument("--engine", type=str, default=None,
                    choices=("dp", "zero1"))
    ap.add_argument("--accum_steps", type=int, default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from tpudml_torch.checkpoint.sharded import (
        restore_latest_valid_sharded,
        save_sharded_checkpoint,
    )
    from tpudml_torch.core import DistributedConfig, distributed_init
    from tpudml_torch.device import no_tf32, resolve_device
    from tpudml_torch.models.mlp import ForwardMLP
    from tpudml_torch.obs.tracer import Tracer, set_tracer, sync_device
    from tpudml_torch.optim import Sgd
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.resilience.faults import rank_kill_hook
    from tpudml_torch.train import params_of

    # Plan merge, explicit CLI wins: flags left at their (None) defaults
    # are filled from the plan's engine_config; anything given explicitly
    # overrides the plan.
    engine = args.engine
    accum = args.accum_steps
    if args.plan:
        from tpudml_torch.plan.emit import load_plan

        ec = load_plan(args.plan)["engine_config"]
        if engine is None:
            engine = ec.get("engine")
        if accum is None:
            accum = int(ec.get("accum_steps", 1))
    engine = engine or "dp"
    accum = accum or 1
    if engine not in ("dp", "zero1"):
        raise SystemExit(
            f"drill child implements dp/zero1 chains, got {engine!r}"
        )

    device = resolve_device(args.device)
    no_tf32(device)
    distributed_init(DistributedConfig.from_env(), device=device)
    if not dist.is_initialized():
        raise SystemExit("the drill child runs in a launched job (TPUDML_COORDINATOR unset)")
    rank, world = dist.get_rank(), dist.get_world_size()
    tracer = Tracer()
    set_tracer(tracer)
    if args.global_batch % world:
        raise SystemExit(f"global_batch {args.global_batch} % world {world} != 0")
    if (args.global_batch // world) % accum:
        raise SystemExit(
            f"local batch {args.global_batch // world} % accum {accum} != 0"
        )

    model = ForwardMLP(in_features=args.feature_dim, hidden=(32, 16),
                       num_classes=args.classes, device=device,
                       generator=torch.Generator().manual_seed(args.seed))
    eng = DataParallel(model, Sgd(lr=args.lr, momentum=args.momentum),
                       stacked_batches=False, accum_steps=accum,
                       zero1=engine == "zero1")
    ts = eng.create_state()

    # Batches are a pure function of the step index (same on every rank and
    # every incarnation): a resumed run replays steps c..N-1 bit-exactly.
    teacher = (
        np.random.default_rng(args.seed + 777)
        .standard_normal((args.feature_dim, args.classes))
        .astype(np.float32)
    )

    def batch_for(step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(args.seed * 1_000_003 + step)
        x = rng.standard_normal((args.global_batch, args.feature_dim)).astype(
            np.float32
        )
        y = np.argmax(x @ teacher, axis=1).astype(np.int32)
        return x, y

    # Resume from the newest CRC-valid sharded checkpoint, if any. The
    # checkpoint layout is CANONICAL — full-shaped params + full-shaped
    # momentum ("mom") + step — regardless of the chain that wrote it, so
    # any chain at any world restores any other's checkpoint (the
    # property that makes shrink-with-chain-switch a restore, not a
    # retrain).
    params = params_of(model)

    def canonical_mom():
        """The checkpointed momentum: always full parameter-shaped."""
        if not args.momentum:
            return ()
        if engine == "zero1":
            return eng.optimizer.gather_params(ts.opt_state, params)
        return {n: t.detach() for n, t in ts.opt_state.items()}

    target = {
        "mom": canonical_mom(),
        "params": {n: p.detach().clone() for n, p in params.items()},
        "step": np.zeros((), np.int64),
    }
    restored = restore_latest_valid_sharded(args.ckpt_dir, target)
    start_step = int(restored["step"])
    if start_step:
        print(
            f"[drill] rank {rank} resumed step {start_step} "
            f"wall {time.time():.3f}",
            flush=True,
        )
        tracer.instant("drill_resume", cat="elastic", args={"step": start_step})
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(restored["params"][n])
        if args.momentum:
            # Chain-specific layout: ZeRO-1 keeps this rank's chunk of the
            # flat-padded momentum (zero padding is exact for SGD).
            mom = (eng.optimizer.shard_params(restored["mom"]) if engine == "zero1"
                   else restored["mom"])
            for n, t in ts.opt_state.items():
                t.copy_(mom[n])
    step_fn = eng.make_train_step()

    kill = None
    if args.kill_step >= 0:
        kill = rank_kill_hook(
            args.kill_step, marker=args.kill_marker, rank=args.kill_rank
        )

    loss = None
    losses: list[np.float32] = []
    t_loop = time.perf_counter()
    for step in range(start_step, args.steps):
        if kill is not None:
            kill(step=step)
        x, y = batch_for(step)
        with tracer.span("drill_step", cat="step", args={"step": step}):
            ts, metrics = step_fn(ts, x, y)
            loss = metrics["loss"]
            sync_device(loss)
        losses.append(np.float32(float(loss)))
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            with tracer.span("drill_checkpoint", cat="ckpt", args={"step": step + 1}):
                save_sharded_checkpoint(
                    args.ckpt_dir,
                    {
                        "mom": canonical_mom(),
                        "params": {n: p.detach() for n, p in params.items()},
                        "step": np.int64(step + 1),
                    },
                    step + 1,
                )
    wall = time.perf_counter() - t_loop
    executed = args.steps - start_step
    sps = executed / wall if wall > 0 else 0.0

    crc = _params_crc(params)
    loss_crc = zlib.crc32(np.asarray(losses, np.float32).tobytes())
    print(
        f"[drill] rank {rank} world {world} engine {engine} accum {accum} "
        f"final_step {args.steps} loss {float(loss):.6f} "
        f"params_crc {crc:08x} loss_crc {loss_crc:08x} "
        f"steps_per_s {sps:.3f}",
        flush=True,
    )
    if args.obs_dir:
        # One Chrome-trace pid track per process (pid = the rank).
        tracer.export(Path(args.obs_dir) / f"trace_p{rank}.json")
    dist.destroy_process_group()
    return 0


# --------------------------------------------------------------- driver


def _child_cmd(steps: int, ckpt_every: int, seed: int, device: str | None) -> list[str]:
    from tpudml_torch.device import default_device

    return [sys.executable, "-u", "-m", CHILD, "--steps", str(steps),
            "--ckpt_every", str(ckpt_every), "--seed", str(seed),
            "--device", device or default_device()]


def _cluster(world: int, timeout_s: float, device: str | None):
    """The drill's job: ``world`` ranks, the card hidden for a CPU drill."""
    from tpudml_torch.device import default_device
    from tpudml_torch.launch.cluster import ClusterSpec

    cpu = (device or default_device()) == "cpu"
    return ClusterSpec(num_processes=world, timeout_s=timeout_s, grace_s=3.0,
                       platform="cpu" if cpu else None,
                       env={"OMP_NUM_THREADS": "1"} if cpu else {})

_FINAL_RE = re.compile(
    r"\[drill\] rank (\d+) world (\d+) engine (\w+) accum (\d+) "
    r"final_step (\d+) loss [-0-9.einfa]+ params_crc ([0-9a-f]{8}) "
    r"loss_crc ([0-9a-f]{8}) steps_per_s ([0-9.]+)"
)
_RESUME_RE = re.compile(r"\[drill\] rank (\d+) resumed step (\d+) wall ([0-9.]+)")


class _Tee(io.TextIOBase):
    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def write(self, s):
        for k in self.sinks:
            k.write(s)
        return len(s)

    def flush(self):
        for k in self.sinks:
            k.flush()


def _parse_finals(log: str) -> dict[int, dict]:
    """rank → the final-line evidence record."""
    out = {}
    for m in _FINAL_RE.finditer(log):
        out[int(m.group(1))] = {
            "world": int(m.group(2)),
            "engine": m.group(3),
            "accum_steps": int(m.group(4)),
            "final_step": int(m.group(5)),
            "params_crc": m.group(6),
            "loss_crc": m.group(7),
            "steps_per_s": float(m.group(8)),
        }
    return out


def _parse_crcs(log: str) -> dict[int, str]:
    return {r: f["params_crc"] for r, f in _parse_finals(log).items()}


def _parse_resumes(log: str) -> list[tuple[int, int, float]]:
    return [
        (int(m.group(1)), int(m.group(2)), float(m.group(3)))
        for m in _RESUME_RE.finditer(log)
    ]


def run_drill(
    base_dir: str,
    *,
    world: int = 2,
    steps: int = 20,
    ckpt_every: int = 5,
    kill_step: int = 13,
    kill_rank: int = 1,
    backoff_s: float = 0.25,
    timeout_s: float = 600.0,
    seed: int = 0,
    sink=None,
    device: str | None = None,
) -> dict:
    """Run the full restart drill; returns the MTTR/bit-exactness evidence.

    Sequence: (1) uninterrupted ``world``-process run → reference CRC;
    (2) same job with rank ``kill_rank`` hard-killed at ``kill_step``,
    supervised by :class:`ElasticController` (restart policy, seeded
    backoff, fresh coordinator port) → must resume from the newest valid
    checkpoint and finish with the *same* CRC; (3) merge the per-rank
    traces into one document and check one pid track per process.
    ``ok`` in the result is the drill verdict the CLI / tests gate on.
    ``device`` is the ranks' (default ``TPUDML_DEVICE``, else the card:
    one card holds one NCCL rank, so there ``world`` is 1 and
    ``kill_rank`` 0).
    """
    from tpudml_torch.elastic.controller import ElasticController
    from tpudml_torch.launch.launcher import launch
    from tpudml_torch.obs.tracer import merge_chrome_traces, validate_chrome_trace

    base = Path(base_dir)
    base.mkdir(parents=True, exist_ok=True)
    obs_dir = base / "obs"
    child = _child_cmd(steps, ckpt_every, seed, device) + ["--obs_dir", str(obs_dir)]
    spec = _cluster(world, timeout_s, device)

    # (1) the uninterrupted reference run.
    clean_log = io.StringIO()
    clean = launch(
        child + ["--ckpt_dir", str(base / "clean_ckpt")],
        spec,
        sink=_Tee(clean_log, sink),
    )
    clean_crcs = _parse_crcs(clean_log.getvalue())

    # (2) the drill run: adversary armed, controller supervising.
    marker = base / "kill.marker"
    drill_cmd = child + [
        "--ckpt_dir", str(base / "drill_ckpt"),
        "--kill_step", str(kill_step),
        "--kill_rank", str(kill_rank),
        "--kill_marker", str(marker),
    ]
    drill_log = io.StringIO()
    ctrl = ElasticController(
        drill_cmd,
        dataclasses.replace(
            spec,
            restart_backoff_s=backoff_s,
            restart_backoff_jitter=0.5,
            restart_backoff_seed=seed,
        ),
        policy="restart",
        max_reforms=2,
        sink=_Tee(drill_log, sink),
    )
    eres = ctrl.run()
    drill_crcs = _parse_crcs(drill_log.getvalue())
    resumes = _parse_resumes(drill_log.getvalue())
    obs_dir.mkdir(parents=True, exist_ok=True)
    (obs_dir / "elastic.json").write_text(
        json.dumps(eres.to_dict(), indent=2, sort_keys=True) + "\n"
    )

    # (3) per-process trace evidence: the final (successful) incarnation's
    # ranks each exported their own pid track.
    pids: list[int] = []
    trace_ok = False
    trace_files = sorted(obs_dir.glob("trace_p*.json"))
    if trace_files:
        try:
            merged = merge_chrome_traces(
                [json.loads(p.read_text()) for p in trace_files]
            )
            validate_chrome_trace(merged)
            (obs_dir / "trace.json").write_text(
                json.dumps(merged, sort_keys=True, separators=(",", ":")) + "\n"
            )
            pids = sorted(
                {e["pid"] for e in merged["traceEvents"] if e["ph"] != "M"}
            )
            trace_ok = pids == list(range(world))
        except ValueError:
            trace_ok = False

    # MTTR accounting, anchored on wall clocks: the failed round's end
    # (containment complete) → the last rank's resume print.
    steps_lost = None
    restart_latency_s = None
    resume_step = None
    if resumes and len(eres.records) >= 2:
        resume_step = min(s for _, s, _ in resumes)
        steps_lost = kill_step - resume_step
        restart_latency_s = max(w for _, _, w in resumes) - eres.records[0].t_end
    ports = [r.coordinator_port for r in eres.records]
    bit_exact = (
        len(clean_crcs) == world
        and len(drill_crcs) == world
        and len({*clean_crcs.values(), *drill_crcs.values()}) == 1
    )
    ok = (
        clean.success
        and eres.success
        and eres.reforms == 1
        and bit_exact
        and steps_lost is not None
        and steps_lost >= 0
        and len(set(ports)) == len(ports)
        and trace_ok
    )
    return {
        "ok": ok,
        "bit_exact": bit_exact,
        "world": world,
        "steps": steps,
        "kill_step": kill_step,
        "kill_rank": kill_rank,
        "killed_rank_observed": eres.records[0].failed_rank
        if eres.records
        else None,
        "resume_step": resume_step,
        "steps_lost": steps_lost,
        "reforms": eres.reforms,
        "coordinator_ports": ports,
        "fresh_port": len(set(ports)) == len(ports),
        "backoff_s": eres.records[-1].backoff_s if eres.reforms else 0.0,
        "restart_latency_s": restart_latency_s,
        "clean_wall_s": clean.elapsed_s,
        "drill_wall_s": eres.total_elapsed_s,
        "overhead_vs_clean_frac": (
            (eres.total_elapsed_s - clean.elapsed_s) / clean.elapsed_s
            if clean.elapsed_s
            else None
        ),
        "params_crc": next(iter(clean_crcs.values()), None),
        "trace_pids": pids,
    }


def _copy_step(src_ckpt: Path, step: int, dst_ckpt: Path) -> None:
    """Copy one ``step_{k}`` checkpoint dir — the pristine restore point
    the reference arms start from (the drill's own dir keeps growing past
    it as the continuation writes newer steps)."""
    src = src_ckpt / f"step_{step}"
    dst = dst_ckpt / f"step_{step}"
    dst_ckpt.mkdir(parents=True, exist_ok=True)
    shutil.copytree(src, dst)


def run_shrink_drill(
    base_dir: str,
    *,
    world: int = 2,
    steps: int = 20,
    ckpt_every: int = 5,
    kill_step: int = 13,
    kill_rank: int = 1,
    backoff_s: float = 0.25,
    timeout_s: float = 600.0,
    seed: int = 0,
    include_naive: bool = False,
    sink=None,
    device: str | None = None,
) -> dict:
    """The shrink-re-plan drill: SIGKILL → planner consulted at the new
    world → resume under a *different* engine chain → bit-exact.

    Sequence:

    1. Plan the launch config: :class:`Replanner` over the dp/zero1
       lattice at ``world`` (winner: ZeRO-1 + accumulation) writes
       ``plan.json``; the child picks the chain up via ``--plan``.
    2. Drill run under :class:`ElasticController` (``shrink`` policy,
       replanner attached): rank ``kill_rank`` is hard-killed at
       ``kill_step``; the controller shrinks to ``world-1``, consults
       the planner (at world 1 ZeRO-1 is infeasible — receipts say so —
       and plain DP wins), rewrites ``plan.json``, and re-forms; the
       new incarnation restores the canonical checkpoint under the new
       chain and finishes.
    3. Reference arm: an uninterrupted ``world-1`` run of the *new*
       chain started from a pristine copy of the same checkpoint — the
       continued run must match it bit-exactly (params CRC and
       loss-history CRC).
    4. Optional naive arm (``include_naive``): the *old* chain forced at
       ``world-1`` via explicit ``--engine``/``--accum_steps`` flags
       (which override the plan — the precedence contract), so
       re-planned-vs-naive throughput is measured, not claimed.

    ``device`` as :func:`run_drill`'s (two NCCL ranks need two cards).
    """
    from tpudml_torch.elastic.controller import ElasticController
    from tpudml_torch.elastic.replan import Replanner
    from tpudml_torch.launch.launcher import launch
    from tpudml_torch.obs.tracer import (
        Tracer,
        merge_chrome_traces,
        set_tracer,
        validate_chrome_trace,
    )
    from tpudml_torch.plan.space import flagship_lm

    base = Path(base_dir)
    base.mkdir(parents=True, exist_ok=True)
    obs_dir = base / "obs"
    obs_dir.mkdir(parents=True, exist_ok=True)
    plan_path = base / "plan.json"
    ckpt_dir = base / "drill_ckpt"

    # Controller-side tracer: the reform/replan instants land in their
    # own exported track (the children export theirs per-rank).
    tracer = Tracer()
    prev_tracer = set_tracer(tracer)
    try:
        # (1) plan the launch. dp/zero1 lattice: at world>=2 the planner
        # picks ZeRO-1 (+accum, overlap hidden); at world 1 ZeRO-1 has no
        # mesh, so a shrink forces a genuine chain switch.
        rp = Replanner(
            flagship_lm(),
            engines=["dp", "zero1"],
            verify=False,
            plan_path=plan_path,
        )
        old_plan = rp.initial_plan(world)
        old_key = old_plan["winner"]["candidate"]["key"]
        old_engine = old_plan["engine_config"]["engine"]
        old_accum = old_plan["engine_config"]["accum_steps"]

        child = _child_cmd(steps, ckpt_every, seed, device) + ["--plan", str(plan_path)]
        spec = _cluster(world, timeout_s, device)

        # (2) the drill: shrink policy + replanner.
        marker = base / "kill.marker"
        drill_cmd = child + [
            "--ckpt_dir", str(ckpt_dir),
            "--obs_dir", str(obs_dir),
            "--kill_step", str(kill_step),
            "--kill_rank", str(kill_rank),
            "--kill_marker", str(marker),
        ]
        drill_log = io.StringIO()
        ctrl = ElasticController(
            drill_cmd,
            dataclasses.replace(
                spec,
                restart_backoff_s=backoff_s,
                restart_backoff_jitter=0.5,
                restart_backoff_seed=seed,
            ),
            policy="shrink",
            min_world=1,
            max_reforms=2,
            replanner=rp,
            sink=_Tee(drill_log, sink),
        )
        eres = ctrl.run()
        finals = _parse_finals(drill_log.getvalue())
        resumes = _parse_resumes(drill_log.getvalue())
        new_plan = rp.plan
        new_key = new_plan["winner"]["candidate"]["key"]
        new_engine = new_plan["engine_config"]["engine"]
        new_accum = new_plan["engine_config"]["accum_steps"]
        replan = eres.replans[0] if eres.replans else None
        (obs_dir / "elastic.json").write_text(
            json.dumps(eres.to_dict(), indent=2, sort_keys=True) + "\n"
        )
        tracer.export(obs_dir / "trace_controller.json")

        resume_step = min((s for _, s, _ in resumes), default=None)
        steps_lost = kill_step - resume_step if resume_step is not None else None
        restart_latency_s = (
            max(w for _, _, w in resumes) - eres.records[0].t_end
            if resumes and len(eres.records) >= 2
            else None
        )
        final = finals.get(0)

        # (3) the reference arm: new chain, same checkpoint, uninterrupted.
        bit_exact = False
        ref_final = None
        if resume_step is not None and final is not None:
            _copy_step(ckpt_dir, resume_step, base / "ref_ckpt")
            ref_log = io.StringIO()
            ref = launch(
                child + ["--ckpt_dir", str(base / "ref_ckpt")],
                dataclasses.replace(spec, num_processes=world - 1),
                sink=_Tee(ref_log, sink),
            )
            ref_final = _parse_finals(ref_log.getvalue()).get(0)
            bit_exact = (
                ref.success
                and ref_final is not None
                and ref_final["params_crc"] == final["params_crc"]
                and ref_final["loss_crc"] == final["loss_crc"]
            )

        # (4) the naive A/B arm: old chain forced at the shrunken world by
        # explicit flags (explicit CLI beats the plan file).
        naive = None
        replan_beats_naive = None
        if include_naive and resume_step is not None and final is not None:
            _copy_step(ckpt_dir, resume_step, base / "naive_ckpt")
            naive_log = io.StringIO()
            naive_res = launch(
                child + [
                    "--ckpt_dir", str(base / "naive_ckpt"),
                    "--engine", str(old_engine),
                    "--accum_steps", str(old_accum),
                ],
                dataclasses.replace(spec, num_processes=world - 1),
                sink=_Tee(naive_log, sink),
            )
            naive_final = _parse_finals(naive_log.getvalue()).get(0)
            if naive_res.success and naive_final is not None:
                naive = {
                    "engine": naive_final["engine"],
                    "accum_steps": naive_final["accum_steps"],
                    "steps_per_s": naive_final["steps_per_s"],
                    "params_crc": naive_final["params_crc"],
                }
                replan_beats_naive = (
                    final["steps_per_s"] > naive_final["steps_per_s"]
                )

        # Trace evidence: the surviving incarnation's rank 0 track merges.
        pids: list[int] = []
        trace_files = sorted(obs_dir.glob("trace_p*.json"))
        if trace_files:
            try:
                merged = merge_chrome_traces(
                    [json.loads(p.read_text()) for p in trace_files]
                )
                validate_chrome_trace(merged)
                (obs_dir / "trace.json").write_text(
                    json.dumps(merged, sort_keys=True, separators=(",", ":")) + "\n"
                )
                pids = sorted(
                    {e["pid"] for e in merged["traceEvents"] if e["ph"] != "M"}
                )
            except ValueError:
                pids = []

        ports = [r.coordinator_port for r in eres.records]
        receipts = list(replan["receipts"]) if replan else []
        plan_switched = bool(replan and replan.get("switched") and not replan.get("error"))
        chain_switched = (
            final is not None
            and final["engine"] == new_engine
            and new_engine != old_engine
        )
        ok = (
            eres.success
            and eres.reforms == 1
            and eres.final_world == world - 1
            and plan_switched
            and chain_switched
            and bool(receipts)
            and resume_step is not None
            and steps_lost is not None
            and steps_lost >= 0
            and bit_exact
            and len(set(ports)) == len(ports)
        )
        return {
            "ok": ok,
            "mode": "shrink_replan",
            "bit_exact": bit_exact,
            "world": world,
            "final_world": eres.final_world,
            "steps": steps,
            "kill_step": kill_step,
            "kill_rank": kill_rank,
            "killed_rank_observed": eres.records[0].failed_rank
            if eres.records
            else None,
            "resume_step": resume_step,
            "steps_lost": steps_lost,
            "reforms": eres.reforms,
            "coordinator_ports": ports,
            "fresh_port": len(set(ports)) == len(ports),
            "backoff_s": eres.records[-1].backoff_s if eres.reforms else 0.0,
            "restart_latency_s": restart_latency_s,
            "drill_wall_s": eres.total_elapsed_s,
            "old_plan": {
                "key": old_key, "engine": old_engine, "accum_steps": old_accum,
            },
            "new_plan": {
                "key": new_key, "engine": new_engine, "accum_steps": new_accum,
            },
            "plan_switched": plan_switched,
            "chain_switched": chain_switched,
            "replan_latency_s": replan["latency_s"] if replan else None,
            "replan_receipts": receipts,
            "params_crc": final["params_crc"] if final else None,
            "loss_crc": final["loss_crc"] if final else None,
            "post_shrink_steps_per_s": final["steps_per_s"] if final else None,
            "naive": naive,
            "replan_beats_naive": replan_beats_naive,
            "trace_pids": pids,
        }
    finally:
        set_tracer(prev_tracer)


if __name__ == "__main__":
    sys.exit(child_main())
