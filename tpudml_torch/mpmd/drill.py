"""The MPMD re-mesh drill: SIGKILL one stage rank → drain → re-mesh →
bit-exact resume (the port of ``tpudml/mpmd/drill.py``).

- :func:`child_main` — one rank of one *stage group*
  (``python -m tpudml_torch.mpmd.drill``): reads the round's wiring file,
  forms its stage's process group (gloo, its own coordinator: no group
  spans two stages), dials and accepts the boundary p2p channels and the
  intra-stage drain-barrier star, and runs the heterogeneous 1F1B
  schedule (:class:`~tpudml_torch.mpmd.runtime.StageWorker`) on
  ``--device`` (the card, unless the launcher's ``platform="cpu"`` says
  the CPU). Batches are a pure function of the step index, per-stage
  sharded CRC-verified checkpoints land every k steps in JAX's canonical
  ``{mom, params, step}`` layout, and a peer death drains the rank at the
  step boundary: marker file + rc 0 (so the controller's victim
  attribution stays unambiguous). ``--drain_mode abort`` is the *naive*
  arm: peer death exits rc 75 at once, which trips every group's
  containment — the whole-world-restart baseline.

- :func:`run_mpmd_drill` — the e2e evidence: a 2-stage×2-dp pipeline (a
  bf16 trunk with 2 microbatches feeding an f32 head with 1), one head
  rank SIGKILLed mid-training, the surviving groups drain, the planner is
  consulted fail-open, the pipeline re-forms in place (the trunk keeps
  its world; only the victim's stage shrinks), and the continued run must
  be CRC-identical per surviving (stage, rank) to an uninterrupted
  reference run of the re-meshed configuration started from a pristine
  copy of the same checkpoint. The re-mesh MTTR is anchored on the kill
  marker's mtime (the failure instant) → the last rank's resume print.
  The stage processes may share one card: their groups sum over gloo
  (``runtime.GroupReducer``) and their boundaries are TCP.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import shutil
import signal
import socket as socketlib
import sys
import time
import zlib
from pathlib import Path

import numpy as np

CHILD = "tpudml_torch.mpmd.drill"


# --------------------------------------------------------------- child


def _params_crc(params: list) -> int:
    """CRC-32 over the concatenated little-endian bytes of every parameter
    in JAX's flatten order (each layer's ``b``, then ``w``): the drill's
    bit-exactness witness."""
    crc = 0
    for layer in params:
        for k in ("b", "w"):
            crc = zlib.crc32(np.ascontiguousarray(layer[k].detach().cpu().numpy()).tobytes(),
                             crc)
    return crc


def child_main(argv=None) -> int:
    from tpudml_torch.device import default_device

    ap = argparse.ArgumentParser(prog=f"python -m {CHILD}")
    ap.add_argument("--stage", type=int, required=True)
    ap.add_argument("--wiring", type=str, required=True)
    ap.add_argument("--round_dir", type=str, required=True)
    ap.add_argument("--resume_step", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt_dir", type=str, required=True)
    ap.add_argument("--ckpt_every", type=int, default=5)
    ap.add_argument("--feature_dim", type=int, default=8)
    ap.add_argument("--hidden", type=str, default="16")
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill_step", type=int, default=-1)
    ap.add_argument("--kill_stage", type=int, default=-1)
    ap.add_argument("--kill_rank", type=int, default=1)
    ap.add_argument("--kill_marker", type=str, default=None)
    ap.add_argument("--drain_mode", type=str, default="drain", choices=("drain", "abort"))
    ap.add_argument("--obs_dir", type=str, default=None)
    ap.add_argument("--device", type=str, default=default_device(),
                    help="the stage program's device: cuda or cpu (default TPUDML_DEVICE, "
                         "else cuda); the stage group sums over gloo either way")
    args = ap.parse_args(argv)

    from tpudml_torch.checkpoint.sharded import (
        restore_sharded_checkpoint,
        save_sharded_checkpoint,
    )
    from tpudml_torch.comm.p2p import DrainBarrier, accept_channels, connect_channel
    from tpudml_torch.core import DistributedConfig, distributed_init
    from tpudml_torch.device import no_tf32, resolve_device
    from tpudml_torch.mpmd.groups import drain_marker_path, stage_ckpt_dir
    from tpudml_torch.mpmd.runtime import (
        DrainSignal,
        GroupReducer,
        StageProgram,
        StageWorker,
        make_batch_fn,
        stage_layer_dims,
    )
    from tpudml_torch.mpmd.spec import PipelineSpec, boundary_plan
    from tpudml_torch.obs.tracer import Tracer, set_tracer
    from tpudml_torch.resilience.faults import rank_kill_hook

    wiring = json.loads(Path(args.wiring).read_text())
    if wiring.get("version") != 1:
        raise SystemExit(f"unsupported wiring version {wiring.get('version')}")
    spec = PipelineSpec.from_dict(wiring["pipeline"])
    stage = args.stage
    st = spec.stages[stage]
    rank = int(os.environ.get("TPUDML_PROCESS_ID", "0"))
    round_no = int(os.environ.get("TPUDML_MPMD_ROUND", wiring["round"]))
    hidden = tuple(int(h) for h in args.hidden.split(",") if h)
    n_stages = len(spec.stages)
    device = resolve_device(args.device)
    no_tf32(device)

    if st.dp > 1:
        # The stage's group sums host tensors: gloo, whatever the program's
        # device (runtime.GroupReducer).
        distributed_init(DistributedConfig.from_env(), device="cpu")

    # The drain marker must be written even when this rank is torn down by
    # its group's containment (the victim's peers get SIGTERM before they
    # observe the death themselves): a drained rank ALWAYS exits 0 with a
    # marker, so the controller can tell victims from survivors. Installed
    # after the group is up, so no handler of the runtime's replaces it.
    state = {"step": args.resume_step}

    def _drain_and_exit(signum, frame):
        try:
            drain_marker_path(args.round_dir, stage, rank).write_text(
                json.dumps({"step": state["step"], "why": "sigterm",
                            "round": round_no}) + "\n")
        except OSError:
            pass
        os._exit(0)

    signal.signal(signal.SIGTERM, _drain_and_exit)

    tracer = Tracer()
    set_tracer(tracer)

    program = StageProgram(spec, stage, feature_dim=args.feature_dim, hidden=hidden,
                           classes=args.classes, seed=args.seed, lr=args.lr,
                           momentum=args.momentum, device=device)
    batch_for = make_batch_fn(spec.global_batch, args.feature_dim, args.classes, args.seed)

    # Resume from the controller-designated common step: the exact-step
    # CRC-verified restore (not newest-valid: the stages must agree).
    if args.resume_step > 0:
        target = {"mom": program.momentum, "params": program.params,
                  "step": np.zeros((), np.int64)}
        restored = restore_sharded_checkpoint(
            stage_ckpt_dir(args.ckpt_dir, stage) / f"step_{args.resume_step}", target,
            verify=True)
        program.params = restored["params"]
        program.momentum = restored["mom"]
        print(f"[mpmd] stage {stage} rank {rank} resumed step {args.resume_step} "
              f"wall {time.time():.3f}", flush=True)
        tracer.instant("mpmd_resume", cat="mpmd",
                       args={"stage": stage, "rank": rank, "step": args.resume_step})

    # ------------------------------------------------ wire the topology
    host = wiring["host"]
    deadline_s = 60.0
    up_listener = None
    if stage > 0:
        b = wiring["boundaries"][stage - 1]
        port = b["listeners"][str(rank)]["port"]
        up_listener = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_STREAM)
        up_listener.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1)
        up_listener.bind((host, port))
        n_up = len({t.src_rank for t in boundary_plan(spec, stage - 1) if t.dst_rank == rank})
        up_listener.listen(n_up)
    ctl_listener = None
    if st.dp > 1 and rank == 0:
        port = wiring["ctl"][str(stage)]["port"]
        ctl_listener = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_STREAM)
        ctl_listener.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1)
        ctl_listener.bind((host, port))
        ctl_listener.listen(st.dp - 1)

    down_channels = {}
    if stage < n_stages - 1:
        b = wiring["boundaries"][stage]
        for q in sorted({t.dst_rank for t in boundary_plan(spec, stage)
                         if t.src_rank == rank}):
            edge = f"s{stage}r{rank}->s{stage + 1}r{q}"
            down_channels[edge] = connect_channel(
                b["listeners"][str(q)]["host"], b["listeners"][str(q)]["port"],
                edge=edge, hello={"stage": stage, "rank": rank, "edge": edge},
                deadline_s=deadline_s, tracer=tracer)
    barrier = None
    if st.dp > 1 and rank != 0:
        edge = f"ctl:s{stage}r{rank}"
        ch = connect_channel(
            wiring["ctl"][str(stage)]["host"], wiring["ctl"][str(stage)]["port"],
            edge=edge, hello={"stage": stage, "rank": rank, "edge": edge},
            deadline_s=deadline_s, tracer=tracer)
        barrier = DrainBarrier(hub=False, channels={rank: ch})

    up_channels = {}
    try:
        if up_listener is not None:
            accepted = accept_channels(up_listener, n_up, deadline_s=deadline_s, tracer=tracer)
            up_channels = {edge: ch for edge, (ch, _hello) in accepted.items()}
        if ctl_listener is not None:
            accepted = accept_channels(ctl_listener, st.dp - 1, deadline_s=deadline_s,
                                       tracer=tracer)
            barrier = DrainBarrier(hub=True, channels={
                int(hello["rank"]): ch for _edge, (ch, hello) in accepted.items()})
    finally:
        for lst in (up_listener, ctl_listener):
            if lst is not None:
                lst.close()

    up_features = (stage_layer_dims(args.feature_dim, hidden, args.classes,
                                    n_stages)[stage - 1][-1][1] if stage > 0 else None)
    worker = StageWorker(spec, stage, rank, program=program, batch_for=batch_for,
                         up_features=up_features, up_channels=up_channels,
                         down_channels=down_channels, barrier=barrier,
                         reducer=GroupReducer(st.dp))

    kill = None
    if args.kill_step >= 0 and args.kill_stage == stage:
        kill = rank_kill_hook(args.kill_step, marker=args.kill_marker, rank=args.kill_rank)

    loss = float("nan")
    t_loop = time.perf_counter()
    final_step = args.steps
    for step in range(args.resume_step, args.steps):
        state["step"] = step
        if kill is not None:
            kill(step=step)
        try:
            with tracer.span("mpmd_step", cat="step", args={"step": step, "stage": stage}):
                loss = worker.run_step(step)
        except DrainSignal as e:
            final_step = e.step
            if args.drain_mode == "abort":
                # Naive arm: no cooperative drain — die loudly so every
                # group's containment tears the whole world down.
                print(f"[mpmd] stage {stage} rank {rank} aborted step {e.step} ({e.why})",
                      flush=True)
                return 75
            drain_marker_path(args.round_dir, stage, rank).write_text(
                json.dumps({"step": e.step, "why": e.why, "round": round_no}) + "\n")
            print(f"[mpmd] stage {stage} rank {rank} drained step {e.step} ({e.why})",
                  flush=True)
            tracer.instant("mpmd_drain", cat="mpmd",
                           args={"stage": stage, "rank": rank, "step": e.step, "why": e.why})
            break
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            with tracer.span("mpmd_checkpoint", cat="ckpt",
                             args={"step": step + 1, "stage": stage}):
                save_sharded_checkpoint(
                    stage_ckpt_dir(args.ckpt_dir, stage),
                    {"mom": program.momentum, "params": program.params,
                     "step": np.int64(step + 1)},
                    step + 1)
    wall = time.perf_counter() - t_loop
    executed = max(0, final_step - args.resume_step)
    sps = executed / wall if wall > 0 else 0.0

    crc = _params_crc(program.params)
    loss_crc = zlib.crc32(np.asarray(worker.losses, np.float32).tobytes())
    print(f"[mpmd] stage {stage} rank {rank} world {st.dp} dtype {st.dtype} "
          f"mb {st.microbatches} final_step {final_step} loss {float(loss):.6f} "
          f"params_crc {crc:08x} loss_crc {loss_crc:08x} steps_per_s {sps:.3f}",
          flush=True)
    for ch in (*up_channels.values(), *down_channels.values()):
        ch.close()
    if args.obs_dir:
        tracer.export(Path(args.obs_dir) / f"trace_s{stage}_p{rank}.json")
    return 0


# --------------------------------------------------------------- driver

_FINAL_RE = re.compile(
    r"\[mpmd\] stage (\d+) rank (\d+) world (\d+) dtype (\S+) mb (\d+) "
    r"final_step (\d+) loss [-0-9.einfa]+ params_crc ([0-9a-f]{8}) "
    r"loss_crc ([0-9a-f]{8}) steps_per_s ([0-9.]+)"
)
_RESUME_RE = re.compile(r"\[mpmd\] stage (\d+) rank (\d+) resumed step (\d+) wall ([0-9.]+)")
_DRAIN_RE = re.compile(r"\[mpmd\] stage (\d+) rank (\d+) drained step (\d+)")


def _parse_finals(log: str) -> dict:
    """(stage, rank) → the final-line evidence record; later lines (the
    re-meshed incarnation) overwrite earlier ones."""
    out = {}
    for m in _FINAL_RE.finditer(log):
        out[(int(m.group(1)), int(m.group(2)))] = {
            "world": int(m.group(3)),
            "dtype": m.group(4),
            "microbatches": int(m.group(5)),
            "final_step": int(m.group(6)),
            "params_crc": m.group(7),
            "loss_crc": m.group(8),
            "steps_per_s": float(m.group(9)),
        }
    return out


def _parse_resumes(log: str) -> list:
    return [(int(m.group(1)), int(m.group(2)), int(m.group(3)), float(m.group(4)))
            for m in _RESUME_RE.finditer(log)]


def _parse_drains(log: str) -> list:
    return [(int(m.group(1)), int(m.group(2)), int(m.group(3)))
            for m in _DRAIN_RE.finditer(log)]


def _copy_stage_ckpts(src_ckpt: Path, step: int, dst_ckpt: Path, n_stages: int) -> None:
    """Pristine per-stage copies of one common step: the restore point the
    reference and naive arms start from."""
    for s in range(n_stages):
        src = Path(src_ckpt) / f"stage{s}" / f"step_{step}"
        dst = Path(dst_ckpt) / f"stage{s}" / f"step_{step}"
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copytree(src, dst)


def _drill_pipeline(global_batch: int = 8):
    from tpudml_torch.mpmd.spec import PipelineSpec, StageSpec

    return PipelineSpec(
        stages=(
            StageSpec("trunk", dp=2, microbatches=2, dtype="bfloat16"),
            StageSpec("head", dp=2, microbatches=1, dtype="float32"),
        ),
        global_batch=global_batch,
    )


def _merge_stage_traces(obs_dir: Path, n_stages: int, controller_doc=None):
    """One pid track per stage group: the stage leaders' (local rank 0)
    exported docs re-pidded to the stage index, plus the controller's
    track at pid ``n_stages``. Returns (merged_doc_or_None, pids)."""
    from tpudml_torch.obs.tracer import merge_chrome_traces, validate_chrome_trace

    docs = []
    for s in range(n_stages):
        p = Path(obs_dir) / f"trace_s{s}_p0.json"
        if not p.is_file():
            return None, []
        doc = json.loads(p.read_text())
        for e in doc.get("traceEvents", []):
            e["pid"] = s
            if e.get("ph") == "M" and e.get("name") == "process_name":
                e["args"] = {"name": f"mpmd stage {s}"}
        docs.append(doc)
    if controller_doc is not None:
        for e in controller_doc.get("traceEvents", []):
            e["pid"] = n_stages
            if e.get("ph") == "M" and e.get("name") == "process_name":
                e["args"] = {"name": "mpmd controller"}
        docs.append(controller_doc)
    try:
        merged = merge_chrome_traces(docs)
        validate_chrome_trace(merged)
    except ValueError:
        return None, []
    pids = sorted({e["pid"] for e in merged["traceEvents"] if e["ph"] != "M"})
    return merged, pids


def run_mpmd_drill(
    base_dir: str,
    *,
    steps: int = 20,
    ckpt_every: int = 5,
    kill_step: int = 13,
    kill_stage: int = 1,
    kill_rank: int = 1,
    backoff_s: float = 0.25,
    timeout_s: float = 600.0,
    seed: int = 0,
    include_naive: bool = False,
    sink=None,
    device: str | None = None,
) -> dict:
    """The full re-mesh drill; returns the evidence dict the CLI and the
    tests gate on (``ok``). ``device`` is the stage programs' (default
    ``TPUDML_DEVICE``, else the card; all four stage processes share one
    card). It also runs the pipeline uninterrupted from step 0 and reports
    its wall beside the drill's (``clean_wall_s``,
    ``overhead_vs_clean_frac``), as the elastic drill does."""
    from tpudml_torch.device import default_device
    from tpudml_torch.elastic.replan import Replanner
    from tpudml_torch.launch.cluster import ClusterSpec
    from tpudml_torch.mpmd.groups import MPMDController, _Tee
    from tpudml_torch.mpmd.spec import PipelineSpec
    from tpudml_torch.obs.tracer import Tracer, set_tracer
    from tpudml_torch.plan.space import flagship_lm

    base = Path(base_dir)
    base.mkdir(parents=True, exist_ok=True)
    obs_dir = base / "obs"
    obs_dir.mkdir(parents=True, exist_ok=True)
    pipeline = _drill_pipeline()
    n_stages = len(pipeline.stages)
    plan_path = base / "plan.json"
    ckpt_dir = base / "ckpt"
    marker = base / "kill.marker"
    device = device or default_device()
    cpu = device == "cpu"

    def child(ckpt: Path, obs: Path, every: int, *extra) -> list:
        return [sys.executable, "-u", "-m", CHILD, "--steps", str(steps),
                "--ckpt_every", str(every), "--ckpt_dir", str(ckpt), "--seed", str(seed),
                "--obs_dir", str(obs), "--device", device, *extra]

    def kill_flags(mark: Path) -> list:
        return ["--kill_step", str(kill_step), "--kill_stage", str(kill_stage),
                "--kill_rank", str(kill_rank), "--kill_marker", str(mark)]

    tracer = Tracer()
    prev_tracer = set_tracer(tracer)
    try:
        rp = Replanner(flagship_lm(), engines=["dp", "zero1"], verify=False,
                       plan_path=plan_path)
        rp.initial_plan(pipeline.total_slots)

        spec = ClusterSpec(
            num_processes=2,  # overwritten per stage
            timeout_s=timeout_s,
            grace_s=3.0,
            platform="cpu" if cpu else None,
            # The children's host work is a few small tensors a step: one
            # thread each keeps the stage processes from crowding the cores.
            env={"OMP_NUM_THREADS": "1"},
            restart_backoff_s=backoff_s,
            restart_backoff_jitter=0.5,
            restart_backoff_seed=seed,
        )
        drill_log = io.StringIO()
        ctrl = MPMDController(
            child(ckpt_dir, obs_dir, ckpt_every, *kill_flags(marker)), pipeline, spec,
            run_dir=base / "run", ckpt_dir=ckpt_dir, max_reforms=2, replanner=rp,
            sink=_Tee(drill_log, sink))
        mres = ctrl.run()
        log = drill_log.getvalue()
        finals = _parse_finals(log)
        resumes = _parse_resumes(log)
        drains = _parse_drains(log)
        (obs_dir / "mpmd_elastic.json").write_text(
            json.dumps(mres.to_dict(), indent=2, sort_keys=True) + "\n")

        resume_step = min((s for _, _, s, _ in resumes), default=None)
        kill_wall = marker.stat().st_mtime if marker.is_file() else None
        remesh_mttr = (max(w for _, _, _, w in resumes) - kill_wall
                       if resumes and kill_wall is not None else None)
        restart_latency = (max(w for _, _, _, w in resumes) - mres.records[0].t_end
                           if resumes and len(mres.records) >= 2 else None)
        final_pipeline = (PipelineSpec.from_dict(mres.records[-1].pipeline)
                          if mres.records else None)

        # Reference arm: the re-meshed configuration, uninterrupted, from a
        # pristine copy of the same checkpoint — per-(stage, rank) CRC
        # comparison is the bit-exactness verdict.
        bit_exact = False
        if mres.success and resume_step is not None and final_pipeline is not None:
            _copy_stage_ckpts(ckpt_dir, resume_step, base / "ref_ckpt", n_stages)
            ref_log = io.StringIO()
            ref_ctrl = MPMDController(
                child(base / "ref_ckpt", base / "ref_obs", 0), final_pipeline, spec,
                run_dir=base / "ref_run", ckpt_dir=base / "ref_ckpt", max_reforms=0,
                sink=_Tee(ref_log, sink))
            ref_res = ref_ctrl.run()
            ref_finals = _parse_finals(ref_log.getvalue())
            bit_exact = (
                ref_res.success
                and set(ref_finals) == set(finals)
                and all(finals[k]["params_crc"] == ref_finals[k]["params_crc"]
                        and finals[k]["loss_crc"] == ref_finals[k]["loss_crc"]
                        for k in ref_finals)
            )

        # Clean arm: the same pipeline, no kill, from step 0.
        clean_res = MPMDController(
            child(base / "clean_ckpt", base / "clean_obs", 0), pipeline, spec,
            run_dir=base / "clean_run", ckpt_dir=base / "clean_ckpt", max_reforms=0,
            sink=sink).run()
        clean_wall = clean_res.total_elapsed_s if clean_res.success else None

        # Naive A/B arm: same kill, but peers abort instead of draining —
        # every group's containment fires and the whole world restarts.
        naive = None
        if include_naive:
            naive_ckpt = base / "naive_ckpt"
            naive_marker = base / "naive_kill.marker"
            naive_log = io.StringIO()
            naive_ctrl = MPMDController(
                child(naive_ckpt, base / "naive_obs", ckpt_every, *kill_flags(naive_marker),
                      "--drain_mode", "abort"),
                pipeline, spec, run_dir=base / "naive_run", ckpt_dir=naive_ckpt,
                max_reforms=2, victim_rc=17, sink=_Tee(naive_log, sink))
            naive_res = naive_ctrl.run()
            naive_resumes = _parse_resumes(naive_log.getvalue())
            naive_kill_wall = (naive_marker.stat().st_mtime
                               if naive_marker.is_file() else None)
            naive_mttr = (max(w for _, _, _, w in naive_resumes) - naive_kill_wall
                          if naive_resumes and naive_kill_wall is not None else None)
            naive = {
                "success": naive_res.success,
                "reforms": naive_res.reforms,
                "restart_mttr_s": naive_mttr,
                "resume_step": min((s for _, _, s, _ in naive_resumes), default=None),
            }

        # Trace evidence: one pid per stage group + the controller track.
        merged, pids = _merge_stage_traces(obs_dir, n_stages, tracer.chrome_trace())
        if merged is not None:
            (obs_dir / "trace.json").write_text(
                json.dumps(merged, sort_keys=True, separators=(",", ":")) + "\n")

        ports = [p for r in mres.records for p in r.coordinator_ports]
        replan = mres.replans[0] if mres.replans else None
        receipts = list(replan.get("receipts", [])) if replan else []
        in_place = (
            len(mres.records) == 2
            and mres.records[0].stage_worlds == [2, 2]
            and mres.records[1].stage_worlds
            == [2 if s != kill_stage else 1 for s in range(n_stages)]
        )
        victim = mres.records[0].victim if mres.records else None
        ok = (
            mres.success
            and mres.reforms == 1
            and in_place
            and victim is not None
            and victim["stage"] == kill_stage
            and victim["rank"] == kill_rank
            and replan is not None
            and not replan.get("error")
            and bool(receipts)
            and resume_step is not None
            and kill_step - resume_step >= 0
            and bool(drains)
            and bit_exact
            and len(set(ports)) == len(ports)
            and merged is not None
            and pids == list(range(n_stages + 1))
        )
        result = {
            "ok": ok,
            "mode": "mpmd_remesh",
            "device": device,
            "bit_exact": bit_exact,
            "pipeline": pipeline.to_dict(),
            "final_stage_worlds": mres.final_stage_worlds,
            "in_place": in_place,
            "steps": steps,
            "kill_step": kill_step,
            "kill_stage": kill_stage,
            "kill_rank": kill_rank,
            "victim": victim,
            "drains": drains,
            "resume_step": resume_step,
            "steps_lost": kill_step - resume_step if resume_step is not None else None,
            "reforms": mres.reforms,
            "stop_reason": mres.stop_reason,
            "coordinator_ports": ports,
            "fresh_ports": len(set(ports)) == len(ports),
            "remesh_mttr_s": remesh_mttr,
            "restart_latency_s": restart_latency,
            "backoff_s": mres.records[-1].backoff_s if mres.reforms else 0.0,
            "drill_wall_s": mres.total_elapsed_s,
            "clean_wall_s": clean_wall,
            "overhead_vs_clean_frac": ((mres.total_elapsed_s - clean_wall) / clean_wall
                                       if clean_wall else None),
            "replan_receipts": receipts,
            "replan_error": replan.get("error") if replan else None,
            "steps_per_s": {f"s{s}r{r}": f["steps_per_s"]
                            for (s, r), f in sorted(finals.items())},
            "params_crc": {f"s{s}r{r}": f["params_crc"]
                           for (s, r), f in sorted(finals.items())},
            "naive": naive,
            "remesh_beats_naive": (
                remesh_mttr is not None
                and naive is not None
                and naive["restart_mttr_s"] is not None
                and remesh_mttr < naive["restart_mttr_s"]
            ) if include_naive else None,
            "trace_pids": pids,
        }
        (obs_dir / "mpmd.json").write_text(
            json.dumps(result, indent=2, sort_keys=True) + "\n")
        return result
    finally:
        set_tracer(prev_tracer)


if __name__ == "__main__":
    sys.exit(child_main())
