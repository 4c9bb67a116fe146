"""MPMD stage-group controller: form, supervise, re-mesh in place (the
port of ``tpudml/mpmd/groups.py``).

The elastic controller (``tpudml_torch/elastic/controller.py``) supervises
ONE process group. :class:`MPMDController` generalizes it to a *fleet of
worlds*: each pipeline stage is its own process group with its own
coordinator rendezvous, spawned via the launcher's single-attempt core
(:func:`tpudml_torch.launch.launcher.launch_once`) in one thread per stage.
The same membership machinery drives formation and teardown:

- **fresh ports per round** — every incarnation reserves, by
  bind-and-hold, one coordinator port per stage plus the p2p boundary
  listener ports and the intra-stage ctl (drain barrier) ports, all
  guaranteed never-reused within the job (the elastic controller's
  zombie-rendezvous defense, per stage);
- **wiring file** — the round's full topology (stages, slots, boundary
  listeners, ctl hubs) is written as ``wiring_r{N}.json`` before
  spawning; children read it instead of guessing peers;
- **drain classification** — a SIGKILLed rank exits non-zero and its
  group's containment SIGTERMs the group; every *surviving* rank (in
  any group) drains at a step boundary, writes a
  ``drain_s{S}_r{R}.json`` marker into the round dir and exits 0 — so
  the victim is always the unique rank with a non-zero rc, and drained
  ranks are never mistaken for failures;
- **pre-launch protocol gate** — before any round spawns, the static
  cross-rank protocol checker (``tpudml_torch/analysis/protocol.py``) runs
  over the round's ``PipelineSpec`` — the initial spec and every
  ``replace_pipeline`` result alike. Error-severity findings (P300
  boundary asymmetry, P301 wait-for cycles, P302 collective-sequence
  divergence) refuse the launch with machine-readable receipts
  (``protocol_report.json`` in the run dir, ``stop_reason=
  "protocol_rejected"``) instead of a hung drill burning its timeout;
- **re-mesh in place** — the ``Replanner`` (``elastic/replan.py``) is consulted
  fail-open at the surviving world, the pipeline shrinks via
  :func:`~tpudml_torch.mpmd.spec.replace_pipeline` (``StageQuorumError``
  stops the job, the ``min_world``-per-stage quorum), the common
  resume step is computed from the per-stage checkpoint directories
  (newest step present and manifest-complete in EVERY stage dir —
  a scan of files alone; children do the CRC-verified restore), and the
  surviving groups re-form on fresh ports — no whole-world restart.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import re
import socket
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from tpudml_torch.launch.cluster import ClusterSpec
from tpudml_torch.launch.launcher import launch_once, restart_backoff
from tpudml_torch.mpmd.spec import PipelineSpec, StageQuorumError, replace_pipeline

#: Env contract for MPMD children, alongside the launcher's TPUDML_*
#: rendezvous variables (which are per-STAGE here: TPUDML_PROCESS_ID is
#: the stage-local rank).
ROUND_ENV = "TPUDML_MPMD_ROUND"
STAGE_ENV = "TPUDML_MPMD_STAGE"

WIRING_VERSION = 1

_STEP_RE = re.compile(r"^step_(\d+)$")


def write_wiring(path: Path, *, round_no: int, pipeline: PipelineSpec,
                 coordinator_ports: list, boundary_ports: dict,
                 ctl_ports: dict, host: str = "127.0.0.1") -> dict:
    """The round's topology document. ``boundary_ports`` maps boundary
    index -> {dst_rank: port} (the downstream rank listens, the upstream
    rank dials); ``ctl_ports`` maps stage index -> hub port (stage-local
    rank 0 listens) for every dp>1 stage."""
    doc = {
        "version": WIRING_VERSION,
        "round": round_no,
        "host": host,
        "pipeline": pipeline.to_dict(),
        "coordinator_ports": [int(p) for p in coordinator_ports],
        "boundaries": [
            {
                "from": b,
                "to": b + 1,
                "listeners": {
                    str(q): {"host": host, "port": int(p)}
                    for q, p in sorted(boundary_ports[b].items())
                },
            }
            for b in sorted(boundary_ports)
        ],
        "ctl": {
            str(s): {"host": host, "port": int(p)}
            for s, p in sorted(ctl_ports.items())
        },
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return doc


def drain_marker_path(round_dir: Path, stage: int, rank: int) -> Path:
    return Path(round_dir) / f"drain_s{stage}_r{rank}.json"


def read_drain_markers(round_dir: Path) -> dict:
    """(stage, rank) -> marker dict for every drain marker in the round
    dir. Tolerant of torn writes (a SIGTERM handler wrote them)."""
    out = {}
    round_dir = Path(round_dir)
    if not round_dir.is_dir():
        return out
    for p in sorted(round_dir.glob("drain_s*_r*.json")):
        m = re.match(r"drain_s(\d+)_r(\d+)\.json$", p.name)
        if not m:
            continue
        try:
            out[(int(m.group(1)), int(m.group(2)))] = json.loads(p.read_text())
        except (OSError, ValueError):
            out[(int(m.group(1)), int(m.group(2)))] = {}
    return out


def stage_ckpt_dir(ckpt_dir, stage: int) -> Path:
    return Path(ckpt_dir) / f"stage{stage}"


def _complete_steps(stage_dir: Path) -> set:
    """Steps under one stage's checkpoint dir whose manifest set is
    complete (every process manifest the writers declared is present).
    Pure filesystem + JSON, usable from the controller."""
    steps = set()
    if not stage_dir.is_dir():
        return steps
    for name in os.listdir(stage_dir):
        m = _STEP_RE.match(name)
        if not m:
            continue
        path = stage_dir / name
        manifests = sorted(p for p in os.listdir(path)
                           if p.startswith("manifest_p"))
        if not manifests:
            continue
        try:
            expect = int(
                json.loads((path / manifests[0]).read_text())["num_processes"]
            )
        except (OSError, ValueError, KeyError, TypeError):
            continue
        if len(manifests) == expect:
            steps.add(int(m.group(1)))
    return steps


def common_resume_step(ckpt_dir, n_stages: int) -> int:
    """Newest step checkpointed by EVERY stage (0 = fresh start). The
    stages checkpoint independently, so after a mid-step kill their
    newest steps can disagree; resuming anywhere but the intersection
    would desynchronize the pipeline's replayed trajectory."""
    common = None
    for s in range(n_stages):
        steps = _complete_steps(stage_ckpt_dir(ckpt_dir, s))
        common = steps if common is None else (common & steps)
        if not common:
            return 0
    return max(common) if common else 0


@dataclass
class StageRound:
    """One stage group's outcome within one round."""

    stage: int
    world: int
    coordinator_port: int
    returncodes: list
    failed_rank: int | None
    timed_out: bool
    elapsed_s: float


@dataclass
class MPMDReformRecord:
    """One incarnation of the whole pipeline (round 0 = first form)."""

    round: int
    pipeline: dict
    stage_worlds: list
    coordinator_ports: list
    stages: list  # list[StageRound as dict]
    victim: dict | None  # {stage, rank, slot, rc} for the failed rank
    drained: list  # [(stage, rank), ...] markers observed
    resume_step: int
    backoff_s: float
    elapsed_s: float
    t_start: float
    t_end: float

    @property
    def success(self) -> bool:
        return all(
            not s["timed_out"] and all(rc == 0 for rc in s["returncodes"])
            for s in self.stages
        ) and not self.drained

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class MPMDResult:
    records: list = field(default_factory=list)
    replans: list = field(default_factory=list)
    protocol: list = field(default_factory=list)  # per-round gate receipts
    success: bool = False
    total_elapsed_s: float = 0.0
    stop_reason: str = ""

    @property
    def reforms(self) -> int:
        return max(0, len(self.records) - 1)

    @property
    def final_stage_worlds(self) -> list:
        return self.records[-1].stage_worlds if self.records else []

    def to_dict(self) -> dict:
        return {
            "records": [r.to_dict() for r in self.records],
            "replans": [dict(r) for r in self.replans],
            "protocol": [dict(r) for r in self.protocol],
            "success": self.success,
            "total_elapsed_s": self.total_elapsed_s,
            "stop_reason": self.stop_reason,
            "reforms": self.reforms,
            "final_stage_worlds": self.final_stage_worlds,
        }


class _Tee:
    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]
        self._lock = threading.Lock()

    def write(self, s):
        with self._lock:
            for k in self.sinks:
                k.write(s)
        return len(s)

    def flush(self):
        for k in self.sinks:
            k.flush()


class MPMDController:
    """Supervise an MPMD pipeline across rank death with in-place
    re-meshes.

    ``cmd`` is the per-rank child argv template (typically
    ``python -m tpudml_torch.mpmd.drill ...``); the controller appends
    ``--stage S --wiring FILE --round_dir DIR --resume_step N`` per
    stage per round. ``spec`` supplies the per-stage ClusterSpec
    template (timeouts, grace, backoff seed); ``num_processes`` and
    ``coordinator_port`` are overwritten per stage. ``replanner`` is
    duck-typed exactly like the elastic controller's (fail-open: a
    replanner exception is recorded, never fatal).
    """

    def __init__(self, cmd, pipeline: PipelineSpec,
                 spec: ClusterSpec | None = None, *,
                 run_dir, ckpt_dir, max_reforms: int = 2,
                 replanner=None, victim_rc: int | None = None, sink=None,
                 protocol_checker=None):
        self.cmd = list(cmd)
        self.pipeline = pipeline
        self.spec = (dataclasses.replace(spec) if spec is not None
                     else ClusterSpec())
        self.run_dir = Path(run_dir)
        self.ckpt_dir = Path(ckpt_dir)
        self.max_reforms = max_reforms
        self.replanner = replanner
        # When peers die loudly instead of draining (the naive
        # whole-world-restart arm aborts rc 75 on peer death), "first
        # failed rank" is ambiguous: victim_rc pins attribution to the
        # fault injector's exit code.
        self.victim_rc = victim_rc
        self.sink = sink
        # PipelineSpec -> list[Finding]; defaults to the static protocol
        # analyzer. Injectable so tests can force a rejection without
        # constructing a genuinely broken (hence unconstructible) spec.
        self.protocol_checker = protocol_checker

    # ---------------------------------------------------- protocol gate

    def _check_protocol(self, pipeline: PipelineSpec, rnd: int,
                        res: MPMDResult) -> bool:
        """Run the cross-rank protocol checker on the spec about to be
        spawned; append the receipt (clean or not) and keep the run
        dir's ``protocol_report.json`` current. Returns False — refuse
        to launch — on any error-severity finding."""
        checker = self.protocol_checker
        if checker is None:
            from tpudml_torch.analysis.protocol import analyze_pipeline

            def checker(p):
                return analyze_pipeline(p, entrypoint=f"round{rnd}")
        findings = checker(pipeline)
        errors = [f for f in findings
                  if getattr(f, "severity", "error") == "error"]
        res.protocol.append({
            "round": rnd,
            "pipeline": pipeline.to_dict(),
            "ok": not errors,
            "findings": [
                {
                    "rule": f.rule,
                    "severity": f.severity,
                    "message": f.message,
                    "file": f.file,
                    "line": f.line,
                    "entrypoint": f.entrypoint,
                }
                for f in findings
            ],
        })
        report = {
            "version": 1,
            "ok": all(r["ok"] for r in res.protocol),
            "checks": res.protocol,
        }
        (self.run_dir / "protocol_report.json").write_text(
            json.dumps(report, indent=2, sort_keys=True) + "\n")
        return not errors

    # ------------------------------------------------------------- ports

    def _reserve(self, used: set):
        """Bind-and-hold a never-used port: ``(sock, port)`` — the
        elastic controller's reservation discipline, shared by the
        coordinator, boundary and ctl ports alike."""
        for _ in range(128):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.bind((self.spec.coordinator_host, 0))
            except OSError:
                s.close()
                continue
            port = s.getsockname()[1]
            if port in used:
                s.close()
                continue
            used.add(port)
            return s, port
        raise RuntimeError("could not reserve a fresh port")

    def _round_ports(self, pipeline: PipelineSpec, used: set):
        """All port reservations for one round: per-stage coordinator,
        per-boundary per-dst-rank p2p listener, per-dp>1-stage ctl hub.
        Returns (reservations, coord_ports, boundary_ports, ctl_ports)."""
        holds = []
        coord = []
        for _ in pipeline.stages:
            s, p = self._reserve(used)
            holds.append(s)
            coord.append(p)
        boundary: dict = {}
        for b in range(len(pipeline.stages) - 1):
            boundary[b] = {}
            for q in range(pipeline.stages[b + 1].dp):
                s, p = self._reserve(used)
                holds.append(s)
                boundary[b][q] = p
        ctl: dict = {}
        for si, st in enumerate(pipeline.stages):
            if st.dp > 1:
                s, p = self._reserve(used)
                holds.append(s)
                ctl[si] = p
        return holds, coord, boundary, ctl

    # --------------------------------------------------------------- run

    def run(self) -> MPMDResult:
        from tpudml_torch.obs.tracer import get_tracer

        out = self.sink or sys.stdout
        spec = self.spec
        budget = spec.timeout_s
        pipeline = self.pipeline
        rng = random.Random(spec.restart_backoff_seed)
        used_ports: set = set()
        res = MPMDResult()
        backoff = 0.0
        # Scan the checkpoint dirs even for round 0: a controller pointed
        # at an existing per-stage checkpoint tree (the drill's reference
        # arm, an operator restart) resumes from the common step.
        resume_step = common_resume_step(self.ckpt_dir, len(pipeline.stages))
        self.run_dir.mkdir(parents=True, exist_ok=True)

        for rnd in range(self.max_reforms + 1):
            # Pre-launch gate: the initial spec AND every re-meshed spec
            # must pass the static protocol checks before any process
            # (or port reservation) is spent on them.
            if not self._check_protocol(pipeline, rnd, res):
                out.write(
                    f"[mpmd] round {rnd}: protocol checker rejected the "
                    f"pipeline spec — refusing to launch (receipts in "
                    f"protocol_report.json)\n"
                )
                out.flush()
                res.stop_reason = "protocol_rejected"
                break
            holds, coord, boundary, ctl = self._round_ports(
                pipeline, used_ports
            )
            round_dir = self.run_dir / f"round_{rnd}"
            round_dir.mkdir(parents=True, exist_ok=True)
            wiring = self.run_dir / f"wiring_r{rnd}.json"
            write_wiring(
                wiring, round_no=rnd, pipeline=pipeline,
                coordinator_ports=coord, boundary_ports=boundary,
                ctl_ports=ctl, host=spec.coordinator_host,
            )
            remaining = None if budget is None else budget - res.total_elapsed_s
            out.write(
                f"[mpmd] round {rnd}: stage worlds "
                f"{[st.dp for st in pipeline.stages]}, resume_step "
                f"{resume_step}, fresh ports {coord}\n"
            )
            out.flush()
            get_tracer().instant(
                "mpmd_form", cat="mpmd",
                args={
                    "round": rnd,
                    "stage_worlds": [st.dp for st in pipeline.stages],
                    "resume_step": resume_step,
                },
            )

            # Release every reservation at the last instant, then spawn
            # all stage groups concurrently — one launch_once per stage.
            for h in holds:
                h.close()
            results: list = [None] * len(pipeline.stages)
            threads = []
            t_start = time.time()
            for s, st in enumerate(pipeline.stages):
                stage_spec = dataclasses.replace(
                    spec,
                    num_processes=st.dp,
                    coordinator_port=coord[s],
                    timeout_s=remaining,
                    max_restarts=0,
                    env={
                        **spec.env,
                        ROUND_ENV: str(rnd),
                        STAGE_ENV: str(s),
                    },
                )
                stage_cmd = self.cmd + [
                    "--stage", str(s),
                    "--wiring", str(wiring),
                    "--round_dir", str(round_dir),
                    "--resume_step", str(resume_step),
                ]
                prefix = _StagePrefix(out, s)

                def work(i=s, c=stage_cmd, sp=stage_spec, pf=prefix):
                    results[i] = launch_once(c, sp, pf)

                t = threading.Thread(target=work, daemon=True)
                threads.append(t)
                t.start()
            for t in threads:
                t.join()
            t_end = time.time()
            elapsed = t_end - t_start
            res.total_elapsed_s += elapsed

            markers = read_drain_markers(round_dir)
            victim = None
            timed_out = any(r.timed_out for r in results)
            if self.victim_rc is not None:
                for s, r in enumerate(results):
                    for rank, rc in enumerate(r.returncodes):
                        if rc == self.victim_rc and victim is None:
                            victim = {
                                "stage": s,
                                "rank": rank,
                                "slot": pipeline.slot_of(s, rank),
                                "rc": rc,
                            }
            for s, r in enumerate(results):
                if r.failed_rank is not None and victim is None:
                    victim = {
                        "stage": s,
                        "rank": r.failed_rank,
                        "slot": pipeline.slot_of(s, r.failed_rank),
                        "rc": r.returncodes[r.failed_rank],
                    }
            rec = MPMDReformRecord(
                round=rnd,
                pipeline=pipeline.to_dict(),
                stage_worlds=[st.dp for st in pipeline.stages],
                coordinator_ports=list(coord),
                stages=[
                    dataclasses.asdict(StageRound(
                        stage=s,
                        world=pipeline.stages[s].dp,
                        coordinator_port=coord[s],
                        returncodes=list(r.returncodes),
                        failed_rank=r.failed_rank,
                        timed_out=r.timed_out,
                        elapsed_s=r.elapsed_s,
                    ))
                    for s, r in enumerate(results)
                ],
                victim=victim,
                drained=sorted(markers),
                resume_step=resume_step,
                backoff_s=backoff,
                elapsed_s=elapsed,
                t_start=t_start,
                t_end=t_end,
            )
            res.records.append(rec)

            if rec.success:
                res.success = True
                res.stop_reason = "success"
                break
            if timed_out:
                res.stop_reason = "timeout"
                break
            if rnd == self.max_reforms:
                res.stop_reason = "max_reforms"
                break
            if victim is None:
                # Drains without an attributable victim (e.g. an operator
                # SIGTERM of a whole group) — nothing to shrink on.
                res.stop_reason = "unattributable_failure"
                break

            why = (
                f"stage {victim['stage']} rank {victim['rank']} "
                f"(slot {victim['slot']}) failed rc={victim['rc']}"
            )
            # Consult the planner at the surviving world — fail-open,
            # exactly the elastic controller's contract: a replanner
            # crash is recorded and recovery proceeds on the old plan.
            surviving = pipeline.total_slots - 1
            if self.replanner is not None:
                t0 = time.time()
                try:
                    rep = self.replanner.replan(surviving, why=why)
                    rep_d = (rep.to_dict() if hasattr(rep, "to_dict")
                             else dict(rep))
                except Exception as e:
                    rep_d = {
                        "trigger": "membership",
                        "why": why,
                        "old_world": pipeline.total_slots,
                        "new_world": surviving,
                        "switched": False,
                        "receipts": [],
                        "error": f"{type(e).__name__}: {e}",
                    }
                latency = time.time() - t0
                res.total_elapsed_s += latency
                rep_d["round"] = rnd + 1
                res.replans.append(rep_d)
                if rep_d.get("error"):
                    out.write(
                        f"[mpmd] re-plan at world {surviving} failed "
                        f"({rep_d['error']}); keeping the old plan\n"
                    )
                else:
                    out.write(
                        f"[mpmd] re-plan at world {surviving}: "
                        f"{rep_d.get('old_key')} -> {rep_d.get('new_key')}"
                        + (" (switched)" if rep_d.get("switched")
                           else " (retained)") + "\n"
                    )
                out.flush()
                get_tracer().instant(
                    "mpmd_replan", cat="mpmd",
                    args={
                        "round": rnd + 1,
                        "world": surviving,
                        "switched": bool(rep_d.get("switched")),
                        "error": rep_d.get("error"),
                    },
                )
            try:
                pipeline, slot_map = replace_pipeline(
                    pipeline, {victim["slot"]}
                )
            except StageQuorumError as e:
                out.write(f"[mpmd] {why}; {e} — cannot re-form\n")
                out.flush()
                res.stop_reason = "below_stage_quorum"
                break
            except ValueError as e:
                out.write(f"[mpmd] {why}; shrink infeasible: {e}\n")
                out.flush()
                res.stop_reason = "infeasible_shrink"
                break
            resume_step = common_resume_step(
                self.ckpt_dir, len(pipeline.stages)
            )
            backoff = restart_backoff(spec, rng, rnd + 1)
            if budget is not None and res.total_elapsed_s + backoff >= budget:
                res.stop_reason = "budget_exhausted"
                break
            out.write(
                f"[mpmd] {why}; re-mesh {rnd + 1}/{self.max_reforms}: "
                f"stage worlds {rec.stage_worlds} -> "
                f"{[st.dp for st in pipeline.stages]}, resume_step "
                f"{resume_step}, fresh ports"
                + (f", {backoff:.2f}s backoff" if backoff > 0 else "")
                + "\n"
            )
            out.flush()
            get_tracer().instant(
                "mpmd_reform", cat="mpmd",
                args={
                    "round": rnd + 1,
                    "why": why,
                    "stage_worlds": [st.dp for st in pipeline.stages],
                    "resume_step": resume_step,
                    "backoff_s": backoff,
                },
            )
            if backoff > 0:
                time.sleep(backoff)
                res.total_elapsed_s += backoff
        return res


class _StagePrefix:
    """Per-stage sink wrapper: prefixes the launcher's ``[rank R]`` tags
    with the stage, so interleaved multi-gang output stays attributable
    (``[stage 1][rank 0] ...``)."""

    def __init__(self, sink, stage: int):
        self.sink = sink
        self.prefix = f"[stage {stage}]"

    def write(self, s):
        return self.sink.write(
            "".join(
                f"{self.prefix}{line}" if line.strip() else line
                for line in s.splitlines(keepends=True)
            )
        )

    def flush(self):
        self.sink.flush()
