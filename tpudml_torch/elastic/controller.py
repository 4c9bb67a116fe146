"""Elastic controller: membership-aware restart on top of the launcher (the
port of ``tpudml/elastic/controller.py``).

Where ``launch(max_restarts=...)`` relaunches the *same* job shape on a
failure, :class:`ElasticController` treats each failure as a membership
event and re-forms the job:

- **fresh rendezvous** — every re-form gets a coordinator port never used
  by an earlier round of this job, so a zombie rank still blocked in the
  old rendezvous (or a half-dead coordinator holding the socket) can
  never join — or deadlock — the new incarnation. Ports are *reserved by
  binding* (the socket is held until the instant the round spawns), not
  picked-and-released, so two concurrent controllers on one host cannot
  race each other onto the same port; a pinned ``coordinator_port`` is
  probed for bindability first and falls back to a fresh port (with a
  warning) when something else is squatting on it — a collision degrades
  to a port change, never to a rendezvous deadlock;
- **adaptive re-plan** — with a ``replanner``
  (:class:`tpudml_torch.elastic.replan.Replanner`) attached, every membership
  *change* consults the planner at the new world size before re-forming:
  the next incarnation may run a different engine chain entirely, picked
  up by ``--plan``-consuming children from the refreshed plan file. The
  re-plan decision (old/new winner, receipts, latency) is recorded on
  the result and its latency is charged against the whole-job budget;
  a replanner failure is recorded and the old plan is kept — recovery
  never dies inside the recovery path;
- **membership policy** — ``"restart"`` re-forms at the same world size
  (the failed rank's slot is refilled); ``"shrink"`` drops one rank per
  failure and re-forms the survivors at ``world-1`` (never below
  ``min_world``), the preemption story where the capacity is *gone*;
- **budget + backoff** — one whole-job wall-clock budget
  (``spec.timeout_s``) is charged across every round *and* every backoff
  sleep, and the backoff schedule is the launcher's seeded exponential
  (:func:`tpudml_torch.launch.launcher.restart_backoff`) so drills are
  reproducible per (spec, seed).

Resume is the command's job, by design: pair the supervised command with
a sharded checkpoint dir (``restore_latest_valid_sharded``) and each
incarnation continues from the newest CRC-valid step — any world size
can restore any other world size's checkpoint, which is what makes
``"shrink"`` a *training* policy and not just a process policy.
"""

from __future__ import annotations

import dataclasses
import random
import socket
import sys
import time
from dataclasses import dataclass, field

from tpudml_torch.launch.cluster import ClusterSpec
from tpudml_torch.launch.launcher import LaunchResult, launch_once, restart_backoff

#: Env var telling each child which incarnation of the job it belongs to
#: (0 = first form, k = after k re-forms). Children use it to tag
#: per-round artifacts (traces, logs); training code can ignore it.
ROUND_ENV = "TPUDML_ELASTIC_ROUND"


@dataclass
class ReformRecord:
    """One incarnation of the job (round 0 = the initial form)."""

    round: int
    world: int
    coordinator_port: int
    returncodes: list[int]
    failed_rank: int | None
    timed_out: bool
    elapsed_s: float
    backoff_s: float  # slept BEFORE this round formed (0.0 for round 0)
    t_start: float  # wall clock (time.time()) at spawn / end of round —
    t_end: float  # the MTTR measurement anchors for drill evidence

    @property
    def success(self) -> bool:
        return not self.timed_out and all(rc == 0 for rc in self.returncodes)


@dataclass
class ElasticResult:
    records: list[ReformRecord] = field(default_factory=list)
    #: One dict per planner consultation (ReplanRecord.to_dict() plus a
    #: "round" key naming the incarnation the new plan formed), in order.
    replans: list[dict] = field(default_factory=list)
    success: bool = False
    total_elapsed_s: float = 0.0
    #: Why the controller stopped: "success" | "max_reforms" |
    #: "budget_exhausted" | "below_min_world".
    stop_reason: str = ""

    @property
    def reforms(self) -> int:
        return max(0, len(self.records) - 1)

    @property
    def final_world(self) -> int:
        return self.records[-1].world if self.records else 0

    def to_dict(self) -> dict:
        """The telemetry record drills persist (``elastic.json``) and
        ``tpudml_torch.tools.obs_report``'s reform/replan section reads."""
        return {
            "records": [dataclasses.asdict(r) for r in self.records],
            "replans": [dict(r) for r in self.replans],
            "success": self.success,
            "total_elapsed_s": self.total_elapsed_s,
            "stop_reason": self.stop_reason,
            "reforms": self.reforms,
            "final_world": self.final_world,
        }


class ElasticController:
    """Supervise ``cmd`` across rank death with membership re-forms.

    ``cmd`` and ``spec`` mean exactly what they mean for
    :func:`tpudml_torch.launch.launch`; ``spec.max_restarts`` is ignored here —
    re-forming is this controller's job (``max_reforms``), and each round
    runs exactly once via the launcher's single-attempt core (which
    already contains failures: first non-zero rank ⇒ SIGTERM→SIGKILL of
    the whole round, so no zombie survives into the next rendezvous).

    ``replanner`` (optional) is consulted on every membership *change*
    (``replanner.replan(new_world, why=...)``) before the re-form — any
    object with that method works; the real one is
    :class:`tpudml_torch.elastic.replan.Replanner`, which this module
    never imports (controller semantics stay importable and testable
    without the planner).
    """

    def __init__(
        self,
        cmd: list[str],
        spec: ClusterSpec | None = None,
        *,
        policy: str = "restart",
        min_world: int = 1,
        max_reforms: int = 2,
        replanner=None,
        sink=None,
    ):
        if policy not in ("restart", "shrink"):
            raise ValueError(f"unknown membership policy {policy!r}")
        if min_world < 1:
            raise ValueError(f"min_world must be >= 1, got {min_world}")
        self.cmd = list(cmd)
        self.spec = dataclasses.replace(spec) if spec is not None else ClusterSpec()
        self.policy = policy
        self.min_world = min_world
        self.max_reforms = max_reforms
        self.replanner = replanner
        self.sink = sink

    def _reserve_fresh_port(self, used: set[int]):
        """Reserve a never-used port by *binding* it and holding the
        socket: ``(sock, port)``. The caller closes ``sock`` at the last
        instant before spawning the round, so a concurrent controller
        (or any fault-injected squatter) probing ports in the meantime
        cannot grab it — the pick-without-binding race this replaces
        left a window from pick to rendezvous."""
        for _ in range(64):
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
            return s, port
        raise RuntimeError("could not reserve a fresh coordinator port")

    def _pinned_port_usable(self, port: int) -> bool:
        """Bindability probe for an explicitly pinned round-0 port."""
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.bind((self.spec.coordinator_host, port))
            return True
        except OSError:
            return False
        finally:
            s.close()

    def run(self) -> ElasticResult:
        from tpudml_torch.obs.tracer import get_tracer

        out = self.sink or sys.stdout
        spec = self.spec
        budget = spec.timeout_s
        world = spec.num_processes
        rng = random.Random(spec.restart_backoff_seed)
        used_ports: set[int] = set()
        res = ElasticResult()
        backoff = 0.0
        for rnd in range(self.max_reforms + 1):
            # Fresh rendezvous per incarnation: an explicitly pinned port is
            # honored for the first form only — re-forms must never reuse a
            # port a (possibly zombie) earlier round rendezvoused on. Fresh
            # ports stay *bound* (reservation held) until the round spawns.
            reservation = None
            if rnd == 0 and spec.coordinator_port != 0:
                port = spec.coordinator_port
                if not self._pinned_port_usable(port):
                    out.write(
                        f"[elastic] pinned coordinator port {port} is not "
                        f"bindable (already in use) — falling back to a "
                        f"fresh port\n"
                    )
                    out.flush()
                    reservation, port = self._reserve_fresh_port(used_ports)
            else:
                reservation, port = self._reserve_fresh_port(used_ports)
            used_ports.add(port)
            remaining = None if budget is None else budget - res.total_elapsed_s
            round_spec = dataclasses.replace(
                spec,
                num_processes=world,
                coordinator_port=port,
                timeout_s=remaining,
                max_restarts=0,
                env={**spec.env, ROUND_ENV: str(rnd)},
            )
            t_start = time.time()
            if reservation is not None:
                # Release at the last instant — the round's coordinator
                # binds this port next.
                reservation.close()
            launched: LaunchResult = launch_once(self.cmd, round_spec, out)
            t_end = time.time()
            res.total_elapsed_s += launched.elapsed_s
            rec = ReformRecord(
                round=rnd,
                world=world,
                coordinator_port=port,
                returncodes=launched.returncodes,
                failed_rank=launched.failed_rank,
                timed_out=launched.timed_out,
                elapsed_s=launched.elapsed_s,
                backoff_s=backoff,
                t_start=t_start,
                t_end=t_end,
            )
            res.records.append(rec)
            if rec.success:
                res.success = True
                res.stop_reason = "success"
                break
            if rnd == self.max_reforms:
                res.stop_reason = "max_reforms"
                break
            why = (
                "timeout"
                if rec.timed_out
                else f"rank {rec.failed_rank} failed"
                f" (rc={rec.returncodes[rec.failed_rank]})"
                if rec.failed_rank is not None
                else "job failed"
            )
            next_world = world
            if self.policy == "shrink" and not rec.timed_out:
                next_world = world - 1
                if next_world < self.min_world:
                    out.write(
                        f"[elastic] {why}; world {world}-1 < min_world "
                        f"{self.min_world} — cannot re-form\n"
                    )
                    out.flush()
                    res.stop_reason = "below_min_world"
                    break
            backoff = restart_backoff(spec, rng, rnd + 1)
            if budget is not None and res.total_elapsed_s + backoff >= budget:
                res.stop_reason = "budget_exhausted"
                break
            if self.replanner is not None and next_world != world:
                # Membership changed: consult the planner at the new world
                # before re-forming. Latency is real recovery time, so it
                # is charged against the whole-job budget like everything
                # else; a replanner failure keeps the old plan.
                t0 = time.time()
                try:
                    rep = self.replanner.replan(next_world, why=why)
                    rep_d = (
                        rep.to_dict() if hasattr(rep, "to_dict") else dict(rep)
                    )
                except Exception as e:
                    rep_d = {
                        "trigger": "membership",
                        "why": why,
                        "old_world": world,
                        "new_world": next_world,
                        "old_key": None,
                        "new_key": None,
                        "switched": False,
                        "latency_s": 0.0,
                        "receipts": [],
                        "calibration": None,
                        "error": f"{type(e).__name__}: {e}",
                    }
                latency = time.time() - t0
                res.total_elapsed_s += latency
                rep_d["round"] = rnd + 1
                res.replans.append(rep_d)
                if rep_d.get("error"):
                    out.write(
                        f"[elastic] re-plan at world {next_world} failed "
                        f"({rep_d['error']}); keeping the old plan\n"
                    )
                else:
                    out.write(
                        f"[elastic] re-plan at world {next_world}: "
                        f"{rep_d.get('old_key')} → {rep_d.get('new_key')}"
                        + (" (engine chain switched)"
                           if rep_d.get("switched") else " (retained)")
                        + f" in {rep_d.get('latency_s', 0.0):.3f}s\n"
                    )
                out.flush()
                get_tracer().instant(
                    "elastic_replan",
                    cat="elastic",
                    args={
                        "round": rnd + 1,
                        "world": next_world,
                        "old_key": rep_d.get("old_key"),
                        "new_key": rep_d.get("new_key"),
                        "switched": bool(rep_d.get("switched")),
                        "latency_s": rep_d.get("latency_s", 0.0),
                        "error": rep_d.get("error"),
                    },
                )
            out.write(
                f"[elastic] {why}; re-form {rnd + 1}/{self.max_reforms}: "
                f"world {world}→{next_world}, fresh port"
                + (f", {backoff:.2f}s backoff" if backoff > 0 else "")
                + "\n"
            )
            out.flush()
            get_tracer().instant(
                "elastic_reform",
                cat="elastic",
                args={
                    "round": rnd + 1,
                    "why": why,
                    "world": next_world,
                    "backoff_s": backoff,
                },
            )
            if backoff > 0:
                time.sleep(backoff)
                res.total_elapsed_s += backoff
            world = next_world
        return res
