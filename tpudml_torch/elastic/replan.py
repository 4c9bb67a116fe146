"""Adaptive re-planning: the planner as a runtime controller (the port of
``tpudml/elastic/replan.py``).

``tpudml_torch.plan`` decides a config once; the elastic controller makes
failure a membership event. This module closes the loop between them:

- **membership trigger** — on a shrink (or grow-back) the
  :class:`ElasticController` hands the new world size to
  :meth:`Replanner.replan` *before* re-forming. The planner re-runs
  enumerate → prune → score at the new world and may pick a different
  engine chain entirely (world 2 ZeRO-1+accum → world 1 plain DP); the
  sharded checkpoint's any-world-restores-any-world property makes the
  switch a restore, not a retrain. Every re-plan stamps the plan's v2
  ``replan`` block with the old winner and machine-readable
  **receipts** for why the old config lost at the new world;
- **drift trigger** — :meth:`Replanner.on_drift` feeds measured
  static-vs-measured records (``obs/drift.py``, its 10% threshold)
  through
  :class:`~tpudml_torch.plan.score.Calibration` and re-scores the lattice
  with the measured constants folded into the roofline: the cost model
  calibrates itself instead of ranking with a constant it has been
  shown to be wrong by. A fresh (in-threshold) report produces **no**
  re-plan — no false positives;
- **fixture replay** — :func:`replay_fixture` runs the whole loop over
  a pre-recorded membership/drift event stream, so controller +
  planner logic is exercised in CI without spawning a process group or
  touching a device (``verify=False`` plans never build an engine).

Receipt verdicts (machine-readable, one per re-plan, for the old
winner re-instantiated at the new world):

- ``infeasible_at_world`` — the old engine chain has no mesh at the
  new world (e.g. ZeRO-1 on one chip shards nothing);
- ``pruned`` — the shared capability/divisibility/HBM rules dropped it
  (the receipt carries the prune rule + reason verbatim);
- ``outranked`` — feasible, but a different candidate scores better
  (the receipt carries the rank and the slowdown ratio);
- ``retained`` — the old config is still the winner (no switch).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

from tpudml_torch.obs.drift import DEFAULT_THRESHOLD, build_drift_report, drift_from_pairs
from tpudml_torch.plan.emit import load_plan, make_plan, plan_to_json
from tpudml_torch.plan.score import DEFAULT_HARDWARE, Calibration
from tpudml_torch.plan.space import ModelSpec, _engine_meshes, flagship_lm

#: Candidate knobs that identify "the same config" across world sizes
#: (everything except the mesh, which necessarily changes with world).
_CONFIG_KNOBS = (
    "engine", "zero1", "zero1_overlap", "accum_steps", "fused_xent",
    "sentinel", "obs",
)


@dataclass
class ReplanRecord:
    """One re-plan decision — the telemetry row the drill/bench report."""

    trigger: str  # "membership" | "drift"
    why: str
    old_world: int
    new_world: int
    old_key: str | None
    new_key: str | None
    switched: bool
    latency_s: float
    receipts: list = field(default_factory=list)
    calibration: dict | None = None
    error: str | None = None

    def to_dict(self) -> dict:
        return {
            "trigger": self.trigger,
            "why": self.why,
            "old_world": self.old_world,
            "new_world": self.new_world,
            "old_key": self.old_key,
            "new_key": self.new_key,
            "switched": self.switched,
            "latency_s": self.latency_s,
            "receipts": list(self.receipts),
            "calibration": self.calibration,
            "error": self.error,
        }


def _knobs(cand: dict) -> tuple:
    return tuple(cand[k] for k in _CONFIG_KNOBS)


def _receipts(old_plan: dict, new_plan: dict) -> list:
    """Why the old plan's winner is not the new plan's winner (or is).

    The old winner is matched *by knobs* (engine chain + flags, mesh
    excluded) against the new plan's ranking and prune records — the
    honest question is "what happened to this config re-instantiated at
    the new world", not string equality of mesh-bearing keys.
    """
    old = old_plan["winner"]["candidate"]
    target = _knobs(old)
    new_world = new_plan["world"]

    if not _engine_meshes(old["engine"], new_world):
        return [{
            "candidate": old["key"],
            "verdict": "infeasible_at_world",
            "reason": (
                f"engine {old['engine']!r} has no mesh at world "
                f"{new_world}: nothing left to shard"
            ),
        }]

    out = []
    for rank, entry in enumerate(new_plan["ranking"]):
        if _knobs(entry["candidate"]) != target:
            continue
        if rank == 0:
            out.append({
                "candidate": entry["candidate"]["key"],
                "verdict": "retained",
                "reason": "old config still ranks first at the new world",
            })
        else:
            winner = new_plan["ranking"][0]
            ratio = (
                entry["score"]["per_token_s"]
                / winner["score"]["per_token_s"]
            )
            out.append({
                "candidate": entry["candidate"]["key"],
                "verdict": "outranked",
                "rank": rank,
                "slowdown_vs_winner": ratio,
                "reason": (
                    f"ranked #{rank + 1} at world {new_world}: "
                    f"{ratio:.3f}x the winner's per-token time"
                ),
            })
        break
    for rec in new_plan["pruned"]:
        if _knobs(rec["candidate"]) == target:
            out.append({
                "candidate": rec["candidate"]["key"],
                "verdict": "pruned",
                "rule": rec["rule"],
                "reason": rec["reason"],
            })
    if not out:
        out.append({
            "candidate": old["key"],
            "verdict": "infeasible_at_world",
            "reason": (
                f"config not enumerable at world {new_world} "
                f"(no candidate with matching knobs)"
            ),
        })
    return out


class Replanner:
    """Holds the current plan and re-runs the planner on triggers.

    ``verify=False`` (the default) builds nothing — scores come from the
    analytic roofline and no engine or device is touched, which is what
    lets the controller consult the planner from inside a supervision
    loop (and the fixture replay run in CI). ``hw`` are the roofline's
    constants (the card's by default). ``plan_path`` (optional) is kept up to date with the
    current plan after every (re-)plan — the file ``--plan``-consuming
    child commands read, so the next incarnation picks the new config
    up through the existing explicit-CLI-wins merge.

    Re-planning **fails open**: a planner error (no feasible candidate
    at the new world, unwritable plan file) is caught and recorded on
    the returned :class:`ReplanRecord` — the controller proceeds with
    the old plan rather than dying inside recovery.
    """

    def __init__(
        self,
        spec: ModelSpec | None = None,
        *,
        engines=None,
        hbm_budget_bytes: int | None = None,
        verify: bool = False,
        plan_path: str | Path | None = None,
        hw=DEFAULT_HARDWARE,
    ):
        self.spec = spec if spec is not None else flagship_lm()
        self.hw = hw
        self.engines = list(engines) if engines is not None else None
        self.hbm_budget_bytes = hbm_budget_bytes
        self.verify = verify
        self.plan_path = Path(plan_path) if plan_path is not None else None
        self.plan: dict | None = None
        self.calibration: Calibration | None = None

    # ------------------------------------------------------------- plumbing

    def _emit(self, plan: dict) -> None:
        self.plan = plan
        if self.plan_path is not None:
            self.plan_path.parent.mkdir(parents=True, exist_ok=True)
            self.plan_path.write_text(plan_to_json(plan))

    def _make(self, world: int, replan: dict | None) -> dict:
        return make_plan(
            self.spec,
            world,
            hbm_budget_bytes=self.hbm_budget_bytes,
            engines=self.engines,
            verify=self.verify,
            calibration=self.calibration,
            replan=replan,
            hw=self.hw,
        )

    @property
    def winner_key(self) -> str | None:
        if self.plan is None:
            return None
        return self.plan["winner"]["candidate"]["key"]

    # ------------------------------------------------------------- triggers

    def initial_plan(self, world: int) -> dict:
        """Plan the first incarnation (no trigger, no receipts)."""
        self._emit(self._make(world, None))
        return self.plan

    def load_existing(self, path: str | Path) -> dict | None:
        """Adopt an existing plan.json as the current plan — *tolerant*:
        a vandalized / truncated / wrong-version file returns None (and
        leaves the current plan unchanged) instead of raising, so a
        corrupted plan file degrades to re-planning from scratch."""
        try:
            plan = load_plan(str(path))
            # A plan must at least name a winner + world to be usable.
            plan["winner"]["candidate"]["key"]
            int(plan["world"])
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError):
            return None
        self.plan = plan
        return plan

    def replan(
        self,
        world: int,
        *,
        why: str = "membership change",
        trigger: str = "membership",
    ) -> ReplanRecord:
        """Re-run the planner at ``world`` and record the decision."""
        old_plan = self.plan
        old_key = self.winner_key
        old_world = old_plan["world"] if old_plan else 0
        t0 = time.perf_counter()
        try:
            provenance = None
            if old_plan is not None:
                # Receipts need the new plan; plan twice-cheaply is
                # avoided by stamping provenance after the fact on the
                # same dict (make_plan records it verbatim).
                provenance = {
                    "trigger": trigger,
                    "why": why,
                    "old_world": old_world,
                    "old_winner": dict(old_plan["winner"]["candidate"]),
                    "receipts": [],
                }
            new_plan = self._make(world, provenance)
            if provenance is not None:
                provenance["receipts"] = _receipts(old_plan, new_plan)
            self._emit(new_plan)
        except Exception as e:  # fail open: recovery must not die here
            return ReplanRecord(
                trigger=trigger,
                why=why,
                old_world=old_world,
                new_world=world,
                old_key=old_key,
                new_key=old_key,
                switched=False,
                latency_s=time.perf_counter() - t0,
                receipts=[],
                calibration=None,
                error=f"{type(e).__name__}: {e}",
            )
        return ReplanRecord(
            trigger=trigger,
            why=why,
            old_world=old_world,
            new_world=world,
            old_key=old_key,
            new_key=self.winner_key,
            switched=old_key is not None and old_key != self.winner_key,
            latency_s=time.perf_counter() - t0,
            receipts=list(
                (self.plan.get("replan") or {}).get("receipts", ())
            ),
            calibration=self.plan.get("calibration"),
        )

    def on_drift(
        self,
        pairs: list[dict],
        threshold: float | None = None,
    ) -> ReplanRecord | None:
        """Drift-triggered re-score at the *current* world.

        ``pairs`` are drift fixture pairs (``entrypoint`` +
        ``static_wire_bytes`` + ``measured_wire_bytes``). In-threshold reports
        return None — the plan stands, no false-positive re-plan. Past
        the threshold, the measured constants become a
        :class:`Calibration` and the lattice is re-scored with them.
        """
        if self.plan is None:
            raise RuntimeError("on_drift needs a current plan")
        thr = DEFAULT_THRESHOLD if threshold is None else threshold
        report = build_drift_report(drift_from_pairs(pairs), thr)
        if report["ok"]:
            return None
        worst = max(
            report["records"], key=lambda r: r["rel_err"]
        )
        self.calibration = Calibration.from_drift_records(
            report["records"], source="obs/drift"
        )
        return self.replan(
            self.plan["world"],
            why=(
                f"measured drift {worst['rel_err']:.1%} > "
                f"{thr:.0%} at {worst['entrypoint']}"
            ),
            trigger="drift",
        )


# ------------------------------------------------------------ fixture replay

FIXTURE_VERSION = 1


def replay_fixture(
    fixture: dict | str | Path,
    *,
    plan_path: str | Path | None = None,
    sink=None,
    hw=DEFAULT_HARDWARE,
) -> dict:
    """Replay a pre-recorded membership/drift event stream — the
    process-free mode of ``python -m tpudml_torch.elastic --drill
    --fixture`` (scored on ``hw``).

    Fixture schema (``tests/elastic_fixtures/*.json``)::

        {
          "version": 1,
          "engines": ["dp", "zero1"] | null,   # null → all engines
          "spec": ModelSpec.to_dict() | null,  # null → flagship_lm()
          "initial_world": int,
          "events": [
            {"type": "membership", "world": int, "why": str},
            {"type": "drift", "pairs": [  # obs drift fixture pairs
                {"entrypoint", "static_wire_bytes",
                 "measured_wire_bytes"}, ...]},
            ...
          ]
        }

    Returns the replay report: every re-plan record, the switch/firing
    counts, and the final plan summary. ``ok`` is False iff any
    re-plan errored out.
    """
    if not isinstance(fixture, dict):
        fixture = json.loads(Path(fixture).read_text())
    ver = fixture.get("version")
    if ver != FIXTURE_VERSION:
        raise ValueError(
            f"fixture version {ver!r} != supported {FIXTURE_VERSION}"
        )
    spec = (
        ModelSpec.from_dict(fixture["spec"])
        if fixture.get("spec")
        else flagship_lm()
    )
    rp = Replanner(
        spec,
        engines=fixture.get("engines"),
        verify=False,
        plan_path=plan_path,
        hw=hw,
    )
    rp.initial_plan(int(fixture["initial_world"]))
    initial_key = rp.winner_key

    def emit(msg: str) -> None:
        if sink is not None:
            sink.write(msg + "\n")
            sink.flush()

    emit(f"[replay] initial world {fixture['initial_world']}: {initial_key}")
    replans: list[ReplanRecord] = []
    drift_checks = 0
    drift_firings = 0
    for ev in fixture.get("events", ()):
        kind = ev.get("type")
        if kind == "membership":
            rec = rp.replan(
                int(ev["world"]), why=ev.get("why", "membership change")
            )
            replans.append(rec)
            emit(
                f"[replay] membership → world {rec.new_world}: "
                f"{rec.old_key} → {rec.new_key}"
                + (" (switched)" if rec.switched else "")
                + (f" ERROR {rec.error}" if rec.error else "")
            )
        elif kind == "drift":
            drift_checks += 1
            rec = rp.on_drift(ev["pairs"], ev.get("threshold"))
            if rec is None:
                emit("[replay] drift check: in threshold, no re-plan")
                continue
            drift_firings += 1
            replans.append(rec)
            emit(
                f"[replay] drift fired: {rec.why} → {rec.new_key} "
                f"(comm_scale "
                f"{(rec.calibration or {}).get('comm_scale', 1.0):.3f})"
            )
        else:
            raise ValueError(f"unknown fixture event type {kind!r}")
    return {
        "initial": {
            "world": int(fixture["initial_world"]),
            "winner": initial_key,
        },
        "events": len(fixture.get("events", ())),
        "replans": [r.to_dict() for r in replans],
        "plan_switches": sum(
            1 for r in replans if r.switched and not r.error
        ),
        "drift_checks": drift_checks,
        "drift_firings": drift_firings,
        "final": {
            "world": rp.plan["world"],
            "winner": rp.winner_key,
            "engine_config": dict(rp.plan["engine_config"]),
            "calibration": rp.plan["calibration"],
        },
        "ok": not any(r.error for r in replans),
    }
