"""The autosharding planner: enumerate → prune → score → emit (the port
of ``tpudml.plan``).

Given a :class:`~tpudml_torch.plan.space.ModelSpec` and a device count it

1. **enumerates** the candidate space (``space.py``): mesh factorization
   × engine chain {DP, ZeRO-1, FSDP, TP, FSDP×TP, PP×DP} × zero1-overlap
   × accumulation × fused-kernel / sentinel / obs knobs;
2. **prunes** statically (``prune.py``): divisibility of heads / vocab /
   layers against the axis sizes, HBM over budget through a closed-form
   peak-live estimate, and every engine composition rejection through the
   capability table (``tpudml_torch.capabilities``) the engines
   themselves raise from — planner and runtime cannot disagree;
3. **scores** survivors (``score.py``) on the ring wire model
   (``tpudml_torch.comm.timing.collective_wire_bytes``) plus a roofline
   step-time estimate on the card's constants;
4. **emits** the winner (``emit.py``) as a runnable ``plan.json`` (v2
   schema; v1 files still load) — and verifies it first: the winning
   engine is built in the job it would run in and one train step of it
   is run and checked (finite, replicas equal, within the HBM budget); a
   failing winner is demoted and the next survivor tried, and the step's
   measured wire bytes and peak land in the plan's ``predicted`` block.

The elastic controller re-runs this pipeline at a new world size on a
membership change (``tpudml_torch.elastic.replan.Replanner``), and a
drift report re-scores the lattice with the measured constants folded in
as a :class:`~tpudml_torch.plan.score.Calibration`.

CLI: ``python -m tpudml_torch.plan`` (``--format text|json|github``,
``--no-verify``, ``--check`` for the world-4/8 smoke).
"""

from tpudml_torch.plan.emit import (
    PLAN_VERSION,
    SUPPORTED_PLAN_VERSIONS,
    VERIFY_RULES,
    build_candidate,
    engine_config,
    load_plan,
    make_plan,
    plan_drift_findings,
    plan_to_json,
    verify_candidate,
)
from tpudml_torch.plan.prune import PruneRecord, prune
from tpudml_torch.plan.score import (
    DEFAULT_HARDWARE,
    Calibration,
    Hardware,
    Score,
    estimate_hbm,
    score_candidate,
)
from tpudml_torch.plan.space import (
    Candidate,
    ModelSpec,
    enumerate_candidates,
    flagship_lm,
)

__all__ = [
    "DEFAULT_HARDWARE",
    "PLAN_VERSION",
    "SUPPORTED_PLAN_VERSIONS",
    "VERIFY_RULES",
    "Calibration",
    "Candidate",
    "Hardware",
    "ModelSpec",
    "PruneRecord",
    "Score",
    "build_candidate",
    "engine_config",
    "enumerate_candidates",
    "estimate_hbm",
    "flagship_lm",
    "load_plan",
    "make_plan",
    "plan_drift_findings",
    "plan_to_json",
    "prune",
    "score_candidate",
    "verify_candidate",
]
