"""Static feasibility pruning — every dropped candidate is reported (the
port of ``tpudml/plan/prune.py``).

Three pruning families, checked in order:

1. **capability** — the shared engine composition table
   (``tpudml_torch.capabilities``).  The reason string carries the *exact*
   message the engine constructor would raise, because it is the same
   table entry; planner and runtime cannot skew.
2. **divisibility** — heads/vocab against the ``model`` axis, layers
   against the ``stage`` axis: shapes a manual shard body cannot demote
   its way out of.
3. **hbm** — the closed-form per-chip peak-live preview
   (``score.estimate_hbm``; the verification step holds the winner's
   measured peak to the same budget on the card) against the caller's
   budget.

The contract is *honesty*: ``prune()`` returns every dropped candidate
with its rule and reason — no silent caps, pinned by test.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpudml_torch.capabilities import TABLE, candidate_rejection
from tpudml_torch.plan.score import estimate_hbm
from tpudml_torch.plan.space import Candidate, ModelSpec


@dataclass(frozen=True)
class PruneRecord:
    candidate: Candidate
    rule: str
    reason: str

    def to_dict(self) -> dict:
        return {
            "candidate": self.candidate.to_dict(),
            "rule": self.rule,
            "reason": self.reason,
        }


def _check(spec: ModelSpec, cand: Candidate, hbm_budget_bytes):
    key = candidate_rejection(cand.to_dict())
    if key is not None:
        return f"capability:{key}", TABLE[key].message
    mesh = cand.mesh_dict
    model = mesh.get("model", 1)
    stage = mesh.get("stage", 1)
    if model > 1:
        if spec.num_heads % model:
            return "divisibility", (
                f"num_heads {spec.num_heads} not divisible by the "
                f"'model' axis size {model}"
            )
        if spec.vocab_size % model:
            return "divisibility", (
                f"vocab_size {spec.vocab_size} not divisible by the "
                f"'model' axis size {model}"
            )
    if stage > 1 and spec.num_layers % stage:
        return "divisibility", (
            f"num_layers {spec.num_layers} not divisible by the "
            f"'stage' axis size {stage}"
        )
    if hbm_budget_bytes is not None:
        est = estimate_hbm(spec, cand)
        if est > hbm_budget_bytes:
            return "hbm", (
                f"estimated per-chip peak {est} bytes exceeds the "
                f"budget {hbm_budget_bytes}"
            )
    return None


def prune(
    spec: ModelSpec,
    candidates,
    hbm_budget_bytes: int | None = None,
):
    """(survivors, dropped) — ``len(survivors) + len(dropped)`` always
    equals ``len(candidates)``."""
    survivors, dropped = [], []
    for cand in candidates:
        hit = _check(spec, cand, hbm_budget_bytes)
        if hit is None:
            survivors.append(cand)
        else:
            dropped.append(PruneRecord(cand, *hit))
    return survivors, dropped
