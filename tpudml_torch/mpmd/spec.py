"""MPMD pipeline topology: stage partition, boundary dataflow, quorum (the
port of ``tpudml/mpmd/spec.py``, a copy: it needs no device).

An MPMD pipeline (arXiv 2412.14374) is S independent process groups —
one per stage — that agree only on a *wire contract*. This module is
that contract, kept deliberately jax-free so the controller
(``mpmd/groups.py``), the meshless fixture replay (``mpmd/fixture.py``)
and the unit tests reason about topology without a backend:

- :class:`StageSpec` / :class:`PipelineSpec` — the partition of the
  cluster into stage groups. Stages may differ in data parallelism,
  microbatch count, compute precision, and model code; the *global
  batch* is the one shared unit of account. Composition limits are
  table rejections (``tpudml_torch/capabilities.py`` ``mpmd_*`` entries), so
  the planner prunes infeasible MPMD candidates with receipts instead
  of discovering them as crashes.
- :func:`boundary_plan` — the deterministic transfer list for one
  stage boundary. Global batch rows are the common currency: stage
  ``b`` partitions them by its microbatches then its dp ranks
  (contiguously), stage ``b+1`` by *its* microbatches and ranks, and
  every transfer is an intersection of two such intervals. Both sides
  derive the identical list, which is what makes the (step, microbatch,
  edge) framing in ``comm/p2p.py`` deterministic: the frame's
  microbatch field is the transfer's index in this list.
- :func:`warmup_microbatches` — the 1F1B warmup depth, generalized to
  heterogeneous microbatch counts by measuring warmup in *rows* rather
  than microbatches (the homogeneous formula ``S-1-s`` deadlocks when
  a downstream stage chunks finer than its producer).
- :func:`replace_pipeline` / :func:`drain_order` — re-mesh-in-place
  bookkeeping: which ranks drain in what canonical order after a
  membership event, and what the shrunken pipeline looks like
  (:class:`StageQuorumError` when a stage falls below ``min_world``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

from tpudml_torch.capabilities import reject

__all__ = [
    "StageSpec",
    "PipelineSpec",
    "Transfer",
    "StageQuorumError",
    "boundary_plan",
    "warmup_microbatches",
    "replace_pipeline",
    "drain_order",
]


class StageQuorumError(ValueError):
    """A membership event left some stage below its ``min_world``: the
    pipeline cannot re-form and the controller must halt (the MPMD
    analogue of ``ElasticController``'s min_world stop)."""


@dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: its own process group, schedule and precision.

    ``dtype`` is the stage's *compute and wire* precision — parameters
    are kept in f32 master copies by the runtime regardless.
    ``microbatches`` is per-stage: a bf16 trunk may chunk the global
    batch finer than the f32 head consuming it. ``min_world`` is the
    stage's survival quorum under re-mesh.
    """

    name: str
    dp: int = 1
    microbatches: int = 1
    dtype: str = "float32"
    min_world: int = 1
    moe_experts: int = 0
    fused_xent: bool = False

    def candidate(self) -> dict:
        """This stage as a planner candidate dict — the capability
        table's ``when`` predicates read exactly these keys."""
        return {
            "engine": "mpmd",
            "mpmd": True,
            "moe_experts": self.moe_experts,
            "fused_xent": self.fused_xent,
        }


@dataclass(frozen=True)
class PipelineSpec:
    """A full MPMD pipeline: ordered stages plus the global batch size
    they jointly process. Slots (global process indices) are laid out
    contiguously per stage, in stage order."""

    stages: tuple = ()
    global_batch: int = 0
    serve: bool = False

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))
        if len(self.stages) < 1:
            raise ValueError("PipelineSpec needs at least one stage")
        if self.global_batch < 1:
            raise ValueError("global_batch must be >= 1")
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        for i, s in enumerate(self.stages):
            if s.dp < 1 or s.microbatches < 1:
                raise ValueError(
                    f"stage {s.name}: dp and microbatches must be >= 1"
                )
            if not (1 <= s.min_world <= s.dp):
                raise ValueError(
                    f"stage {s.name}: min_world must be in [1, dp={s.dp}]"
                )
            rows = self.global_batch
            if rows % s.microbatches:
                raise ValueError(
                    f"stage {s.name}: global_batch={rows} not divisible "
                    f"by microbatches={s.microbatches}"
                )
            if (rows // s.microbatches) % s.dp:
                raise ValueError(
                    f"stage {s.name}: microbatch of "
                    f"{rows // s.microbatches} rows not divisible by "
                    f"dp={s.dp}"
                )
            # Literal reject() call sites per composition rule — the
            # capability table's source scan maps each key to its guard.
            if s.moe_experts:
                reject("mpmd_moe_aux_loss")
            if s.fused_xent:
                reject("mpmd_fused_xent_head")
            if self.serve:
                reject("mpmd_serve")

    # ------------------------------------------------------ slot layout

    @property
    def total_slots(self) -> int:
        return sum(s.dp for s in self.stages)

    def stage_slots(self, s: int) -> range:
        """Global slot range of stage ``s`` (contiguous, stage order)."""
        lo = sum(st.dp for st in self.stages[:s])
        return range(lo, lo + self.stages[s].dp)

    def slot_of(self, stage: int, rank: int) -> int:
        return self.stage_slots(stage)[rank]

    def locate(self, slot: int):
        """Global slot -> (stage, stage-local rank)."""
        for s in range(len(self.stages)):
            r = self.stage_slots(s)
            if slot in r:
                return s, slot - r.start
        raise ValueError(f"slot {slot} out of range [0, {self.total_slots})")

    # -------------------------------------------------- row bookkeeping

    def rows_per_rank(self, s: int) -> int:
        st = self.stages[s]
        return self.global_batch // (st.microbatches * st.dp)

    def row_interval(self, s: int, microbatch: int, rank: int):
        """Global row interval [lo, hi) that (stage, microbatch, rank)
        owns under the contiguous layout."""
        st = self.stages[s]
        mb_rows = self.global_batch // st.microbatches
        per_rank = mb_rows // st.dp
        lo = microbatch * mb_rows + rank * per_rank
        return lo, lo + per_rank

    def to_dict(self) -> dict:
        return {
            "global_batch": self.global_batch,
            "serve": self.serve,
            "stages": [
                {
                    "name": s.name,
                    "dp": s.dp,
                    "microbatches": s.microbatches,
                    "dtype": s.dtype,
                    "min_world": s.min_world,
                }
                for s in self.stages
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineSpec":
        return cls(
            stages=tuple(StageSpec(**st) for st in d["stages"]),
            global_batch=int(d["global_batch"]),
            serve=bool(d.get("serve", False)),
        )


@dataclass(frozen=True)
class Transfer:
    """One contiguous row interval crossing one stage boundary: the
    intersection of a (src microbatch, src rank) interval with a
    (dst microbatch, dst rank) interval. ``index`` is the transfer's
    position in the boundary's sorted plan — the deterministic
    ``microbatch`` field of its wire frames."""

    index: int
    edge: str
    src_stage: int
    dst_stage: int
    src_rank: int
    dst_rank: int
    src_microbatch: int
    dst_microbatch: int
    rows: tuple  # global [lo, hi)
    src_rows: tuple  # local to the src rank's microbatch shard
    dst_rows: tuple  # local to the dst rank's microbatch shard


def boundary_plan(spec: PipelineSpec, b: int) -> tuple:
    """Deterministic transfer list for the boundary stage b -> b+1.

    Sorted by global row, which increases with src microbatch, src
    rank, dst microbatch and dst rank simultaneously (contiguous
    layout) — so per-channel frame order agrees with both the sender's
    and the receiver's schedule order, and the 1F1B loops on either
    side can send/recv strictly in plan order without deadlock.
    """
    if not (0 <= b < len(spec.stages) - 1):
        raise ValueError(f"no boundary {b} in a {len(spec.stages)}-stage pipeline")
    src, dst = spec.stages[b], spec.stages[b + 1]
    out = []
    for i in range(src.microbatches):
        for r in range(src.dp):
            slo, shi = spec.row_interval(b, i, r)
            for j in range(dst.microbatches):
                for q in range(dst.dp):
                    dlo, dhi = spec.row_interval(b + 1, j, q)
                    lo, hi = max(slo, dlo), min(shi, dhi)
                    if lo >= hi:
                        continue
                    out.append(
                        Transfer(
                            index=0,
                            edge=f"s{b}r{r}->s{b + 1}r{q}",
                            src_stage=b,
                            dst_stage=b + 1,
                            src_rank=r,
                            dst_rank=q,
                            src_microbatch=i,
                            dst_microbatch=j,
                            rows=(lo, hi),
                            src_rows=(lo - slo, hi - slo),
                            dst_rows=(lo - dlo, hi - dlo),
                        )
                    )
    out.sort(key=lambda t: t.rows)
    return tuple(replace(t, index=k) for k, t in enumerate(out))


def warmup_microbatches(spec: PipelineSpec, s: int) -> int:
    """1F1B warmup depth for stage ``s``, in *its own* microbatches.

    The homogeneous rule (inject ``S-1-s`` microbatches before the
    steady state) assumes every stage chunks the batch identically.
    With per-stage microbatch counts the correct measure is rows: a
    stage must keep enough rows in flight to fill the downstream
    stages' first forward each — ``sum_{t>s} global_batch/m_t`` rows —
    and converts that to its own microbatch granularity, rounding up.
    Reduces to ``S-1-s`` when all counts are equal; caps at ``m_s``.
    """
    stages = spec.stages
    if not (0 <= s < len(stages)):
        raise ValueError(f"no stage {s}")
    if s == len(stages) - 1:
        return 0
    downstream_rows = sum(
        spec.global_batch // stages[t].microbatches
        for t in range(s + 1, len(stages))
    )
    own_rows = spec.global_batch // stages[s].microbatches
    return min(stages[s].microbatches, math.ceil(downstream_rows / own_rows))


def replace_pipeline(spec: PipelineSpec, dead_slots) -> tuple:
    """Shrink the pipeline onto the surviving slots.

    Returns ``(new_spec, slot_map)`` where ``slot_map`` maps every
    surviving old global slot to its new global slot (stage order and
    surviving-rank order are preserved, so a rank's checkpoint shards
    stay attributable). Raises :class:`StageQuorumError` when any
    stage's survivors fall below its ``min_world``, and ``ValueError``
    when the surviving dp no longer divides the stage's microbatch rows
    (the spec validation re-runs on construction).
    """
    dead = set(dead_slots)
    unknown = dead - set(range(spec.total_slots))
    if unknown:
        raise ValueError(f"unknown slots {sorted(unknown)}")
    new_stages = []
    slot_map = {}
    new_slot = 0
    for s, st in enumerate(spec.stages):
        survivors = [r for r in spec.stage_slots(s) if r not in dead]
        if len(survivors) < st.min_world:
            raise StageQuorumError(
                f"stage {st.name}: {len(survivors)} survivors < "
                f"min_world={st.min_world}"
            )
        new_stages.append(replace(st, dp=len(survivors)))
        for old in survivors:
            slot_map[old] = new_slot
            new_slot += 1
    return (
        PipelineSpec(
            stages=tuple(new_stages),
            global_batch=spec.global_batch,
            serve=spec.serve,
        ),
        slot_map,
    )


def drain_order(spec: PipelineSpec, dead_slots) -> tuple:
    """Canonical drain order after a membership event: deepest stage
    first (it holds the fewest in-flight microbatches and its exit
    unblocks the upstream wire), ranks ascending within a stage,
    victims excluded. The fixture replay and the drill's event log both
    emit drains in exactly this order, which is what makes the logs
    byte-deterministic."""
    dead = set(dead_slots)
    out = []
    for s in reversed(range(len(spec.stages))):
        for slot in spec.stage_slots(s):
            if slot not in dead:
                out.append((s, slot - spec.stage_slots(s).start))
    return tuple(out)
