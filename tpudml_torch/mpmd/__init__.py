"""MPMD pipelines: multi-controller stage groups with point-to-point
transfer and re-mesh in place (the port of ``tpudml.mpmd``).

One process group cannot span programs that differ in code, precision or
schedule, so an MPMD pipeline (arXiv 2412.14374) runs S *independent*
groups, one a stage, agreeing only on a wire contract:

- ``tpudml_torch.mpmd.spec`` — the topology: stage partition,
  deterministic boundary transfer plans, heterogeneous 1F1B warm-up
  depths, re-mesh bookkeeping (quorum, drain order);
- ``tpudml_torch.comm.p2p`` — the boundary channel: (step, microbatch,
  edge) framed tensors over TCP, JAX's frames byte for byte, priced in
  the shared ring wire model, plus the intra-stage drain barrier;
- ``tpudml_torch.mpmd.runtime`` — the stage programs (their own
  microbatch count and compute dtype, f32 master parameters, on the card
  or the CPU) and the 1F1B host loop; a stage's replicas sum their
  gradients over gloo, so several stage processes can share one card;
- ``tpudml_torch.mpmd.groups`` — :class:`MPMDController`: forms every
  stage group on fresh ports a round, gates each round's spec through
  the protocol checker, supervises the groups concurrently, and on rank
  death drains the survivors, consults the planner fail-open and
  re-forms the shrunken pipeline *in place* from the common checkpoint
  step;
- ``tpudml_torch.mpmd.drill`` / ``tpudml_torch.mpmd.fixture`` — the e2e
  kill drill (CRC bit-exactness against an uninterrupted reference) and
  the meshless membership/transfer event replay.

Only the device-free layers are imported here; ``runtime`` and ``drill``
load on first use.
"""

from tpudml_torch.mpmd.groups import (
    MPMDController,
    MPMDReformRecord,
    MPMDResult,
    common_resume_step,
    drain_marker_path,
    read_drain_markers,
    stage_ckpt_dir,
    write_wiring,
)
from tpudml_torch.mpmd.spec import (
    PipelineSpec,
    StageQuorumError,
    StageSpec,
    Transfer,
    boundary_plan,
    drain_order,
    replace_pipeline,
    warmup_microbatches,
)

__all__ = [
    "MPMDController",
    "MPMDReformRecord",
    "MPMDResult",
    "PipelineSpec",
    "StageQuorumError",
    "StageSpec",
    "Transfer",
    "boundary_plan",
    "common_resume_step",
    "drain_marker_path",
    "drain_order",
    "read_drain_markers",
    "replace_pipeline",
    "stage_ckpt_dir",
    "warmup_microbatches",
    "write_wiring",
]
