"""Static analysis of the port (the port of ``tpudml.analysis``): the
pre-flight lint for distributed training and serving on the card.

- the **graph pass** (``graph_pass``, rules J1xx) captures one real step
  of each engine of the port (``entrypoints``: the same 16 names as
  JAX's) through ``capture`` and reads the record for the hazards that
  otherwise show only at scale: collectives on groups that stand for no
  mesh axis, device→host reads in the step, stray bf16→f32 upcasts,
  megabyte constants the step closes over, double-buffered state, the
  unsharded head on a vocab-sharded kernel, replicated updates under a
  data axis, the decode steps' full-sequence softmax, pool-wide paged
  attention and unfused tails, and updates with no finiteness check;
- the **AST pass** (``ast_pass``, rules A2xx and P304) lints the source
  for what one captured step cannot show: Python control flow over
  tensors, repeated random draws, epoch loops without ``set_epoch``,
  host-clock timing without a synchronize, and port-reservation
  discipline;
- the **protocol pass** (``protocol``, rules P300–P303) checks the
  composed schedules of every (stage, rank) of an MPMD pipeline, with no
  device, which is why ``MPMDController`` runs it as its pre-launch gate;
  ``traced_collective_events`` gives it a stage's captured collectives.

Run it as ``python -m tpudml_torch.analysis`` (``--strict`` for CI, with
the committed ``tpudml_torch/analysis/allowlist.toml``; ``--device cpu``
to capture on the CPU). J102, the dataflow rules J112–J116, the cost
reports and J118 are ROADMAP.md queue 1 item 11's next slice.
"""

from tpudml_torch.analysis.allowlist import load_allowlist, split_allowed, unused_entries
from tpudml_torch.analysis.ast_pass import analyze_file, analyze_source, analyze_tree
from tpudml_torch.analysis.capture import Capture, capture
from tpudml_torch.analysis.entrypoints import ENTRYPOINTS, analyze_entrypoint, analyze_entrypoints
from tpudml_torch.analysis.findings import RULES, Finding, sort_findings
from tpudml_torch.analysis.graph_pass import (
    CHECKED_RULES,
    analyze_callable,
    analyze_capture,
    collective_shape_signature,
    donation_findings,
)
from tpudml_torch.analysis.protocol import (
    Ev,
    analyze_pipeline,
    analyze_protocol_surface,
    build_schedules,
    check_schedules,
    protocol_surface,
    traced_collective_events,
    validate_fixture_events,
)

__all__ = [
    "CHECKED_RULES",
    "RULES",
    "Capture",
    "ENTRYPOINTS",
    "Ev",
    "Finding",
    "analyze_callable",
    "analyze_capture",
    "analyze_entrypoint",
    "analyze_entrypoints",
    "analyze_file",
    "analyze_pipeline",
    "analyze_protocol_surface",
    "analyze_source",
    "analyze_tree",
    "build_schedules",
    "capture",
    "check_schedules",
    "collective_shape_signature",
    "donation_findings",
    "load_allowlist",
    "protocol_surface",
    "sort_findings",
    "split_allowed",
    "traced_collective_events",
    "unused_entries",
    "validate_fixture_events",
]
