"""Static analysis of the port (the port of ``tpudml.analysis``), as far
as it is ported: the finding model (``findings``) and the cross-rank
protocol pass over MPMD pipelines (``protocol``, rules P300–P303), which
``MPMDController`` runs as its pre-launch gate. The graph passes (J1xx),
the AST pass (A2xx, P304), the cost reports and the CLI are ROADMAP.md
queue 1 item 11."""

from tpudml_torch.analysis.findings import RULES, Finding, sort_findings
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
    "RULES",
    "Ev",
    "Finding",
    "analyze_pipeline",
    "analyze_protocol_surface",
    "build_schedules",
    "check_schedules",
    "protocol_surface",
    "sort_findings",
    "traced_collective_events",
    "validate_fixture_events",
]
