"""The observability layer of the port (``tpudml.obs``; the drift
monitor's live regimes and ``python -m tpudml_torch.obs --check-drift``
wait for the analyzers' dataflow pass, ROADMAP.md queue 1 item 11):

- :mod:`tpudml_torch.obs.tracer`    — structured spans → Perfetto ``trace.json``.
- :mod:`tpudml_torch.obs.stepstats` — the DP step's :class:`StepStats`.
- :mod:`tpudml_torch.obs.convert`   — serve event log → trace spans (pure).
- :mod:`tpudml_torch.obs.drift`     — static-vs-measured drift records and
  reports (pure: from measured pairs).
"""

from tpudml_torch.obs.convert import serve_trace_events, write_serve_trace
from tpudml_torch.obs.stepstats import StepStats, make_step_stats
from tpudml_torch.obs.tracer import (
    NULL_SPAN,
    NULL_TRACER,
    TRACE_SCHEMA_VERSION,
    Span,
    Tracer,
    chrome_trace_doc,
    dump_trace,
    get_tracer,
    merge_chrome_traces,
    set_tracer,
    use_tracer,
    validate_chrome_trace,
)

__all__ = [
    "NULL_SPAN",
    "NULL_TRACER",
    "TRACE_SCHEMA_VERSION",
    "Span",
    "StepStats",
    "Tracer",
    "chrome_trace_doc",
    "dump_trace",
    "get_tracer",
    "make_step_stats",
    "merge_chrome_traces",
    "serve_trace_events",
    "set_tracer",
    "use_tracer",
    "validate_chrome_trace",
    "write_serve_trace",
]
