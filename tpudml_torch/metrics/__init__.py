"""Metrics of the port: the JSONL scalar writer, the profiler session and
the span timer."""

from tpudml_torch.metrics.profiler import SpanTimer, annotate, trace
from tpudml_torch.metrics.writer import MetricsWriter

__all__ = ["MetricsWriter", "SpanTimer", "annotate", "trace"]
