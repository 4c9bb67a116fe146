"""Metrics of the port: the JSONL scalar writer."""

from tpudml_torch.metrics.writer import MetricsWriter

__all__ = ["MetricsWriter"]
