"""Tracing and profiling (the port of ``tpudml/metrics/profiler.py``).

The reference times with inline ``time.time()`` spans and recommends
``torch.cuda.Event`` timing (codes/task2/model-mp.py:48-79,
sections/task2.tex:69-80). Two layers, as in JAX:

- :func:`trace` is a ``torch.profiler`` session (CPU activity, and CUDA
  activity where a card is present) that writes a Chrome trace under
  ``log_dir``: per-kernel device time, launches and the host ops around
  them, openable in Perfetto. It stands where JAX captures an XLA
  profile with ``jax.profiler``.
- :class:`SpanTimer` is the host wall-clock layer: named spans with
  totals, counts and p50/p99, the card of ``sync=`` synchronized before
  a span closes (the reference's Event recipe), each span also fed to a
  :class:`tpudml_torch.obs.Tracer` when one is given.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator

TRACE_FILE = "profile_trace.rank{rank}.json"


@contextmanager
def trace(log_dir: str | Path, enabled: bool = True) -> Iterator[object]:
    """Profile the body with ``torch.profiler`` and write its Chrome trace
    to ``log_dir/profile_trace.rank<r>.json`` (r: the process group's
    rank, 0 without one); yields the profiler, whose ``trace_path`` names
    the file once the body has ended. ``enabled=False`` yields None and
    records nothing, so call sites can pass a config flag through."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpudml_torch.obs.tracer import _process_index

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / TRACE_FILE.format(rank=_process_index())
    prof = profile(activities=activities)
    with prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    prof.trace_path = path


def annotate(name: str):
    """Label a host region on the profiler's timeline
    (``torch.profiler.record_function``, where JAX has
    ``jax.profiler.TraceAnnotation``)."""
    import torch

    return torch.profiler.record_function(name)


class SpanTimer:
    """Named wall-clock spans with device synchronization.

    ``sync=`` names a tensor whose card is synchronized before the span
    closes, so the kernels queued inside are charged to it. Each span's
    per-call durations feed a ``CommStats``, so ``report()`` carries
    p50/p99 beside the mean, interpolated as every other percentile of
    the port. A ``tracer=`` receives every span as a trace event.

    Usage::

        timer = SpanTimer()
        with timer.span("step", sync=loss):
            ts, metrics = step(ts, x, y)
        print(timer.report())
    """

    def __init__(self, tracer=None):
        from tpudml_torch.comm.timing import CommStats

        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.stats: dict[str, CommStats] = defaultdict(CommStats)
        self.tracer = tracer

    @contextmanager
    def span(self, name: str, sync=None) -> Iterator[None]:
        from tpudml_torch.obs.tracer import sync_device

        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync_device(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.stats[name].add(dt)
            if self.tracer is not None and self.tracer.enabled:
                dur_us = int(dt * 1e6)
                self.tracer.add_complete(
                    name, cat="timer",
                    ts_us=max(self.tracer.now_us() - dur_us, 0),
                    dur_us=dur_us,
                )

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def percentiles(self, name: str) -> dict:
        """p50/p99 seconds of one span (``{}`` before any call)."""
        return self.stats[name].percentiles()

    def report(self) -> str:
        parts = []
        for name in sorted(self.totals):
            line = (
                f"{name}: {self.totals[name]:.4f}s over {self.counts[name]} "
                f"calls (mean {self.mean(name) * 1e3:.2f}ms"
            )
            pct = self.percentiles(name)
            if pct:
                line += (f", p50 {pct['p50_s'] * 1e3:.2f}ms,"
                         f" p99 {pct['p99_s'] * 1e3:.2f}ms")
            parts.append(line + ")")
        return "\n".join(parts)
