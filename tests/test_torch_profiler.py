"""The port's profiler layer (``tpudml_torch.metrics.profiler``) against
``tpudml.metrics.profiler``, on the CPU.

- ``SpanTimer``: totals, counts, p50/p99 and the report equal JAX's under
  the same injected clock (``time.perf_counter`` replaced for both), and
  its spans feed a tracer;
- ``trace()`` runs a ``torch.profiler`` session that writes a Chrome
  trace under its directory (CPU activity here), holding the
  ``annotate`` region; disabled, it writes nothing.
"""

import json
import time

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tpudml.metrics.profiler import SpanTimer as JaxSpanTimer  # noqa: E402
from tpudml_torch.metrics import SpanTimer, annotate, trace  # noqa: E402
from tpudml_torch.obs import Tracer, validate_chrome_trace  # noqa: E402


def _clock(durations):
    """A perf_counter that advances by the given durations, one span (two
    reads) each."""
    ticks = []
    t = 100.0
    for d in durations:
        ticks += [t, t + d]
        t += d + 1.0
    it = iter(ticks)
    return lambda: next(it)


DURATIONS = [0.010, 0.030, 0.020, 0.250, 0.015, 0.012, 0.011]


def _spans(timer_cls, monkeypatch):
    monkeypatch.setattr(time, "perf_counter", _clock(DURATIONS))
    timer = timer_cls()
    for i, _ in enumerate(DURATIONS):
        with timer.span("step" if i % 3 else "comm"):
            pass
    monkeypatch.undo()
    return timer


def test_span_timer_percentiles_equal_jax(monkeypatch):
    got, want = _spans(SpanTimer, monkeypatch), _spans(JaxSpanTimer, monkeypatch)
    for name in ("step", "comm"):
        assert got.percentiles(name) == want.percentiles(name)
        assert got.totals[name] == want.totals[name] and got.counts[name] == want.counts[name]
        assert got.mean(name) == want.mean(name)
    assert got.report() == want.report()
    assert got.percentiles("never") == {}


def test_span_timer_feeds_tracer_and_syncs():
    tr = Tracer()
    timer = SpanTimer(tracer=tr)
    for _ in range(3):
        with timer.span("step", sync=torch.ones(1)):
            pass
    rpt = timer.report()
    assert "step: " in rpt and "3 calls" in rpt and "p50 " in rpt and "p99 " in rpt
    assert [(s.cat, s.name) for s in tr.events] == [("timer", "step")] * 3
    validate_chrome_trace(tr.chrome_trace(pid=0))


def test_trace_writes_a_chrome_trace_on_cpu(tmp_path):
    x = torch.randn(64, 64)
    with trace(tmp_path / "profile") as prof:
        with annotate("matmul_region"):
            (x @ x).sum()
    path = prof.trace_path
    assert path.parent == tmp_path / "profile" and path.name == "profile_trace.rank0.json"
    doc = json.loads(path.read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "matmul_region" in names and any("mm" in str(n) for n in names)
    with trace(tmp_path / "off", enabled=False) as none:
        (x @ x).sum()
    assert none is None and not (tmp_path / "off").exists()
