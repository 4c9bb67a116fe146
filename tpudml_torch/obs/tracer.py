"""The flight recorder (the port of ``tpudml/obs/tracer.py``): nested,
thread-safe structured spans exported as one Chrome trace-event
``trace.json``, openable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.

Every telemetry source of the port (``SpanTimer`` wall spans,
``CommStats`` collective timings, the serving engine's event log,
sentinel trips, checkpoint save/restore/verify, launcher restarts) feeds
one :class:`Tracer`; the document has one ``pid`` track per process (the
process group's rank, 0 without a group).

Determinism contract, as in JAX: the export sorts events by ``(ts, -dur,
tid, cat, name)`` and serializes with sorted keys and canonical
separators, so a fixed event log gives byte-identical ``trace.json``.

A disabled tracer allocates nothing: ``Tracer(enabled=False).span(...)``
returns a shared no-op context manager and records no :class:`Span`
(the module counter ``SPANS_ALLOCATED`` lets tests assert it).

``span(sync=x)``: where JAX blocks on ``x`` (``jax.block_until_ready``)
before the span closes, the port synchronizes the card that holds the
tensor ``x`` (or the first tensor of a dict, list or tuple ``x``), so
queued kernels are charged to the span that launched them; on the CPU,
whose ops have finished when they return, it does nothing.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

TRACE_SCHEMA_VERSION = 1

# Every Span ever constructed bumps this: the disabled path's zero
# allocation is asserted against it.
SPANS_ALLOCATED = 0


@dataclass
class Span:
    """One structured event: a complete span (``ph='X'``, with ``dur_us``)
    or an instant (``ph='i'``); integer microseconds on the owning
    tracer's clock (wall for live tracing, the serving engine's virtual
    clock for deterministic conversions)."""

    name: str
    cat: str
    ts_us: int
    dur_us: int = 0
    ph: str = "X"
    tid: int = 0
    args: dict | None = None

    def __post_init__(self):
        global SPANS_ALLOCATED
        SPANS_ALLOCATED += 1


class _NullSpan:
    """Reusable no-op context manager: the whole disabled-tracer path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def sync_device(x) -> None:
    """Wait for the card that holds ``x`` (a tensor, or the first tensor
    of a dict, list or tuple); nothing for CPU tensors or anything else."""
    import torch

    if isinstance(x, dict):
        x = next(iter(x.values()), None)
    elif isinstance(x, (list, tuple)):
        x = x[0] if x else None
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class Tracer:
    """Thread-safe structured-span recorder.

    Usage::

        tracer = Tracer()
        with tracer.span("train_step", cat="step", sync=loss):
            ts, metrics = step(ts, x, y)
        tracer.instant("sentinel_trip", cat="sentinel", args={"step": 7})
        tracer.export(run_dir / "trace.json")

    Nesting is positional (complete events nest by containment per
    ``tid``); each OS thread gets its own track, numbered densely in
    first-seen order.
    """

    def __init__(self, enabled: bool = True, clock=time.perf_counter):
        self.enabled = enabled
        self._clock = clock
        self._t0 = clock() if enabled else 0.0
        self._lock = threading.Lock()
        self.events: list[Span] = []
        self._tids: dict[int, int] = {}

    # ----------------------------------------------------------- recording

    def now_us(self) -> int:
        return int((self._clock() - self._t0) * 1e6)

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _record(self, span: Span) -> None:
        with self._lock:
            self.events.append(span)

    def span(self, name: str, cat: str = "host", sync=None, args: dict | None = None):
        """Context manager timing a host region as a complete span (the
        card of ``sync`` synchronized before it closes). No-op, and no
        allocation, when the tracer is disabled."""
        if not self.enabled:
            return NULL_SPAN
        return self._timed_span(name, cat, sync, args)

    @contextmanager
    def _timed_span(self, name, cat, sync, args) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            if sync is not None:
                sync_device(sync)
            ts_us = int((t0 - self._t0) * 1e6)
            dur_us = int((self._clock() - t0) * 1e6)
            self._record(Span(name, cat, ts_us, dur_us, "X", self._tid(), args))

    def instant(self, name: str, cat: str = "host", args: dict | None = None,
                ts_us: int | None = None) -> None:
        if not self.enabled:
            return
        ts = self.now_us() if ts_us is None else int(ts_us)
        self._record(Span(name, cat, ts, 0, "i", self._tid(), args))

    def add_complete(self, name: str, cat: str, ts_us: int, dur_us: int,
                     args: dict | None = None, tid: int | None = None) -> None:
        """Record a span with explicit timestamps: the feed of quantities
        already timed (``CommStats.add``) and of deterministic conversions
        (serve events on the virtual clock)."""
        if not self.enabled:
            return
        self._record(Span(name, cat, int(ts_us), int(dur_us), "X",
                          self._tid() if tid is None else int(tid), args))

    def add_events(self, events: list[dict]) -> None:
        """Bulk-ingest built trace events (dicts with name/cat/ph/ts/dur/
        tid/args keys: the output of ``tpudml_torch.obs.convert``)."""
        if not self.enabled:
            return
        for e in events:
            self._record(Span(
                e["name"], e.get("cat", "host"), int(e.get("ts", 0)),
                int(e.get("dur", 0)), e.get("ph", "X"),
                int(e.get("tid", 0)), e.get("args"),
            ))

    # ------------------------------------------------------------- export

    def trace_events(self) -> list[dict]:
        """Deterministically sorted Chrome trace events (no pid yet)."""
        with self._lock:
            spans = list(self.events)
        return sorted((_event_dict(s) for s in spans), key=_sort_key)

    def chrome_trace(self, pid: int | None = None) -> dict:
        return chrome_trace_doc(self.trace_events(), pid=pid)

    def export(self, path: str | Path, pid: int | None = None) -> Path:
        """Write ``trace.json`` (schema ``TRACE_SCHEMA_VERSION``); returns
        the path. Byte-deterministic for a fixed event log."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(dump_trace(self.chrome_trace(pid=pid)))
        return path

    def summary(self) -> dict:
        """Deterministic per-(cat, name) aggregate: count, total, and
        p50/p99 microseconds (``CommStats.percentiles``, so every
        percentile of the port interpolates alike)."""
        from tpudml_torch.comm.timing import CommStats

        groups: dict[tuple[str, str], CommStats] = {}
        with self._lock:
            spans = list(self.events)
        for s in spans:
            groups.setdefault((s.cat, s.name), CommStats()).add(s.dur_us * 1e-6)
        out = {}
        for (cat, name), st in sorted(groups.items()):
            pct = st.percentiles()
            out[f"{cat}/{name}"] = {
                "count": st.calls,
                "total_us": int(st.comm_time_s * 1e6),
                "p50_us": int(pct["p50_s"] * 1e6) if pct else 0,
                "p99_us": int(pct["p99_s"] * 1e6) if pct else 0,
            }
        return {"schema": TRACE_SCHEMA_VERSION, "spans": out}


def _event_dict(s: Span) -> dict:
    e = {"name": s.name, "cat": s.cat, "ph": s.ph, "ts": s.ts_us, "tid": s.tid}
    if s.ph == "X":
        e["dur"] = s.dur_us
    else:
        e["s"] = "t"  # instant scope: thread
    if s.args:
        e["args"] = s.args
    return e


def _sort_key(e: dict):
    # Parents (longer spans) sort before their children at equal ts, as
    # trace viewers need for nesting.
    return (e["ts"], -e.get("dur", 0), e["tid"], e["cat"], e["name"])


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def chrome_trace_doc(events: list[dict], pid: int | None = None) -> dict:
    """Wrap sorted trace events in the Chrome trace-event document:
    metadata naming the process track (``pid`` defaults to the process
    group's rank, 0 without a group), then the events stamped with it."""
    if pid is None:
        pid = _process_index()
    stamped = [dict(e, pid=pid) for e in events]
    meta = {
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"tpudml process {pid}"},
    }
    return {
        "displayTimeUnit": "ms",
        "metadata": {"tpudml_trace_schema": TRACE_SCHEMA_VERSION},
        "traceEvents": [meta] + stamped,
    }


def dump_trace(doc: dict) -> str:
    """Canonical serialization: sorted keys, no whitespace."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"


def merge_chrome_traces(docs: list[dict]) -> dict:
    """Merge per-process trace documents (one per rank, distinct pids) into
    one multi-track document. Each input must validate; two inputs with
    the same pid raise. Deterministic: metadata tracks by pid, then the
    events in :meth:`Tracer.trace_events` order with pid leading."""
    metas: dict[int, dict] = {}
    events: list[dict] = []
    for doc in docs:
        validate_chrome_trace(doc)
        for e in doc["traceEvents"]:
            if e["ph"] == "M":
                if e["pid"] in metas:
                    raise ValueError(
                        f"duplicate pid {e['pid']} across trace documents"
                    )
                metas[e["pid"]] = e
            else:
                events.append(e)
    events.sort(key=lambda e: (e["pid"],) + _sort_key(e))
    return {
        "displayTimeUnit": "ms",
        "metadata": {"tpudml_trace_schema": TRACE_SCHEMA_VERSION},
        "traceEvents": [metas[p] for p in sorted(metas)] + events,
    }


def validate_chrome_trace(doc: dict) -> None:
    """Schema check of an exported trace document: ValueError on the first
    violation of the Chrome trace-event contract."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must be a dict with 'traceEvents'")
    if doc.get("metadata", {}).get("tpudml_trace_schema") != TRACE_SCHEMA_VERSION:
        raise ValueError("missing/unknown tpudml_trace_schema version")
    for i, e in enumerate(doc["traceEvents"]):
        for key in ("name", "ph", "pid", "tid"):
            if key not in e:
                raise ValueError(f"event {i} missing {key!r}: {e}")
        if e["ph"] == "X":
            if not isinstance(e.get("ts"), int) or not isinstance(e.get("dur"), int):
                raise ValueError(f"event {i}: complete events need int ts/dur")
        elif e["ph"] == "i":
            if not isinstance(e.get("ts"), int):
                raise ValueError(f"event {i}: instant events need int ts")
        elif e["ph"] != "M":
            raise ValueError(f"event {i}: unknown phase {e['ph']!r}")


# ------------------------------------------------------- ambient tracer
#
# Cross-cutting layers (checkpoint store, launcher, sentinel hook) emit
# into the ambient tracer; it defaults to a disabled one, so runs without
# it pay one check and allocate nothing.

NULL_TRACER = Tracer(enabled=False)
_ambient: Tracer = NULL_TRACER
_ambient_lock = threading.Lock()


def get_tracer() -> Tracer:
    return _ambient


def set_tracer(tracer: Tracer | None) -> Tracer:
    """Install ``tracer`` as the ambient tracer (None: disabled); returns
    the previous one."""
    global _ambient
    with _ambient_lock:
        prev = _ambient
        _ambient = tracer if tracer is not None else NULL_TRACER
    return prev


@contextmanager
def use_tracer(tracer: Tracer | None) -> Iterator[Tracer]:
    """Scoped :func:`set_tracer`."""
    prev = set_tracer(tracer)
    try:
        yield get_tracer()
    finally:
        set_tracer(prev)
