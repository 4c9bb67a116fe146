"""Serve event log → trace spans (the port of ``tpudml/obs/convert.py``):
a pure, deterministic conversion.

The serving engine's event log is already byte-deterministic (tuples of
``(kind, rid, slot, step)`` plus ``("spec", rid, slot, step, accepted)``
on the virtual clock — see ``tpudml_torch/serve/engine.py``), so the observability layer
does NOT instrument the serve loop: it converts the finished report's
events into Chrome trace events after the fact. Two identical runs
therefore produce byte-identical ``trace.json`` files — the determinism
the golden tests pin.

Track model: tid 0 is the queue/admission track (reject / defer /
expire-from-queue, which carry slot −1); tid ``slot+1`` is that decode
slot's track. Each request's residency in a slot becomes one complete
span (``slot<i>:rid<r>``, admit → evict/expire), with the per-event
instants (admit/evict/expire/spec) overlaid on the same track.

Timestamps: ``step × step_time_s`` in microseconds when the engine ran
on its virtual clock, else the raw step index as microseconds — both
integer-exact and run-independent.
"""

from __future__ import annotations

from pathlib import Path

from tpudml_torch.obs.tracer import chrome_trace_doc, dump_trace

QUEUE_EVENTS = ("reject", "defer")


def _ts_us(step: int, step_time_s: float | None) -> int:
    if step_time_s is None:
        return int(step)
    return int(round(step * step_time_s * 1e6))


def serve_trace_events(events: list, step_time_s: float | None = None) -> list[dict]:
    """Chrome trace events (sorted, deterministic) from a serve event log.

    ``events`` is ``ServeReport.events`` verbatim; ``step_time_s`` should
    be the ``ServeConfig.step_time_s`` the run used (None → step-index
    timestamps). Pure function of its inputs."""
    out: list[dict] = []
    open_spans: dict[tuple[int, int], int] = {}  # (rid, slot) -> admit step
    max_step = 0
    for ev in events:
        kind, rid, slot, step = ev[0], int(ev[1]), int(ev[2]), int(ev[3])
        max_step = max(max_step, step)
        tid = 0 if slot < 0 else slot + 1
        args = {"rid": rid, "step": step}
        if kind == "spec":
            args["accepted"] = int(ev[4])
        out.append({
            "name": kind, "cat": "serve", "ph": "i",
            "ts": _ts_us(step, step_time_s), "tid": tid, "s": "t",
            "args": args,
        })
        if kind == "admit":
            open_spans[(rid, slot)] = step
        elif kind in ("evict", "expire") and slot >= 0:
            start = open_spans.pop((rid, slot), None)
            if start is not None:
                out.append(_residency(rid, slot, start, step, step_time_s))
    # Requests still resident when the log ends close at the last step —
    # the honest reading of an in-flight slot.
    for (rid, slot), start in sorted(open_spans.items()):
        out.append(_residency(rid, slot, start, max_step, step_time_s))
    out.sort(key=lambda e: (e["ts"], -e.get("dur", 0), e["tid"],
                            e["name"], repr(e.get("args"))))
    return out


def _residency(rid: int, slot: int, start: int, end: int,
               step_time_s: float | None) -> dict:
    t0 = _ts_us(start, step_time_s)
    return {
        "name": f"slot{slot}:rid{rid}", "cat": "serve", "ph": "X",
        "ts": t0, "dur": max(_ts_us(end, step_time_s) - t0, 0),
        "tid": slot + 1, "args": {"rid": rid, "admit_step": start,
                                  "release_step": end},
    }


def write_serve_trace(
    report,
    path: str | Path,
    step_time_s: float | None = None,
    pid: int | None = None,
) -> Path:
    """``trace.json`` from a finished :class:`ServeReport` — byte-
    deterministic whenever the run itself was (virtual clock + fixed
    workload). ``pid`` defaults to the process group's rank (0 without a group)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = chrome_trace_doc(serve_trace_events(report.events, step_time_s), pid=pid)
    path.write_text(dump_trace(doc))
    return path
