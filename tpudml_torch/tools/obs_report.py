"""Human-readable summary of one run directory's observability artifacts
(the port of ``tools/obs_report.py``, its sections of this layer).

Reads whatever the flight recorder left behind; a missing file skips its
section:

- ``metrics.jsonl``  — the MetricsWriter scalar stream (loss, the
  ``obs/*`` StepStats tags, comm and serve scalars);
- ``trace.json``     — the Chrome trace-event export (per-category span
  count / total / p50 / p99);
- ``obs/drift.json`` — a static-vs-measured drift report, read only if a
  run left one (the port's drift monitor is ROADMAP.md queue 1 item 11).

The elastic, fleet, MPMD and residual sections wait for the modules that
write their files (items 10 and 11).

Usage::

    python -m tpudml_torch.tools.obs_report RUN_DIR
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _fmt_row(cols: list, widths: list[int]) -> str:
    return "  ".join(str(c).ljust(w) for c, w in zip(cols, widths)).rstrip()


def _table(header: list, rows: list[list]) -> str:
    widths = [max(len(str(header[i])), *(len(str(r[i])) for r in rows))
              for i in range(len(header))]
    lines = [_fmt_row(header, widths), _fmt_row(["-" * w for w in widths], widths)]
    lines += [_fmt_row(r, widths) for r in rows]
    return "\n".join(lines)


def metrics_summary(path: Path) -> str | None:
    """Per-tag count / first / last from ``metrics.jsonl`` (every line is
    strict JSON: non-finite values are null with ``"finite": false``)."""
    if not path.is_file():
        return None
    series: dict[str, list] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rec = json.loads(line)
                series.setdefault(rec["tag"], []).append(rec["value"])
    if not series:
        return None

    def fmt(v):
        return "non-finite" if v is None else f"{v:.6g}"

    rows = [[tag, len(vals), fmt(vals[0]), fmt(vals[-1])]
            for tag, vals in sorted(series.items())]
    return _table(["tag", "points", "first", "last"], rows)


def trace_summary(path: Path) -> str | None:
    """Per-(cat, name) span aggregates of an exported ``trace.json``,
    through the live recorder's ``Tracer.summary()``."""
    if not path.is_file():
        return None
    from tpudml_torch.obs.tracer import Tracer

    doc = json.loads(path.read_text())
    tracer = Tracer()
    tracer.add_events([e for e in doc.get("traceEvents", []) if e.get("ph") in ("X", "i")])
    spans = tracer.summary()["spans"]
    if not spans:
        return None
    rows = [[key, st["count"], st["total_us"], st["p50_us"], st["p99_us"]]
            for key, st in spans.items()]
    return _table(["span (cat/name)", "count", "total_us", "p50_us", "p99_us"], rows)


def drift_summary(path: Path) -> str | None:
    """The verdict table of a drift report (``obs/drift.json``), in JAX's
    ``format_drift_table`` layout."""
    if not path.is_file():
        return None
    doc = json.loads(path.read_text())
    lines = [f"{'entrypoint':<16} {'static MB':>10} {'measured MB':>12} {'rel err':>8}  status"]
    for r in doc["records"]:
        lines.append(f"{r['entrypoint']:<16} {r['static_wire_bytes'] / 1e6:>10.3f} "
                     f"{r['measured_wire_bytes'] / 1e6:>12.3f} "
                     f"{r['rel_err'] * 100:>7.2f}%  {r['status']}")
    lines.append(f"worst {doc['worst_rel_err'] * 100:.2f}% vs threshold "
                 f"{doc['threshold'] * 100:.0f}% — " + ("OK" if doc["ok"] else "DRIFT"))
    return "\n".join(lines)


def report(run_dir: str | Path) -> str:
    run_dir = Path(run_dir)
    sections = [
        ("metrics.jsonl", metrics_summary(run_dir / "metrics.jsonl")),
        ("trace.json", trace_summary(run_dir / "trace.json")),
        ("obs/drift.json", drift_summary(run_dir / "obs" / "drift.json")),
    ]
    out = [f"== obs report: {run_dir} =="]
    found = False
    for title, body in sections:
        if body is None:
            continue
        found = True
        out.append(f"\n-- {title} --\n{body}")
    if not found:
        out.append("(no observability artifacts found)")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", help="run directory (MetricsWriter.run_dir)")
    args = p.parse_args(argv)
    if not Path(args.run_dir).is_dir():
        print(f"error: {args.run_dir} is not a directory", file=sys.stderr)
        return 2
    print(report(args.run_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
