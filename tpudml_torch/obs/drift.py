"""Static-vs-measured drift monitor, its pure half (the port of
``tpudml/obs/drift.py``).

A planner that prices candidates with a cost model that has drifted from
the measured path ranks them wrong. A drift record compares, for one
entrypoint, the static wire bytes against the measured ones (both on the
ring model of ``comm.timing.collective_wire_bytes``) and carries the
relative error; a report stamps each record against a threshold (default
10%) and rolls them up. ``drift_from_pairs`` builds records from
pre-measured pairs (fixtures, the elastic re-planner's drift trigger);
``obs/drift.json`` is where a report is written.

JAX measures its live regimes (:func:`measure_regime`,
:func:`drift_records`) by tracing the fused step through its dataflow
interpreter; the port's analyzers are not ported yet, so those two raise.
"""

from __future__ import annotations

import json
import os
from typing import Any

DRIFT_REPORT_VERSION = 1
DEFAULT_THRESHOLD = 0.10
DRIFT_REPORT_PATH = os.path.join("obs", "drift.json")

_NOT_PORTED = ("needs the step's static wire bytes from analysis/dataflow.py, which is "
               "not ported yet (ROADMAP.md queue 1 item 11)")


def measure_regime(name: str) -> dict:
    """A live regime's drift record: the static side needs the dataflow pass."""
    raise NotImplementedError(f"measure_regime {_NOT_PORTED}")


def drift_records(names: list[str] | None = None) -> list[dict]:
    """Every live regime's drift record: the static side needs the dataflow pass."""
    raise NotImplementedError(f"drift_records {_NOT_PORTED}")


def _record(entrypoint: str, static: float, measured: float,
            **extra: Any) -> dict:
    rel_err = abs(static - measured) / measured if measured > 0 else (
        0.0 if static == 0 else float("inf"))
    return {
        "entrypoint": entrypoint,
        "static_wire_bytes": static,
        "measured_wire_bytes": measured,
        "rel_err": rel_err,
        **extra,
    }


def drift_from_pairs(pairs: list[dict]) -> list[dict]:
    """Records from pre-measured (static, measured) pairs — the fixture/
    CI path. Each pair needs ``entrypoint``, ``static_wire_bytes``,
    ``measured_wire_bytes``; extra keys ride along."""
    out = []
    for p in pairs:
        extra = {k: v for k, v in p.items()
                 if k not in ("entrypoint", "static_wire_bytes",
                              "measured_wire_bytes")}
        out.append(_record(p["entrypoint"], float(p["static_wire_bytes"]),
                           float(p["measured_wire_bytes"]), **extra))
    return out


def build_drift_report(records: list[dict],
                       threshold: float = DEFAULT_THRESHOLD) -> dict:
    """Stamp each record OK/WARN against ``threshold`` and roll up."""
    stamped = [dict(r, status="WARN" if r["rel_err"] > threshold else "OK")
               for r in records]
    worst = max((r["rel_err"] for r in stamped), default=0.0)
    return {
        "version": DRIFT_REPORT_VERSION,
        "threshold": threshold,
        "units": "bytes/device (ring model, comm.timing.collective_wire_bytes)",
        "records": stamped,
        "worst_rel_err": worst,
        "ok": all(r["status"] == "OK" for r in stamped),
    }


def write_drift_report(report: dict, path: str = DRIFT_REPORT_PATH) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def format_drift_table(report: dict) -> str:
    lines = [
        f"{'entrypoint':<16} {'static MB':>10} {'measured MB':>12} "
        f"{'rel err':>8}  status",
    ]
    for r in report["records"]:
        lines.append(
            f"{r['entrypoint']:<16} {r['static_wire_bytes'] / 1e6:>10.3f} "
            f"{r['measured_wire_bytes'] / 1e6:>12.3f} "
            f"{r['rel_err'] * 100:>7.2f}%  {r['status']}"
        )
    lines.append(
        f"worst {report['worst_rel_err'] * 100:.2f}% vs threshold "
        f"{report['threshold'] * 100:.0f}% — "
        + ("OK" if report["ok"] else "DRIFT")
    )
    return "\n".join(lines)
