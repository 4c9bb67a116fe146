"""Human-readable summary of one run directory's observability artifacts
(the port of ``tools/obs_report.py``, its sections of this layer).

Reads whatever the flight recorder left behind; a missing file skips its
section:

- ``metrics.jsonl``  — the MetricsWriter scalar stream (loss, the
  ``obs/*`` StepStats tags, comm and serve scalars);
- ``trace.json``     — the Chrome trace-event export (per-category span
  count / total / p50 / p99);
- ``obs/drift.json`` — a static-vs-measured drift report
  (``tpudml_torch.obs.drift``), read if a run left one;
- ``elastic.json``   — the elastic controller's reform/re-plan history
  (``tpudml_torch.elastic``'s drills write it), plus the
  ``elastic``-category instants in the exported traces;
- ``fleet.json``     — the serving fleet's run summary (the drill's
  verdict rows with per-rank token CRCs and the merged per-replica trace
  path, or a deterministic router run's membership and latency
  aggregates, ``FleetReport.to_dict()``);
- ``obs/mpmd.json``  — the MPMD re-mesh drill's verdict (bit-exactness
  against the uninterrupted reference, the re-mesh MTTR), the pre-launch
  protocol gate's verdict (``protocol_report.json``), and per-edge
  transfer bytes from the merged per-stage trace (one pid track a stage
  group).

The residuals section waits for the module that writes its file
(ROADMAP.md queue 1 item 11).

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
    """The drift monitor's verdict table (``obs/drift.json``)."""
    if not path.is_file():
        return None
    from tpudml_torch.obs.drift import format_drift_table

    return format_drift_table(json.loads(path.read_text()))


def elastic_summary(run_dir: Path) -> str | None:
    """Reform/re-plan history from the elastic controller's artifacts:
    ``elastic.json`` (ElasticResult: one row per round, one per re-plan
    decision) plus any ``elastic``-category instants found in the
    exported traces (``trace_controller.json`` / ``trace.json``)."""
    path = run_dir / "elastic.json"
    if not path.is_file():
        return None
    res = json.loads(path.read_text())
    out = [
        f"outcome: {res.get('stop_reason', '?')}  "
        f"success={res.get('success')}  reforms={res.get('reforms')}  "
        f"final_world={res.get('final_world')}  "
        f"wall={res.get('total_elapsed_s', 0.0):.1f}s"
    ]
    rounds = res.get("records") or []
    if rounds:
        rows = [
            [
                r.get("round"),
                r.get("world"),
                r.get("coordinator_port"),
                r.get("failed_rank") if r.get("failed_rank") is not None else "-",
                "yes" if r.get("timed_out") else "no",
                f"{r.get('backoff_s', 0.0):.3f}",
                f"{r.get('elapsed_s', 0.0):.2f}",
            ]
            for r in rounds
        ]
        out.append(_table(
            ["round", "world", "port", "failed_rank", "timed_out",
             "backoff_s", "elapsed_s"],
            rows,
        ))
    replans = res.get("replans") or []
    if replans:
        rows = []
        for r in replans:
            verdicts = ",".join(
                rc.get("verdict", "?") for rc in r.get("receipts", ())
            ) or "-"
            rows.append([
                r.get("round", "-"),
                r.get("trigger"),
                f"{r.get('old_world')}→{r.get('new_world')}",
                r.get("old_key"),
                r.get("new_key"),
                "yes" if r.get("switched") else "no",
                f"{r.get('latency_s', 0.0) * 1e3:.1f}",
                verdicts,
                (r.get("error") or "-"),
            ])
        out.append(_table(
            ["round", "trigger", "world", "old plan", "new plan",
             "switched", "plan_ms", "receipts", "error"],
            rows,
        ))
    else:
        out.append("(no re-plans recorded)")
    # Controller-side instants, if a trace was exported alongside.
    instants = []
    for name in ("trace_controller.json", "trace.json"):
        tpath = run_dir / name
        if not tpath.is_file():
            continue
        try:
            doc = json.loads(tpath.read_text())
        except ValueError:
            continue
        instants += [
            e for e in doc.get("traceEvents", [])
            if e.get("ph") == "i" and e.get("cat") == "elastic"
        ]
    if instants:
        rows = [
            [
                e.get("name"),
                json.dumps(e.get("args", {}), sort_keys=True),
            ]
            for e in sorted(instants, key=lambda e: e.get("ts", 0))
        ]
        out.append(_table(["instant", "args"], rows))
    return "\n\n".join(out)


def protocol_verdict(run_dir: Path) -> str | None:
    """One-line verdict of the MPMDController's pre-launch protocol
    gate (``protocol_report.json``, written per checked round), so the
    static evidence sits next to the dynamic drill verdict for the same
    spec."""
    for p in (run_dir / "protocol_report.json",
              run_dir / "run" / "protocol_report.json",
              run_dir / "obs" / "protocol_report.json"):
        if not p.is_file():
            continue
        try:
            doc = json.loads(p.read_text())
        except ValueError:
            return None
        checks = doc.get("checks") or []
        line = (f"protocol gate: {len(checks)} spec check(s)  "
                f"ok={doc.get('ok')}")
        bad = [c for c in checks if not c.get("ok")]
        if bad:
            c = bad[0]
            rules = sorted({
                f.get("rule") for f in c.get("findings", ())
                if f.get("severity") == "error"
            })
            line += (f"  — REJECTED at round {c.get('round')} "
                     f"({', '.join(rules)}); launch refused")
        else:
            line += "  (every round's spec P300-P303 clean pre-launch)"
        return line
    return None


def mpmd_summary(run_dir: Path) -> str | None:
    """MPMD section: the re-mesh drill's verdict (``obs/mpmd.json``,
    written by ``python -m tpudml_torch.mpmd --drill``), the pre-launch
    protocol gate's verdict when a ``protocol_report.json`` is present,
    plus per-edge boundary transfer aggregates read out of the merged
    per-stage trace (one pid per stage group, ``cat="comm"`` spans with
    edge-labeled bytes)."""
    verdict = protocol_verdict(run_dir)
    path = run_dir / "obs" / "mpmd.json"
    if not path.is_file():
        path = run_dir / "mpmd.json"
    if not path.is_file():
        # A rejected launch leaves the gate receipts but no drill
        # verdict — still worth a section.
        return verdict
    doc = json.loads(path.read_text())
    out = []
    victim = doc.get("victim") or {}
    out.append(
        f"drill: ok={doc.get('ok')}  mode={doc.get('mode', '?')}  "
        f"bit_exact={doc.get('bit_exact')}  "
        f"in_place={doc.get('in_place')}  "
        f"stop_reason={doc.get('stop_reason', '?')}"
    )
    if verdict:
        out.append(verdict)
    out.append(
        f"re-mesh: victim=stage {victim.get('stage', '?')} rank "
        f"{victim.get('rank', '?')} (rc {victim.get('rc', '?')})  "
        f"final stage worlds={doc.get('final_stage_worlds')}  "
        f"resume_step={doc.get('resume_step')}  "
        f"steps_lost={doc.get('steps_lost')}  "
        f"fresh_ports={doc.get('fresh_ports')}"
    )
    mttr = doc.get("remesh_mttr_s")
    naive = doc.get("naive") or {}
    line = "mttr: re-mesh-in-place "
    line += f"{mttr:.2f}s" if mttr is not None else "-"
    if naive.get("restart_mttr_s") is not None:
        line += (
            f"  whole-world-restart {naive['restart_mttr_s']:.2f}s  "
            f"(re-mesh wins: {doc.get('remesh_beats_naive')})"
        )
    out.append(line)
    sps = doc.get("steps_per_s") or {}
    crcs = doc.get("params_crc") or {}
    if sps:
        rows = [
            [k, f"{sps[k]:.2f}", crcs.get(k, "-")]
            for k in sorted(sps)
        ]
        out.append(_table(["stage rank", "steps/s", "params_crc"], rows))
    # Per-edge transfer bytes from the merged trace: sum the cat="comm"
    # p2p spans' byte args per (pid, edge) — one row per stage track.
    tpath = run_dir / "obs" / "trace.json"
    if tpath.is_file():
        try:
            tdoc = json.loads(tpath.read_text())
        except ValueError:
            tdoc = {}
        edges: dict[tuple, list] = {}
        for e in tdoc.get("traceEvents", []):
            if e.get("cat") != "comm" or e.get("ph") != "X":
                continue
            args = e.get("args") or {}
            if "edge" not in args:
                continue
            key = (e.get("pid"), args["edge"], e.get("name"))
            agg = edges.setdefault(key, [0, 0])
            agg[0] += 1
            agg[1] += int(args.get("bytes", 0))
        if edges:
            rows = [
                [pid, edge, name, n, nbytes]
                for (pid, edge, name), (n, nbytes) in sorted(edges.items())
            ]
            out.append(_table(
                ["stage pid", "edge", "span", "frames", "bytes"], rows
            ))
    return "\n\n".join(out)


def fleet_summary(run_dir: Path) -> str | None:
    """Serving-fleet section: ``fleet.json`` left by either fleet form —
    the spawned drill (``python -m tpudml_torch.serve.fleet --drill``: per-rank
    verdict rows + the merged per-replica trace) or a deterministic
    router run that dumped ``FleetReport.to_dict()``."""
    path = run_dir / "fleet.json"
    if not path.is_file():
        return None
    doc = json.loads(path.read_text())
    out = []
    if "ranks" in doc:  # drill report (fleet/drill.py)
        out.append(
            f"drill: ok={doc.get('ok')}  world={doc.get('world')}  "
            f"reforms={doc.get('reforms')}  "
            f"stop_reason={doc.get('stop_reason', '?')}  "
            f"crc_ok={doc.get('crc_ok')}"
        )
        rows = []
        for rank in sorted(doc.get("ranks", {}), key=int):
            r = doc["ranks"][rank]
            if "error" in r:
                rows.append([rank, "-", "-", "-", "-", r["error"]])
                continue
            rows.append([
                rank,
                r.get("requests"),
                r.get("generated_tokens"),
                f"{r.get('tokens_crc', 0):08x}",
                "yes" if r.get("match") else "NO",
                "-",
            ])
        out.append(_table(
            ["rank", "requests", "tokens", "crc", "match", "error"], rows
        ))
        if doc.get("merged_trace"):
            out.append(f"merged fleet trace: {doc['merged_trace']}")
    else:  # FleetReport.to_dict()
        lat = doc.get("latency", {})
        out.append(
            f"router: replicas={doc.get('replicas')}  "
            f"steps={doc.get('steps')}  "
            f"tok/s={doc.get('tokens_per_sec', 0.0):.1f}  "
            f"finished={doc.get('finished')}  "
            f"rejected={doc.get('rejected')}  expired={doc.get('expired')}"
        )
        out.append(
            f"membership: kills={doc.get('kills')}  "
            f"drains={doc.get('drains')}  readmits={doc.get('readmits')}  "
            f"peak_queue={doc.get('peak_queue_depth')}  "
            f"events_crc32={doc.get('events_crc32', 0):08x}"
        )
        if lat:
            out.append(
                f"latency: ttft p50/p99 = {lat.get('ttft_p50_s', 0.0):.4f}/"
                f"{lat.get('ttft_p99_s', 0.0):.4f}s  tpot p50/p99 = "
                f"{lat.get('per_token_p50_s', 0.0):.4f}/"
                f"{lat.get('per_token_p99_s', 0.0):.4f}s"
            )
        per_rep = doc.get("per_replica") or []
        if per_rep:
            rows = []
            for r in per_rep:
                busy = r.get("busy_slot_steps", 0)
                denom = max(r.get("decode_steps", 0) * r.get("slots", 1), 1)
                rows.append([
                    r.get("replica"),
                    r.get("decode_steps"),
                    f"{busy / denom:.2f}",
                    r.get("killed_at") if r.get("killed_at") is not None else "-",
                    r.get("reformed_at") if r.get("reformed_at") is not None else "-",
                ])
            out.append(_table(
                ["replica", "decode_steps", "occupancy", "killed_at",
                 "reformed_at"],
                rows,
            ))
        replans = doc.get("replans") or []
        for r in replans:
            out.append(
                f"replan @ step {r.get('step')}: {r.get('why', '?')} → "
                + (r.get("error") or json.dumps(
                    r.get("decision", {}), sort_keys=True))
            )
    return "\n\n".join(out)


def report(run_dir: str | Path) -> str:
    run_dir = Path(run_dir)
    sections = [
        ("metrics.jsonl", metrics_summary(run_dir / "metrics.jsonl")),
        ("trace.json", trace_summary(run_dir / "trace.json")),
        ("obs/drift.json", drift_summary(run_dir / "obs" / "drift.json")),
        ("elastic.json (reform/re-plan)", elastic_summary(run_dir)),
        ("fleet.json (serving fleet)", fleet_summary(run_dir)),
        ("mpmd.json (MPMD re-mesh)", mpmd_summary(run_dir)),
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
