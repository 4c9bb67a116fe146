"""CLI: ``python -m tpudml_torch.analysis [--strict] [...]`` (the port of
``python -m tpudml.analysis``).

Report-only by default; ``--strict`` (the CI mode) exits non-zero when any
finding is not covered by the committed allowlist
(``tpudml_torch/analysis/allowlist.toml``), and warns on the entries that
matched nothing (stale suppressions). A full run lints the source (the AST
pass over ``tpudml_torch/`` and ``chip_smoke.py``), captures one step of
every entrypoint (the graph pass, on the card unless ``--device cpu`` or
``TPUDML_DEVICE=cpu``) and checks the MPMD protocol surface.
``--protocol`` runs only the protocol pass (P300–P303 over the drill and
fixture ``PipelineSpec`` surface, plus the AST pass's P304): no device,
milliseconds, byte-deterministic. ``--format`` selects the output:
``text`` (human), ``json``, or ``github`` (workflow-annotation lines).
``--cost``, ``--hbm_budget`` and ``--plan`` are the next slice's
(ROADMAP.md queue 1 item 11): they raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# --format github: one workflow-annotation line per finding, mapped from
# the rule severity (info → notice).
_GITHUB_LEVEL = {"error": "error", "warn": "warning", "info": "notice"}
_AST_ROOTS = ("tpudml_torch", "chip_smoke.py")


def _github_line(f) -> str:
    level = _GITHUB_LEVEL.get(f.severity, "warning")
    loc = ""
    if f.file:
        loc = f"file={f.file}"
        if f.line:
            loc += f",line={f.line}"
    ep = f" [{f.entrypoint}]" if f.entrypoint else ""
    # '::' inside the message would end the annotation early.
    msg = f"{f.rule}{ep}: {f.message}".replace("::", ":")
    return f"::{level} {loc}::{msg}"


def _finding_dicts(findings) -> list[dict]:
    return [f.__dict__ | {"severity": f.severity} for f in findings]


def _not_ported(flag: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} needs the dataflow interpreter and the static cost walk (dataflow.py, "
        f"cost.py), which are not ported yet (ROADMAP.md queue 1 item 11)")


def main(argv: list[str] | None = None) -> int:
    from tpudml_torch.device import default_device

    parser = argparse.ArgumentParser(
        prog="python -m tpudml_torch.analysis",
        description="Static pre-flight analysis of the port's distributed training and "
                    "serving hazards (graph + AST + protocol passes).",
    )
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 on any finding not in the allowlist; warn on stale "
                             "allowlist entries")
    parser.add_argument("--format", default=None, dest="fmt",
                        choices=("text", "json", "github"),
                        help="findings output format (default: text)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="alias for --format json")
    parser.add_argument("--protocol", action="store_true",
                        help="cross-rank protocol pass only: P300-P303 over the drill/"
                             "fixture PipelineSpec surface plus the AST P304 lint (no "
                             "capture, no device)")
    parser.add_argument("--cost", action="store_true",
                        help="the static comm/HBM cost table (not ported yet)")
    parser.add_argument("--hbm_budget", type=float, default=None, metavar="MB",
                        help="arm J116 (not ported yet)")
    parser.add_argument("--plan", default=None, metavar="PLAN_JSON",
                        help="arm J118 against a plan.json (not ported yet)")
    parser.add_argument("--entrypoints", default=None, metavar="A,B",
                        help="comma-separated entrypoints (default: all; see --list-rules)")
    parser.add_argument("--paths", nargs="*", default=None,
                        help=f"roots for the AST pass (default: {' '.join(_AST_ROOTS)})")
    parser.add_argument("--allowlist", default=None, metavar="TOML",
                        help="allowlist path (default: tpudml_torch/analysis/allowlist.toml)")
    parser.add_argument("--skip-graph", action="store_true",
                        help="AST pass only (no capture, no device)")
    parser.add_argument("--skip-ast", action="store_true", help="graph pass only")
    parser.add_argument("--show-allowed", action="store_true",
                        help="also print findings the allowlist suppressed")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue (and which rules the port checks "
                             "so far) and the entrypoints")
    parser.add_argument("--device", default=default_device(),
                        help="where the graph pass captures the steps: cuda (the default "
                             "unless TPUDML_DEVICE says otherwise) or cpu")
    args = parser.parse_args(argv)
    fmt = args.fmt or ("json" if args.as_json else "text")
    if args.cost:
        raise _not_ported("--cost")
    if args.hbm_budget is not None:
        raise _not_ported("--hbm_budget")
    if args.plan:
        raise _not_ported("--plan (J118)")

    from tpudml_torch.analysis.allowlist import (
        DEFAULT_PATH,
        load_allowlist,
        split_allowed,
        unused_entries,
    )
    from tpudml_torch.analysis.entrypoints import ENTRYPOINTS
    from tpudml_torch.analysis.findings import RULES, sort_findings
    from tpudml_torch.analysis.graph_pass import CHECKED_RULES

    if args.list_rules:
        checked = set(CHECKED_RULES) | {r for r in RULES if r[0] in "AP"}
        for rule, (sev, desc) in RULES.items():
            mark = "checked" if rule in checked else "next slice"
            print(f"{rule}  {sev:5s}  [{mark:10s}]  {desc}")
        print("\nentrypoints:", ", ".join(ENTRYPOINTS))
        return 0

    names = None
    if args.entrypoints:
        names = [n.strip() for n in args.entrypoints.split(",") if n.strip()]
        unknown = [n for n in names if n not in ENTRYPOINTS]
        if unknown:
            parser.error(f"unknown entrypoints {unknown}; known: {', '.join(ENTRYPOINTS)}")

    from tpudml_torch.analysis.ast_pass import analyze_tree
    from tpudml_torch.analysis.protocol import analyze_protocol_surface

    roots = args.paths or [r for r in _AST_ROOTS if os.path.exists(r)]
    findings = []
    if args.protocol:
        findings.extend(analyze_protocol_surface())
        findings.extend(f for f in analyze_tree(roots) if f.rule == "P304")
    else:
        if not args.skip_ast:
            findings.extend(analyze_tree(roots))
        if not args.skip_graph:
            from tpudml_torch.analysis.entrypoints import analyze_entrypoints

            findings.extend(analyze_entrypoints(names, device=args.device))
        if not args.skip_ast and not args.skip_graph:
            # A full run covers the protocol surface too (cheap, no device).
            findings.extend(analyze_protocol_surface())

    entries = load_allowlist(args.allowlist)
    active, allowed = split_allowed(sort_findings(findings), entries)
    # Stale entries are judged on the full surface only: a filtered run
    # misses findings its entries cover.
    full_run = (not args.protocol and names is None and args.paths is None
                and not args.skip_graph and not args.skip_ast)
    stale = unused_entries(findings, entries) if full_run else []

    if fmt == "json":
        print(json.dumps({
            "active": _finding_dicts(active),
            "allowed": _finding_dicts(allowed),
            "stale_allowlist": [e.__dict__ for e in stale],
        }, indent=2))
    elif fmt == "github":
        for f in active:
            print(_github_line(f))
        for e in stale:
            print(f"::warning file={args.allowlist or DEFAULT_PATH}::stale allowlist entry "
                  f"rule={e.rule} path={e.path} matched no finding ({e.reason})")
    else:
        for f in active:
            print(f.format())
        if args.show_allowed and allowed:
            print(f"\n-- allowlisted ({len(allowed)}) --")
            for f in allowed:
                print(f.format())
        if args.strict and stale:
            print(f"\n-- stale allowlist entries ({len(stale)}) --")
            for e in stale:
                print(f"  {e.rule} path={e.path!r}" + (f" line={e.line}" if e.line else "")
                      + f" — matched no finding (reason was: {e.reason})")
        print(f"\n{len(active)} finding(s), {len(allowed)} allowlisted "
              f"({len(entries)} allowlist entr{'y' if len(entries) == 1 else 'ies'})")

    if args.strict and active:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
