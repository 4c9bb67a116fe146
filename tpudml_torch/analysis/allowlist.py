"""Committed allowlist: triaged true-but-accepted findings (the port of
``tpudml/analysis/allowlist.py``).

``tpudml_torch/analysis/allowlist.toml`` holds ``[[allow]]`` tables:

    [[allow]]
    rule = "J104"                        # required
    path = "tpudml_torch/nn/layers.py"   # fnmatch glob against the finding's
                                         # file (or "<entrypoint>" pseudo-path)
    reason = "LN stats accumulate in f32 by design"   # required
    # line = 123                         # optional: pin to an exact line

Matching is on (rule, path[, line]), not on the message text, which
changes with shapes. An entry with no ``path`` matches the rule everywhere;
use that sparingly. ``--strict`` fails on any finding NOT matched here, so
the workflow is: run the analyzer, fix what is fixable, and commit an
entry with a one-line ``reason`` for what is accepted. The reason field is
mandatory so that the allowlist stays reviewable.
"""

from __future__ import annotations

import fnmatch
import os
import tomllib
from dataclasses import dataclass

from tpudml_torch.analysis.findings import Finding

DEFAULT_PATH = os.path.join("tpudml_torch", "analysis", "allowlist.toml")


@dataclass(frozen=True)
class AllowEntry:
    rule: str
    path: str = "*"
    line: int = 0  # 0 = any line
    reason: str = ""

    def matches(self, f: Finding) -> bool:
        if f.rule != self.rule:
            return False
        loc = f.file or (f"<{f.entrypoint}>" if f.entrypoint else "")
        if not fnmatch.fnmatch(loc, self.path):
            return False
        return self.line == 0 or self.line == f.line


def load_allowlist(path: str | None = None) -> list[AllowEntry]:
    path = path or DEFAULT_PATH
    if not os.path.exists(path):
        return []
    with open(path, "rb") as fh:
        data = tomllib.load(fh)
    entries: list[AllowEntry] = []
    for i, raw in enumerate(data.get("allow", [])):
        if "rule" not in raw or "reason" not in raw:
            raise ValueError(
                f"{path}: [[allow]] entry #{i + 1} needs 'rule' and "
                f"'reason' keys (got {sorted(raw)})")
        entries.append(AllowEntry(
            rule=str(raw["rule"]),
            path=str(raw.get("path", "*")),
            line=int(raw.get("line", 0)),
            reason=str(raw["reason"]),
        ))
    return entries


def split_allowed(
    findings: list[Finding], entries: list[AllowEntry],
) -> tuple[list[Finding], list[Finding]]:
    """(active, allowed) partition of findings against the allowlist."""
    active: list[Finding] = []
    allowed: list[Finding] = []
    for f in findings:
        (allowed if any(e.matches(f) for e in entries) else active).append(f)
    return active, allowed


def unused_entries(
    findings: list[Finding], entries: list[AllowEntry],
) -> list[AllowEntry]:
    """Entries that matched NO finding in this run: stale suppressions
    whose finding was fixed (or whose path or rule drifted). ``--strict``
    warns on these so that an entry cannot outlive the finding it was
    written for. Only meaningful for runs over the full surface (every
    entrypoint and the default lint roots)."""
    return [e for e in entries if not any(e.matches(f) for f in findings)]
