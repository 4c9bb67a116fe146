"""``python -m tpudml_torch.analysis``: the strict CI contract on the port's
own tree (one subprocess), the ``--format json|github`` goldens, the
protocol-only mode, the next slice's flags and the device default."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tpudml_torch.analysis.__main__ import main  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

SEEDED = textwrap.dedent('''
    import time

    import torch


    def branch(x):
        y = torch.mean(x)
        if y > 0:
            x = x + 1.0
        return x


    def reseeded(shape):
        g = torch.Generator().manual_seed(0)
        a = torch.randn(shape, generator=g)
        g.manual_seed(0)
        return a + torch.randn(shape, generator=g)


    def epochs(loader):
        for epoch in range(2):
            for batch in loader:
                pass


    def timed(step, x):
        t0 = time.perf_counter()
        step(torch.as_tensor(x))
        return time.perf_counter() - t0
''')


@pytest.fixture
def seeded(tmp_path):
    path = tmp_path / "seeded.py"
    path.write_text(SEEDED)
    return str(path)


def test_strict_cli_green_on_the_port():
    """CI contract: the committed allowlist covers the port's whole tree
    and every entrypoint captured on the CPU, with no stale entry."""
    env = {**os.environ, "TPUDML_DEVICE": "cpu"}
    proc = subprocess.run([sys.executable, "-m", "tpudml_torch.analysis", "--strict"],
                          cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "\n0 finding(s)" in proc.stdout
    assert "stale allowlist" not in proc.stdout


def test_cli_format_json_golden(seeded, capsys):
    assert main(["--skip-graph", "--format", "json", "--paths", seeded]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"active", "allowed", "stale_allowlist"}
    assert out["stale_allowlist"] == []  # a partial run never judges staleness
    assert {f["rule"] for f in out["active"]} == {"A201", "A202", "A203", "A204"}
    for f in out["active"]:
        assert f["file"].endswith("seeded.py") and f["line"] > 0
        assert f["severity"] in ("error", "warn", "info")


def test_cli_format_github_golden(seeded, capsys):
    assert main(["--skip-graph", "--format", "github", "--paths", seeded]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 4
    shape = re.compile(r"^::(error|warning|notice) file=[^,]+,line=\d+::A\d{3}")
    for ln in lines:
        assert shape.match(ln), ln
        _, _, message = ln.split("::", 2)
        assert "::" not in message, ln


def test_cli_strict_fails_on_an_unallowed_finding_only(seeded, tmp_path, capsys):
    assert main(["--skip-graph", "--strict", "--paths", seeded]) == 1
    assert "4 finding(s)" in capsys.readouterr().out
    allow = tmp_path / "allow.toml"
    allow.write_text("".join(f'[[allow]]\nrule = "{r}"\npath = "*seeded.py"\nreason = "x"\n\n'
                             for r in ("A201", "A202", "A203", "A204")))
    assert main(["--skip-graph", "--strict", "--paths", seeded, "--allowlist", str(allow)]) == 0
    assert "0 finding(s), 4 allowlisted (4 allowlist entries)" in capsys.readouterr().out


def test_cli_protocol_mode_is_green_and_deterministic(capsys):
    assert main(["--protocol", "--strict"]) == 0
    first = capsys.readouterr().out
    assert main(["--protocol", "--strict"]) == 0
    assert capsys.readouterr().out == first
    assert "\n0 finding(s)" in first


def test_cli_list_rules_says_what_the_port_checks(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    rows = {ln.split()[0]: ln for ln in out.splitlines() if re.match(r"^[JAP]\d{3} ", ln)}
    for rule in ("J101", "J104", "J111", "J119", "A201", "P302", "P304"):
        assert "[checked" in rows[rule], rows[rule]
    for rule in ("J102", "J112", "J116", "J118"):
        assert "[next slice" in rows[rule], rows[rule]
    assert "task1_single" in out and "serve_fused" in out


@pytest.mark.parametrize("flag", [["--cost"], ["--hbm_budget", "100"], ["--plan", "p.json"]])
def test_next_slice_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="item 11"):
        main(flag)


def test_cli_asks_for_the_card_by_default(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot be shown")
    monkeypatch.delenv("TPUDML_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--entrypoints", "task1_single", "--skip-ast"])
