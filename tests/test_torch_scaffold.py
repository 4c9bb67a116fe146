"""Package rules of the PyTorch port ``tpudml_torch``.

- It imports with jax blocked, and loads nothing of ``tpudml`` (neither
  does ``chip_smoke.py``); an AST scan finds no such import anywhere.
- Entry points asked for the card on a machine without one raise, and
  ``chip_smoke.py`` exits non-zero without one, also when it is the only
  file of the repository present.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "tpudml_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_imports_with_jax_blocked_and_no_tpudml():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {list(_modules())!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'tpudml' or m.startswith('tpudml.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('tpudml_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_tpudml_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "tpudml"), f"{path}: imports {n}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot be shown")


def test_cuda_entry_points_raise_without_card(no_card, tmp_path):
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.serve import ServingEngine
    from tpudml_torch.tasks import task6_serve

    with pytest.raises(RuntimeError, match="cuda"):
        TransformerLM(vocab_size=16, embed_dim=8, num_heads=2, num_layers=1)
    model = TransformerLM(vocab_size=16, embed_dim=8, num_heads=2, num_layers=1,
                          device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        task6_serve.main(["--device", "cuda", "--n_requests", "1",
                          "--log_dir", str(tmp_path)])


def test_engine_refuses_model_on_other_device():
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.serve import ServingEngine

    model = TransformerLM(vocab_size=16, embed_dim=8, num_heads=2, num_layers=1,
                          device="cpu")
    model.to("meta")
    with pytest.raises(ValueError, match="move the model"):
        ServingEngine(model, device="cpu")


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_card(no_card, tmp_path, alone):
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
