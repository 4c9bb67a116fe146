"""Package rules of the PyTorch port ``tpudml_torch``.

- It imports with jax blocked, and loads nothing of ``tpudml`` (neither
  does ``chip_smoke.py``); an AST scan finds no such import anywhere, nor
  in ``tests/torch_dist_worker.py``, the multi-process tests' rank script.
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
# The multi-process tests' rank script runs without jax too.
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                       REPO / "tests" / "torch_dist_worker.py"]


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


@pytest.mark.parametrize("module", ["tpudml_torch.nn.moe", "tpudml_torch.ops.moe_kernel"])
def test_moe_modules_are_among_the_checked(module):
    """The MoE layer and the grouped-dW wrapper are among the modules the
    jax-blocked import and the AST scan cover."""
    assert module in list(_modules())
    assert REPO / (module.replace(".", "/") + ".py") in SOURCES


@pytest.mark.parametrize("module", [
    "tpudml_torch.capabilities", "tpudml_torch.core.config", "tpudml_torch.core.dist",
    "tpudml_torch.comm.collectives", "tpudml_torch.comm.timing", "tpudml_torch.comm.bench",
    "tpudml_torch.data.sampler", "tpudml_torch.data.loader", "tpudml_torch.parallel.dp",
    "tpudml_torch.ops.junction_kernel"])
def test_dp_slice_modules_are_among_the_checked(module):
    """The data-parallel slice's modules are among the modules the
    jax-blocked import and the AST scan cover."""
    assert module in list(_modules())
    assert REPO / (module.replace(".", "/") + ".py") in SOURCES


@pytest.mark.parametrize("module", [
    "tpudml_torch.serve.paged", "tpudml_torch.serve.spec", "tpudml_torch.serve.sched",
    "tpudml_torch.serve.engine", "tpudml_torch.tools.profile_serve"])
def test_serving_lever_modules_are_among_the_checked(module):
    """The serving levers' modules (paged cache, speculative decoding, SLO
    admission) are among the modules the jax-blocked import and the AST
    scan cover."""
    assert module in list(_modules())
    assert REPO / (module.replace(".", "/") + ".py") in SOURCES


@pytest.mark.parametrize("module", [
    "tpudml_torch.obs", "tpudml_torch.obs.tracer", "tpudml_torch.obs.convert",
    "tpudml_torch.obs.stepstats", "tpudml_torch.metrics.profiler", "tpudml_torch.checkpoint",
    "tpudml_torch.checkpoint.store", "tpudml_torch.resilience",
    "tpudml_torch.resilience.faults", "tpudml_torch.resilience.sentinel",
    "tpudml_torch.launch", "tpudml_torch.launch.cluster", "tpudml_torch.launch.launcher",
    "tpudml_torch.launch.__main__", "tpudml_torch.tools.obs_report"])
def test_host_infrastructure_modules_are_among_the_checked(module):
    """The host-infrastructure slice's modules (flight recorder, profiler,
    checkpoint store, sentinel and faults, launcher, obs report) are among
    the modules the jax-blocked import and the AST scan cover."""
    assert module in list(_modules())
    path = REPO / (module.replace(".", "/") + ".py")
    assert (path if path.exists() else path.with_suffix("") / "__init__.py") in SOURCES


@pytest.mark.parametrize("module", ["tpudml_torch.serve.tp", "tpudml_torch.parallel.cp"])
def test_tp_serving_and_cp_modules_are_among_the_checked(module):
    """Tensor-parallel serving and context parallelism are among the
    modules the jax-blocked import and the AST scan cover."""
    assert module in list(_modules())
    assert REPO / (module.replace(".", "/") + ".py") in SOURCES


@pytest.mark.parametrize("module", [
    "tpudml_torch.plan", "tpudml_torch.plan.space", "tpudml_torch.plan.score",
    "tpudml_torch.plan.prune", "tpudml_torch.plan.emit", "tpudml_torch.plan.__main__",
    "tpudml_torch.elastic", "tpudml_torch.elastic.controller", "tpudml_torch.elastic.replan",
    "tpudml_torch.elastic.drill", "tpudml_torch.elastic.__main__", "tpudml_torch.obs.drift"])
def test_control_plane_modules_are_among_the_checked(module):
    """The planner, the elastic controller and the drift monitor's pure
    half are among the modules the jax-blocked import and the AST scan
    cover."""
    assert module in list(_modules())
    path = REPO / (module.replace(".", "/") + ".py")
    assert (path if path.exists() else path.with_suffix("") / "__init__.py") in SOURCES


@pytest.mark.parametrize("module", [
    "tpudml_torch.comm.p2p", "tpudml_torch.analysis", "tpudml_torch.analysis.findings",
    "tpudml_torch.analysis.protocol", "tpudml_torch.mpmd", "tpudml_torch.mpmd.spec",
    "tpudml_torch.mpmd.groups", "tpudml_torch.mpmd.fixture", "tpudml_torch.mpmd.runtime",
    "tpudml_torch.mpmd.drill", "tpudml_torch.mpmd.__main__"])
def test_mpmd_modules_are_among_the_checked(module):
    """The MPMD slice's modules (the p2p wire, the stage groups, the
    protocol checker) are among the modules the jax-blocked import and the
    AST scan cover."""
    assert module in list(_modules())
    path = REPO / (module.replace(".", "/") + ".py")
    assert (path if path.exists() else path.with_suffix("") / "__init__.py") in SOURCES


@pytest.mark.parametrize("module", [
    "tpudml_torch.serve.fleet", "tpudml_torch.serve.fleet.router",
    "tpudml_torch.serve.fleet.disagg", "tpudml_torch.serve.fleet.drill",
    "tpudml_torch.serve.fleet.__main__", "tpudml_torch.serve.fleet.quant"])
def test_fleet_modules_are_among_the_checked(module):
    """The serving fleet's modules (the router, the KV handoff, the drill
    and its CLI) are among the modules the jax-blocked import and the AST
    scan cover."""
    assert module in list(_modules())
    path = REPO / (module.replace(".", "/") + ".py")
    assert (path if path.exists() else path.with_suffix("") / "__init__.py") in SOURCES


@pytest.mark.parametrize("module", [
    "tpudml_torch.markers", "tpudml_torch.analysis.capture", "tpudml_torch.analysis.graph_pass",
    "tpudml_torch.analysis.entrypoints", "tpudml_torch.analysis.ast_pass",
    "tpudml_torch.analysis.allowlist", "tpudml_torch.analysis.capabilities",
    "tpudml_torch.analysis.__main__"])
def test_analyzer_modules_are_among_the_checked(module):
    """The graph pass, the source lint, their CLI and the marker regions
    are among the modules the jax-blocked import and the AST scan cover."""
    assert module in list(_modules())
    assert REPO / (module.replace(".", "/") + ".py") in SOURCES


def test_markers_module_imports_nothing_of_the_package():
    """The engines mark their code through ``tpudml_torch.markers``: it
    must not import ``tpudml_torch.analysis`` (which imports the engines)."""
    tree = ast.parse((PKG / "markers.py").read_text())
    imported = [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)] + [
        a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert not [m for m in imported if m.startswith("tpudml")], imported


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
