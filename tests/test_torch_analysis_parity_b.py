"""The second half of the registry against JAX's graph pass: the module
docstring of ``tests/test_torch_analysis_parity.py`` says what is
compared, and names the defined differences pinned here (J119 on the
unfused decode steps, J103 on the ragged MoE)."""

from __future__ import annotations

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_analysis_parity import DEFINED_EXTRA, jax_run  # noqa: E402

from tpudml_torch.analysis.entrypoints import (  # noqa: E402
    ENTRYPOINTS,
    analyze_entrypoint,
    entrypoint_group,
)

NAMES = list(ENTRYPOINTS)[8:]


@pytest.fixture(scope="module")
def port():
    with entrypoint_group("cpu") as dev:
        yield {name: analyze_entrypoint(name, device=dev) for name in NAMES}


@pytest.fixture(scope="module")
def jax_s():
    return {name: jax_run(name) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_rule_set_equals_jax_s(port, jax_s, name):
    got = {f.rule for f in port[name]}
    extra = DEFINED_EXTRA.get(name, set())
    assert got - extra == jax_s[name]["rules"] - extra, (got, jax_s[name]["rules"])
    assert extra <= got
    for f in port[name]:
        assert f.file and f.line > 0, f
        assert f.entrypoint == name


@pytest.mark.parametrize("name", ["serve_decode", "serve_paged_decode"])
def test_defined_difference_j119_on_the_unfused_decode_steps(port, jax_s, name):
    """The port's J119 fires on the unfused tails at serve/engine.py
    (allowlisted, as JAX's entry for them is) and not on the fused one;
    JAX's fires only where its jaxpr names the decode step's jit ``pjit``."""
    (f,) = [f for f in port[name] if f.rule == "J119"]
    assert f.file == "tpudml_torch/serve/engine.py"
    assert not any(f.rule == "J119" for f in port["serve_fused"])
    if "pjit" not in jax_s[name]["names"]:
        assert "J119" not in jax_s[name]["rules"]


def test_defined_difference_j103_on_the_ragged_moe(port, jax_s):
    """The port's ragged FFN counts each expert's rows and reads them on
    the host to cut its slabs; JAX's ragged_dot never leaves the device."""
    files = {f.file for f in port["moe_ragged"] if f.rule == "J103"}
    assert files == {"tpudml_torch/nn/moe.py", "tpudml_torch/ops/moe_kernel.py"}
    assert "J103" not in jax_s["moe_ragged"]["rules"]
    assert not any(f.rule == "J103" for f in port["ep_moe"])  # the gather dispatch
