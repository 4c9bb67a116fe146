"""The port's graph pass against JAX's, entrypoint by entrypoint.

For each of the 16 registered entrypoints the set of rules that fires in
the port (one captured step of the port's engine, on the CPU) equals the
set JAX's ``analyze_entrypoint`` gives for the same name, but for the
defined differences (ROADMAP.md "Defined differences"), each pinned by a
test of its own below:

- ``task2_dp`` adds J108: the port's rule sees the replicated update that
  JAX's allowlist entry for it was written for; JAX's reads shard_map's
  ``out_names``, which the installed jax no longer carries;
- ``serve_decode`` and ``serve_paged_decode`` add J119: the port's rule
  sees the unfused tail JAX's allowlist entry was written for; JAX's keys
  on ``pjit`` equations, which the installed jax names ``jit``;
- ``moe_ragged`` adds J103: the port's ragged dispatch reads the experts'
  row counts on the host, where JAX's ``ragged_dot`` keeps them on the
  device.

JAX's J111 findings carry no file under the installed jax; every port
finding carries a real ``file:line``.
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tpudml.analysis import analyze_callable as jax_analyze_callable  # noqa: E402
from tpudml.analysis.entrypoints import ENTRYPOINTS as JAX_ENTRYPOINTS  # noqa: E402

from tpudml_torch.analysis.entrypoints import (  # noqa: E402
    ENTRYPOINTS,
    analyze_entrypoint,
    entrypoint_group,
)

# entrypoint -> rules the port adds to JAX's set (module docstring).
DEFINED_EXTRA = {"task2_dp": {"J108"}, "serve_decode": {"J119"},
                 "serve_paged_decode": {"J119"}, "moe_ragged": {"J103"}}


#: The half of the registry this file covers (the other half:
#: test_torch_analysis_parity_b.py; JAX builds each engine in ~2 s).
NAMES = list(ENTRYPOINTS)[:8]


def _walk_jaxpr(obj, names: set, params: set) -> None:
    from tpudml.analysis.jaxpr_pass import _inner_jaxpr, _sub_jaxprs

    jaxpr, _ = _inner_jaxpr(obj)
    for e in jaxpr.eqns:
        names.add(e.primitive.name)
        if e.primitive.name == "shard_map":
            params.update(e.params)
        for sub, _ in _sub_jaxprs(e):
            _walk_jaxpr(sub, names, params)


def jax_run(name: str) -> dict:
    """JAX's ``analyze_entrypoint(name)``, step for step (build, then
    ``analyze_callable`` on each program), plus the primitive names and
    shard_map params of its traced programs."""
    import jax

    rules, names, params = set(), set(), set()
    for prog in JAX_ENTRYPOINTS[name]():
        rules |= {f.rule for f in jax_analyze_callable(
            prog.fn, prog.args, entrypoint=prog.name, expects_donation=prog.expects_donation,
            in_specs=prog.in_specs, mesh_axes=prog.mesh_axes)}
        _walk_jaxpr(jax.make_jaxpr(prog.fn)(*prog.args), names, params)
    return {"rules": rules, "names": names, "params": params}


@pytest.fixture(scope="module")
def port():
    with entrypoint_group("cpu") as dev:
        yield {name: analyze_entrypoint(name, device=dev) for name in ENTRYPOINTS}


@pytest.fixture(scope="module")
def jax_s():
    return {name: jax_run(name) for name in NAMES}


def test_registry_names_are_jax_s():
    assert list(ENTRYPOINTS) == list(JAX_ENTRYPOINTS)


@pytest.mark.parametrize("name", NAMES)
def test_rule_set_equals_jax_s(port, jax_s, name):
    got = {f.rule for f in port[name]}
    extra = DEFINED_EXTRA.get(name, set())
    assert got - extra == jax_s[name]["rules"] - extra, (got, jax_s[name]["rules"])
    assert extra <= got
    for f in port[name]:
        assert f.file and f.line > 0, f
        assert f.entrypoint == name


def test_training_entrypoints_fire_j111_but_the_sentinel(port):
    training = [n for n in ENTRYPOINTS if not n.startswith("serve")]
    assert {n for n in training if any(f.rule == "J111" for f in port[n])} == (
        set(training) - {"dp_sentinel"})
    assert {f.file for n in training for f in port[n] if f.rule == "J111"} == {
        "tpudml_torch/optim/optimizers.py"}


def test_defined_difference_j108_on_replicated_dp(port):
    """The port's J108 fires on the replicated-DP baseline at its
    aggregation's all-reduce (allowlisted, as JAX's entry for the same
    finding is) and stays silent under ZeRO-1's reduce-scatter."""
    (f,) = [f for f in port["task2_dp"] if f.rule == "J108"]
    assert f.file == "tpudml_torch/comm/collectives.py"
    assert not any(f.rule == "J108" for n in ("dp_zero1", "dp_sentinel", "fsdp", "fsdp_fused")
                   for f in port[n])


def test_defined_difference_j108_jax_reads_a_param_the_installed_jax_lacks(jax_s):
    if "out_names" not in jax_s["task2_dp"]["params"]:
        assert "J108" not in jax_s["task2_dp"]["rules"]
    else:  # a jax that keeps out_names fires it, as the port does
        assert "J108" in jax_s["task2_dp"]["rules"]
