"""The port's capability table against ``tpudml.capabilities`` over the
planner's whole candidate space: the same first rejection
(``candidate_rejection``) and the same set of firing rows on every
candidate of ``tpudml.plan.space.enumerate_candidates`` at worlds 1, 2,
3, 4, 6 and 8; JAX's keys, messages and row order; and the rows the port
lacks firing on no candidate. The planner's ``pruned`` block names the
first row that fires, so a wrong predicate or a row out of JAX's order
would change the plan.
"""

import pytest

pytest.importorskip("torch")

from tpudml.capabilities import TABLE as JAX_TABLE  # noqa: E402
from tpudml.capabilities import candidate_rejection as jax_rejection  # noqa: E402
from tpudml.plan.space import enumerate_candidates  # noqa: E402

from tpudml_torch.capabilities import TABLE, candidate_rejection  # noqa: E402

WORLDS = (1, 2, 3, 4, 6, 8)


def _records(world):
    return [c.to_dict() for c in enumerate_candidates(world)]


def _firing(table, rec):
    return {k for k, cap in table.items() if cap.when is not None and cap.when(rec)}


@pytest.mark.parametrize("world", WORLDS)
def test_first_rejection_and_firing_rows_are_jax_on_every_candidate(world):
    recs = _records(world)
    assert recs
    first = [(r["key"], candidate_rejection(r), jax_rejection(r)) for r in recs]
    assert [f for f in first if f[1] != f[2]] == []
    sets = [(r["key"], _firing(TABLE, r), _firing(JAX_TABLE, r)) for r in recs]
    assert [s for s in sets if s[1] != s[2]] == []


def test_keys_messages_and_order_are_jax():
    assert set(TABLE) <= set(JAX_TABLE)
    for key, cap in TABLE.items():
        assert cap.message == JAX_TABLE[key].message, key
        assert (cap.when is None) == (JAX_TABLE[key].when is None), key
    assert list(TABLE) == [k for k in JAX_TABLE if k in TABLE]


def test_rows_the_port_lacks_fire_on_no_planner_candidate():
    """Since the serving fleet's ``serve_fleet_spec`` came back, the port
    lacks no row of JAX's table: both tables hold the same rows in the same
    order."""
    assert list(TABLE) == list(JAX_TABLE)


def test_gspmd_fused_xent_row_fires_on_accumulation_and_custom_loss():
    """The row's predicate is JAX's (the port's guard in
    ``GSPMDParallel`` rejects the same): accum_steps != 1 or a custom loss
    with the fused head, whatever the schedule."""
    base = {"engine": "fsdp", "fused_xent": True, "schedule": None}
    assert candidate_rejection(dict(base, accum_steps=2)) == "gspmd_fused_xent_accum"
    assert candidate_rejection(dict(base, accum_steps=1, custom_loss=True)) == \
        "gspmd_fused_xent_accum"
    assert candidate_rejection(dict(base, accum_steps=1)) is None
    assert candidate_rejection(dict(base, accum_steps=1, schedule="gpipe")) is None


MPMD_ROWS = ("mpmd_moe_aux_loss", "mpmd_fused_xent_head", "mpmd_serve")


def test_mpmd_rows_stand_at_jax_s_places():
    """The three ``mpmd_*`` rows are back, after ``serve_tp_dense_only``
    and in JAX's order, owned by the port's ``mpmd.spec``."""
    keys, jkeys = list(TABLE), list(JAX_TABLE)
    assert keys[-3:] == list(MPMD_ROWS) == jkeys[-3:]
    assert keys[-4] == jkeys[-4] == "serve_tp_dense_only"
    assert all(TABLE[k].owner == "tpudml_torch.mpmd.spec" for k in MPMD_ROWS)


@pytest.mark.parametrize("key,stage,serve", [
    ("mpmd_moe_aux_loss", {"moe_experts": 4}, False),
    ("mpmd_fused_xent_head", {"fused_xent": True}, False),
    ("mpmd_serve", {}, True),
])
def test_mpmd_predicates_and_guard_sites_fire_as_jax_s(key, stage, serve):
    """A stage's planner candidate (``StageSpec.candidate()``, with
    ``serve``) is rejected by the row JAX's table names, and building the
    ``PipelineSpec`` raises that row's message from its ``reject`` site."""
    from tpudml_torch.capabilities import CompositionError
    from tpudml_torch.mpmd.spec import PipelineSpec, StageSpec

    cand = dict(StageSpec("a", **stage).candidate(), serve=serve)
    assert candidate_rejection(cand) == jax_rejection(cand) == key
    with pytest.raises(CompositionError) as ei:
        PipelineSpec(stages=(StageSpec("a", **stage), StageSpec("b")), global_batch=8,
                     serve=serve)
    assert str(ei.value) == TABLE[key].message


SERVE_RECORDS = [
    {"serve_fleet": fleet, "serve_spec_k": k, "serve_tp": tp, "serve_cache_layout": layout,
     "serve_fused_head": fused, "serve_weight_quant": wq}
    for fleet in (False, True) for k in (0, 2) for tp in (False, True)
    for layout in ("dense", "paged") for fused in (False, True) for wq in (None, "int8")
]


def test_serve_fleet_spec_stands_at_jax_s_place_and_fires_as_jax_s():
    """The fleet's row sits between ``serve_tp_weight_quant`` and
    ``serve_tp_dense_only`` as in JAX, owned by the port's router; over
    every serving record the firing rows and the first rejection are
    JAX's, and the fleet's row fires exactly on fleet x spec_k > 0."""
    keys, jkeys = list(TABLE), list(JAX_TABLE)
    i = keys.index("serve_fleet_spec")
    assert i == jkeys.index("serve_fleet_spec")
    assert keys[i - 1] == "serve_tp_weight_quant" and keys[i + 1] == "serve_tp_dense_only"
    assert TABLE["serve_fleet_spec"].owner == "tpudml_torch.serve.fleet.router"
    for rec in SERVE_RECORDS:
        assert _firing(TABLE, rec) == _firing(JAX_TABLE, rec), rec
        assert candidate_rejection(rec) == jax_rejection(rec), rec
        fires = "serve_fleet_spec" in _firing(TABLE, rec)
        assert fires == (rec["serve_fleet"] and rec["serve_spec_k"] > 0), rec


def test_fleet_config_raises_jax_s_spec_message():
    """``FleetConfig(engine=ServeConfig(spec_k>0))`` raises the row's message
    as ``ServeCompositionError``, from the template and from a replica's
    config alike."""
    from tpudml_torch.serve import ServeCompositionError, ServeConfig
    from tpudml_torch.serve.fleet import FleetConfig

    spec = ServeConfig(slots=2, max_len=64, prefill_chunk=8, step_time_s=0.01, spec_k=2)
    plain = ServeConfig(slots=2, max_len=64, prefill_chunk=8, step_time_s=0.01)
    for kw in ({"engine": spec}, {"engine": plain, "replica_engines": (plain, spec)}):
        with pytest.raises(ServeCompositionError) as ei:
            FleetConfig(replicas=2, **kw)
        assert str(ei.value) == JAX_TABLE["serve_fleet_spec"].message
