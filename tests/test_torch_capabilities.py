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
    missing = [k for k in JAX_TABLE if k not in TABLE]
    assert missing  # the serving fleet's and mpmd/'s rows come with their slices
    for world in WORLDS:
        for rec in _records(world):
            assert not _firing({k: JAX_TABLE[k] for k in missing}, rec), rec["key"]


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
