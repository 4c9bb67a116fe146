"""The port's collectives (``tpudml_torch.comm``) on a 2-process gloo
group, against numpy and against ``tpudml.comm`` on a 2-device CPU mesh:
the counterparts of ``tests/test_comm.py``. The ranks run in
``tests/torch_dist_worker.py`` (suite ``comm``), spawned once for the
module; each rank's inputs come from ``default_rng((seed, rank))``, which
this process rebuilds. f32 sums over two ranks: rtol 1e-6; moves exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

import torch_dist_worker  # noqa: E402
from tpudml.comm.collectives import AGGREGATORS as JAX_AGGREGATORS  # noqa: E402
from tpudml.comm.timing import collective_wire_bytes as jax_wire_bytes  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.parallel.sharding import shard_map_fn  # noqa: E402
from tpudml_torch.comm import (  # noqa: E402
    CommStats, attribute_overlap, collective_wire_bytes, get_aggregator, timed_call,
)
from tpudml_torch.comm.collectives import aggregation_wire_bytes  # noqa: E402
from tpudml_torch.comm.timing import _WIRE_MODEL  # noqa: E402

WORLD = 2
RTOL = 1e-6


def _value(shape, seed, rank):
    return np.random.default_rng((seed, rank)).standard_normal(shape).astype(np.float32)


def _all(shape, seed):
    """[world, *shape]: every rank's input."""
    return np.stack([_value(shape, seed, r) for r in range(WORLD)])


def _tree(seed0=1):
    return {"a": _all((4, 3), seed0), "b": _all((5,), seed0 + 1), "c": _all((), seed0 + 2)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    job = tmp_path_factory.mktemp("comm")
    rng = np.random.default_rng(7)
    grads = [{"w": torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal((3,)).astype(np.float32))}
             for _ in range(WORLD)]
    torch.save(grads, job / "grads.pt")
    return grads, torch_dist_worker.spawn("comm", job, WORLD)


def _check(got: dict, want: dict, rtol=RTOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), want[k], rtol=rtol, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("name,reduce", [
    ("psum", lambda x: x.sum(0)),
    ("pmean", lambda x: x.mean(0)),
    ("pmax", lambda x: x.max(0)),
    ("allreduce", lambda x: x.mean(0)),
    ("allgather", lambda x: x.mean(0)),
    ("reducescatter", lambda x: x.mean(0)),
])
def test_reductions_match_numpy(ranks, name, reduce):
    """Sums, means and maxima of a mixed-shape tree (a 0-d leaf, a leaf
    whose dim 0 does not divide the world: reducescatter's mean)."""
    want = {k: reduce(v) for k, v in _tree().items()}
    for got in ranks[1]:
        _check(got[name], want)


def test_reduce_scatter_mean_equals_mean_when_divisible(ranks):
    even = {"a": _all((2 * WORLD, 3), 4), "b": _all((WORLD,), 5)}
    for got in ranks[1]:
        _check(got["reducescatter_even"], {k: v.mean(0) for k, v in even.items()})


def test_all_gather_and_psum_scatter(ranks):
    tree = _tree()
    even = {"a": _all((2 * WORLD, 3), 4), "b": _all((WORLD,), 5)}
    x = _all((4, 3), 0)
    wide = _all((3, 2 * WORLD), 6)
    for r, got in enumerate(ranks[1]):
        _check(got["all_gather"], tree, rtol=0)
        _check(got["all_gather_tiled"], {k: np.concatenate(list(v)) for k, v in even.items()},
               rtol=0)
        np.testing.assert_array_equal(got["all_gather_axis1"].numpy(), x.transpose(1, 0, 2))
        rows = {k: v.sum(0)[r * (len(v[0]) // WORLD):(r + 1) * (len(v[0]) // WORLD)]
                for k, v in even.items()}
        _check(got["psum_scatter"], rows)
        np.testing.assert_allclose(got["psum_scatter_axis1"].numpy(),
                                   wide.sum(0)[:, 2 * r:2 * r + 2], rtol=RTOL)
        assert "does not divide the 2-rank group" in got["scatter_error"]


def test_broadcast_ppermute_all_to_all(ranks):
    tree = _tree()
    x = _all((4, 3), 0)
    a2a = _all((WORLD, WORLD, 2), 7)
    for r, got in enumerate(ranks[1]):
        _check(got["broadcast"], {k: v[1] for k, v in tree.items()}, rtol=0)
        # rank i's value lands on rank i+1.
        np.testing.assert_array_equal(got["ppermute"].numpy(), x[(r - 1) % WORLD])
        # chunk r of every rank's axis 1, concatenated along axis 0 in rank order
        np.testing.assert_array_equal(got["all_to_all"].numpy(),
                                      np.concatenate([a2a[j][:, r:r + 1] for j in range(WORLD)]))


def test_mixed_dtypes_take_one_buffer_each(ranks):
    h = _all((3,), 8)
    f = _all((3,), 9)
    for got in ranks[1]:
        out = got["bf16_f32"]
        assert out["h"].dtype == torch.bfloat16 and out["f"].dtype == torch.float32
        want_h = torch.from_numpy(h).bfloat16().float().sum(0).bfloat16() / WORLD
        np.testing.assert_allclose(out["h"].float().numpy(), want_h.float().numpy(), rtol=1e-2)
        np.testing.assert_allclose(out["f"].numpy(), f.mean(0), rtol=RTOL)


def test_plogsumexp_value_and_grad(ranks):
    x = _all((6,), 10)
    lse = np.log(np.exp(x).sum(0))
    for r, got in enumerate(ranks[1]):
        np.testing.assert_allclose(got["plogsumexp"].numpy(), lse, rtol=RTOL)
        np.testing.assert_allclose(got["plogsumexp_grad"].numpy(), np.exp(x[r] - lse),
                                   rtol=1e-5)


def test_aggregators_match_jax_on_a_two_device_mesh(ranks):
    grads, results = ranks
    mesh = make_mesh(MeshConfig({"data": WORLD}), jax.devices()[:WORLD])
    stacked = {k: np.stack([g[k].numpy() for g in grads]) for k in grads[0]}
    sharded = jax.device_put({k: jnp.asarray(v) for k, v in stacked.items()},
                             NamedSharding(mesh, P("data")))
    for name, agg in JAX_AGGREGATORS.items():
        fn = shard_map_fn(
            lambda t, agg=agg: jax.tree.map(lambda x: x[None],
                                            agg(jax.tree.map(lambda x: x[0], t), "data")),
            mesh, in_specs=P("data"), out_specs=P("data"))
        want = jax.tree.map(np.asarray, jax.jit(fn)(sharded))
        for r, got in enumerate(results):
            _check(got["jax_inputs"][name], {k: v[r] for k, v in want.items()})


def test_aggregation_wire_bytes_follow_the_wire_model():
    """Each strategy's bytes are the sum of JAX's wire model over the
    collectives it issues; reducescatter's mean fallback leaf is a psum."""
    tree = {"w": torch.zeros(8, 3), "odd": torch.zeros(5)}
    split, rest = 8 * 3 * 4, 5 * 4
    for world in (1, 2, 4):
        assert aggregation_wire_bytes("allreduce", tree, world) == jax_wire_bytes(
            "psum", split + rest, world)
        assert aggregation_wire_bytes("allgather", tree, world) == jax_wire_bytes(
            "all_gather", split + rest, world)
        assert aggregation_wire_bytes("reducescatter", tree, world) == (
            jax_wire_bytes("psum_scatter", split, world)
            + jax_wire_bytes("all_gather", split / world, world)
            + jax_wire_bytes("psum", rest, world))


def test_comm_time_table_times_every_aggregator(ranks):
    for got in ranks[1]:
        assert set(got["table"]) == {"allreduce", "allgather", "reducescatter"}
        for row in got["table"].values():
            assert row["iters"] == 2 and 0 < row["median_s"] <= row["total_s"]


def test_bench_and_same_program_guard(ranks):
    for r, got in enumerate(ranks[1]):
        assert [(b["strategy"], b["elements"]) for b in got["bench"]] == [
            (s, n) for n in (64, 256) for s in ("allgather", "allreduce", "reducescatter")]
        for b in got["bench"]:
            assert set(b) == {"strategy", "elements", "bytes", "world", "mean_ms"}
            assert b["world"] == WORLD and b["bytes"] == 4 * b["elements"] and b["mean_ms"] > 0
        assert "processes [1] disagree with process 0" in got["mismatch"]


@pytest.mark.parametrize("kind", sorted(_WIRE_MODEL) + ["unknown"])
def test_collective_wire_bytes_match_jax(kind):
    for world in (1, 2, 3, 8):
        assert collective_wire_bytes(kind, 1000.0, world) == jax_wire_bytes(kind, 1000.0, world)


def test_get_aggregator_rejects_unknown():
    with pytest.raises(ValueError, match="unknown aggregation"):
        get_aggregator("ring-of-power")


def test_timed_call_and_overlap_attribution():
    stats = CommStats()
    out = timed_call(stats, lambda t: t * 2, torch.ones(3), nbytes=12.0)
    assert torch.equal(out, torch.full((3,), 2.0))
    assert stats.calls == 1 and stats.comm_bytes == 12.0 and stats.comm_time_s > 0
    assert stats.report().startswith("Total communication time:")
    rep = attribute_overlap(fused_s=1.0, compute_s=0.7, comm_s=0.5)
    assert rep["exposed_comm_s"] == pytest.approx(0.3)
    assert rep["overlap_frac"] == pytest.approx(0.4)
