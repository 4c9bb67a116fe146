"""Ring and Ulysses attention of the port (``tpudml_torch.parallel.cp``)
against ``tpudml.parallel.cp`` on the CPU, at world 2 and 4.

The port's ranks run over gloo (``tests/torch_dist_worker.py``'s ``cp``
suite, spawned once a world), each on its T/W columns of global q, k, v
(B=2, T=32, H=4, D=8, seeded; striped first for the striped layout);
JAX runs the same functions under ``shard_map`` on a CPU mesh of W
devices, as ``tests/test_cp.py`` does. Each rank's output shard and the
gradients of sum(out · w) with respect to its q, k, v shards are held to
JAX's at the f32 contract, rtol 1e-5 (atol 1e-6; the gradients atol
1e-5: sums over blocks in the same order, elementwise in another):

- ring, causal and not, contiguous and striped; on the plain block math
  (``use_flash`` None on the CPU) and through the flash wrappers
  (``use_flash=True``: their plain versions here; JAX's Pallas kernels in
  interpret mode), the striped layout with ``k_shift = 1``;
- Ulysses, causal and not;
- the folds each rank makes in each direction: the causal contiguous ring
  skips the fully masked blocks (rank r folds r + 1, W(W+1)/2 over the
  ring), striped and non-causal fold all W² — and a NaN in the rows of v
  that only later ranks hold never reaches rank 0's output;
- Ulysses rejects heads the world does not divide, and the engine a
  layout the model was not built with, in JAX's words.

The engine (``ContextParallel``): ``tests/test_torch_cp_engine.py``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dist_worker  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.parallel import cp as jax_cp  # noqa: E402
from tpudml.parallel.sharding import shard_map_fn  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.optim import Adam  # noqa: E402
from tpudml_torch.parallel import ContextParallel  # noqa: E402

B, T, H, D = 2, 32, 4, 8
SPEC = P(None, "seq")
# name: (impl, causal, layout, use_flash)
CASES = {
    "ring_causal": ("ring", True, "contiguous", None),
    "ring_striped": ("ring", True, "striped", None),
    "ring_flash_striped": ("ring", True, "striped", True),
    "ulysses_causal": ("ulysses", True, "contiguous", None),
    "ring_full": ("ring", False, "contiguous", None),
    "ring_flash_causal": ("ring", True, "contiguous", True),
    "ring_flash_full": ("ring", False, "contiguous", True),
    "ulysses_full": ("ulysses", False, "contiguous", None),
    "ring_poison": ("ring", True, "contiguous", None),
}
WORLD_CASES = {2: ["ring_causal", "ring_striped", "ring_flash_striped", "ulysses_causal"],
               4: list(CASES)}
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(1)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4)]


def _jax_case(name, world, mesh):
    """JAX's output and gradients of sum(out · w) on the case's global
    (striped when the case is) q, k, v, w."""
    impl, causal, layout, use_flash = CASES[name]
    q, k, v, w = _inputs()
    if name == "ring_poison":
        v[:, T // world:] = np.nan
        w = np.ones_like(w)
    if layout == "striped":
        q, k, v, w = (np.asarray(jax_cp._stripe_time(a, world)) for a in (q, k, v, w))

    def f(q, k, v):
        if impl == "ring":
            return jax_cp.ring_attention(q, k, v, "seq", causal=causal, layout=layout,
                                         use_flash=bool(use_flash), interpret=bool(use_flash))
        return jax_cp.ulysses_attention(q, k, v, "seq", causal=causal)

    sharded = shard_map_fn(f, mesh, in_specs=(SPEC,) * 3, out_specs=SPEC)

    def out_and_grads(q, k, v, w):  # one compile for both directions
        out, vjp = jax.vjp(sharded, q, k, v)
        return out, vjp(w)

    out, grads = jax.jit(out_and_grads)(q, k, v, w)
    out = np.asarray(out)
    case = {"q": q, "k": k, "v": v, "w": w, "impl": impl, "causal": causal,
            "layout": layout, "use_flash": use_flash}
    return case, (out, *(np.asarray(g) for g in grads))


def _run(world, tmp_path_factory):
    job = tmp_path_factory.mktemp(f"cp{world}")
    mesh = make_mesh(MeshConfig({"seq": world}), jax.devices()[:world])
    cases, want = {}, {}
    for name in WORLD_CASES[world]:
        cases[name], want[name] = _jax_case(name, world, mesh)
    torch.save({"attn": cases}, job / "cases.pt")
    return want, torch_dist_worker.spawn("cp", job, world)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _run(4, tmp_path_factory)


def _check(want, ranks, name, world):
    tl = T // world
    for r, got in enumerate(ranks):
        cols = slice(r * tl, (r + 1) * tl)
        np.testing.assert_allclose(got[name]["out"].numpy(), want[name][0][:, cols], **OUT_TOL)
        for g, key in zip(want[name][1:], ("dq", "dk", "dv")):
            np.testing.assert_allclose(got[name][key].numpy(), g[:, cols], **GRAD_TOL,
                                       err_msg=f"{name} rank {r} {key}")


@pytest.mark.parametrize("name", WORLD_CASES[2])
def test_world2_matches_jax(world2, name):
    _check(*world2, name, 2)


@pytest.mark.parametrize("name", [n for n in WORLD_CASES[4] if n != "ring_poison"])
def test_world4_matches_jax(world4, name):
    _check(*world4, name, 4)


@pytest.mark.parametrize("world", [2, 4])
def test_the_causal_ring_skips_the_masked_blocks(world2, world4, world):
    """Rank r folds r + 1 blocks each way in the causal contiguous ring
    (W(W+1)/2 over the ring), W in the striped and non-causal rings."""
    ranks = (world2 if world == 2 else world4)[1]
    assert [got["ring_causal"]["folds"] for got in ranks] == [[r + 1] * 2 for r in range(world)]
    assert sum(got["ring_causal"]["folds"][0] for got in ranks) == world * (world + 1) // 2
    for got in ranks:
        assert got["ring_striped"]["folds"] == [world, world]
        if world == 4:
            assert got["ring_full"]["folds"] == [world, world]


def test_a_poisoned_future_block_never_reaches_rank_0(world4):
    """NaNs in v rows only later ranks hold: rank 0 skips their blocks, so
    its output is finite and equal to JAX's (which skips them too)."""
    want, ranks = world4
    got0 = ranks[0]["ring_poison"]["out"].numpy()
    assert np.isfinite(got0).all()
    np.testing.assert_allclose(got0, want["ring_poison"][0][:, :T // 4], **OUT_TOL)
    assert not np.isfinite(ranks[3]["ring_poison"]["out"].numpy()).all()


def test_the_rejections_keep_jax_s_words(world4):
    """Ulysses needs the heads to divide by the world (5 heads at 4), the
    engine the model's layout."""
    assert world4[1][0]["ulysses_error"] == "ulysses needs num_heads 5 divisible by axis size 4"
    lm = TransformerLM(vocab_size=32, embed_dim=32, num_heads=4, num_layers=1, impl="ring",
                       seq_sharded=True, device="cpu")
    with pytest.raises(ValueError, match=re.escape("engine layout 'striped' != model "
                                                   "seq_layout 'contiguous'")):
        ContextParallel(lm, Adam(lr=0.01), layout="striped")
