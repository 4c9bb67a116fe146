"""The port's fused greedy decode head (plain version on the CPU) and int8
weight quantization against ``tpudml``.

The JAX side runs its Pallas kernels in interpret mode with small tiles
(block_n=8, block_v=32), so several vocab tiles — and, at V=70, a padded
tail — are walked. Tokens are exact (first occurrence on ties); max logit
and lse at rtol=1e-6 (single-pass f32 against the kernel's tile-by-tile
online softmax). int8 codes and scales are bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.ops import decode_head as jhead  # noqa: E402
from tpudml.serve.fleet import quant as jquant  # noqa: E402
from tpudml_torch.ops import fused_decode_head, fused_decode_head_int8  # noqa: E402
from tpudml_torch.ops.decode_head import (  # noqa: E402
    GROUP, LAYOUT, RING_STEPS, STEP_LOADS, TILE, head_plan,
)
from tpudml_torch.serve.fleet import quant as tquant  # noqa: E402

BLOCKS = dict(block_n=8, block_v=32, interpret=True)


def _operands(n=16, d=8, v=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(d, v)).astype(np.float32),
            rng.normal(size=(v,)).astype(np.float32))


def _check(got, ref):
    tok, mx, lse = (x.numpy() for x in got)
    rt, rm, rl = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(tok, rt)
    assert tok.dtype == np.int32
    np.testing.assert_allclose(mx, rm, rtol=1e-6)
    np.testing.assert_allclose(lse, rl, rtol=1e-6)


# 70: padded vocab tail; d = 6408: one 8-row group of x is wider than the
# card kernel's stage, which then walks d in chunks.
@pytest.mark.parametrize("v,d", [(64, 8), (70, 8), (40, 6408)], ids=["64", "70", "40-d6408"])
def test_fused_decode_head_matches_pallas(v, d):
    x, w, b = _operands(d=d, v=v)
    ref = jhead.fused_decode_head(*map(jnp.asarray, (x, w, b)), **BLOCKS)
    _check(fused_decode_head(*map(torch.from_numpy, (x, w, b))), ref)


@pytest.mark.parametrize("v", [64, 70])
def test_fused_decode_head_int8_matches_pallas(v):
    x, w, b = _operands(v=v, seed=3)
    wq, scale = jquant._quant_kernel(jnp.asarray(w))
    ref = jhead.fused_decode_head_int8(jnp.asarray(x), wq, scale, jnp.asarray(b),
                                       **BLOCKS)
    tq, ts = tquant._quant_kernel(torch.from_numpy(w))
    got = fused_decode_head_int8(torch.from_numpy(x), tq, ts, torch.from_numpy(b))
    _check(got, ref)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("v", [1, 3, 127, 128, 129, 1000, 1001, 32773])
def test_head_plan_covers_every_column_once(v, int8):
    """The kernel's blocks (one a 128-column tile) and each lane's 16-byte
    copy (4 f32 or 16 int8 columns) cover every vocab column exactly once;
    where the plan is aligned, a copy's columns lie all in the row or all
    past it, so no 16-byte copy reads past a row's end."""
    plan = head_plan(8, 512, v, int8)
    vec = LAYOUT[int8][0]
    seen = np.zeros(v, np.int64)
    for tile in range(plan.tiles):
        for lane in range(TILE // vec):  # the column groups of a row
            col = tile * TILE + lane * vec
            inside = [c for c in range(col, col + vec) if c < v]
            if plan.aligned:
                assert len(inside) in (0, vec)
            seen[inside] += 1
    assert (seen == 1).all()
    assert plan.tiles == -(-v // TILE)


@pytest.mark.parametrize("v", [1000, 1001, 1024, 32768, 32773])
def test_head_plan_picks_the_instance(v):
    """16-byte loads where V keeps every W row on 16 bytes: a multiple of 4
    columns in f32, of 16 in int8 (V = 1000 is aligned in f32 only)."""
    assert head_plan(8, 512, v).aligned == (v % 4 == 0)
    assert head_plan(8, 512, v, True).aligned == (v % 16 == 0)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("d", [1, 3, 512, 6400, 6401, 8192, 100000])
def test_head_plan_stage_fits(d, int8):
    """x's stage and the threads' rings of W copies (which the warps'
    partial sums overlay) fit two blocks an SM at any d: the warps' slices
    cover d once, each walked in chunks of at most 128 (f32) or 256 (int8)
    rows, a whole number of steps each."""
    plan = head_plan(9, d, 32768, int8)
    vec, warps, chunk_max = LAYOUT[int8]
    step = 32 // (TILE // vec) * STEP_LOADS
    assert plan.warps == warps and plan.slice * warps >= d > (plan.slice - 1) * warps
    rows = [k for w in range(warps) for k in range(min(w * plan.slice, d),
                                                    min((w + 1) * plan.slice, d))]
    assert rows == list(range(d))
    assert plan.chunk % step == 0 and plan.chunk <= chunk_max
    assert plan.chunk >= min(plan.slice, chunk_max)
    ring = 16 * RING_STEPS * STEP_LOADS * 32 * warps
    assert ring >= 4 * warps * GROUP * TILE  # the partial sums fit over the ring
    assert plan.smem_bytes == ring + 4 * warps * GROUP * plan.chunk
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024  # two blocks an SM


@pytest.mark.parametrize("b", [1, 8, 9, 200])
def test_head_plan_scratch(b):
    """One int32 buffer a call: tokens, max, lse, then each tile's (max,
    column, Σexp) for each row; the batch in 8-row groups in one launch."""
    for int8 in (False, True):
        plan = head_plan(b, 512, 1001, int8)
        assert plan.tiles == 8 and plan.groups == -(-b // 8)
        assert plan.scratch == 3 * b + 3 * b * plan.tiles


@pytest.mark.parametrize("case", ["within_tile", "across_tiles", "all_equal"])
def test_ties_pick_first_occurrence(case):
    """Duplicated max columns in one vocab tile (3, 5), split across tiles
    (7, 40 with 32-wide tiles), or a flat row: the first occurrence wins,
    as jnp.argmax and the Pallas kernel's strict-> merge decide."""
    x = np.ones((4, 4), np.float32)
    w = np.zeros((4, 96), np.float32)
    cols = {"within_tile": (5, 3), "across_tiles": (40, 7), "all_equal": ()}[case]
    for c in cols:
        w[:, c] = 2.0
    ref = jhead.fused_decode_head(jnp.asarray(x), jnp.asarray(w), None, **BLOCKS)
    got = fused_decode_head(torch.from_numpy(x), torch.from_numpy(w))
    _check(got, ref)
    assert got[0].tolist() == [min(cols) if cols else 0] * 4


def test_quantize_params_bitwise():
    rng = np.random.default_rng(7)
    tree = {
        "tok_embed": rng.normal(size=(16, 8)).astype(np.float32),
        "block0": {"attn": {"q": {"kernel": rng.normal(size=(8, 8)).astype(np.float32),
                                  "bias": rng.normal(size=(8,)).astype(np.float32)}},
                   "fc1": {"kernel": (rng.normal(size=(8, 32)) * 40).astype(np.float32),
                           "bias": np.zeros(32, np.float32)}},
        "head": {"kernel": np.zeros((8, 16), np.float32),  # all-zero: eps floor
                 "bias": rng.normal(size=(16,)).astype(np.float32)},
    }
    jq, js = jquant.quantize_params(jax.tree.map(jnp.asarray, tree))
    ttree = jax.tree.map(torch.from_numpy, tree)
    tq, ts = tquant.quantize_params(ttree)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jq):
        got = tq
        for key in path:
            got = got[key.key]
        assert got.dtype == (torch.int8 if leaf.dtype == jnp.int8 else torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    for path, leaf in jax.tree_util.tree_leaves_with_path(js):
        got = ts
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    # The real path's dequantization is bitwise the oracle's, on both sides.
    deq = tquant.dequantize_params(tq, ts)
    sim = tquant.sim_quantize_params(ttree)
    jsim = jquant.sim_quantize_params(jax.tree.map(jnp.asarray, tree))
    for k in ("tok_embed",):
        np.testing.assert_array_equal(deq[k].numpy(), sim[k].numpy())
    np.testing.assert_array_equal(deq["block0"]["fc1"]["kernel"].numpy(),
                                  np.asarray(jsim["block0"]["fc1"]["kernel"]))
    np.testing.assert_array_equal(sim["head"]["kernel"].numpy(),
                                  np.asarray(jsim["head"]["kernel"]))
    assert tquant.quantized_param_bytes(tq, ts) == \
        jquant.quantized_param_bytes(jq, js)


def test_quantize_flat_state_dict():
    """A flat state_dict quantizes by the last dotted name component."""
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32))
    q, s = tquant.quantize_params({"head.kernel": w, "head.bias": w[0]})
    assert q["head.kernel"].dtype == torch.int8 and s["head.bias"] is None
    assert torch.equal(q["head.bias"], w[0])
