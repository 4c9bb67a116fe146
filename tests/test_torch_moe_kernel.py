"""The port's grouped dW and ragged expert FFN (``tpudml_torch.ops.moe_kernel``)
against ``tpudml.ops.moe_kernel`` on the CPU.

``grouped_dw_reference`` (the plain version kernel 16 is held to on the
card) against the JAX package's Pallas kernel run in interpret mode and
its XLA reference, on the JAX tests' group sets (uneven, empty experts,
one collapsed expert) with and without tail rows past Σ group_sizes;
bf16-rounded inputs against the f32 reference (both accumulate exact
products in f32). ``ragged_matmul`` against ``lax.ragged_dot``;
``ragged_ffn``'s output and its six gradients against JAX's
``custom_vjp``. Tolerance rtol 1e-5 / atol 1e-6 (f32 sums of up to 64
products in another order). The operands are at a training step's scale
(unit activations, fan-in weights, the cotangent of a mean over the rows),
so the results are O(1): with unit operands throughout, sums of 64
products reach ~30, whose f32 ulp (2e-6) already exceeds the atol where a
sum cancels to near zero.

``grouped_dw_plan`` (kernel 16's cut of its work) and the chunk list it
implies (``grouped_dw_chunks``, the kernel's walk of the sizes mirrored in
Python) are checked by hypothesis over sizes, M and E: every routed row in
exactly one chunk, each chunk inside one slab and at most R rows, at most
⌈M / R⌉ + E chunks, a grid that fits grid x, a bounded workspace.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from jax import lax  # noqa: E402

from tpudml.ops import moe_kernel as jmk  # noqa: E402
from tpudml_torch.ops import moe_kernel as tmk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
# The JAX tests' group sets (tests/test_moe_kernel.py:49-53).
GROUPS = {
    "uneven": [3, 11, 2, 17, 9, 5, 12, 5],
    "empty": [20, 0, 10, 0, 14, 0, 20, 0],
    "collapsed": [64, 0, 0, 0, 0, 0, 0, 0],
}
TAIL = 7  # rows past Σ group_sizes, which every version ignores
GRID_X_MAX = 2**31 - 1  # blocks a CUDA grid holds along x


def _operands(m, k, n, seed=0):
    """x [m, k] unit activations; g [m, n] a cotangent scaled by m^-1/2."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("tail", [0, TAIL], ids=["no_tail", "tail"])
@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_grouped_dw_reference_matches_pallas_interpret(groups, tail):
    gs = np.array(GROUPS[groups], np.int32)
    x, g = _operands(int(gs.sum()) + tail, 16, 24, seed=1)
    got = tmk.grouped_dw_reference(_t(x), _t(g), _t(gs))
    kernel = jmk.grouped_dw(jnp.asarray(x), jnp.asarray(g), jnp.asarray(gs),
                            tiling=(16, 128, 128), interpret=True)
    xla = jmk._reference_grouped_dw(jnp.asarray(x), jnp.asarray(g), jnp.asarray(gs))
    assert got.dtype == torch.float32 and got.shape == (8, 16, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)


@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_grouped_dw_bf16_inputs_accumulate_in_f32(groups):
    """bf16 x and g: the plain version widens them and sums in f32, as the
    JAX reference does on the same bf16-rounded values."""
    gs = np.array(GROUPS[groups], np.int32)
    x, g = _operands(int(gs.sum()) + TAIL, 16, 24, seed=2)
    xb, gb = _t(x).bfloat16(), _t(g).bfloat16()
    got = tmk.grouped_dw(xb, gb, _t(gs))  # CPU tensors: the plain version
    want = jmk._reference_grouped_dw(jnp.asarray(xb.float().numpy()),
                                     jnp.asarray(gb.float().numpy()), jnp.asarray(gs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_dw_checks_its_operands():
    x, g = _t(np.zeros((4, 3), np.float32)), _t(np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="row-aligned"):
        tmk.grouped_dw(x, g[:3], torch.tensor([4]))
    with pytest.raises(ValueError, match="row-aligned"):
        tmk.grouped_dw(x[None], g, torch.tensor([4]))
    with pytest.raises(ValueError, match="integer"):
        tmk.grouped_dw(x, g, torch.tensor([4.0]))
    with pytest.raises(ValueError, match="integer"):
        tmk.grouped_dw(x, g, torch.tensor([[4]]))


@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_ragged_matmul_matches_ragged_dot(groups):
    gs = np.array(GROUPS[groups], np.int32)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(int(gs.sum()) + TAIL, 16)).astype(np.float32)
    w = rng.normal(size=(8, 16, 24)).astype(np.float32)
    want = lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    got = tmk.ragged_matmul(_t(x), _t(w), gs.tolist())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ffn_inputs(gs, d=16, h=32, seed=4):
    """x, w1, b1, w2, b2 (unit rows, fan-in-scaled weights and biases), the
    sorted rows' onehot, group_sizes and a cotangent of the mean loss."""
    rng = np.random.default_rng(seed)
    e, p = len(gs), int(np.sum(gs))
    eids = np.repeat(np.arange(e), gs)
    onehot = np.eye(e, dtype=np.float32)[eids]
    arrays = [(rng.normal(size=s) * scale).astype(np.float32) for s, scale in
              (((p, d), 1.0), ((e, d, h), d ** -0.5), ((e, h), d ** -0.5),
               ((e, h, d), h ** -0.5), ((e, d), h ** -0.5))]
    dout = (rng.normal(size=(p, d)) / p).astype(np.float32)
    return arrays, onehot, np.array(gs, np.int32), dout


@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_ragged_ffn_value_and_grads_match_jax(groups):
    """Output and the six gradients (x, w1, b1, w2, b2; onehot gets none)
    of ``ragged_ffn`` against JAX's ``custom_vjp`` (its backward runs the
    XLA reference of grouped_dw on the CPU)."""
    arrays, onehot, gs, dout = _ffn_inputs(GROUPS[groups])

    def jfn(*a):
        return jnp.sum(jmk.ragged_ffn(*a, jnp.asarray(onehot), jnp.asarray(gs))
                       * jnp.asarray(dout))

    jout = jmk.ragged_ffn(*map(jnp.asarray, arrays), jnp.asarray(onehot), jnp.asarray(gs))
    jgrads = jax.grad(jfn, argnums=tuple(range(5)))(*map(jnp.asarray, arrays))
    leaves = [_t(a).requires_grad_() for a in arrays]
    oh = _t(onehot).requires_grad_()
    out = tmk.ragged_ffn(*leaves, oh, _t(gs))
    grads = torch.autograd.grad(out, leaves + [oh], _t(dout), allow_unused=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for name, got, want in zip(("x", "w1", "b1", "w2", "b2"), grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)
    assert grads[5] is None  # the onehot is integer-derived: no gradient


def test_ragged_ffn_backward_takes_dw_from_grouped_dw(monkeypatch):
    """dW1 and dW2 come from grouped_dw (two calls a backward), in f32,
    cast to the weights' dtype."""
    calls = []
    real = tmk.grouped_dw
    monkeypatch.setattr(tmk, "grouped_dw", lambda *a: calls.append(a[0].shape) or real(*a))
    arrays, onehot, gs, dout = _ffn_inputs(GROUPS["uneven"])
    leaves = [_t(a).requires_grad_() for a in arrays]
    out = tmk.ragged_ffn(*leaves, _t(onehot), _t(gs))
    assert calls == []
    out.backward(_t(dout))
    assert calls == [(64, 32), (64, 16)]  # hidden for dW2, then x for dW1


def _chunk_checks(sizes, m, plan):
    """The chunk list of ``sizes`` over m rows: each chunk inside its
    expert's slab, in expert order, every expert present; the list fits the
    plan's slots and ⌈M / R⌉ + E. Returns the list and the slabs."""
    chunks = tmk.grouped_dw_chunks(sizes, m, plan)
    slabs = tmk._slabs(sizes, m)
    assert len(chunks) <= plan["slots"] <= -(-m // plan["rows"]) + len(sizes)
    assert [c[0] for c in chunks] == sorted(c[0] for c in chunks)
    assert {c[0] for c in chunks} == set(range(len(sizes)))
    for e, lo, hi in chunks:
        assert slabs[e][0] <= lo <= hi <= slabs[e][1]
    return chunks, slabs


@settings(max_examples=300, deadline=None)
@given(sizes=st.lists(st.integers(0, 4000), min_size=1, max_size=70),
       m=st.integers(0, 20000), k=st.integers(1, 3000), n=st.integers(1, 3000),
       bf16=st.booleans())
def test_grouped_dw_chunks_cover_each_routed_row_once(sizes, m, k, n, bf16):
    """Sizes >= 0 (disjoint slabs, possibly summing past M): every row of
    [0, off[E]) clamped to M lies in exactly one chunk, no tail row in
    any; no chunk exceeds R rows (R is never grown); an empty slab has one
    empty chunk."""
    plan = tmk.grouped_dw_plan(m, k, n, len(sizes), torch.bfloat16 if bf16 else torch.float32)
    chunks, slabs = _chunk_checks(sizes, m, plan)
    cover = np.zeros(m, np.int64)
    for e, lo, hi in chunks:
        assert hi - lo <= plan["rows"]
        cover[lo:hi] += 1
        if slabs[e][1] == slabs[e][0]:
            assert [c for c in chunks if c[0] == e] == [(e, lo, lo)]
    routed = slabs[-1][1]
    assert (cover[:routed] == 1).all() and not cover[routed:].any()


@settings(max_examples=200, deadline=None)
@given(sizes=st.lists(st.integers(-3000, 3000), min_size=1, max_size=20),
       m=st.integers(0, 6000))
def test_grouped_dw_chunks_of_overlapping_slabs(sizes, m):
    """Negative sizes overlap the clamped slabs (their lengths may sum past
    M): the chunk length doubles until the list fits the slots, and each
    slab's rows still lie in exactly one of its own chunks."""
    plan = tmk.grouped_dw_plan(m, 64, 96, len(sizes), torch.float32)
    chunks, slabs = _chunk_checks(sizes, m, plan)
    for e, (lo, hi) in enumerate(slabs):
        cover = np.zeros(m, np.int64)
        for _, a, b in (c for c in chunks if c[0] == e):
            cover[a:b] += 1
        assert (cover[lo:hi] == 1).all() and cover.sum() == hi - lo


@settings(max_examples=300, deadline=None)
@given(m=st.integers(0, 2**31 - 1), k=st.integers(1, 16384), n=st.integers(1, 16384),
       e=st.integers(1, 256), bf16=st.booleans())
def test_grouped_dw_plan_grid_and_workspace(m, k, n, e, bf16):
    """The grid (slots × tiles) fits grid x; R is a multiple of the row
    unit, at least the minimum, at most the bf16 cap, and otherwise the
    shortest that keeps ⌊M / R⌋ chunks over every tile within
    GDW_FILL_ELEMS elements of dW work, so that until the cap the workspace
    (a partial tile for each slot and tile) stays within that plus E tiles
    of dW[e], whatever M."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    plan = tmk.grouped_dw_plan(m, k, n, e, dtype)
    tj, tc = tmk.GDW_TILE[dtype]
    tiles = -(-k // tj) * -(-n // tc)
    work = tiles * tj * tc  # dW elements of one chunk over every tile
    rows = plan["rows"]
    assert plan["tile"] == (tj, tc) and plan["stage_rows"] == tmk.GDW_STAGE_ROWS
    cap = tmk.GDW_MAX_ROWS[dtype]
    assert rows % tmk.GDW_ROW_UNIT == 0 and rows >= tmk.GDW_MIN_ROWS
    assert cap is None or rows <= cap
    assert plan["slots"] == m // rows + e and plan["blocks"] == plan["slots"] * tiles
    assert plan["workspace_bytes"] == 4 * (plan["slots"] * work + e * tiles)
    if rows != cap:
        assert plan["blocks"] <= GRID_X_MAX
        assert (m // rows) * work <= tmk.GDW_FILL_ELEMS
    if tmk.GDW_MIN_ROWS < rows != cap:  # the fill rule set R: one row unit less cuts finer
        assert -(-m // (rows - tmk.GDW_ROW_UNIT)) * work > tmk.GDW_FILL_ELEMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("e", [4, 8])
@pytest.mark.parametrize("k,n", [(512, 2048), (2048, 512)])
def test_grouped_dw_plan_at_the_moe_step(e, k, n, dtype):
    """At the MoE step (M = 8192, dW1 and dW2): R = 1024 in both dtypes, so
    a balanced slab of E = 8 (1024 rows) stays one chunk, while a collapsed
    routing (8000 rows in one expert) is cut into 8 chunks: 8 × tiles
    blocks of work, more than the card's 132 SMs."""
    plan = tmk.grouped_dw_plan(8192, k, n, e, dtype)
    assert plan["rows"] == 1024 and plan["slots"] == 8 + e
    balanced = tmk.grouped_dw_chunks([8192 // e] * e, 8192, plan)
    assert len(balanced) == e * (8192 // e // 1024)
    collapsed = tmk.grouped_dw_chunks([0] * (e - 1) + [8000], 8192, plan)
    assert sum(1 for c in collapsed if c[1] < c[2]) == 8
    assert 8 * plan["blocks"] // plan["slots"] > 132
