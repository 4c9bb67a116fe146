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


@pytest.mark.parametrize("v", [64, 70])  # 70: padded vocab tail
def test_fused_decode_head_matches_pallas(v):
    x, w, b = _operands(v=v)
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
