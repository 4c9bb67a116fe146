"""The port's attention ops against ``tpudml.nn.attention`` and the Pallas
flash forward (interpret mode), on the CPU.

Tolerances: f32 at rtol=1e-5, atol=1e-6 (the JAX package's parity
tolerances) throughout — the plain flash version computes the softmax in
one pass where the interpreted kernel walks 8-wide tiles, which moves
results by a few f32 ulps only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.nn import attention as jatt  # noqa: E402
from tpudml.ops.attention_kernel import flash_forward_lse as jax_flash  # noqa: E402
from tpudml_torch.nn import attention as tatt  # noqa: E402
from tpudml_torch.ops import flash_forward_lse, flash_head_dim_ok  # noqa: E402
from tpudml_torch.ops.attention_kernel import NEG_INF  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _qkv(b=2, t=12, h=4, d=8, tk=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk or t, h, d)).astype(np.float32)
    v = rng.normal(size=(b, tk or t, h, d)).astype(np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("batched", [False, True], ids=["pos_T", "pos_BT"])
def test_rotary_embedding_matches_jax(batched):
    x, _, _ = _qkv(b=3, t=5, h=2, d=8)
    if batched:  # per-slot decode positions
        pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4], [9, 10, 11, 12, 13]])
    else:
        pos = np.arange(5) + 17
    ref = jatt.rotary_embedding(jnp.asarray(x), jnp.asarray(pos), 500.0)
    got = tatt.rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos), 500.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal,q_offset", [(False, 0), (True, 0), (True, 8)])
def test_dot_product_attention_matches_jax(causal, q_offset):
    q, k, v = _qkv(t=4, tk=4 + q_offset)
    ref = jatt.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal, q_offset=q_offset)
    got = tatt.dot_product_attention(*_t(q, k, v), causal=causal,
                                     q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_decode_attention_matches_jax():
    q, k, v = _qkv(b=3, t=1, tk=10)
    pos = np.array([0, 4, 9], np.int32)
    ref = jatt.decode_attention(*map(jnp.asarray, (q, k, v, pos)))
    got = tatt.decode_attention(*_t(q, k, v), torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


_MASKS = [(False, 0), (True, 0), (True, 1)]
# Head dim 8 (the first six cases, named as before) and, outside the
# kernels' compiled widths, 48, 80 and 256 (the forward takes 1 to 256).
_FWD_CASES = [(t, causal, k_shift, d) for d in (8, 48, 80, 256)
              for causal, k_shift in _MASKS for t in (16, 13)]


@pytest.mark.parametrize(
    "t,causal,k_shift,d", _FWD_CASES,
    ids=[f"{causal}-{k_shift}-T{t}" + ("" if d == 8 else f"-d{d}")
         for t, causal, k_shift, d in _FWD_CASES])
def test_flash_forward_lse_plain_matches_pallas(t, causal, k_shift, d):
    """Plain version vs the Pallas kernel run in interpret mode with 8-row
    tiles (several Q and K tiles, a padded tail when T=13). A row that
    sees no key (row 0 at k_shift=1) has lse -1e30 in both; its output is
    the port's defined 0 where the TPU kernel leaves an average over the
    masked tile, which no merge ever weighs, so outputs are compared on
    rows that see a key."""
    q, k, v = _qkv(t=t, d=d)
    ro, rl = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                       k_shift=k_shift, block_q=8, block_k=8, interpret=True)
    o, lse = flash_forward_lse(*_t(q, k, v), causal=causal, k_shift=k_shift)
    seen = slice(k_shift if causal else 0, None)
    np.testing.assert_allclose(o.numpy()[:, seen], np.asarray(ro)[:, seen], **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rl), **TOL)
    if causal and k_shift:
        assert (lse.numpy()[..., 0] == NEG_INF).all()
        assert (o.numpy()[:, 0] == 0).all()


@pytest.mark.parametrize("dims, ok", [(range(1, 257), True), ((0, -1, 257, 512), False)],
                         ids=["inside", "outside"])
def test_flash_head_dim_ok(dims, ok):
    """The flash kernels' head-dim domain, forward and backward: 1 to 256."""
    assert all(flash_head_dim_ok(d) is ok for d in dims)


@pytest.mark.parametrize("start", [0, 8, 24], ids=["start0", "startC", "start3C"])
def test_chunk_flash_window_matches_causal_attention(start):
    """The log-sum-exp merge of per-block flash calls equals one causal
    attention over the window at the chunk's offset."""
    c = 8
    q, k, v = _qkv(b=1, t=c, tk=start + c, seed=start)
    ref = jatt.dot_product_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                     q_offset=start)
    got = tatt.chunk_flash_window(*_t(q, k, v), start)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    mine = tatt.dot_product_attention(*_t(q, k, v), causal=True, q_offset=start)
    np.testing.assert_allclose(got.numpy(), mine.numpy(), **TOL)


def test_multi_head_attention_gqa_matches_jax():
    """The module's full forward (projections, RoPE, GQA repeat, causal
    attention) with the JAX module's parameters."""
    from tpudml_torch.nn import MultiHeadAttention

    jm = jatt.MultiHeadAttention(16, 4, causal=True, num_kv_heads=2, rope=True)
    params, _ = jm.init(jax.random.key(3))
    tm = MultiHeadAttention(16, 4, causal=True, num_kv_heads=2, rope=True)
    tm.load_state_dict({f"{n}.{p}": torch.from_numpy(np.array(a))
                        for n, sub in params.items() for p, a in sub.items()})
    x = np.random.default_rng(4).normal(size=(2, 6, 16)).astype(np.float32)
    ref, _ = jm.apply(params, {}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
