"""The port's KV cache against ``tpudml.serve.cache``, for every kind.

Writes are pure copies and the int8 / bf16 encodings round the same way
in both packages (round half to even), so every stored array — codes,
scales, bf16 storage, f32 storage and the dequantized reads — is compared
bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.serve import cache as jcache  # noqa: E402
from tpudml_torch.serve import cache as tcache  # noqa: E402

B, L, H, D = 3, 16, 2, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _same(t, j):
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = _np(getattr(t, name)), _np(getattr(j, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind", tcache.KINDS)
def test_cache_writes_and_reads_match_jax(kind):
    rng = np.random.default_rng(0)
    jc = jcache.init_cache(B, L, H, D, kind)
    tc = tcache.init_cache(B, L, H, D, kind)
    assert tcache.cache_bytes(tc) == jcache.cache_bytes(jc)
    # A chunk into slot 1 at rows [4, 8), then one token per slot.
    kc, vc = (rng.normal(size=(1, 4, H, D)).astype(np.float32) * 3 for _ in range(2))
    jc = jcache.write_chunk(jc, jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(1, jnp.int32), 4)
    tc = tcache.write_chunk(tc, torch.from_numpy(kc), torch.from_numpy(vc), 1, 4)
    _same(tc, jc)
    kt, vt = (rng.normal(size=(B, 1, H, D)).astype(np.float32) for _ in range(2))
    kt[0, 0, 1] = 0.0  # an all-zero row: the scale floor
    pos = np.array([0, 8, 15], np.int32)
    jc = jcache.write_token(jc, jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(pos))
    tc = tcache.write_token(tc, torch.from_numpy(kt), torch.from_numpy(vt),
                            torch.from_numpy(pos))
    _same(tc, jc)
    for got, ref in zip(tcache.read_all(tc, torch.float32),
                        jcache.read_all(jc, jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(tcache.read_slot_prefix(tc, 1, 12, torch.float32),
                        jcache.read_slot_prefix(jc, jnp.asarray(1, jnp.int32), 12,
                                                jnp.float32)):
        assert got.shape == (1, 12, H, D)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int8_quant_rounds_half_to_even():
    """Codes at exact .5 ties round to even in both packages."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, 0.0]], np.float32)
    jq, js = jcache._quant(jnp.asarray(x))
    tq, ts = tcache._quant(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.tolist()[0][1:6] == [0, 2, 2, 0, -2]


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown cache kind"):
        tcache.init_cache(1, 4, 1, 2, "fp8")
