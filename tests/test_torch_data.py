"""The port's samplers and loaders against ``tpudml.data``: the same index
streams and the same batches, bit for bit, for every division, with and
without shuffling, over three epochs, at world 1, 2 and 3 and a dataset
size that no world divides."""

import numpy as np
import pytest

pytest.importorskip("torch")

from tpudml.data.datasets import ArrayDataset as JaxArrayDataset  # noqa: E402
from tpudml.data.loader import DataLoader as JaxLoader  # noqa: E402
from tpudml.data.loader import ShardedDataLoader as JaxShardedLoader  # noqa: E402
from tpudml.data.sampler import make_sampler as jax_make_sampler  # noqa: E402
from tpudml_torch.data import (  # noqa: E402
    ArrayDataset, DataLoader, ShardedDataLoader, make_sampler,
)

N = 47  # prime: divides no world
DIVISIONS = ("partition", "sampling", "sequential")


@pytest.mark.parametrize("division", DIVISIONS)
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "ordered"])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_sampler_streams_bitwise(division, shuffle, world):
    for rank in range(world):
        ours = make_sampler(division, N, world, rank, shuffle=shuffle, seed=11)
        theirs = jax_make_sampler(division, N, world, rank, shuffle=shuffle, seed=11)
        assert len(ours) == len(theirs)
        for epoch in range(3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            a = np.fromiter(iter(ours), np.int64)
            b = np.fromiter(iter(theirs), np.int64)
            np.testing.assert_array_equal(a, b)


def test_sampler_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="unknown division"):
        make_sampler("striped", N, 2, 0)
    with pytest.raises(ValueError, match="out of range"):
        make_sampler("partition", N, 2, 2)


def _data(dtype=np.float32):
    rng = np.random.default_rng(3)
    images = (rng.integers(0, 256, size=(N, 4, 4, 1)).astype(np.uint8) if dtype == np.uint8
              else rng.standard_normal((N, 4, 4, 1)).astype(np.float32))
    labels = rng.integers(0, 10, size=N).astype(np.int32)
    return images, labels


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("division", DIVISIONS)
def test_loader_batches_bitwise(division, drop_remainder):
    images, labels = _data()
    ours = DataLoader(ArrayDataset(images, labels), 5,
                      make_sampler(division, N, 2, 1, seed=4), drop_remainder)
    theirs = JaxLoader(JaxArrayDataset(images, labels), 5,
                       jax_make_sampler(division, N, 2, 1, seed=4), drop_remainder)
    assert len(ours) == len(theirs)
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want)
        for (x, y), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)


def test_sharded_loader_batches_bitwise():
    images, labels = _data()
    world = 3
    ours = ShardedDataLoader(ArrayDataset(images, labels), 4,
                             [make_sampler("partition", N, world, r, seed=2)
                              for r in range(world)])
    theirs = JaxShardedLoader(JaxArrayDataset(images, labels), 4,
                              [jax_make_sampler("partition", N, world, r, seed=2)
                               for r in range(world)])
    ours.set_epoch(1)
    theirs.set_epoch(1)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 4  # ceil(47 / 3) = 16 rows a replica
    for (x, y), (wx, wy) in zip(got, want):
        assert x.shape == (world, 4, 4, 4, 1)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
    with pytest.raises(ValueError, match="at least one sampler"):
        ShardedDataLoader(ArrayDataset(images, labels), 4, [])


def test_u8_storage_normalizes_at_batch_time():
    images, labels = _data(np.uint8)
    scale, bias = 1 / 255, -0.5
    ds = ArrayDataset(images, labels, scale=scale, bias=bias)
    want = JaxArrayDataset(images, labels, scale=scale, bias=bias)
    idx = np.array([5, 0, 46, 5])
    x, y = ds.gather(idx)
    wx, wy = want.gather(idx)
    assert x.dtype == np.float32
    np.testing.assert_allclose(x, wx, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(y, wy)
    np.testing.assert_array_equal(ds[3][0], ds.gather(np.array([3]))[0][0])
    np.testing.assert_array_equal(ds[np.arange(N) < 2][1], labels[:2])
