"""MNIST's IDX files, the native data plane and the device prefetch of
the port against ``tpudml``, on the CPU.

- ``read_idx`` / ``write_idx``: round trips of every IDX dtype (the
  multi-byte ones swapped by the native byte swap), plain and ``.gz``,
  read across with JAX's reader and writer; malformed files raise.
- ``load_mnist``: IDX files under JAX's candidate names and
  subdirectories, ``u8`` (the /255 fused into the gather) against
  ``f32`` and against JAX's loader; the synthetic fallback (60000 /
  10000 images, seeds 0 / 1, prototypes 100) equal to JAX's bitwise.
- ``tpudml_torch.native``: built at first use and loaded, each gather
  against numpy indexing (the path ``TPUDML_NO_NATIVE=1`` asks for),
  out-of-range indices raising, a failed build raising, and the loader
  gathering through it.
- ``prefetch_to_device``: order and values, ``size`` validated at the call.

Values are compared bitwise (the gathers copy rows, and the fused
normalization computes ``float(u8) * scale + bias`` in f32 as numpy
does), except ``u8`` against ``f32`` storage: ``u8 · (1/255)`` and ``u8 /
255`` are at most 1 ulp apart, in JAX's loader as in the port's.
"""

import gzip

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tpudml.data.datasets import load_mnist as jax_load_mnist  # noqa: E402
from tpudml.data.idx import read_idx as jax_read_idx  # noqa: E402
from tpudml.data.idx import write_idx as jax_write_idx  # noqa: E402
from tpudml_torch import native  # noqa: E402
from tpudml_torch.data import (  # noqa: E402
    ArrayDataset, DataLoader, load_dataset, load_mnist, prefetch_to_device, read_idx,
    write_idx,
)
from tpudml_torch.data import datasets  # noqa: E402

DTYPES = [np.uint8, np.int8, np.int16, np.int32, np.float32, np.float64]

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tiny tensors (several test
    workers share the machine's cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("suffix", ["", ".gz"])
@pytest.mark.parametrize("dtype", DTYPES, ids=[np.dtype(d).name for d in DTYPES])
def test_idx_round_trips_and_reads_across_with_jax(tmp_path, dtype, suffix):
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(3, 5, 4)) * 100).astype(dtype)
    write_idx(tmp_path / f"a{suffix}", a)
    jax_write_idx(tmp_path / f"b{suffix}", a)
    assert (tmp_path / f"a{suffix}").read_bytes() == (tmp_path / f"b{suffix}").read_bytes() \
        or suffix == ".gz"  # gzip headers carry a time stamp
    for path in (tmp_path / f"a{suffix}", tmp_path / f"b{suffix}"):
        got = read_idx(path)
        assert got.dtype == a.dtype and got.flags.writeable
        np.testing.assert_array_equal(got, a)
        np.testing.assert_array_equal(got, jax_read_idx(path))


def test_malformed_idx_files_raise(tmp_path):
    (tmp_path / "bad").write_bytes(b"\x01\x00\x08\x01\x00\x00\x00\x01\x05")
    with pytest.raises(ValueError, match="not an IDX file"):
        read_idx(tmp_path / "bad")
    (tmp_path / "code").write_bytes(b"\x00\x00\x07\x01\x00\x00\x00\x01\x05")
    with pytest.raises(ValueError, match="unknown IDX dtype 0x07"):
        read_idx(tmp_path / "code")
    with pytest.raises(ValueError, match="not representable"):
        write_idx(tmp_path / "c", np.zeros(3, np.int64))


def _fake_mnist(root, n_train=40, n_test=24, gz=False):
    rng = np.random.default_rng(1)
    sfx = ".gz" if gz else ""
    for split, n in (("train", n_train), ("t10k", n_test)):
        write_idx(root / f"{split}-images-idx3-ubyte{sfx}",
                  rng.integers(0, 256, size=(n, 28, 28)).astype(np.uint8))
        write_idx(root / f"{split}-labels-idx1-ubyte{sfx}",
                  rng.integers(0, 10, size=n).astype(np.uint8))


@pytest.mark.parametrize("layout", ["flat", "MNIST/raw", "gz"])
def test_load_mnist_reads_idx_as_jax(tmp_path, layout):
    root = tmp_path / layout if layout == "MNIST/raw" else tmp_path
    root.mkdir(parents=True, exist_ok=True)
    _fake_mnist(root, gz=layout == "gz")
    for split in ("train", "test"):
        u8, f32 = (load_mnist(str(tmp_path), split, storage=s) for s in ("u8", "f32"))
        want = jax_load_mnist(str(tmp_path), split, storage="f32")
        assert u8.name == f32.name == f"mnist-{split}"
        assert u8.images.dtype == np.uint8 and u8.images.shape[1:] == (28, 28, 1)
        assert u8.labels.dtype == np.int32
        np.testing.assert_array_equal(f32.images, want.images)
        idx = np.arange(len(u8))[::-1]
        gu, gf = u8.gather(idx), f32.gather(idx)
        # u8 · (1/255) in the gather against f32's u8 / 255 at load: 1 ulp apart,
        # as in JAX's loader.
        np.testing.assert_array_max_ulp(gu[0], gf[0], maxulp=1)
        np.testing.assert_array_equal(gu[1], gf[1])
        np.testing.assert_array_equal(gu[0], jax_load_mnist(str(tmp_path), split).gather(idx)[0])
    assert load_dataset("mnist", str(tmp_path), "train").name == "mnist-train"


def test_mnist_synthetic_fallback_is_jaxs_bitwise(tmp_path, monkeypatch):
    """The test split at its default 10000 images and the train split cut
    to 3000, bitwise; the train split's default size is 60000."""
    got, want = load_mnist(str(tmp_path), "test"), jax_load_mnist(str(tmp_path), "test")
    assert got.name == want.name == "mnist-synthetic-test" and len(got) == 10000
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    got = load_mnist(str(tmp_path), "train", synthetic_size=3000)
    want = jax_load_mnist(str(tmp_path), "train", synthetic_size=3000)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    calls = []
    monkeypatch.setattr(datasets, "synthetic_classification",
                        lambda n, *a, **kw: calls.append((n, a, kw)) or (
                            np.zeros((1, 28, 28, 1), np.float32), np.zeros(1, np.int32)))
    load_mnist(str(tmp_path), "train")
    assert calls == [(60000, ((28, 28, 1), 10), dict(seed=0, proto_seed=100))]
    with pytest.raises(FileNotFoundError, match="MNIST IDX files not found"):
        load_mnist(str(tmp_path), "train", synthetic_fallback=False)


# ---------------------------------------------------------------- native


def test_native_is_built_and_loaded():
    assert native.available()
    assert native._LIB_PATH.exists() and native._LIB_PATH.parent.name == "_build"


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_native_gathers_equal_numpy(monkeypatch, dtype):
    rng = np.random.default_rng(2)
    src = (rng.random((50, 7, 3)) * 255).astype(dtype)
    labels = rng.integers(0, 10, size=50).astype(np.int32)
    idx = np.array([0, 49, -1, 7, 7, -50])
    got = (native.gather_rows(src, idx), native.gather_labels(labels, idx),
           native.gather_normalize(src.astype(np.uint8), idx, 1 / 255, -0.5))
    monkeypatch.setenv("TPUDML_NO_NATIVE", "1")
    assert not native.available()
    want = (native.gather_rows(src, idx), native.gather_labels(labels, idx),
            native.gather_normalize(src.astype(np.uint8), idx, 1 / 255, -0.5))
    np.testing.assert_array_equal(want[0], src[idx])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_native_rejects_what_it_cannot_gather():
    src = np.zeros((4, 3), np.float32)
    for bad in ([4], [-5], [0, 1, 9]):
        with pytest.raises(IndexError, match="out of range"):
            native.gather_rows(src, np.array(bad))
    with pytest.raises(TypeError, match="TPUDML_NO_NATIVE"):
        native.gather_rows(src.astype(np.float64), np.array([0]))
    with pytest.raises(TypeError, match="C-contiguous"):
        native.gather_rows(np.zeros((3, 4), np.float32).T, np.array([0]))
    with pytest.raises(ValueError, match="writeable"):
        a = np.zeros(3, np.int32)
        a.flags.writeable = False
        native.byteswap_inplace(a)
    b = np.array([1, 2**16], dtype=np.int32)
    np.testing.assert_array_equal(native.byteswap_inplace(b), [2**24, 2**8])


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "dataplane.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_LIB_PATH", tmp_path / "_build" / "lib.so")
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.available()


def test_loader_gathers_through_native(monkeypatch):
    calls = []
    rows = native.gather_normalize
    monkeypatch.setattr(native, "gather_normalize",
                        lambda *a, **kw: calls.append(len(a[1])) or rows(*a, **kw))
    ds = ArrayDataset(np.arange(10 * 4, dtype=np.uint8).reshape(10, 2, 2, 1),
                      np.arange(10, dtype=np.int32), scale=0.5)
    batches = list(DataLoader(ds, 4))
    assert calls == [4, 4] and len(batches) == 2
    np.testing.assert_array_equal(batches[1][0], ds.images[4:8].astype(np.float32) * 0.5)


# -------------------------------------------------------------- prefetch


def test_prefetch_keeps_order_and_values():
    rng = np.random.default_rng(3)
    items = [(rng.random((2, 3), dtype=np.float32), np.arange(i, i + 2, dtype=np.int32))
             for i in range(5)]
    for size in (1, 2, 7):
        got = list(prefetch_to_device(iter(items), size=size, device="cpu"))
        assert len(got) == 5
        for (x, y), (wx, wy) in zip(got, items):
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            np.testing.assert_array_equal(x.numpy(), wx)
            np.testing.assert_array_equal(y.numpy(), wy)
    nested = list(prefetch_to_device([{"a": [np.ones(2)]}], device="cpu"))
    assert torch.equal(nested[0]["a"][0], torch.ones(2, dtype=torch.float64))


def test_prefetch_validates_size_at_the_call():
    def never():
        raise AssertionError("consumed")
        yield

    with pytest.raises(ValueError, match="prefetch size must be >= 1"):
        prefetch_to_device(never(), size=0, device="cpu")


def test_gz_reader_reads_what_gzip_wrote(tmp_path):
    a = np.arange(6, dtype=np.int16).reshape(2, 3)
    write_idx(tmp_path / "x", a)
    with gzip.open(tmp_path / "y.gz", "wb") as f:
        f.write((tmp_path / "x").read_bytes())
    np.testing.assert_array_equal(read_idx(tmp_path / "y.gz"), a)
