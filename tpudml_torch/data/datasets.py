"""Datasets of the port (the port of ``tpudml/data/datasets.py``:
``ArrayDataset``, ``synthetic_classification``, ``synthetic_lm``,
``load_mnist``, ``load_cifar10`` and ``load_dataset``). Plain numpy,
bit-identical to the JAX package's.

MNIST is read from its IDX files under ``data_dir`` (torchvision's
``MNIST/raw`` layout or flat, plain or ``.gz``), CIFAR-10 from its
python-pickle batches (unpacking ``cifar-10-python.tar.gz`` there if that
is all there is); without them the deterministic, learnable synthetic set
of the same shapes takes their place. Batches are gathered by the native
data plane (``tpudml_torch.native``), which also fuses a uint8 dataset's
normalization into the gather.
"""

from __future__ import annotations

import pickle
import tarfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tpudml_torch import native
from tpudml_torch.data.idx import read_idx

MNIST_FILES = {
    "train_images": ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
    "train_labels": ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
    "test_images": ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
    "test_labels": ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"],
}


@dataclass
class ArrayDataset:
    """In-memory dataset of (images, labels): float32 already normalized
    (scale=1, bias=0), or raw uint8 normalized at batch time as
    ``raw * scale + bias`` in f32 by the native fused gather (4× less
    resident memory than f32)."""

    images: np.ndarray  # [N, ...] float32 normalized, or uint8 raw
    labels: np.ndarray  # [N] int32
    name: str = "dataset"
    scale: float = 1.0
    bias: float = 0.0

    def __post_init__(self):
        # Row-major storage, as the native gather reads it (a transposed
        # load, e.g. CIFAR's NCHW batches viewed NHWC, is copied once here).
        self.images = np.ascontiguousarray(self.images)
        self.labels = np.ascontiguousarray(self.labels)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx):
        # Same semantics as gather; scalars, index arrays, boolean masks
        # and slices.
        if isinstance(idx, slice):
            idx = np.arange(len(self))[idx]
        idx = np.asarray(idx)
        if idx.dtype == np.bool_:
            if len(idx) != len(self):
                raise IndexError(
                    f"boolean mask length {len(idx)} does not match dataset "
                    f"length {len(self)}"
                )
            idx = np.nonzero(idx)[0]
        if idx.ndim == 0:
            imgs, lbls = self.gather(idx[None].astype(np.int64))
            return imgs[0], lbls[0]
        return self.gather(idx.astype(np.int64))

    def gather(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """A batch: rows ``idx`` (normalized to f32 for uint8 storage) and
        their labels, through ``tpudml_torch.native``."""
        if self.images.dtype == np.uint8:
            imgs = native.gather_normalize(self.images, idx, self.scale, self.bias)
        else:
            imgs = native.gather_rows(self.images, idx)
        return imgs, native.gather_labels(self.labels, idx)


def synthetic_lm(
    n: int, seq_len: int, vocab: int, seed: int, noise: float = 0.0
) -> np.ndarray:
    """Deterministic next-token sequences: x[t+1] = π(x[t]) for a fixed
    vocab permutation π (optionally corrupted with probability ``noise``).
    A language model must learn π, so LM loss → 0 is achievable. Returns
    [n, seq_len+1] int32 tokens; slice [:, :-1] / [:, 1:] for
    inputs/targets."""
    perm = np.random.default_rng(0xC0FFEE).permutation(vocab)
    rng = np.random.default_rng(seed)
    seqs = np.empty((n, seq_len + 1), np.int32)
    seqs[:, 0] = rng.integers(0, vocab, size=n)
    for t in range(seq_len):
        seqs[:, t + 1] = perm[seqs[:, t]]
    if noise:
        corrupt = rng.random(seqs.shape) < noise
        seqs = np.where(corrupt, rng.integers(0, vocab, size=seqs.shape), seqs)
    return seqs.astype(np.int32)


def _check_storage(storage: str) -> None:
    if storage not in ("u8", "f32"):
        raise ValueError(f"storage must be 'u8' or 'f32', got {storage!r}")


def synthetic_classification(
    n: int,
    shape: tuple[int, ...],
    num_classes: int,
    seed: int,
    noise: float = 0.35,
    proto_seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic class-structured data: per-class prototype + Gaussian
    noise, clipped to [0,1]. ``proto_seed`` fixes the class prototypes
    independently of the sample draw, so train/test splits share one
    distribution (different ``seed``, same ``proto_seed``)."""
    proto_rng = np.random.default_rng(seed if proto_seed is None else proto_seed)
    protos = proto_rng.uniform(0.0, 1.0, size=(num_classes, *shape)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    imgs = protos[labels] + rng.normal(0.0, noise, size=(n, *shape)).astype(np.float32)
    return np.clip(imgs, 0.0, 1.0).astype(np.float32), labels


def _find_file(data_dir: Path, candidates: list[str]) -> Path | None:
    # torchvision layout (MNIST/raw/...) and flat layout both supported.
    for sub in ("", "MNIST/raw", "mnist", "raw"):
        for name in candidates:
            for suffix in ("", ".gz"):
                p = data_dir / sub / (name + suffix)
                if p.exists():
                    return p
    return None


def load_mnist(
    data_dir: str = "./data",
    split: str = "train",
    synthetic_fallback: bool = True,
    synthetic_size: int | None = None,
    storage: str = "u8",
) -> ArrayDataset:
    """MNIST, NHWC [N, 28, 28, 1] in [0, 1] (the reference's ToTensor
    only, codes/task1/pytorch/model.py:93-95): ``u8`` storage keeps the raw
    bytes and fuses the /255 into the batch gather, ``f32`` converts at
    load time. Without the IDX files, the synthetic set (seeds 0 / 1 for
    train / test, prototypes from seed 100; 60000 / 10000 images unless
    ``synthetic_size``)."""
    _check_storage(storage)
    data_dir = Path(data_dir)
    part = "train" if split == "train" else "test"
    img_path = _find_file(data_dir, MNIST_FILES[f"{part}_images"])
    lbl_path = _find_file(data_dir, MNIST_FILES[f"{part}_labels"])
    if img_path is not None and lbl_path is not None:
        images = read_idx(img_path)[..., None]  # [N, 28, 28, 1] uint8
        labels = read_idx(lbl_path).astype(np.int32)
        if storage == "u8":
            return ArrayDataset(np.ascontiguousarray(images), labels, name=f"mnist-{split}",
                                scale=1.0 / 255.0)
        return ArrayDataset(images.astype(np.float32) / 255.0, labels, name=f"mnist-{split}")
    if not synthetic_fallback:
        raise FileNotFoundError(f"MNIST IDX files not found under {data_dir}")
    n = synthetic_size or (60000 if split == "train" else 10000)
    imgs, labels = synthetic_classification(
        n, (28, 28, 1), 10, seed=0 if split == "train" else 1, proto_seed=100)
    return ArrayDataset(imgs, labels, name=f"mnist-synthetic-{split}")


def load_cifar10(
    data_dir: str = "./data",
    split: str = "train",
    synthetic_fallback: bool = True,
    synthetic_size: int | None = None,
    storage: str = "u8",
) -> ArrayDataset:
    """CIFAR-10 python-pickle batches, NHWC in [0,1] (``u8`` storage keeps
    the raw bytes and normalizes at batch time, ``f32`` at load time);
    else the synthetic set (seeds 2 / 3 for train / test, prototypes from
    seed 101; 50000 / 10000 images unless ``synthetic_size``)."""
    _check_storage(storage)
    data_dir = Path(data_dir)
    base = None
    for cand in (data_dir / "cifar-10-batches-py", data_dir):
        if (cand / "data_batch_1").exists():
            base = cand
            break
    tar = data_dir / "cifar-10-python.tar.gz"
    if base is None and tar.exists():
        with tarfile.open(tar) as tf:
            tf.extractall(data_dir, filter="data")  # no path traversal
        base = data_dir / "cifar-10-batches-py"
    if base is not None:
        files = ([base / f"data_batch_{i}" for i in range(1, 6)] if split == "train"
                 else [base / "test_batch"])
        imgs, labels = [], []
        for f in files:
            with open(f, "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            imgs.append(d[b"data"])
            labels.append(np.asarray(d[b"labels"]))
        raw = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        all_labels = np.concatenate(labels).astype(np.int32)
        if storage == "u8":
            return ArrayDataset(np.ascontiguousarray(raw), all_labels,
                                name=f"cifar10-{split}", scale=1.0 / 255.0)
        return ArrayDataset(raw.astype(np.float32) / 255.0, all_labels,
                            name=f"cifar10-{split}")
    if not synthetic_fallback:
        raise FileNotFoundError(f"CIFAR-10 not found under {data_dir}")
    n = synthetic_size or (50000 if split == "train" else 10000)
    imgs, labels = synthetic_classification(
        n, (32, 32, 3), 10, seed=2 if split == "train" else 3, proto_seed=101)
    return ArrayDataset(imgs, labels, name=f"cifar10-synthetic-{split}")


def load_dataset(name: str, data_dir: str, split: str, **kw) -> ArrayDataset:
    """``mnist`` (:func:`load_mnist`), ``cifar10`` (:func:`load_cifar10`) or
    ``synthetic`` (MNIST-shaped [28, 28, 1] images, 4096 / 1024,
    prototypes from seed 100)."""
    name = name.lower()
    if name == "mnist":
        return load_mnist(data_dir, split, **kw)
    if name == "cifar10":
        return load_cifar10(data_dir, split, **kw)
    if name == "synthetic":
        storage = kw.pop("storage", "f32")
        _check_storage(storage)
        n = kw.get("synthetic_size") or (4096 if split == "train" else 1024)
        imgs, labels = synthetic_classification(
            n, (28, 28, 1), 10, seed=0 if split == "train" else 1, proto_seed=100)
        if storage == "u8":
            return ArrayDataset(np.ascontiguousarray((imgs * 255.0).round().astype(np.uint8)),
                                labels, name=f"synthetic-{split}", scale=1.0 / 255.0)
        return ArrayDataset(imgs, labels, name=f"synthetic-{split}")
    raise ValueError(f"unknown dataset {name!r}")
