"""Datasets of the port (the port of ``tpudml/data/datasets.py``:
``ArrayDataset`` and ``synthetic_lm``). Plain numpy, bit-identical to the
JAX package's."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ArrayDataset:
    """In-memory dataset of (images, labels): float32 already normalized
    (scale=1, bias=0), or raw uint8 normalized at batch time as
    ``raw * scale + bias`` in f32 (the JAX package's numpy path)."""

    images: np.ndarray  # [N, ...] float32 normalized, or uint8 raw
    labels: np.ndarray  # [N] int32
    name: str = "dataset"
    scale: float = 1.0
    bias: float = 0.0

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
        their labels."""
        if self.images.dtype == np.uint8:
            imgs = self.images[idx].astype(np.float32) * self.scale + self.bias
        else:
            imgs = self.images[idx]
        return imgs, self.labels[idx]


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
