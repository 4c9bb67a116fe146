"""Seeded synthetic data (the port's copy of ``tpudml/data/datasets.py``
``synthetic_lm``). Plain numpy, bit-identical to the JAX package's."""

from __future__ import annotations

import numpy as np


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
