"""PRNG keys (the port of ``tpudml/core/prng.py``).

JAX's keys are explicit values folded with epoch, step, rank and layer, so
every draw is reproducible from the config's seed. The port keeps that
discipline without a global RNG: a :class:`Key` is its seed and the path
of folds and splits that led to it, e.g. ``seed → fold 0x0D0 → fold
step → fold rank → fold layer → fold salt``. A draw asks the key for a
``torch.Generator`` on the tensor's device, seeded from a hash of that
path (numpy's ``SeedSequence``), so the same path gives the same stream
on every call and every process. The streams are not JAX's threefry
numbers; because the key keeps its path, a test can rebuild JAX's key for
the same place in the program and compare against it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_U32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1
_SEED, _FOLD, _SPLIT = 0, 1, 2  # entry tags: no two paths hash from the same words


@dataclass(frozen=True)
class Key:
    """A seed and its path: ``("fold", data)`` and ``("split", num, index)``
    entries in the order they were applied (``jax.random.fold_in`` and
    ``jax.random.split(key, num)[index]``)."""

    seed: int
    path: tuple = ()

    def fold_in(self, data: int) -> "Key":
        """The key folded with ``data`` (taken as uint32, as JAX does)."""
        return Key(self.seed, self.path + (("fold", int(data) & _U32),))

    def split(self, num: int, index: int) -> "Key":
        """The ``index``-th of ``num`` keys split from this one."""
        if not 0 <= index < num:
            raise ValueError(f"split index {index} outside [0, {num})")
        return Key(self.seed, self.path + (("split", int(num), int(index)),))

    def entropy(self) -> list[int]:
        """The path as 32-bit words, each entry tagged by its kind."""
        s = int(self.seed) & _U64
        words = [_SEED, s & _U32, s >> 32]
        for entry in self.path:
            words += [_FOLD, entry[1]] if entry[0] == "fold" else [_SPLIT, *entry[1:]]
        return words

    def generator(self, device: str | torch.device = "cpu") -> torch.Generator:
        """A generator on ``device`` seeded from the hash of the path."""
        state = np.random.SeedSequence(self.entropy()).generate_state(2, np.uint32)
        seed = (int(state[0]) | int(state[1]) << 32) & ((1 << 63) - 1)
        return torch.Generator(device=device).manual_seed(seed)


def seed_key(seed: int) -> Key:
    return Key(int(seed))


def key_for_step(root: Key, step: int) -> Key:
    return root.fold_in(step)


def fold_in_epoch(root: Key, epoch: int) -> Key:
    """Sampler-style per-epoch reshuffle key (the ``set_epoch`` analogue,
    reference: sections/task3.tex:52)."""
    return root.fold_in(epoch)
