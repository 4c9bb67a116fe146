"""Sampler framework: how the global dataset is divided across replicas
(a copy of ``tpudml/data/sampler.py``, plain numpy: the same index
streams for every division, seed, epoch, rank and world).

Re-design of the reference's task3 sampler layer (codes/task3/sampler.py:5-25
+ torch ``DistributedSampler`` at codes/task2/model.py:124). The two required
division modes (sections/task3.tex:19-24, sections/checking.tex:13):

- **random partition** — one shuffle from a seed shared by all replicas,
  each replica takes a disjoint stride → disjoint, jointly-exhaustive shards.
- **random sampling** — each replica shuffles independently (the reference
  achieves this by passing ``seed=rank``, codes/task3/model.py:111) → random
  sampling with replacement *across* replicas (examples may be seen by
  several replicas or none in a given epoch).

Both are bit-reproducible from (seed, epoch, rank) and support the
``set_epoch`` per-epoch reshuffle contract (sections/task3.tex:52).
Index generation is host-side numpy — it composes with per-host data
sharding (each host materializes only its replicas' indices).
"""

from __future__ import annotations

import numpy as np


class Sampler:
    """Iterable of dataset indices for one replica's epoch.

    Parity with the reference's ``MySampler`` surface: ``__iter__``,
    ``__len__``, ``set_epoch`` (codes/task3/sampler.py:16-25).
    """

    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
    ):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_size = int(dataset_size)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        # ceil(N / num_replicas), as in the reference (sampler.py:14).
        self.num_samples = -(-self.dataset_size // num_replicas)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def _indices(self) -> np.ndarray:
        raise NotImplementedError

    def __iter__(self):
        return iter(self._indices())


class SequentialSampler(Sampler):
    """Un-shuffled strided shard; the shuffle=False degenerate case."""

    def _indices(self) -> np.ndarray:
        padded = _pad_to_multiple(np.arange(self.dataset_size), self.num_replicas)
        return padded[self.rank :: self.num_replicas]


class RandomPartitionSampler(Sampler):
    """Random partition: shared-seed shuffle, disjoint per-rank stride.

    All replicas must construct this with the SAME seed; the per-epoch
    reshuffle folds in ``epoch`` so shards change across epochs but remain
    disjoint within one.
    """

    def _indices(self) -> np.ndarray:
        order = np.arange(self.dataset_size)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(order)
        padded = _pad_to_multiple(order, self.num_replicas)
        return padded[self.rank :: self.num_replicas]


class RandomSamplingSampler(Sampler):
    """Random sampling: per-rank independent shuffle (reference's
    ``seed=rank`` discipline) — replicas draw overlapping samples."""

    def _indices(self) -> np.ndarray:
        if not self.shuffle:
            # Without shuffling, independent per-rank draws would collapse to
            # every rank reading the same head of the dataset; degrade to the
            # strided disjoint shard instead (SequentialSampler semantics).
            padded = _pad_to_multiple(np.arange(self.dataset_size), self.num_replicas)
            return padded[self.rank :: self.num_replicas]
        rng = np.random.default_rng((self.seed, self.rank, self.epoch))
        return rng.permutation(self.dataset_size)[: self.num_samples]


def _pad_to_multiple(order: np.ndarray, m: int) -> np.ndarray:
    """Pad by wrapping from the front so every rank gets num_samples
    indices (torch DistributedSampler semantics)."""
    total = -(-len(order) // m) * m
    if total == len(order):
        return order
    return np.concatenate([order, order[: total - len(order)]])


def make_sampler(
    division: str,
    dataset_size: int,
    num_replicas: int,
    rank: int,
    shuffle: bool = True,
    seed: int = 0,
) -> Sampler:
    """Factory keyed by the config's ``division`` field."""
    division = division.lower()
    cls = {
        "partition": RandomPartitionSampler,
        "sampling": RandomSamplingSampler,
        "sequential": SequentialSampler,
    }.get(division)
    if cls is None:
        raise ValueError(f"unknown division mode {division!r}")
    return cls(dataset_size, num_replicas, rank, shuffle=shuffle, seed=seed)
