"""Batching data loader (the port of ``tpudml/data/loader.py``).

The DataLoader role of the reference's Dataset/Sampler/DataLoader triad
(sections/task3.tex:27-43): draws an index stream from a Sampler, gathers
rows from the in-memory dataset, and yields fixed-shape numpy batches
(``drop_remainder`` defaults to True, as in the JAX package). Rows are
gathered by the dataset's ``gather``: for an ``ArrayDataset`` the native
data plane's fused gather (``tpudml_torch.native``), plain indexing for a
dataset without one.

``ShardedDataLoader`` batches for several replicas at once: each
replica's stream from its own sampler, stacked on a leading replica axis
(the form ``DataParallel.shard_batch`` accepts).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from tpudml_torch.data.datasets import ArrayDataset
from tpudml_torch.data.sampler import Sampler, SequentialSampler


class DataLoader:
    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        sampler: Sampler | None = None,
        drop_remainder: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or SequentialSampler(len(dataset), shuffle=False)
        self.drop_remainder = drop_remainder

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        idx = np.fromiter(iter(self.sampler), dtype=np.int64)
        end = (
            len(idx) - len(idx) % self.batch_size if self.drop_remainder else len(idx)
        )
        gather = getattr(self.dataset, "gather", None)
        for start in range(0, end, self.batch_size):
            batch = idx[start : start + self.batch_size]
            if gather is not None:
                yield gather(batch)
            else:
                yield self.dataset.images[batch], self.dataset.labels[batch]


class ShardedDataLoader:
    """Batches for all replicas at once: yields ``[R, B, ...]`` arrays (R =
    number of samplers, B = per-replica batch), replica r's rows from its
    own Sampler(rank=r) — what R processes would each load."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        samplers: list[Sampler],
        drop_remainder: bool = True,
    ):
        if not samplers:
            raise ValueError("need at least one sampler")
        self.loaders = [
            DataLoader(dataset, batch_size, s, drop_remainder) for s in samplers
        ]

    def set_epoch(self, epoch: int) -> None:
        for ld in self.loaders:
            ld.set_epoch(epoch)

    def __len__(self) -> int:
        return min(len(ld) for ld in self.loaders)

    def __iter__(self):
        its = [iter(ld) for ld in self.loaders]
        for _ in range(len(self)):
            parts = [next(it) for it in its]
            yield (
                np.stack([p[0] for p in parts]),
                np.stack([p[1] for p in parts]),
            )
