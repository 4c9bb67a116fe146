"""Data of the port (``tpudml.data`` subset): seeded synthetic sets, the
in-memory dataset, samplers and loaders."""

from tpudml_torch.data.datasets import ArrayDataset, synthetic_lm
from tpudml_torch.data.loader import DataLoader, ShardedDataLoader
from tpudml_torch.data.sampler import (
    RandomPartitionSampler,
    RandomSamplingSampler,
    Sampler,
    SequentialSampler,
    make_sampler,
)

__all__ = [
    "ArrayDataset",
    "DataLoader",
    "RandomPartitionSampler",
    "RandomSamplingSampler",
    "Sampler",
    "SequentialSampler",
    "ShardedDataLoader",
    "make_sampler",
    "synthetic_lm",
]
