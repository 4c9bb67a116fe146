"""Data of the port (``tpudml.data`` subset): seeded synthetic sets,
CIFAR-10, the in-memory dataset, samplers and loaders."""

from tpudml_torch.data.datasets import (
    ArrayDataset, load_cifar10, load_dataset, synthetic_classification, synthetic_lm,
)
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
    "load_cifar10",
    "load_dataset",
    "make_sampler",
    "synthetic_classification",
    "synthetic_lm",
]
