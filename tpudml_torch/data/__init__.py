"""Data of the port (``tpudml.data``): seeded synthetic sets, MNIST (IDX)
and CIFAR-10, the in-memory dataset, samplers, loaders and the device
prefetch."""

from tpudml_torch.data.datasets import (
    ArrayDataset, load_cifar10, load_dataset, load_mnist, synthetic_classification,
    synthetic_lm,
)
from tpudml_torch.data.idx import read_idx, write_idx
from tpudml_torch.data.loader import DataLoader, ShardedDataLoader
from tpudml_torch.data.prefetch import prefetch_to_device
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
    "load_mnist",
    "make_sampler",
    "prefetch_to_device",
    "read_idx",
    "synthetic_classification",
    "synthetic_lm",
    "write_idx",
]
