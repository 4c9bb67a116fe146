"""Parallel training engines over ``torch.distributed`` process groups
(``tpudml.parallel`` subset: data parallelism)."""

from tpudml_torch.parallel.dp import DataParallel, shard_rows

__all__ = ["DataParallel", "shard_rows"]
