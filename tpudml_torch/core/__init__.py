"""Process topology and the process group (``tpudml.core`` subset)."""

from tpudml_torch.core.config import (
    DataConfig, DistributedConfig, TrainConfig, build_parser, config_from_args,
)
from tpudml_torch.core.dist import (
    assert_same_program,
    distributed_init,
    get_local_rank,
    get_world_size,
    local_device_count,
    process_count,
    process_group,
    process_index,
)

__all__ = [
    "DataConfig",
    "DistributedConfig",
    "TrainConfig",
    "build_parser",
    "config_from_args",
    "assert_same_program",
    "distributed_init",
    "get_local_rank",
    "get_world_size",
    "local_device_count",
    "process_count",
    "process_group",
    "process_index",
]
