"""Parallel training engines over ``torch.distributed`` process groups
(``tpudml.parallel`` subset: data and expert parallelism)."""

from tpudml_torch.parallel.dp import DataParallel, shard_rows
from tpudml_torch.parallel.ep import ExpertParallel, expert_specs, is_expert_param
from tpudml_torch.parallel.sharding import make_counting_eval_step

__all__ = ["DataParallel", "ExpertParallel", "expert_specs", "is_expert_param",
           "make_counting_eval_step", "shard_rows"]
