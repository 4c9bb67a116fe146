"""Parallel training engines over ``torch.distributed`` process groups
(``tpudml.parallel`` subset: data, expert and rule-driven model
parallelism)."""

from tpudml_torch.parallel.dp import DataParallel, shard_rows
from tpudml_torch.parallel.ep import ExpertParallel, expert_specs, is_expert_param
from tpudml_torch.parallel.mp import (
    GSPMDParallel, apply_rules, replicated_rules, stage_sharding_rules, tensor_parallel_rules,
)
from tpudml_torch.parallel.sharding import make_counting_eval_step

__all__ = ["DataParallel", "ExpertParallel", "GSPMDParallel", "apply_rules", "expert_specs",
           "is_expert_param", "make_counting_eval_step", "replicated_rules", "shard_rows",
           "stage_sharding_rules", "tensor_parallel_rules"]
