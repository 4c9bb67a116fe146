"""Parallel training engines over ``torch.distributed`` process groups
(``tpudml.parallel`` subset: data, expert, rule-driven model,
fully-sharded data, pipeline and context parallelism, and the
collective-matmul overlap)."""

from tpudml_torch.parallel.cp import ContextParallel, ring_attention, ulysses_attention
from tpudml_torch.parallel.dp import DataParallel, shard_rows
from tpudml_torch.parallel.ep import ExpertParallel, expert_specs, is_expert_param
from tpudml_torch.parallel.fsdp import FSDP, fsdp_sharding_rules
from tpudml_torch.parallel.mp import (
    GSPMDParallel, apply_rules, replicated_rules, stage_sharding_rules, tensor_parallel_rules,
)
from tpudml_torch.parallel.overlap import OVERLAP_CHUNKS, tp_overlap_matmul
from tpudml_torch.parallel.pp import (
    GPipe, HeteroOneFOneB, HeteroPipeline, Interleaved1F1B, OneFOneB,
)
from tpudml_torch.parallel.sharding import make_counting_eval_step

__all__ = ["ContextParallel", "DataParallel", "ExpertParallel", "FSDP", "GPipe", "GSPMDParallel",
           "HeteroOneFOneB", "HeteroPipeline", "Interleaved1F1B", "OVERLAP_CHUNKS", "OneFOneB",
           "apply_rules", "expert_specs", "fsdp_sharding_rules", "is_expert_param",
           "make_counting_eval_step", "replicated_rules", "shard_rows",
           "ring_attention", "stage_sharding_rules", "tensor_parallel_rules", "tp_overlap_matmul",
           "ulysses_attention"]
