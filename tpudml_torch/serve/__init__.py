"""tpudml_torch.serve — prefill–decode LM serving (the port of
``tpudml.serve``).

Layers: ``cache`` (dense preallocated per-layer KV caches,
f32/bf16/int8), ``paged`` (page-pool cache + slot→page table + prefix
sharing), ``spec`` (speculative decoding with exact greedy acceptance),
``sched`` (SLO-aware admission priced on the static cost model),
``engine`` (one decode step + chunked prefill + slot scheduler composing
all of the above), ``tp`` (the tensor-parallel decode and prefill steps
on one rank's shard), ``load`` (seeded Poisson request streams),
``fleet.quant`` (int8 weights). The fleet router is still to port
(ROADMAP.md queue 1 item 10).
"""

from tpudml_torch.serve.cache import KVCache, cache_bytes, init_cache
from tpudml_torch.serve.engine import (
    RequestStats,
    ServeCompositionError,
    ServeConfig,
    ServeReport,
    ServingEngine,
    make_cacheless_decode_step,
    make_decode_step,
    make_fused_decode_step,
    make_paged_decode_step,
)
from tpudml_torch.serve.load import Request, poisson_workload
from tpudml_torch.serve.paged import PagedKVCache, PagePool, init_pool, pool_bytes
from tpudml_torch.serve.sched import DecodeCostModel, SLOConfig
from tpudml_torch.serve.spec import draft_from_trunk, make_spec_decode_step

__all__ = [
    "DecodeCostModel",
    "KVCache",
    "PagePool",
    "PagedKVCache",
    "Request",
    "RequestStats",
    "SLOConfig",
    "ServeCompositionError",
    "ServeConfig",
    "ServeReport",
    "ServingEngine",
    "cache_bytes",
    "draft_from_trunk",
    "init_cache",
    "init_pool",
    "make_cacheless_decode_step",
    "make_decode_step",
    "make_fused_decode_step",
    "make_paged_decode_step",
    "make_spec_decode_step",
    "poisson_workload",
    "pool_bytes",
]
