"""tpudml_torch.serve — prefill–decode LM serving (the port of
``tpudml.serve``, dense single-device path).

Layers: ``cache`` (dense preallocated per-layer KV caches,
f32/bf16/int8), ``engine`` (one decode step + chunked prefill + slot
scheduler), ``load`` (seeded Poisson request streams), ``fleet.quant``
(int8 weights). The paged layout, speculative decoding, SLO admission,
tensor parallelism and the fleet router are still to port.
"""

from tpudml_torch.serve.cache import KVCache, cache_bytes, init_cache
from tpudml_torch.serve.engine import (
    RequestStats,
    ServeConfig,
    ServeReport,
    ServingEngine,
    make_decode_step,
    make_fused_decode_step,
)
from tpudml_torch.serve.load import Request, poisson_workload

__all__ = [
    "KVCache",
    "Request",
    "RequestStats",
    "ServeConfig",
    "ServeReport",
    "ServingEngine",
    "cache_bytes",
    "init_cache",
    "make_decode_step",
    "make_fused_decode_step",
    "poisson_workload",
]
