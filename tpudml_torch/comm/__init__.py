"""Communication layer: collectives over a process group and comm-time
accounting (the port of ``tpudml.comm``)."""

from tpudml_torch.comm.collectives import (
    AGGREGATORS,
    all_gather_tree,
    all_to_all,
    allgather_average_gradients,
    allreduce_average_gradients,
    broadcast_from,
    get_aggregator,
    plogsumexp,
    pmax_tree,
    pmean_tree,
    ppermute_ring,
    psum_scatter_tree,
    psum_tree,
    reduce_scatter_average_gradients,
)
from tpudml_torch.comm.timing import (
    CommStats,
    attribute_overlap,
    collective_wire_bytes,
    comm_time_table,
    comm_time_trial,
    timed_call,
)

__all__ = [
    "AGGREGATORS",
    "CommStats",
    "all_gather_tree",
    "all_to_all",
    "allgather_average_gradients",
    "allreduce_average_gradients",
    "attribute_overlap",
    "broadcast_from",
    "collective_wire_bytes",
    "comm_time_table",
    "comm_time_trial",
    "get_aggregator",
    "plogsumexp",
    "pmax_tree",
    "pmean_tree",
    "ppermute_ring",
    "psum_scatter_tree",
    "psum_tree",
    "reduce_scatter_average_gradients",
    "timed_call",
]
