"""Fault tolerance for the port's training path (the port of
``tpudml.resilience``):

- :mod:`sentinel` — :class:`GradSentinel`, an optimizer wrapper that
  skips non-finite (or spiking) updates on the device, carrying the
  previous state forward bit-exactly;
- checkpoint integrity and fallback live in :mod:`tpudml_torch.checkpoint`;
- :mod:`faults` — seeded fault injection (micro-batch corruptors, the
  rank killer, the stragglers, the port squatter, checkpoint and plan
  vandals).
"""

from tpudml_torch.resilience.faults import (
    PLAN_VANDALS,
    VANDALS,
    corrupt_microbatch,
    occupy_port,
    rank_kill_hook,
    reform_straggler_hook,
    straggler_hook,
    vandalize,
    vandalize_plan,
)
from tpudml_torch.resilience.sentinel import (
    GradSentinel,
    SentinelTripped,
    attach_sentinel,
    find_sentinel,
    find_sentinel_state,
    param_leaf_names,
    sentinel_hook,
    sentinel_stats,
)

__all__ = [
    "GradSentinel",
    "PLAN_VANDALS",
    "SentinelTripped",
    "VANDALS",
    "attach_sentinel",
    "corrupt_microbatch",
    "find_sentinel",
    "find_sentinel_state",
    "occupy_port",
    "param_leaf_names",
    "rank_kill_hook",
    "reform_straggler_hook",
    "sentinel_hook",
    "sentinel_stats",
    "straggler_hook",
    "vandalize",
    "vandalize_plan",
]
