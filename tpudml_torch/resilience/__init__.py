"""Fault tolerance for the port's training path (the port of
``tpudml.resilience``, without the elastic and planner adversaries of
ROADMAP.md queue 1 item 10):

- :mod:`sentinel` — :class:`GradSentinel`, an optimizer wrapper that
  skips non-finite (or spiking) updates on the device, carrying the
  previous state forward bit-exactly;
- checkpoint integrity and fallback live in :mod:`tpudml_torch.checkpoint`;
- :mod:`faults` — seeded fault injection (micro-batch corruptors, the
  rank killer, the straggler, checkpoint vandals).
"""

from tpudml_torch.resilience.faults import (
    VANDALS,
    corrupt_microbatch,
    rank_kill_hook,
    straggler_hook,
    vandalize,
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
    "SentinelTripped",
    "VANDALS",
    "attach_sentinel",
    "corrupt_microbatch",
    "find_sentinel",
    "find_sentinel_state",
    "param_leaf_names",
    "rank_kill_hook",
    "sentinel_hook",
    "sentinel_stats",
    "straggler_hook",
    "vandalize",
]
