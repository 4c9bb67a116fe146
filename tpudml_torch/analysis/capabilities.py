"""Analysis-side face of the engine capability table (the port of
``tpudml/analysis/capabilities.py``).

The table itself lives in the dependency-free :mod:`tpudml_torch.capabilities`
(the engines import it at module top, and importing anything under
``tpudml_torch.analysis`` from an engine would cycle through
``analysis.entrypoints`` back into the engines). The planner and the
analysis CLI import it from here so that the public API stays where the
rule catalogue lives.
"""

from tpudml_torch.capabilities import (
    TABLE,
    Capability,
    CompositionError,
    candidate_rejection,
    reject,
)

__all__ = [
    "TABLE",
    "Capability",
    "CompositionError",
    "candidate_rejection",
    "reject",
]
