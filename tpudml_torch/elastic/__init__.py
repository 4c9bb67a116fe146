"""Elastic run control: supervise a multi-process job across rank death
(the port of ``tpudml.elastic``).

``tpudml_torch.launch`` contains failures (one dead rank tears down the
whole job instead of deadlocking the survivors) and can relaunch the job
whole. This package treats each relaunch as a *membership event* — fresh
rendezvous (new coordinator port, so no half-dead coordinator or zombie
rank can poison the re-form), an optional shrink policy that drops the
failed rank and re-forms the survivors (consulting the planner at the new
world, ``replan.py``), and resume from the newest CRC-valid sharded
checkpoint so the restarted job continues the same training trajectory
bit-exactly. The sharded store restores any process count's checkpoint
at any other (``tpudml_torch/checkpoint/sharded.py``), which is what
makes shrink possible at all.

``drill.py`` is the proof: a scripted failure drill (SIGKILL-grade rank
death mid-training → backoff → re-form → resume) whose final parameters
must be bit-identical to an uninterrupted run. Run it as a library
(:func:`run_drill`) or via ``python -m tpudml_torch.elastic --drill``.
"""

from tpudml_torch.elastic.controller import (
    ElasticController,
    ElasticResult,
    ReformRecord,
)


def __getattr__(name):
    # Lazy: ``python -m tpudml_torch.elastic.drill`` (the per-rank child)
    # must not find the drill module pre-imported by its own package (runpy
    # warns, and the child only needs the controller-free half anyway).
    if name == "run_drill":
        from tpudml_torch.elastic.drill import run_drill

        return run_drill
    raise AttributeError(name)


__all__ = [
    "ElasticController",
    "ElasticResult",
    "ReformRecord",
    "run_drill",
]
