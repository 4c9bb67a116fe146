"""Launch / deployment (the port of ``tpudml.launch``, without the TPU-VM
pod tooling of ROADMAP.md queue 1 item 11).

One launcher for the port's multi-process jobs: N copies of a command,
each given the ``TPUDML_COORDINATOR`` / ``TPUDML_NUM_PROCESSES`` /
``TPUDML_PROCESS_ID`` rendezvous that ``DistributedConfig.from_env``
reads, their output tagged by rank. It fills the reference's
failure-detection gap (one dead rank leaves the others blocked in the
collective): the first rank to fail terminates the job, a wall-clock
timeout bounds it, and ``max_restarts`` relaunches it whole with a
seeded backoff. The straggler knobs of the task2 bottleneck experiment
ride the ranks' environment.
"""

from tpudml_torch.launch.cluster import ClusterSpec
from tpudml_torch.launch.launcher import LaunchResult, launch, launch_once, restart_backoff

__all__ = ["ClusterSpec", "LaunchResult", "launch", "launch_once", "restart_backoff"]
