"""Process topology of a run (the port of ``tpudml/core/config.py``
``DistributedConfig``; the task CLI configuration is not ported yet,
ROADMAP.md queue 1 item 3).

Same fields and environment names as the JAX package. The
``coordinator_address`` is the rendezvous of ``torch.distributed``:
``host:port`` (a TCP store, as ``MASTER_ADDR``/``MASTER_PORT`` give it)
or an init-method URL (``tcp://host:port``, ``file:///path``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class DistributedConfig:
    """Process-level topology: ``process_id`` of ``num_processes``
    processes meeting at ``coordinator_address`` (None = one process and
    no process group). JAX's ``cpu_collectives`` has no counterpart: the
    device picks the backend (NCCL for CUDA, gloo for the CPU)."""

    coordinator_address: str | None = None
    num_processes: int = 1
    process_id: int = 0
    initialize_timeout_s: int = 300

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        """Build from env vars: TPUDML_COORDINATOR / TPUDML_NUM_PROCESSES /
        TPUDML_PROCESS_ID first, then MASTER_ADDR/MASTER_PORT (+
        RANK/WORLD_SIZE), the names ``torchrun`` sets."""
        coord = os.environ.get("TPUDML_COORDINATOR")
        if coord is None:
            addr = os.environ.get("MASTER_ADDR")
            port = os.environ.get("MASTER_PORT")
            if addr and port:
                coord = f"{addr}:{port}"
        nproc = os.environ.get(
            "TPUDML_NUM_PROCESSES", os.environ.get("WORLD_SIZE")
        )
        return cls(
            coordinator_address=coord,
            num_processes=int(nproc) if nproc is not None else 1,
            process_id=int(os.environ.get("TPUDML_PROCESS_ID", os.environ.get("RANK", "0"))),
        )
