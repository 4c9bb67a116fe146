"""The process group (the port of ``tpudml/core/dist.py``).

JAX brings up a multi-process runtime and builds a device mesh over it;
the port brings up a ``torch.distributed`` process group, and the engines
take that group where the JAX ones take a mesh axis. ``make_mesh`` has no
counterpart: each process drives one device, and the group's ranks are
the replicas.

The backend follows the device: NCCL for CUDA tensors, gloo for the CPU.
Nothing falls back: asking for the card where NCCL is missing raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import tempfile
from contextlib import contextmanager
from datetime import timedelta

import torch
import torch.distributed as dist

from tpudml_torch.core.config import DistributedConfig

log = logging.getLogger("tpudml_torch")


def backend_for(device: str | torch.device) -> str:
    """The collective backend of ``device``'s tensors: nccl or gloo."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def distributed_init(cfg: DistributedConfig | None = None,
                     device: str | torch.device = "cuda") -> None:
    """Bring up the default process group (idempotent).

    ``cfg`` defaults to :meth:`DistributedConfig.from_env`. Without a
    coordinator this is a no-op (one process, no group), as in JAX. With
    one, every process joins ``init_process_group`` over NCCL when
    ``device`` is CUDA (after ``torch.cuda.set_device``: ``LOCAL_RANK``,
    else the process id modulo the local cards) or over gloo for the
    CPU; unlike JAX this includes a one-process world, so the engines'
    collectives run (over NCCL on the card) at world 1."""
    if dist.is_initialized():
        return
    cfg = cfg or DistributedConfig.from_env()
    if cfg.coordinator_address is None:
        if cfg.num_processes > 1:
            raise ValueError(
                f"{cfg.num_processes} processes need a coordinator_address "
                "(TPUDML_COORDINATOR or MASTER_ADDR/MASTER_PORT)")
        return
    dev = torch.device(device)
    backend = backend_for(dev)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but "
                               "torch.cuda.is_available() is False")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL; CUDA tensors take no "
                               "other backend here")
        local = int(os.environ.get("LOCAL_RANK",
                                   cfg.process_id % torch.cuda.device_count()))
        torch.cuda.set_device(dev.index if dev.index is not None else local)
    dist.init_process_group(
        backend, init_method=_init_method(cfg.coordinator_address),
        world_size=cfg.num_processes, rank=cfg.process_id,
        timeout=timedelta(seconds=cfg.initialize_timeout_s))
    if dist.get_backend() != backend:
        raise RuntimeError(f"asked for {backend}, got {dist.get_backend()}")
    log.info("process group up: rank %d/%d over %s", dist.get_rank(),
             dist.get_world_size(), backend)


@contextmanager
def process_group(cfg: DistributedConfig | None = None,
                  device: str | torch.device = "cuda"):
    """Run the body with the default process group up, and yield it: the
    group already initialized, else the one ``cfg`` (or the environment)
    names, else a one-process group over a file store in a temporary
    directory. A group this call built is destroyed on exit."""
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    cfg = cfg or DistributedConfig.from_env()
    with tempfile.TemporaryDirectory() as tmp:
        if cfg.coordinator_address is None:
            cfg = dataclasses.replace(cfg, coordinator_address=f"file://{tmp}/store",
                                      num_processes=1, process_id=0)
        distributed_init(cfg, device)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def process_index(group=None) -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def process_count(group=None) -> int:
    """Number of processes (1 without a process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


# Aliases with the reference's names.
get_local_rank = process_index
get_world_size = process_count


def local_device_count() -> int:
    """Cards this process sees (the CPU counts as one device)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def collective_device(group=None) -> torch.device:
    """Where a tensor must lie for ``group``'s collectives: the current
    card under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def assert_same_program(fingerprint: str, tag: str = "program", group=None) -> None:
    """Fail fast if processes are about to run different programs: every
    process all-gathers an 8-byte digest of ``fingerprint`` and raises on
    a mismatch, before any training collective could hang on it. No-op
    for one process."""
    if process_count(group) <= 1:
        return
    digest = hashlib.sha256(fingerprint.encode()).digest()[:8]
    mine = torch.tensor([int.from_bytes(digest, "little", signed=True)],
                        dtype=torch.int64, device=collective_device(group))
    everyone = torch.empty(process_count(group), dtype=torch.int64, device=mine.device)
    dist.all_gather_into_tensor(everyone, mine, group=group)
    everyone = everyone.cpu()
    bad = sorted(int(i) for i in torch.nonzero(everyone != everyone[0]).flatten())
    if bad:
        raise RuntimeError(
            f"{tag} mismatch: processes {bad} disagree with process 0 "
            f"(this process={process_index(group)}). All ranks must run the same "
            "program/config; a mismatch would deadlock in the first collective.")
