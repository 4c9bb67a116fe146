"""Scaffolding shared by the task entry points (the port of
``tasks/common.py``): the process group with its same-program guard, the
world it gives, the dataset splits, the ``--device`` flag and the
checkpoint wiring (``--ckpt_dir``, ``--ckpt_every``, ``--resume``), so
launch semantics cannot diverge between tasks."""

from __future__ import annotations

from contextlib import contextmanager

import torch

from tpudml_torch.core import (
    TrainConfig, assert_same_program, process_count, process_group,
)
from tpudml_torch.data import load_dataset
from tpudml_torch.device import default_device


@contextmanager
def init_distributed(cfg: TrainConfig, device: str | torch.device = "cuda"):
    """Run the body inside the process group of ``cfg.dist``
    (``process_group``: the group already up, else the one the config or
    the environment names, else a one-process group), and yield it, after
    every process has all-gathered a hash of its rank-invariant config and
    found it equal (a mismatched rank would otherwise deadlock in the first
    collective)."""
    with process_group(cfg.dist, device=device) as group:
        assert_same_program(cfg.fingerprint(), "task config", group)
        yield group


def select_devices(cfg: TrainConfig, group=None) -> int:
    """The world: the process group's size, one device a process. A world
    given explicitly (``--n_devices`` or the environment) must equal it;
    JAX's first-N-chips of one host is a group of N processes here."""
    world = process_count(group)
    if cfg.dist.explicit_world and cfg.dist.num_processes != world:
        raise ValueError(f"--n_devices {cfg.dist.num_processes} != the {world} processes of "
                         "the group (one device each)")
    return world


def setup_checkpointing(cfg: TrainConfig, ts):
    """(train_state, hooks, manager) per the config's checkpoint fields.

    With ``--ckpt_dir``: ``--resume`` restores the LATEST VALID checkpoint
    into ``ts`` (in place; the CRCs verified, corrupt or partial
    ``step_*`` dirs walked past, every rank reading the same files), and
    ``--ckpt_every N`` installs a rolling-save ``train_loop`` hook. The
    caller does the final save with :func:`final_checkpoint`."""
    if not cfg.ckpt_dir:
        return ts, [], None
    from tpudml_torch.checkpoint import CheckpointHook, CheckpointManager

    mgr = CheckpointManager(cfg.ckpt_dir)
    if cfg.resume:
        ts = mgr.restore_latest(ts)
    hooks = [CheckpointHook(mgr, every_n_steps=cfg.ckpt_every)] if cfg.ckpt_every else []
    return ts, hooks, mgr


def final_checkpoint(mgr, ts) -> None:
    """End-of-run save, skipped when the rolling hook already wrote this
    step."""
    if mgr is not None and mgr.latest_step() != int(ts.step):
        mgr.save(ts, int(ts.step))


def add_device_flag(parser):
    """``--device`` (default ``TPUDML_DEVICE``, else ``cuda``) on a task's
    parser; returns it."""
    parser.add_argument("--device", type=str, default=default_device(),
                        help="'cuda' (the card) or 'cpu'")
    return parser


def load_splits(cfg: TrainConfig):
    """(train, test) ArrayDatasets per the config's dataset selection."""
    return tuple(
        load_dataset(cfg.data.dataset, cfg.data.data_dir, split,
                     synthetic_fallback=cfg.data.synthetic_fallback)
        for split in ("train", "test"))
