"""Scaffolding shared by the task entry points (the port of
``tasks/common.py``): the process group with its same-program guard, the
world it gives, the dataset splits and the ``--device`` flag, so launch semantics cannot
diverge between tasks. Checkpointing is not ported yet (ROADMAP.md queue
1 item 6)."""

from __future__ import annotations

from contextlib import contextmanager

import torch

from tpudml_torch.core import (
    TrainConfig, assert_same_program, process_count, process_group,
)
from tpudml_torch.data import load_dataset

NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item 6, checkpoint)"


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
    """(train_state, hooks, manager): nothing to do without ``--ckpt_dir``;
    with it, raises (not ported)."""
    if not cfg.ckpt_dir:
        return ts, [], None
    raise NotImplementedError(f"--ckpt_dir {NOT_PORTED}")


def add_device_flag(parser):
    """``--device`` (default ``cuda``) on a task's parser; returns it."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the card) or 'cpu'")
    return parser


def load_splits(cfg: TrainConfig):
    """(train, test) ArrayDatasets per the config's dataset selection."""
    return tuple(
        load_dataset(cfg.data.dataset, cfg.data.data_dir, split,
                     synthetic_fallback=cfg.data.synthetic_fallback)
        for split in ("train", "test"))
