"""Checkpoint / resume (the port of ``tpudml/checkpoint``, without the
per-process sharded store, ROADMAP.md queue 1 item 7).

Atomic format-2 checkpoints (``leaves.npz`` + a CRC-32 manifest) written
by rank 0 and restored identically on every rank; a ``tpudml``
checkpoint of the same state restores into the port and the other way
round (``store.py``'s leaf order). Restores verify the CRCs by default,
:func:`restore_latest_valid` walks past corrupt step dirs, and
:class:`CheckpointManager` retention never deletes the only valid one.
"""

from tpudml_torch.checkpoint.store import (
    CheckpointCorruptError,
    CheckpointHook,
    CheckpointManager,
    checkpoint_hook,
    latest_checkpoint,
    restore_checkpoint,
    restore_latest_valid,
    save_checkpoint,
    verify_checkpoint,
)

__all__ = [
    "CheckpointCorruptError",
    "CheckpointHook",
    "CheckpointManager",
    "checkpoint_hook",
    "latest_checkpoint",
    "restore_checkpoint",
    "restore_latest_valid",
    "save_checkpoint",
    "verify_checkpoint",
]
