"""Checkpoint / resume (the port of ``tpudml/checkpoint``).

Atomic format-2 checkpoints (``leaves.npz`` + a CRC-32 manifest) written
by rank 0 and restored identically on every rank; a ``tpudml``
checkpoint of the same state restores into the port and the other way
round (``store.py``'s leaf order). Restores verify the CRCs by default,
:func:`restore_latest_valid` walks past corrupt step dirs, and
:class:`CheckpointManager` retention never deletes the only valid one.
The sharded store (``sharded.py``) writes each process's blocks of a
sharded state in JAX's per-process layout.
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
from tpudml_torch.checkpoint.sharded import (
    Window,
    restore_latest_valid_sharded,
    restore_sharded_checkpoint,
    save_sharded_checkpoint,
    verify_sharded_checkpoint,
)

__all__ = [
    "CheckpointCorruptError",
    "CheckpointHook",
    "CheckpointManager",
    "checkpoint_hook",
    "latest_checkpoint",
    "restore_checkpoint",
    "restore_latest_valid",
    "restore_latest_valid_sharded",
    "restore_sharded_checkpoint",
    "save_checkpoint",
    "save_sharded_checkpoint",
    "verify_checkpoint",
    "verify_sharded_checkpoint",
    "Window",
]
