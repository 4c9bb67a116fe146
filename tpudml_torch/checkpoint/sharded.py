"""Sharded (per-process) checkpoints (the port of
``tpudml/checkpoint/sharded.py``: ``save_sharded_checkpoint``,
``restore_sharded_checkpoint``, ``verify_sharded_checkpoint``,
``restore_latest_valid_sharded``).

The base store (``checkpoint/store.py``) has rank 0 write every leaf, right
for a replicated state. Here each process writes the blocks it holds, in
JAX's on-disk layout, so either package restores what the other wrote:

- ``{dir}/step_{N}/shards_p{K}.npz`` and ``manifest_p{K}.json`` per
  process; each entry carries its leaf, its global ``[start, stop)``
  window a dimension (JAX's layout: conv kernels HWIO), the extended-dtype
  descriptor and a CRC-32 of its encoded bytes (format 2);
- a replicated leaf is written once, by process 0, as ``leaf{i}_full``;
  a block once, by the rank whose other mesh coordinates are 0, as
  ``leaf{i}_s0``;
- each file is written atomically (a temporary file, then a rename), and
  the manifest records ``num_processes``: a restore trusts the step only
  when every process's manifest is there;
- a restore reads every process's file, verifies the CRCs (by default),
  rebuilds each leaf whole, checks that the windows cover it, and gives
  each rank its own window. So any process count restores a checkpoint
  written at any other.

Leaves are taken in JAX's flatten order (``store.tree_leaves``). The
engines say where a rank's leaf sits through ``placement(kind, name,
shape) -> Window | None`` (``kind`` "param", "state", "opt" or "step" of
a TrainState, ``name`` the parameter's; None: replicated):
``GSPMDParallel.placement``, ``DataParallel.placement`` (ZeRO-1's
chunks) and ``ExpertParallel.placement``. Without one every leaf is
whole, as a replicated state is.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tpudml_torch.checkpoint.store import (
    CheckpointCorruptError, _all_step_dirs, _barrier, _crc, _decode_leaf, _encode_leaf,
    _is_train_state, _process_count, _process_index, _rebuild, _restored, tree_leaves,
)

_NPZ = "shards_p{k}.npz"
_MANIFEST = "manifest_p{k}.json"


@dataclass(frozen=True)
class Window:
    """Where a rank's block of a leaf sits: the leaf's global ``shape``,
    the block's ``[start, stop)`` a dimension (both in JAX's layout), and
    whether this rank is the one that writes it."""

    shape: tuple
    index: list
    write: bool = True


Placement = Callable[[str, str, tuple], "Window | None"]


def _window(placement: Placement | None, leaf) -> Window | None:
    if placement is None or leaf.kind is None:
        return None
    return placement(leaf.kind, leaf.name, leaf.shape())


def save_sharded_checkpoint(directory: str | os.PathLike, tree, step: int, *,
                            placement: Placement | None = None) -> str:
    """Write this process's blocks of ``tree`` under ``directory/step_{step}``;
    returns that path. Call on EVERY process (a barrier ends it)."""
    directory = os.fspath(directory)
    path = os.path.join(directory, f"step_{step}")
    from tpudml_torch.obs.tracer import get_tracer

    with get_tracer().span("checkpoint_save", cat="checkpoint",
                           args={"step": int(step), "sharded": True}):
        os.makedirs(path, exist_ok=True)
        proc = _process_index()
        leaves = tree_leaves(tree)
        arrays, meta = {}, {}
        for i, leaf in enumerate(leaves):
            win = _window(placement, leaf)
            if win is None:
                if proc != 0:
                    continue
                key, index = f"leaf{i}_full", [[0, n] for n in leaf.shape()]
            elif win.write:
                key, index = f"leaf{i}_s0", [list(w) for w in win.index]
            else:
                continue
            arr, desc = _encode_leaf(leaf.host(copy=False))
            arrays[key] = arr
            meta[key] = {"leaf": i, "index": index, "desc": desc, "crc": _crc(arr)}
        fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
        os.close(fd)
        try:
            np.savez(tmp, **arrays)
            os.replace(tmp, os.path.join(path, _NPZ.format(k=proc)))
        except BaseException:
            os.unlink(tmp)
            raise
        manifest = {"format": 2, "step": int(step), "process": proc,
                    "num_processes": _process_count(), "num_leaves": len(leaves),
                    "entries": meta}
        tmp_m = os.path.join(path, f".manifest_p{proc}.tmp")
        with open(tmp_m, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp_m, os.path.join(path, _MANIFEST.format(k=proc)))
        _barrier()
    return path


def _read_shard_manifests(path: str) -> list[dict]:
    """Every process's manifest, checked for presence and agreement."""
    names = sorted(f for f in os.listdir(path) if f.startswith("manifest_p"))
    if not names:
        raise CheckpointCorruptError(f"no shard manifests under {path}")
    out = []
    try:
        with open(os.path.join(path, names[0])) as f:
            out.append(json.load(f))
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable shard manifest: {e!r}") from e
    expect = out[0]["num_processes"]
    if len(names) != expect:
        raise CheckpointCorruptError(f"incomplete checkpoint: {len(names)}/{expect} process "
                                     f"manifests present under {path}")
    for k in range(1, expect):
        try:
            with open(os.path.join(path, _MANIFEST.format(k=k))) as f:
                out.append(json.load(f))
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"{path}: unreadable shard manifest p{k}: {e!r}") from e
    return out


def _entries(path: str, manifests: list[dict], verify: bool):
    """(leaf, window, decoded block) of every entry of every process's file."""
    for k, man in enumerate(manifests):
        try:
            data_ctx = np.load(os.path.join(path, _NPZ.format(k=k)))
        except Exception as e:  # missing or truncated payload
            raise CheckpointCorruptError(f"{path}: unreadable shard file p{k}: {e!r}") from e
        with data_ctx as data:
            for key, ent in man["entries"].items():
                try:
                    raw = data[key]
                except Exception as e:
                    raise CheckpointCorruptError(
                        f"{path}: shard {key} missing or undecodable in p{k} payload: "
                        f"{e!r}") from e
                if verify and "crc" in ent and _crc(raw) != ent["crc"]:
                    raise CheckpointCorruptError(
                        f"{path}: shard {key} (process {k}) failed CRC verification — "
                        "checkpoint is corrupt")
                yield ent["leaf"], ent["index"], _decode_leaf(raw, ent.get("desc"))


def restore_sharded_checkpoint(path: str | os.PathLike, target, *, verify: bool = True,
                               placement: Placement | None = None):
    """Rebuild every leaf of the checkpoint at ``path`` whole, from every
    process's file, and give ``target`` its part: a TrainState in place
    (each leaf its ``placement`` window, or whole), any other tree as a
    new tree of whole leaves (tensors on the target leaf's device, the
    rest numpy), as the base store restores. ``verify`` re-checks every
    CRC-32 first (:class:`CheckpointCorruptError` on a mismatch); a
    structure mismatch, a window that does not cover its leaf, or a shape
    or dtype the target cannot take raise ``ValueError``, before anything
    of the target changes."""
    path = os.fspath(path)
    from tpudml_torch.obs.tracer import get_tracer

    with get_tracer().span("checkpoint_restore", cat="checkpoint",
                           args={"path": os.path.basename(path), "verify": bool(verify),
                                 "sharded": True}):
        manifests = _read_shard_manifests(path)
        slots = tree_leaves(target)
        if manifests[0]["num_leaves"] != len(slots):
            raise ValueError(f"checkpoint has {manifests[0]['num_leaves']} leaves, target has "
                             f"{len(slots)} — structure mismatch")
        wins = [_window(placement, s) for s in slots]
        full: list = [None] * len(slots)
        filled: list = [None] * len(slots)
        for i, index, block in _entries(path, manifests, verify):
            if full[i] is None:
                shape = wins[i].shape if wins[i] is not None else slots[i].shape()
                full[i] = torch.zeros(tuple(shape), dtype=block.dtype)
                filled[i] = torch.zeros(tuple(shape), dtype=torch.bool)
            sl = tuple(slice(a, b) for a, b in index)
            full[i][sl] = block.reshape(full[i][sl].shape)
            filled[i][sl] = True
        parts = []
        for i, (leaf, mask) in enumerate(zip(full, filled)):
            if leaf is None or not bool(mask.all()):
                raise ValueError(f"leaf {i}: checkpoint shards do not cover the full array "
                                 "(corrupt or topology-incompatible checkpoint)")
            win = wins[i]
            part = leaf[tuple(slice(a, b) for a, b in win.index)] if win is not None else leaf
            if tuple(part.shape) != slots[i].shape():
                raise ValueError(f"leaf {i}: checkpoint shape {tuple(part.shape)} != target "
                                 f"shape {slots[i].shape()}")
            parts.append(part)
        if not _is_train_state(target):
            return _rebuild(target, iter([_restored(p, s) for p, s in zip(parts, slots)]))
        for i, (part, slot) in enumerate(zip(parts, slots)):
            if isinstance(slot.value, torch.Tensor) and part.dtype != slot.value.dtype:
                raise ValueError(f"leaf {i}: checkpoint dtype {part.dtype} != the state's "
                                 f"{slot.value.dtype}")
        with torch.no_grad():
            for part, slot in zip(parts, slots):
                if isinstance(slot.value, torch.Tensor):
                    slot.value.copy_(part.permute(3, 2, 0, 1) if slot.hwio else part)
                else:
                    slot.put(part.numpy())
        return target


def verify_sharded_checkpoint(path: str | os.PathLike) -> int:
    """Full integrity check of one sharded ``step_*`` dir without a target:
    every process's manifest present, every block decodable, every CRC
    matching. Returns the step; raises :class:`CheckpointCorruptError`."""
    path = os.fspath(path)
    manifests = _read_shard_manifests(path)
    for _ in _entries(path, manifests, verify=True):
        pass
    return int(manifests[0]["step"])


def restore_latest_valid_sharded(directory: str | os.PathLike, target, *,
                                 verify: bool = True, placement: Placement | None = None):
    """Restore the newest ``step_*`` dir that restores, each skipped one
    reported on stderr; ``target`` as it is when there is none; raises
    :class:`CheckpointCorruptError` when step dirs exist but none
    restores."""
    directory = os.fspath(directory)
    dirs = _all_step_dirs(directory)
    if not dirs:
        return target
    failures = []
    for step, path in reversed(dirs):
        try:
            return restore_sharded_checkpoint(path, target, verify=verify, placement=placement)
        except (CheckpointCorruptError, ValueError, OSError, KeyError) as e:
            failures.append(f"step_{step}: {e}")
            print(f"[tpudml_torch.checkpoint] skipping invalid sharded checkpoint "
                  f"step_{step}: {e}", file=sys.stderr)
    raise CheckpointCorruptError(f"no valid sharded checkpoint under {directory}; tried "
                                 + "; ".join(failures))
