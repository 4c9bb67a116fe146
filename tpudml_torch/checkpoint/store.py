"""Checkpoint store: atomic npz + manifest, rank-0 writes (the port of
``tpudml/checkpoint/store.py``), in JAX's format 2, so either package
reads what the other wrote. A state whose ranks hold different blocks
goes through ``checkpoint/sharded.py`` instead.

On disk, as in JAX: ``step_N/leaves.npz`` with one array a leaf under
``leaf_%05d`` keys, and ``manifest.json`` with ``format`` (2), ``step``,
``num_leaves``, ``extended_dtypes`` (``{"i": {"dtype", "shape"}}`` for a
leaf numpy cannot hold, stored as a raw uint16/uint8 view: bfloat16,
float8), ``checksums`` (a CRC-32 an encoded leaf, over exactly the bytes
in ``leaves.npz``) and ``metadata``. Restores verify the CRCs by default
and raise :class:`CheckpointCorruptError` on a mismatch, a truncated or
missing file; :func:`restore_latest_valid` walks ``step_*`` dirs
newest-first past corrupt ones.

The manifest names no leaf, so the leaf ORDER is the only link between a
JAX checkpoint and the port's state. A tree flattens as JAX flattens it:
dict keys sorted at every level (a dotted parameter name counts as the
nested path it names), lists and tuples in order, None no leaf. The
port's :class:`~tpudml_torch.train.TrainState` flattens as JAX's
``TrainState(params, model_state, opt_state, step)``: the model's
parameters by their JAX path names, its floating buffers (BatchNorm's
statistics) as the model state, the optimizer state (Adam's ``{"m",
"t", "v"}``, a sentinel's counters), and the step; conv kernels (a 4-D
``kernel``, OIHW here) in JAX's HWIO, the Adam clock and the step as
int32. A TrainState restores IN PLACE (parameters, buffers and moments
copied into the live tensors, the step and clock reset) and is returned;
any other tree comes back as a new one, tensor leaves as tensors on the
target leaf's device, the rest as numpy arrays.

Writes go to a temp dir then ``os.replace``. Rank 0 of the process group
writes (every replica holds the same state); every rank passes a
``torch.distributed`` barrier in ``finally`` when the group has more than
one rank. Tensors leave the card through one ``.cpu()`` a leaf.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import sys
import tempfile
import threading
import zlib
from typing import Any, Callable

import numpy as np
import torch

from tpudml_torch.core.pytree import jax_sort_key

_MANIFEST = "manifest.json"
_LEAVES = "leaves.npz"
_STEP_DIR = re.compile(r"^step_(\d+)$")
# Dtypes numpy has no type for: stored as raw views, named as ml_dtypes
# (and so JAX) names them.
_RAW_DTYPES = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
               torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
               torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8)}
_RAW_BY_NAME = {name: (dt, view) for dt, (name, view, _) in _RAW_DTYPES.items()}


class CheckpointCorruptError(ValueError):
    """A checkpoint failed verification (missing/truncated/corrupt)."""


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _barrier() -> None:
    if _process_count() > 1:
        import torch.distributed as dist

        dist.barrier()


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


# ------------------------------------------------------------- flattening


class _Leaf:
    """One leaf of a flattened tree: its value and, for restores, how the
    decoded array goes back (``put``) and what shape and dtype it must
    have there."""

    __slots__ = ("value", "put", "hwio", "name", "kind")

    def __init__(self, value, put=None, hwio: bool = False, name: str = ""):
        self.value, self.put, self.hwio, self.name = value, put, hwio, name
        self.kind = None  # a TrainState's leaf: "param", "state", "opt" or "step"

    def host(self, copy: bool) -> np.ndarray | torch.Tensor:
        """The leaf on the host in JAX's layout: a CPU tensor (one
        ``.cpu()`` off the card; a clone on the CPU when ``copy``, so the
        caller may go on mutating the live tensor), or a numpy array."""
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach()
            v = v.cpu() if v.is_cuda else (v.clone() if copy else v)
            return v.permute(2, 3, 1, 0).contiguous() if self.hwio else v
        if isinstance(v, np.ndarray):
            return v.copy() if copy else v
        return np.asarray(v)

    def shape(self) -> tuple:
        v = self.value
        if isinstance(v, torch.Tensor):
            s = tuple(v.shape)
            return (s[2], s[3], s[1], s[0]) if self.hwio else s
        return tuple(np.shape(v))


def _sorted_items(d: dict):
    return sorted(d.items(), key=lambda kv: jax_sort_key(kv[0]))


def _flatten(tree, out: list, put=None, layout: bool = False, name: str = "") -> None:
    """Append ``tree``'s leaves to ``out`` in JAX's order. ``put(value)``
    stores a restored leaf back where it came from; ``layout`` marks the
    TrainState's parameter-named dicts, whose 4-D ``kernel`` tensors are
    stored HWIO."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in _sorted_items(tree):
            _flatten(v, out, _item_put(tree, k), layout, str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, out, _item_put(tree, i) if isinstance(tree, list) else None,
                     layout, name)
    else:
        hwio = (layout and isinstance(tree, torch.Tensor) and tree.dim() == 4
                and name.split(".")[-1] == "kernel")
        out.append(_Leaf(tree, put, hwio, name))


def _item_put(container, key):
    def put(value):
        container[key] = value

    return put


def _int_put(container: dict, key):
    """Store a restored int32 scalar back as the Python int it was."""

    def put(value):
        container[key] = int(value)

    return put


def _train_state_leaves(ts) -> list[_Leaf]:
    """The leaves of a port TrainState in JAX's ``TrainState`` order."""
    out: list[_Leaf] = []
    model = ts.model
    sections = (
        ("param", lambda: _flatten(dict(model.named_parameters()), out, layout=True)),
        ("state", lambda: _flatten({n: b for n, b in model.named_buffers()
                                    if b.is_floating_point()}, out, layout=True)),
        ("opt", lambda: _flatten_opt(ts.opt_state, out)),
        ("step", lambda: out.append(_Leaf(np.int32(ts.step), _step_put(ts), name="step"))),
    )
    for kind, add in sections:
        first = len(out)
        add()
        for leaf in out[first:]:
            leaf.kind = kind
    return out


def _flatten_opt(state, out: list[_Leaf]) -> None:
    """An optimizer state: parameter-named dicts in the TrainState's
    layout; Python-int entries (Adam's clock ``t``) as int32 leaves."""
    if isinstance(state, dict):
        for k, v in _sorted_items(state):
            if isinstance(v, (dict, list, tuple)):
                _flatten_opt(v, out)
            elif isinstance(v, int):
                out.append(_Leaf(np.int32(v), _int_put(state, k), name=str(k)))
            else:
                _flatten(v, out, _item_put(state, k), layout=True, name=str(k))
    elif isinstance(state, (list, tuple)):
        for v in state:
            _flatten_opt(v, out)
    elif state is not None:
        _flatten(state, out, layout=True)


def _step_put(ts):
    def put(value):
        ts.step = int(value)

    return put


def _is_train_state(tree) -> bool:
    from tpudml_torch.train import TrainState

    return isinstance(tree, TrainState)


def tree_leaves(tree) -> list[_Leaf]:
    """``tree``'s leaves in JAX's flatten order (module docstring)."""
    if _is_train_state(tree):
        return _train_state_leaves(tree)
    out: list[_Leaf] = []
    _flatten(tree, out)
    return out


# ---------------------------------------------------------------- encoding


def _encode_leaf(x) -> tuple[np.ndarray, dict | None]:
    """npz-compatible array + (if the dtype needed masking) a descriptor,
    byte for byte as JAX's ``_encode_leaf``."""
    if isinstance(x, torch.Tensor):
        raw = _RAW_DTYPES.get(x.dtype)
        if raw is None:
            return x.numpy(), None
        name, view, np_view = raw
        return (x.view(view).numpy().view(np_view),
                {"dtype": name, "shape": list(x.shape)})
    if x.dtype.kind in "biufc" and x.dtype.name in np.sctypeDict:
        return x, None
    raw = x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint8)
    return raw, {"dtype": x.dtype.name, "shape": list(x.shape)}


def _decode_leaf(raw: np.ndarray, desc: dict | None) -> torch.Tensor:
    """The stored leaf as a CPU tensor (of its extended dtype, where the
    manifest names one)."""
    if desc is None:
        return torch.from_numpy(np.array(raw, copy=True))
    if desc["dtype"] not in _RAW_BY_NAME:
        raise CheckpointCorruptError(f"unsupported extended dtype {desc['dtype']!r}")
    dt, view = _RAW_BY_NAME[desc["dtype"]]
    t = torch.from_numpy(np.array(raw, copy=True)).view(view).view(dt)
    return t.reshape(desc["shape"])


def _encode(leaves: list) -> tuple[dict, dict, dict]:
    arrays, descs, checksums = {}, {}, {}
    for i, leaf in enumerate(leaves):
        arr, desc = _encode_leaf(leaf)
        arrays[f"leaf_{i:05d}"] = arr
        checksums[f"leaf_{i:05d}"] = _crc(arr)
        if desc is not None:
            descs[str(i)] = desc
    return arrays, descs, checksums


def _write(directory: str, path: str, leaves: list, step: int, metadata: dict | None) -> None:
    arrays, descs, checksums = _encode(leaves)
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory)
    try:
        np.savez(os.path.join(tmp, _LEAVES), **arrays)
        manifest = {
            "format": 2,
            "step": int(step),
            "num_leaves": len(leaves),
            "extended_dtypes": descs,
            "checksums": checksums,
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint(directory: str | os.PathLike, tree, step: int, *,
                    metadata: dict | None = None) -> str:
    """Write ``tree`` under ``directory/step_{step}``; returns that path.

    Rank 0 writes; every rank returns after a barrier (when the group has
    more than one rank), so a restore on any rank then sees the files."""
    directory = os.fspath(directory)
    path = os.path.join(directory, f"step_{step}")
    from tpudml_torch.obs.tracer import get_tracer

    with get_tracer().span("checkpoint_save", cat="checkpoint", args={"step": int(step)}):
        try:
            if _process_index() == 0:
                leaves = [leaf.host(copy=False) for leaf in tree_leaves(tree)]
                _write(directory, path, leaves, step, metadata)
        finally:
            # Reached on every path: a rank-0 write failure must not leave
            # the other ranks blocked in the barrier.
            _barrier()
    return path


def latest_checkpoint(directory: str | os.PathLike) -> str | None:
    """Path of the highest-step checkpoint under ``directory`` (None if empty)."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = _STEP_DIR.match(name)
        if m and os.path.isfile(os.path.join(directory, name, _MANIFEST)):
            steps.append(int(m.group(1)))
    if not steps:
        return None
    return os.path.join(directory, f"step_{max(steps)}")


def _read_manifest(path: str) -> dict:
    mpath = os.path.join(path, _MANIFEST)
    try:
        with open(mpath) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CheckpointCorruptError(f"{path}: missing {_MANIFEST}") from None
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest: {e}") from e


def _read_leaves(path: str, manifest: dict, n: int, verify: bool) -> list[torch.Tensor]:
    descs = manifest["extended_dtypes"]
    checksums = manifest.get("checksums", {})
    leaves = []
    try:
        with np.load(os.path.join(path, _LEAVES)) as data:
            for i in range(n):
                key = f"leaf_{i:05d}"
                raw = data[key]
                if verify and key in checksums and _crc(raw) != checksums[key]:
                    raise CheckpointCorruptError(
                        f"{path}: leaf {i} checksum mismatch (corrupt data)")
                leaves.append(_decode_leaf(raw, descs.get(str(i))))
    except CheckpointCorruptError:
        raise
    except Exception as e:  # truncated zip, missing member, zlib error …
        raise CheckpointCorruptError(f"{path}: unreadable {_LEAVES}: {e!r}") from e
    return leaves


def _restored(new: torch.Tensor, slot: _Leaf):
    """The decoded leaf as the target leaf takes it."""
    old = slot.value
    if isinstance(old, torch.Tensor):
        if slot.hwio:
            new = new.permute(3, 2, 0, 1)
        return new.to(old.device)
    if new.dtype in _RAW_DTYPES:
        return new
    return new.numpy()


def restore_checkpoint(path: str | os.PathLike, target, *, verify: bool = True):
    """Refill ``target``'s leaves from the checkpoint at ``path`` (a
    TrainState in place, any other tree as a new tree; module docstring).

    Every rank reads the same files, so all ranks resume identical.
    Shapes must match the target's, and a TrainState's dtypes too (its
    tensors are overwritten in place). ``verify=True`` checks each
    encoded leaf against the manifest's CRC-32 first and raises
    :class:`CheckpointCorruptError` on a mismatch, truncation or an
    unreadable file; nothing of the target changes before every leaf has
    been read, verified and checked."""
    path = os.fspath(path)
    from tpudml_torch.obs.tracer import get_tracer

    with get_tracer().span("checkpoint_restore", cat="checkpoint",
                           args={"path": os.path.basename(path), "verify": bool(verify)}):
        manifest = _read_manifest(path)
        in_place = _is_train_state(target)
        slots = tree_leaves(target)
        if manifest["num_leaves"] != len(slots):
            raise ValueError(
                f"checkpoint has {manifest['num_leaves']} leaves, target has "
                f"{len(slots)} — structure mismatch")
        leaves = _read_leaves(path, manifest, len(slots), verify)
        for i, (new, slot) in enumerate(zip(leaves, slots)):
            if tuple(new.shape) != slot.shape():
                raise ValueError(f"leaf {i}: checkpoint shape {tuple(new.shape)} != target "
                                 f"shape {slot.shape()}")
            if (in_place and isinstance(slot.value, torch.Tensor)
                    and new.dtype != slot.value.dtype):
                raise ValueError(f"leaf {i}: checkpoint dtype {new.dtype} != the state's "
                                 f"{slot.value.dtype}")
        if in_place:
            with torch.no_grad():
                for new, slot in zip(leaves, slots):
                    if isinstance(slot.value, torch.Tensor):
                        if slot.hwio:
                            new = new.permute(3, 2, 0, 1)
                        slot.value.copy_(new)
                    else:
                        slot.put(new.numpy())
            return target
        return _rebuild(target, iter([_restored(n, s) for n, s in zip(leaves, slots)]))


def _rebuild(tree, it):
    """``tree`` with its leaves taken in JAX's order from ``it``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(v, it) for k, v in _sorted_items(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(v, it) for v in tree]
        return items if isinstance(tree, list) else type(tree)(items)
    return next(it)


def verify_checkpoint(path: str | os.PathLike) -> int:
    """Full integrity check of one ``step_`` dir; returns its step.

    Raises :class:`CheckpointCorruptError` on a missing/unreadable
    manifest, a missing/truncated/unreadable ``leaves.npz``, or a leaf
    whose CRC-32 disagrees with the manifest. Format-1 checkpoints (no
    ``checksums``) pass if every leaf is readable."""
    path = os.fspath(path)
    from tpudml_torch.obs.tracer import get_tracer

    with get_tracer().span("checkpoint_verify", cat="checkpoint",
                           args={"path": os.path.basename(path)}):
        manifest = _read_manifest(path)
        checksums = manifest.get("checksums", {})
        try:
            with np.load(os.path.join(path, _LEAVES)) as data:
                for i in range(int(manifest["num_leaves"])):
                    key = f"leaf_{i:05d}"
                    raw = data[key]
                    if key in checksums and _crc(raw) != checksums[key]:
                        raise CheckpointCorruptError(
                            f"{path}: leaf {i} checksum mismatch (corrupt data)")
        except CheckpointCorruptError:
            raise
        except Exception as e:
            raise CheckpointCorruptError(f"{path}: unreadable {_LEAVES}: {e!r}") from e
        return int(manifest["step"])


def _all_step_dirs(directory: str) -> list[tuple[int, str]]:
    """(step, path) of every ``step_`` dir, manifest or not, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_DIR.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def restore_latest_valid(directory: str | os.PathLike, target, *, verify: bool = True):
    """Restore from the NEWEST checkpoint that verifies, walking ``step_*``
    dirs newest-first past corrupt or partial ones (each skip reported on
    stderr). ``target`` as it is when the directory holds no ``step_``
    dir (a fresh start); :class:`CheckpointCorruptError` when step dirs
    exist but none restores."""
    directory = os.fspath(directory)
    dirs = _all_step_dirs(directory)
    if not dirs:
        return target
    failures = []
    for step, path in reversed(dirs):
        try:
            return restore_checkpoint(path, target, verify=verify)
        except (CheckpointCorruptError, ValueError, OSError, KeyError) as e:
            failures.append(f"step_{step}: {e}")
            print(f"[tpudml.checkpoint] skipping invalid checkpoint step_{step}: {e}",
                  file=sys.stderr)
    raise CheckpointCorruptError(
        f"{directory}: no valid checkpoint among {len(dirs)} step dirs — "
        + "; ".join(failures))


class CheckpointManager:
    """Rolling checkpoint directory with retention.

    Usage::

        mgr = CheckpointManager(run_dir, keep=3)
        mgr.save(train_state, step)
        ts = mgr.restore_latest(train_state)   # as it is if empty

    ``async_write=True`` moves the npz write and the atomic rename to a
    background thread: ``save`` still copies every leaf to host memory
    before it returns (one ``.cpu()`` a card tensor, a clone of a CPU
    one), so the next step may update the parameters in place at once.
    One write is in flight at a time: a new save (or ``wait()``,
    ``restore_latest``) joins the previous one first and re-raises its
    error. Single-process only (the multi-rank barrier stays
    synchronous).
    """

    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 async_write: bool = False):
        self.directory = os.fspath(directory)
        self.keep = keep
        if async_write and _process_count() > 1:
            raise ValueError(
                "async_write is single-process only (the multi-rank save "
                "barrier must remain synchronous)")
        self.async_write = async_write
        self._pending: threading.Thread | None = None
        self._pending_error: list[BaseException] = []
        if async_write:
            # A failed FINAL save must not vanish at interpreter exit.
            atexit.register(self._warn_on_exit)

    def _warn_on_exit(self) -> None:
        try:
            self.wait()
        except BaseException as e:  # stderr is all there is at exit
            print(f"[tpudml.checkpoint] final async save FAILED: {e!r}", file=sys.stderr)

    def wait(self) -> None:
        """Block until an in-flight async save (if any) is on disk;
        re-raise its error, if it failed, here."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_error:
            raise self._pending_error.pop()

    def save(self, tree, step: int, metadata: dict | None = None) -> str:
        if not self.async_write:
            path = save_checkpoint(self.directory, tree, step, metadata=metadata)
            self._prune()
            return path
        self.wait()  # one write in flight; surface any earlier failure
        leaves = [leaf.host(copy=True) for leaf in tree_leaves(tree)]
        metadata = dict(metadata) if metadata else None  # by value
        path = os.path.join(self.directory, f"step_{step}")

        def write():
            from tpudml_torch.obs.tracer import get_tracer

            try:
                with get_tracer().span("checkpoint_save", cat="checkpoint",
                                       args={"step": int(step)}):
                    _write(self.directory, path, leaves, step, metadata)
                self._prune()
            except BaseException as e:  # surfaced on the next wait()/save()
                self._pending_error.append(e)

        # Non-daemon: the interpreter joins it at exit, so a final save is
        # not cut short by shutdown.
        self._pending = threading.Thread(target=write, daemon=False)
        self._pending.start()
        return path

    def _valid(self, step: int) -> bool:
        try:
            verify_checkpoint(os.path.join(self.directory, f"step_{step}"))
            return True
        except CheckpointCorruptError:
            return False

    def _prune(self) -> None:
        """Keep-last-K retention that never deletes the ONLY valid
        checkpoint: when none of the K newest verifies, the newest valid
        older step is spared. Verification reads happen only when
        something is due for deletion."""
        if _process_index() != 0 or not os.path.isdir(self.directory):
            return
        steps = sorted(int(m.group(1)) for name in os.listdir(self.directory)
                       if (m := _STEP_DIR.match(name)))
        if self.keep <= 0 or len(steps) <= self.keep:
            return
        kept, candidates = steps[-self.keep:], steps[: -self.keep]
        if not any(self._valid(s) for s in kept):
            for s in reversed(candidates):
                if self._valid(s):
                    candidates = [c for c in candidates if c != s]
                    break
        for s in candidates:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), True)

    def latest_step(self) -> int | None:
        self.wait()
        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        return int(_STEP_DIR.match(os.path.basename(path)).group(1))

    def restore_latest(self, target, *, verify: bool = True):
        """Restore the newest VALID checkpoint (:func:`restore_latest_valid`);
        ``target`` as it is when the directory holds none."""
        self.wait()
        return restore_latest_valid(self.directory, target, verify=verify)


def checkpoint_hook(manager: CheckpointManager, every: int) -> Callable:
    """``train_loop`` hook: save the TrainState every ``every`` optimizer
    steps, keyed by the state's monotonic ``step`` (not the loop's
    counter, which restarts on resume); the offset between the two is
    read once, at the first call."""
    base: int | None = None

    def hook(*, epoch, step, train_state, metrics, **_):
        nonlocal base
        if base is None:
            base = int(train_state.step) - step
        global_step = base + step
        if every and global_step % every == 0:
            manager.save(train_state, global_step, metadata={"epoch": epoch})

    return hook


class CheckpointHook:
    """Object form of :func:`checkpoint_hook`: ``CheckpointHook(manager,
    every_n_steps=50)`` saves every N optimizer steps mid-epoch; with
    ``train_loop``'s fast-forward on a restored state, a run cut between
    epoch boundaries resumes bit-exact from the last saved step."""

    def __init__(self, manager: CheckpointManager, every_n_steps: int):
        if every_n_steps < 1:
            raise ValueError("every_n_steps must be >= 1")
        self.manager = manager
        self.every_n_steps = every_n_steps
        self._hook = checkpoint_hook(manager, every_n_steps)

    def __call__(self, **kwargs) -> None:
        self._hook(**kwargs)
