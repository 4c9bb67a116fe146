"""Seeded, deterministic fault injection (the port of
``tpudml/resilience/faults.py``): the harness that proves the
resilience layer instead of asserting it.

- **microbatch corruptors** (:func:`corrupt_microbatch`) poison a chosen
  microbatch of a batch with NaN / Inf / 1e30-scale outliers (the
  sentinel's prey);
- **process faults** (:func:`rank_kill_hook`, :func:`straggler_hook`)
  kill or delay a rank from inside a training loop's hooks (the
  launcher's and the resume path's prey);
- **elastic adversaries** (:func:`reform_straggler_hook`,
  :func:`occupy_port`) stall a rank rejoining a re-formed job and squat
  on a coordinator port (the elastic controller's prey);
- **checkpoint vandals** (:func:`vandalize`, registry :data:`VANDALS`)
  corrupt a checkpoint directory the four ways checkpoints die: a
  truncated array file, a silent bit flip, a missing manifest and a
  partial ``step_`` dir (``verify=True`` / ``restore_latest_valid``'s
  prey);
- **plan vandals** (:func:`vandalize_plan`, registry
  :data:`PLAN_VANDALS`) tear, garble or mis-version a ``plan.json``
  (``Replanner.load_existing``'s prey).

Every fault takes an explicit seed, the same as JAX's, and none reads
the clock or ambient randomness, so an injected run repeats exactly.
"""

from __future__ import annotations

import os
import time

import numpy as np

# --------------------------------------------------------- data corruptors


def corrupt_microbatch(
    batch,
    kind: str = "nan",
    micro: int = 0,
    accum_steps: int = 1,
    seed: int = 0,
    frac: float = 0.01,
):
    """A copy of ``batch`` with microbatch ``micro`` poisoned.

    The microbatch split matches ``tpudml_torch.train.accumulate_grads``: leading dim
    reshaped to ``[accum_steps, B/accum_steps]``, so with
    ``accum_steps=1`` the whole batch is the single microbatch. ``kind``:
    ``"nan"`` / ``"inf"`` write that value, ``"outlier"`` multiplies by
    1e30 (finite, only a spike test catches it). ``frac`` of the
    microbatch's elements (at least one), at seeded positions.
    """
    if kind not in ("nan", "inf", "outlier"):
        raise ValueError(f"unknown corruption kind {kind!r}")
    x = np.array(batch, dtype=np.float32 if kind != "outlier" else None,
                 copy=True)
    if x.dtype.kind != "f":
        x = x.astype(np.float32)
    n = x.shape[0]
    if n % accum_steps:
        raise ValueError(f"batch dim {n} not divisible by {accum_steps}")
    mb = n // accum_steps
    if not 0 <= micro < accum_steps:
        raise ValueError(f"micro {micro} out of range for {accum_steps}")
    rows = x[micro * mb: (micro + 1) * mb]
    rng = np.random.default_rng(seed)
    k = max(1, int(frac * rows.size))
    idx = rng.choice(rows.size, size=k, replace=False)
    flat = rows.reshape(-1)
    if kind == "nan":
        flat[idx] = np.nan
    elif kind == "inf":
        flat[idx] = np.inf
    else:
        flat[idx] = flat[idx] * 1e30 + 1e30
    return x


# --------------------------------------------------------- process faults


def rank_kill_hook(
    at_step: int,
    *,
    exit_code: int = 17,
    marker: str | None = None,
    rank: int | None = None,
):
    """A ``train_loop`` hook that hard-kills THIS process (``os._exit``,
    no cleanup — a preemption, not a graceful shutdown) the first time
    the loop reaches ``at_step``. With ``marker`` set, the kill happens
    at most once across restarts: the marker file is created atomically
    before exiting, and a restarted run that finds it keeps running —
    exactly the kill→restart→resume sequence the containment tests
    drive. ``rank`` limits the kill to one process (``TPUDML_PROCESS_ID``,
    the launcher's rank env)."""

    def hook(*, step, **_):
        if step != at_step:
            return
        if rank is not None and int(os.environ.get("TPUDML_PROCESS_ID", "0")) != rank:
            return
        if marker is not None:
            try:
                fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return  # already killed once — this is the restarted run
            os.write(fd, f"killed at step {step}\n".encode())
            os.close(fd)
        os._exit(exit_code)

    return hook


def straggler_hook(
    delay_s: float,
    *,
    at_step: int | None = None,
    rank: int | None = None,
):
    """A ``train_loop`` hook injecting a host-side stall (every step, or
    only ``at_step``) on one rank — the synchronous-collective straggler
    of SURVEY.md §5.3, for timeout/containment tests."""

    def hook(*, step, **_):
        if at_step is not None and step != at_step:
            return
        if rank is not None and int(os.environ.get("TPUDML_PROCESS_ID", "0")) != rank:
            return
        time.sleep(delay_s)

    return hook


def reform_straggler_hook(
    delay_s: float,
    *,
    round: int,
    rank: int | None = None,
):
    """A straggler that fires only in elastic re-form round ``round``
    (``TPUDML_ELASTIC_ROUND``, the controller's per-incarnation env):
    the rank comes back after a failure but stalls before its first
    step, delaying the whole re-formed gang — the slow-rejoiner
    adversary. Fires once (the first hook call of that round)."""
    fired = [False]

    def hook(*, step, **_):
        del step
        if fired[0]:
            return
        if int(os.environ.get("TPUDML_ELASTIC_ROUND", "0")) != round:
            return
        if rank is not None and int(os.environ.get("TPUDML_PROCESS_ID", "0")) != rank:
            return
        fired[0] = True
        time.sleep(delay_s)

    return hook


def occupy_port(port: int, host: str = "127.0.0.1"):
    """Bind-and-listen a squatter socket on ``port`` — the
    coordinator-port-collision adversary. Returns the open socket (close
    it to release the port); raises ``OSError`` if the port is already
    taken. The elastic controller must notice the pinned port is dead
    and fall back to a fresh one instead of crash-looping."""
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.bind((host, port))
        s.listen(1)
    except OSError:
        s.close()
        raise
    return s


# -------------------------------------------------------- checkpoint vandals


def _step_dirs(directory: str) -> list[tuple[int, str]]:
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append((int(name[5:]), os.path.join(directory, name)))
            except ValueError:
                continue
    return sorted(out)


def _array_files(step_dir: str) -> list[str]:
    """The npz payload files of either checkpoint format (store's
    ``leaves.npz``, sharded's ``shards_p{k}.npz``)."""
    return sorted(
        os.path.join(step_dir, f)
        for f in os.listdir(step_dir)
        if f.endswith(".npz")
    )


def _manifest_files(step_dir: str) -> list[str]:
    return sorted(
        os.path.join(step_dir, f)
        for f in os.listdir(step_dir)
        if f.startswith("manifest") and f.endswith(".json")
    )


def vandal_truncate(step_dir: str, seed: int = 0) -> str:
    """Truncate the array payload to half its size (a write cut short)."""
    path = _array_files(step_dir)[0]
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    return path


def vandal_bitflip(step_dir: str, seed: int = 0) -> str:
    """Flip one seeded bit in the array payload (silent media corruption
    — the file stays the right size and the zip stays openable)."""
    path = _array_files(step_dir)[0]
    size = os.path.getsize(path)
    rng = np.random.default_rng(seed)
    # Stay inside member data, away from the zip's central directory at
    # the tail, so the corruption is only catchable by a checksum.
    offset = int(rng.integers(low=min(200, size // 4), high=size // 2))
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([byte ^ (1 << int(rng.integers(8)))]))
    return path


def vandal_delete_manifest(step_dir: str, seed: int = 0) -> str:
    """Delete the manifest(s) — metadata loss."""
    paths = _manifest_files(step_dir)
    if not paths:
        raise FileNotFoundError(f"no manifest in {step_dir}")
    for p in paths:
        os.remove(p)
    return paths[0]


def vandal_partial(step_dir: str, seed: int = 0) -> str:
    """Turn the dir into a partial write: manifest present, arrays gone
    (a checkpoint copied or crash-recovered without its payload)."""
    for p in _array_files(step_dir):
        os.remove(p)
    return step_dir


#: name -> vandal(step_dir, seed) -> touched path
VANDALS = {
    "truncate": vandal_truncate,
    "bitflip": vandal_bitflip,
    "no_manifest": vandal_delete_manifest,
    "partial": vandal_partial,
}


def vandalize(
    directory: str,
    kind: str,
    *,
    step: int | None = None,
    seed: int = 0,
) -> str:
    """Apply vandal ``kind`` to the ``step_{step}`` dir under a
    checkpoint ``directory`` (default: the NEWEST step — the one a naive
    restore would trust). Returns the touched path."""
    dirs = _step_dirs(directory)
    if not dirs:
        raise FileNotFoundError(f"no step_* dirs under {directory}")
    if step is None:
        target = dirs[-1][1]
    else:
        by_step = dict(dirs)
        if step not in by_step:
            raise FileNotFoundError(f"no step_{step} under {directory}")
        target = by_step[step]
    return VANDALS[kind](target, seed)


# ----------------------------------------------------------- plan vandals


def plan_vandal_truncate(path: str, seed: int = 0) -> str:
    """Cut the plan file in half mid-JSON (a write torn by a crash)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 2))
    return path


def plan_vandal_garbage(path: str, seed: int = 0) -> str:
    """Replace the plan with non-JSON bytes."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(rng.integers(0, 256, size=64, dtype=np.uint8).tobytes())
    return path


def plan_vandal_bad_version(path: str, seed: int = 0) -> str:
    """Stamp an unsupported schema version into otherwise-valid JSON —
    the one corruption only ``load_plan``'s version gate catches."""
    import json

    with open(path) as f:
        plan = json.load(f)
    plan["version"] = 99
    with open(path, "w") as f:
        json.dump(plan, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


#: name -> vandal(plan_path, seed) -> touched path
PLAN_VANDALS = {
    "truncate": plan_vandal_truncate,
    "garbage": plan_vandal_garbage,
    "bad_version": plan_vandal_bad_version,
}


def vandalize_plan(path: str, kind: str, *, seed: int = 0) -> str:
    """Corrupt a ``plan.json`` the three ways the re-plan path can lose
    it between emit and relaunch. The consumer contract under attack:
    ``Replanner.load_existing`` and the drill child must reject the file
    loudly or fall back, never train under a half-parsed plan."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return PLAN_VANDALS[kind](path, seed)
