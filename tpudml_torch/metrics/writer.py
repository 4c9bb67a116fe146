"""Scalar metrics writer (the port's copy of ``tpudml/metrics/writer.py``).

- **jsonl** (default, dependency-free): one ``{"tag", "value", "step",
  "wall_time"}`` record per line in ``metrics.jsonl`` under
  ``<log_dir>/<YYYY-MM-DD>/<HH-MM-SS>-<run_name>/``.
- **tensorboard** (optional): event files alongside, when
  ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import math
import time
from datetime import datetime
from pathlib import Path


class MetricsWriter:
    def __init__(
        self,
        log_dir: str | Path,
        run_name: str | None = None,
        backends: tuple[str, ...] = ("jsonl",),
    ):
        log_dir = Path(log_dir)
        now = datetime.now()
        # A collision suffix keeps runs started within one second separate.
        sub = now.strftime("%H-%M-%S") + (f"-{run_name}" if run_name else "")
        base = log_dir / now.strftime("%Y-%m-%d") / sub
        self.run_dir = base
        for i in range(1, 1000):
            try:
                self.run_dir.mkdir(parents=True, exist_ok=False)
                break
            except FileExistsError:
                self.run_dir = base.with_name(f"{base.name}-{i}")
        self._jsonl = None
        self._tb = None
        if "jsonl" in backends:
            self._jsonl = open(self.run_dir / "metrics.jsonl", "a", buffering=1)
        if "tensorboard" in backends:
            try:
                from torch.utils.tensorboard import SummaryWriter  # optional
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=str(self.run_dir))

    def add_scalar(self, tag: str, value, step: int) -> None:
        """Append one scalar. Non-finite values serialize as ``null`` with
        ``"finite": false``, so every line round-trips through
        ``json.loads``."""
        v = float(value)
        rec = {"tag": tag, "value": v, "step": int(step), "wall_time": time.time()}
        if not math.isfinite(v):
            rec["value"] = None
            rec["finite"] = False
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb:
            self._tb.add_scalar(tag, v, step)

    def add_scalars(self, scalars: dict, step: int) -> None:
        """Append a dict of scalars in one call, in insertion order."""
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
