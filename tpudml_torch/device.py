"""Device selection for the port's entry points.

Entry points take ``device`` (default ``"cuda"``). Asking for the card on
a machine without one raises: nothing falls back to the CPU quietly. The
CPU is taken only when the caller names it, as the tests do: with
``device="cpu"``, or for the task CLIs' default with ``TPUDML_DEVICE=cpu``
in the environment (``tpudml_torch.launch`` exports it for
``platform="cpu"``, where it also hides the card).
"""

from __future__ import annotations

import os

import torch


def default_device() -> str:
    """The task CLIs' ``--device`` default: ``TPUDML_DEVICE``, else
    ``cuda``."""
    return os.environ.get("TPUDML_DEVICE", "cuda")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain versions on the CPU"
        )
    return dev
