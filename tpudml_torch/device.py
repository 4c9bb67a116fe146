"""Device selection for the port's entry points.

Entry points take ``device`` (default ``"cuda"``). Asking for the card on
a machine without one raises: nothing falls back to the CPU quietly. The
CPU is taken only when the caller names it, as the tests do: with
``device="cpu"``, or for the task CLIs' default with ``TPUDML_DEVICE=cpu``
in the environment (``tpudml_torch.launch`` exports it for
``platform="cpu"``, where it also hides the card). On the card the entry
points compute f32 in f32: :func:`no_tf32`.
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


def no_tf32(device: str | torch.device) -> None:
    """Turn TF32 off for cuBLAS's f32 products and cuDNN's f32 convolutions
    when ``device`` is the card (PyTorch allows it in cuDNN by default):
    the port's f32 is f32, as JAX's CPU reference computes it. The lab
    entries, the north star, the drills' children, ``chip_smoke.py`` and
    the profiling tools call it before they build a model. A no-op on the CPU."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
