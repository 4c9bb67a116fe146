"""Hand-written Hopper kernels of the port (CUDA C++ in ``tpudml_torch/csrc``).

Each public op launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors. ``KERNELS`` lists every ported kernel with
its launch counter; :func:`build_kernels` compiles all of their sources at
once (one ``nvcc`` per source, started together).
"""

from tpudml_torch.ops.attention_kernel import (
    FLASH_FORWARD,
    flash_forward_lse,
    flash_forward_lse_reference,
)
from tpudml_torch.ops.cuda_lib import build_all
from tpudml_torch.ops.decode_head import (
    DECODE_HEAD,
    DECODE_HEAD_INT8,
    fused_decode_head,
    fused_decode_head_int8,
    reference_head,
    reference_head_int8,
)

KERNELS = (FLASH_FORWARD, DECODE_HEAD, DECODE_HEAD_INT8)


def build_kernels() -> float:
    """Compile every kernel source not yet built; returns the seconds spent."""
    return build_all(k.library for k in KERNELS)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS",
    "build_kernels",
    "flash_forward_lse",
    "flash_forward_lse_reference",
    "fused_decode_head",
    "fused_decode_head_int8",
    "reference_head",
    "reference_head_int8",
    "reset_launch_counts",
]
