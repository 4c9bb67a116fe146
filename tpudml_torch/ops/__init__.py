"""Hand-written Hopper kernels of the port (CUDA C++ in ``tpudml_torch/csrc``).

Each public op launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors. ``KERNELS`` lists every ported kernel with
its launch counter; :func:`build_kernels` compiles all of their sources at
once (one ``nvcc`` per source, started together).
"""

from tpudml_torch.ops.attention_kernel import (
    FLASH_DKDV,
    FLASH_DKDV_BF16,
    FLASH_DQ,
    FLASH_DQ_BF16,
    FLASH_FORWARD,
    FLASH_FORWARD_BF16,
    flash_attention,
    flash_block_grads,
    flash_block_grads_reference,
    flash_dkdv,
    flash_dkdv_reference,
    flash_dq,
    flash_dq_reference,
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
from tpudml_torch.ops.layernorm_kernel import (
    ADD_LN_BACKWARD,
    ADD_LN_BACKWARD_BF16,
    ADD_LN_FORWARD,
    ADD_LN_FORWARD_BF16,
    add_layernorm_backward,
    add_layernorm_backward_reference,
    add_layernorm_forward,
    add_layernorm_forward_reference,
    fused_add_layernorm,
)
from tpudml_torch.ops.xent_kernel import (
    XENT_DW,
    XENT_DX,
    XENT_FORWARD,
    XENT_FORWARD_SAVE,
    linear_cross_entropy,
    xent_dw,
    xent_dw_reference,
    xent_dx,
    xent_dx_reference,
    xent_forward,
    xent_forward_reference,
    xent_forward_save,
    xent_forward_save_reference,
)

KERNELS = (FLASH_FORWARD, FLASH_DQ, FLASH_DKDV, DECODE_HEAD, DECODE_HEAD_INT8,
           ADD_LN_FORWARD, ADD_LN_BACKWARD,
           FLASH_FORWARD_BF16, FLASH_DQ_BF16, FLASH_DKDV_BF16,
           ADD_LN_FORWARD_BF16, ADD_LN_BACKWARD_BF16,
           XENT_FORWARD, XENT_FORWARD_SAVE, XENT_DX, XENT_DW)


def build_kernels() -> float:
    """Compile every kernel source not yet built; returns the seconds spent."""
    return build_all(k.library for k in KERNELS)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS",
    "add_layernorm_backward",
    "add_layernorm_backward_reference",
    "add_layernorm_forward",
    "add_layernorm_forward_reference",
    "build_kernels",
    "flash_attention",
    "flash_block_grads",
    "flash_block_grads_reference",
    "flash_dkdv",
    "flash_dkdv_reference",
    "flash_dq",
    "flash_dq_reference",
    "flash_forward_lse",
    "flash_forward_lse_reference",
    "fused_add_layernorm",
    "fused_decode_head",
    "fused_decode_head_int8",
    "linear_cross_entropy",
    "reference_head",
    "reference_head_int8",
    "reset_launch_counts",
    "xent_dw",
    "xent_dw_reference",
    "xent_dx",
    "xent_dx_reference",
    "xent_forward",
    "xent_forward_reference",
    "xent_forward_save",
    "xent_forward_save_reference",
]
