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
    flash_head_dim_ok,
)
from tpudml_torch.ops.cuda_lib import build_all
from tpudml_torch.ops.decode_head import (
    DECODE_HEAD,
    DECODE_HEAD_INT8,
    fused_decode_head,
    fused_decode_head_int8,
    head_plan,
    head_plan_built,
    reference_head,
    reference_head_int8,
)
from tpudml_torch.ops.junction_kernel import fused_attn_junction, reference_attn_junction
from tpudml_torch.ops.layernorm_kernel import (
    ADD_LN_BACKWARD,
    ADD_LN_BACKWARD_BF16,
    ADD_LN_FORWARD,
    ADD_LN_FORWARD_BF16,
    LN_BACKWARD,
    LN_BACKWARD_BF16,
    LN_FORWARD,
    LN_FORWARD_BF16,
    add_layernorm_backward,
    add_layernorm_backward_reference,
    add_layernorm_forward,
    add_layernorm_forward_reference,
    fused_add_layernorm,
    fused_layernorm,
    layernorm_backward,
    layernorm_backward_reference,
    layernorm_forward,
    layernorm_forward_reference,
)
from tpudml_torch.ops.moe_kernel import (
    GROUPED_DW,
    GROUPED_DW_BF16,
    grouped_dw,
    grouped_dw_chunks,
    grouped_dw_plan,
    grouped_dw_plan_built,
    grouped_dw_reference,
    ragged_ffn,
    ragged_matmul,
)
from tpudml_torch.ops.xent_kernel import (
    XENT_DW,
    XENT_DW_LEAN,
    XENT_DX,
    XENT_DX_LEAN,
    XENT_FORWARD,
    XENT_FORWARD_SAVE,
    fwd_plan,
    fwd_plan_built,
    lean_plan,
    lean_plan_built,
    linear_cross_entropy,
    saved_plan,
    saved_plan_built,
    xent_dw,
    xent_dw_lean,
    xent_dw_lean_reference,
    xent_dw_reference,
    xent_dx,
    xent_dx_lean,
    xent_dx_lean_reference,
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
           XENT_FORWARD, XENT_FORWARD_SAVE, XENT_DX, XENT_DW,
           XENT_DX_LEAN, XENT_DW_LEAN,
           LN_FORWARD, LN_BACKWARD, LN_FORWARD_BF16, LN_BACKWARD_BF16,
           GROUPED_DW, GROUPED_DW_BF16)


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
    "flash_head_dim_ok",
    "fused_add_layernorm",
    "fused_attn_junction",
    "fused_decode_head",
    "fused_decode_head_int8",
    "fused_layernorm",
    "grouped_dw",
    "grouped_dw_chunks",
    "grouped_dw_plan",
    "grouped_dw_plan_built",
    "grouped_dw_reference",
    "head_plan",
    "head_plan_built",
    "layernorm_backward",
    "layernorm_backward_reference",
    "layernorm_forward",
    "layernorm_forward_reference",
    "fwd_plan",
    "fwd_plan_built",
    "lean_plan",
    "lean_plan_built",
    "linear_cross_entropy",
    "ragged_ffn",
    "ragged_matmul",
    "reference_attn_junction",
    "reference_head",
    "reference_head_int8",
    "reset_launch_counts",
    "saved_plan",
    "saved_plan_built",
    "xent_dw",
    "xent_dw_lean",
    "xent_dw_lean_reference",
    "xent_dw_reference",
    "xent_dx",
    "xent_dx_lean",
    "xent_dx_lean_reference",
    "xent_dx_reference",
    "xent_forward",
    "xent_forward_reference",
    "xent_forward_save",
    "xent_forward_save_reference",
]
