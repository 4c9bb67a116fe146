"""Fleet tier of the port: int8 weight quantization only in this slice
(the router, disaggregated handoff and drill are still to port)."""

from tpudml_torch.serve.fleet.quant import (
    dequantize_params,
    quantize_params,
    quantized_param_bytes,
    sim_quantize_params,
)

__all__ = [
    "dequantize_params",
    "quantize_params",
    "quantized_param_bytes",
    "sim_quantize_params",
]
