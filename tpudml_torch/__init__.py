"""tpudml_torch: the PyTorch/CUDA port of tpu-dml for an NVIDIA H100.

It grows beside the JAX package ``tpudml`` (the reference, which it never
imports), slice by slice. This slice is the serving path: a
``TransformerLM`` served by the continuous-batching ``ServingEngine``,
with the TPU's Pallas kernels on that path replaced by hand-written CUDA
kernels for Hopper (``tpudml_torch/csrc``): the flash forward of chunked
prefill and the fused greedy decode head (f32 and int8 weights).

- ``tpudml_torch.nn``      — Dense, LayerNorm, attention ops and module.
- ``tpudml_torch.models``  — the decoder-only TransformerLM.
- ``tpudml_torch.ops``     — the CUDA kernels, their wrappers, plain
                             versions and launch counters.
- ``tpudml_torch.serve``   — KV cache, engine, workloads, int8 weights.
- ``tpudml_torch.metrics`` — JSONL scalar writer.
- ``tpudml_torch.interop`` — tpudml param trees -> the port's state.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"
