"""tpudml_torch: the PyTorch/CUDA port of tpu-dml for an NVIDIA H100.

It grows beside the JAX package ``tpudml`` (the reference, which it never
imports), slice by slice, with the TPU's Pallas kernels on each slice's
path replaced by hand-written CUDA kernels for Hopper
(``tpudml_torch/csrc``). Slice 1 is serving: a ``TransformerLM`` served by
the continuous-batching ``ServingEngine`` (the flash forward of chunked
prefill, the fused greedy decode head in f32 and int8). Slice 2 is
single-card training: task5's ``--parallel single`` step with flash
attention (forward, dQ, dK/dV kernels) and the fused add+LayerNorm
junctions (forward and backward kernels), Adam in f32.

- ``tpudml_torch.nn``      — Dense, LayerNorm, attention ops and module,
                             softmax cross-entropy.
- ``tpudml_torch.models``  — the decoder-only TransformerLM.
- ``tpudml_torch.ops``     — the CUDA kernels, their wrappers, plain
                             versions and launch counters.
- ``tpudml_torch.optim``   — GD, Adam, AdamW.
- ``tpudml_torch.train``   — TrainState and the train step.
- ``tpudml_torch.data``    — seeded synthetic data.
- ``tpudml_torch.serve``   — KV cache, engine, workloads, int8 weights.
- ``tpudml_torch.tasks``   — the task entry points (task5 training,
                             task6 serving).
- ``tpudml_torch.metrics`` — JSONL scalar writer.
- ``tpudml_torch.interop`` — tpudml param and Adam-state trees -> the
                             port's state.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"
