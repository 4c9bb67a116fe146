"""tpudml_torch: the PyTorch/CUDA port of tpu-dml for an NVIDIA H100.

It grows beside the JAX package ``tpudml`` (the reference, which it never
imports), slice by slice, with the TPU's Pallas kernels on each slice's
path replaced by hand-written CUDA kernels for Hopper
(``tpudml_torch/csrc``). Slice 1 is serving: a ``TransformerLM`` served by
the continuous-batching ``ServingEngine`` (the flash forward of chunked
prefill, the fused greedy decode head in f32 and int8). Slice 2 is
single-card training: task5's ``--parallel single`` step with flash
attention (forward, dQ, dK/dV kernels) and the fused add+LayerNorm
junctions (forward and backward kernels), Adam in f32. Later slices:
the bf16 flagship step, long context, MoE on one card, data parallelism
over ``torch.distributed`` (slice 6), the ResNet-18 north star, expert
parallelism, the lab tasks with gradient accumulation and dropout
(slice 9), the serving levers (slice 10) and the host infrastructure
(slice 11: checkpoints, the grad sentinel, the flight recorder, the
profiler, the launcher).

- ``tpudml_torch.nn``      — Dense, Conv2D, pools, BatchNorm, LayerNorm,
                             Dropout, Sequential, attention ops and module,
                             MoE, softmax cross-entropy.
- ``tpudml_torch.models``  — the decoder-only TransformerLM, the ResNets,
                             LeNet and the MLP.
- ``tpudml_torch.ops``     — the CUDA kernels, their wrappers, plain
                             versions and launch counters.
- ``tpudml_torch.optim``   — GD, SGD, Adam, the reference Adam, AdamW,
                             the clip, learning-rate schedules.
- ``tpudml_torch.train``   — TrainState, the train step and the local
                             (un-aggregated) step.
- ``tpudml_torch.data``    — seeded synthetic data, MNIST (IDX) and
                             CIFAR-10, the in-memory dataset, samplers,
                             loaders, the device prefetch.
- ``tpudml_torch.native``  — the C++ host gather (ctypes).
- ``tpudml_torch.api``     — the MindSpore-style Model facade.
- ``tpudml_torch.core``    — process topology, the process group, the
                             task CLI config, PRNG keys.
- ``tpudml_torch.comm``    — collectives over a process group, comm
                             timing, the aggregation benchmark.
- ``tpudml_torch.parallel`` — the DataParallel and ExpertParallel engines.
- ``tpudml_torch.capabilities`` — the engines' composition rejections.
- ``tpudml_torch.serve``   — KV cache, engine, workloads, int8 weights.
- ``tpudml_torch.tasks``   — the task entry points (task1, task1_mlp,
                             task2, task3, task5 training, task6 serving,
                             the north star).
- ``tpudml_torch.metrics`` — JSONL scalar writer, the profiler session
                             and the span timer.
- ``tpudml_torch.obs``     — the flight recorder (Chrome-trace spans),
                             StepStats, the serve-trace conversion.
- ``tpudml_torch.checkpoint`` — format-2 checkpoints (JAX's), restore and
                             fallback, the rolling manager.
- ``tpudml_torch.resilience`` — the grad sentinel, fault injection.
- ``tpudml_torch.launch``  — the multi-process launcher.
- ``tpudml_torch.interop`` — tpudml param and Adam-state trees -> the
                             port's state.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"
