"""Drive the PyTorch port (``tpudml_torch``) end to end on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero without one (it never runs on
the CPU). Phases, each printing its own line(s):

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN, so f32 means f32.
2. build: every CUDA kernel source of the port, one nvcc each, together;
   then, for each instance (head dims 32, 64, 128, 256) of the flash
   forward (kernel 1), dQ (kernel 2) and dK/dV (kernel 3), its ptxas
   registers and spills and its SASS count of bf16 tensor-core products,
   TF32 instructions and f32 FMAs. It fails unless every bf16 instance
   holds ``HMMA.16816.F32.BF16``, none holds TF32 and none spills. Then
   each instance of the LayerNorm kernels 6–9 with its registers and
   spills; it fails if a wide instance (past d = 1024) spills. Then each
   instance of the forward kernels 10 and 11 (``xent.cu``: f32 and bf16,
   with and without the score store, ragged d or not), of the saved-scores
   kernels 12 and
   13 and their range sum
   (``xent_saved.cu``) and of the lean head's kernels 14 and 15 and theirs
   (``xent_lean.cu``), f32 and bf16, with its registers, spills, stack frame
   and SASS counts; it fails if one spills or keeps a stack frame, holds
   TF32, or a bf16 twin of 10–15 holds no ``HMMA.16816.F32.BF16``; then
   the cut the built forward kernels make (rows a block, vocabulary slices,
   blocks) at FWD_PLAN_SHAPES against ``fwd_plan``, the cut the built
   saved-scores kernels make (rows or columns a block,
   reads of s, dW's row ranges, blocks) at SAVED_PLAN_SHAPES against
   ``saved_plan``, and the cut of d the built lean kernels choose (columns
   a block, blocks a cluster, score computations a tile) at d = 512 to
   8192, against ``lean_plan``. Then each instance of the grouped dW
   (kernel 16, ``grouped_dw.cu``: f32 and bf16, with and without 16-byte
   row copies) with its registers, spills, stack frame and SASS counts; it
   fails if one spills or keeps a stack frame, holds TF32, a bf16 twin
   holds no wgmma (``HGMMA.*.F32.BF16``) or ptxas serialized its wgmma;
   then its cut (chunk rows R, list slots, blocks, workspace) at
   GDW_PLAN_SHAPES against ``grouped_dw_plan``. Then the four instances of
   the decode head (kernels 4 and 5, ``decode_head.cu``: f32 and int8
   weights, 16-byte loads or one scalar load a column) with their
   registers, spills, stack frame and SASS counts; it fails if one spills,
   keeps a stack frame or holds TF32; then its cut (tiles, slices of d,
   x chunks, buffer) at HEAD_PLAN_SHAPES against ``head_plan``.
3. kernel vs plain version on the card at the main paths' shapes, with
   the tolerances stated: the flash forward (serving: B=1, T=128, H=8,
   D=64: causal, non-causal, odd T, k_shift=1; training: B=8, T=1024,
   H=4, D=128, causal), the fused decode head (B=8, d=512, V=32768, f32
   and int8 weights), the flash backward dQ and dK/dV (B=8, T=1024, H=4,
   D=128 causal; also non-causal, T=1000 and k_shift=1 through
   ``flash_block_grads``), the flash forward, dQ and dK/dV at the
   long-context path's B=2, T=16384, H=4, D=128 causal (the plain
   versions per (batch, head) slice), the fused add+LayerNorm forward and
   backward (N=8192, d=512; also N=1000 and ds=None), the bf16 twins of
   the flash and add+LN kernels at the training shapes, and the fused
   linear-xent kernels 10–13 (N=8192, d=512, V=32768, the ragged
   N=1000, V=1000 and the forward's tile and slice edges XENT_FWD_EDGES,
   with labels −1 and V; f32 and bf16; timed with TFLOP/s at 2·N·d·V, 12
   and 13 beside a yardstick that is not their function, cuBLAS's product
   alone on a dlog materialized in the operand dtype, and 11–13 in f32
   also at the long context's N=32768), the lean head's
   kernels 14 and 15 with kernel 10 that feeds them lse (the same shapes,
   and in f32 the long-context path's N=32768, BASELINE.md:46's N=131072
   and N=2097184 at d=1024, V=256, where N·d passes 2³¹ and the offsets
   need 64 bits; the last two against the plain versions in row chunks;
   timed with TFLOP/s at 4·N·d·V, at the path's shape and at the
   flagship's N=8192 in bf16 and f32),
   and the plain LayerNorm kernels 6 and 7 (N=8192 and N=1000, d=512, f32
   and bf16), and the grouped dW (kernel 16, f32 and bf16 twins) at the MoE
   path's M=8192 rows, (k, n) = (512, 2048) and (2048, 512), E = 4 and 8,
   on a real router's skewed top-1 groups, a set with empty groups and a
   collapsed one, with tail rows past Σ group_sizes, bitwise equal on a
   repeat, timed on the router's groups and on the collapsed set (its
   ratio to the router's time) beside per-expert ``torch.matmul`` and the
   one call ``torch._grouped_mm`` (bf16 output), the bf16 twin also on
   the device, and one slab of 60000 rows past the bf16 twin's 2048-row
   chunk cap; times of the kernel, the plain version and a library call
   computing the same function, beside the bound (bf16 rows against the
   bf16 tensor-core rate), and for the flash kernels their rate in TFLOP/s;
   for the kernels under ~0.13 ms (1 at serving's shape, the bf16 twins
   of 1–3, 4, 5, 6–9) also their device time and the library call's, from
   ``torch.profiler`` over 200 calls; kernels 4 and 5 also their device
   kernels a call (at most one) and their time with a cold L2 (a 256 MiB
   write between calls, CUDA events around each of 50 calls). dQ is held
   bitwise equal on a repeat call at the training, flagship and
   long-context shapes.
   Then the flash forward, dQ and dK/dV (f32 and bf16) at head dims between
   their compiled widths and at the widest, D = 48, 80, 200 and 256
   (causal T=200 and non-causal T=77), with the same tolerances, and dQ and
   dK/dV timed at D = 256 (B=8, T=1024, H=4, causal) beside SDPA's
   backward. Then the widths past the narrow instances, with the
   tolerances of the main shapes: kernels 6–9 (f32 and bf16) at d = 1536,
   2048, 4096, 8192 and 16384 with N·d = 2²⁵, each timed beside its bound
   and ``F.layer_norm``'s forward and backward, with device times, and at
   LN_CHECKS (N = 1, N below the backward's block count, ragged and
   misaligned rows, the looped instances; each backward bitwise equal on
   a repeat), kernels 10–15 at d = 12, 1032 and
   2048 (N = V = 1000, labels −1 and V; timed in f32 at N=4096, d=2048,
   V=8192, and 10, 11 at the flagship's N and V with d = 12), kernels 4
   and 5 at d = 8192 (B=8, V=32768, one launch and at most one device
   kernel a call; wrapper and device times). Then the launches
   past the old grid-y edges:
   kernels 10–13 at N=8,388,609 rows (d=8, V=128; dW in 129 row ranges)
   and the flash forward,
   dQ and dK/dV at B·H=65,537 (B=65,537, H=1, T=16, D=32), against their
   plain versions in row chunks.
4. main path 1, serving: the serving engine at full width (V=32768, d=512, H=8,
   kv_heads=2, L=6, RoPE, f32, random weights from a seeded generator;
   8 slots, max_len 1024, prefill chunks of 128; 16 requests at qps=inf,
   prompts 64-512, 64 new tokens at most), served unfused, with the fused
   f32 head, with the fused int8 head and with the int8_sim oracle.
   Launch counts are zeroed just before and read just after; every
   kernel must have launched, as often as the path requires. Streams are
   checked against a teacher-forced full forward (plain attention) and
   between the fused and unfused runs; a divergence is allowed only at a
   near-tie of the plain logits (top-2 gap < 1e-5), and is printed.
   Then ``[serve_levers]``: first kernel 1's bf16 twin at the serving
   block (B=1, T=128, H=8, D=64, causal and not) against its plain
   version, and the paged prefill's window for both instances (chunk 3,
   start 384, K/V written through a scattered page table, read back with
   ``read_row_prefix``, GQA-repeated, four launches of
   ``chunk_flash_window``) against the plain attention at the chunk's
   offset; then the serving levers at the same width, each
   run after an uncounted warm-up on an engine of its own, with launch
   counts zeroed just before it and read just after (paths
   ``serve_paged`` ... ``serve_bf16_paged``): the paged cache (page 16;
   streams against the dense unfused run's under the near-tie rule, the
   flash launches prefill needs), the same pool starved to a quarter of
   dense capacity (``defer`` events, every request completes), prefix
   sharing (page 128, 8 requests on one seeded 384-token head: prefix
   hits, each request's shared pages, streams against the unshared run,
   flash launches over the unshared chunks only), trunk-draft speculative
   decoding dense and paged (spec_k=3, 3 of 6 layers, block parameters
   ×0.25 as bench.py's spec row; streams against a plain dense engine on
   the same weights, accepted length > 0, the spec events accounting for
   every token), SLO admission (budget = the cost model's 4-slot step at
   the H100's HBM rate: at most 4 active slots, ``defer`` events, a second
   run's event log byte-identical), and the bf16-compute model dense
   unfused, with the fused head and paged (kernel 1's bf16 twin in the
   prefill, the head once a decode step, streams against the bf16 full
   forward with BF16_TIE_GAP). Each run prints tokens/s, per-token and
   TTFT p50/p99, decode steps, occupancy, accepted length and pool
   statistics, and the pool's bytes against the dense cache's.
5. main path 2, training: ``TransformerLM(impl="flash", fused_ln=True,
   rope=True)`` at the repo's chip training config (V=32768, d=512, H=4,
   L=6, T=1024, B=8, f32, Adam lr 1e-3; random weights from a seeded
   generator, batches from ``synthetic_lm``) trains TRAIN_STEPS steps
   through ``make_train_step``; the same initial state trains the same
   steps with ``impl="full", fused_ln=False``, which launches no kernel.
   Launch counts are zeroed just before the kernel run and read just
   after: exactly TRAIN_STEPS × (6, 6, 6, 12, 12) for flash fwd, dQ,
   dK/dV, add+LN fwd, add+LN bwd. Step-1 gradients and every step's loss
   agree with the plain run within the stated tolerances.
   5b. the wide trunk, ``train_wide``: phase 5 on task5's ``--embed_dim
   2048 --num_heads 16 --num_layers 2`` (V=32768, T=1024, B=8, f32, head
   dim 128), the width of a GPT-3 1.3B trunk at two layers, whose add+LN
   rows take the wide instances (it fails unless d > 1024): the same
   checks and tolerances, launches exactly TRAIN_STEPS × (2, 2, 2, 4, 4).
6. main path 3, the flagship step (``bench.py`` ``bench_transformer``):
   (a) on an f32 ``impl="flash", fused_ln=True`` model, step-1 gradients
   of ``make_lm_fused_loss_fn(save_scores=True)`` (the fused head's
   kernels 11–13) against ``make_loss_fn`` (materialized logits);
   (b) ``TransformerLM(impl="flash", fused_ln=True, rope=True,
   compute_dtype=bfloat16)`` with f32 master weights trains
   FLAGSHIP_STEPS steps of AdamW lr 3e-4 through
   ``make_lm_fused_train_step(save_scores=True)`` on bench's batch
   (``synthetic_lm(8, 1024, 32768, seed=1)``), against the same initial
   state trained through the kernel-free bf16 step (``impl="full"``,
   unfused LN, materialized logits). Launch counts are zeroed just before
   the kernel run and read just after: exactly FLAGSHIP_STEPS ×
   FLAGSHIP_PER_STEP. Step-1 gradients of both bf16 runs are held against
   the f32 gradients of (a) and against each other, and the losses
   against each other, within the stated bf16 tolerances;
   (c) one evaluation loss under ``torch.no_grad()``, its own path with
   its own zeroed counts, launches kernel 10 and agrees with the
   materialized loss.
   6b. main path 3b, the flagship data-parallel at world 1: a one-rank
   NCCL group (``tpudml_torch.core.process_group`` over a file store in a
   temporary directory, destroyed at the end). The single-card flagship
   step of (b) runs twice from one seed: does it repeat itself bitwise?
   Then ``DataParallel(fused_xent=True, save_scores=True,
   flash_attn=True)`` trains FLAGSHIP_STEPS steps from the same weights
   and batch, with the launch counts zeroed just before and read just
   after: exactly FLAGSHIP_STEPS × FLAGSHIP_PER_STEP, and losses and
   parameters bitwise equal to the single-card run's where that run
   repeats itself (else within DP_GAP_MULT times the gap between the two
   single-card runs).
   Each aggregator (allreduce, allgather, reducescatter) alone on the
   flagship's gradients, by CUDA events and on the device (NCCL kernels
   against the copies), and the DP and single-card ms/step. The split
   step (``measure_comm=True``, f32, materialized logits, flash, fused
   add+LN) trains DP_SPLIT_STEPS steps of phase 5's batches with its own
   zeroed counts (DP_SPLIT_STEPS × PER_STEP): one positive comm span a
   step, losses and parameters bitwise equal to the fused DP step's
   (the same f32 math on the same batches). Then task5
   ``--parallel dp`` (DP_TASK5: 1 device, its loss falls) and
   ``tpudml_torch.comm.bench`` at world 1, every aggregator.
7. main path 4, long-context training (BASELINE.md:45): task5's own
   ``build_engine`` with ``--attn flash --seq_len 16384 --batch_size 2
   --vocab 32768 --embed_dim 512 --num_heads 4 --num_layers 6 --rope
   --lr 0.001 --fused_xent`` (f32, Adam, random weights from the task's
   seed), whose auto mode must resolve to the lean head (the padded f32
   scores would be 4 GiB). Step-1 gradients and loss through the engine's
   loss agree with the saved-scores head's (``--fused_xent_scores``) and
   with the materialized logits'. Then LONG_STEPS steps of
   task5's batches: launch counts zeroed just before and read just after
   must be exactly LONG_STEPS × LONG_PER_STEP (kernels 11–13 never); the
   same initial state trains the same batches through
   ``--fused_xent_scores``, losses within LOSS_TOL; the lean run's peak
   device memory must lie at least LEAN_MEM_GAP below the saved run's (the
   O(N) contract). No kernel-free run: full attention at T=16384 holds
   8 GiB of scores a layer.
8. the plain LayerNorm op path: ``fused_layernorm`` forward and backward
   under autograd at [8192, 512] in f32 and bf16, with its own zeroed
   launch counts (kernels 6 and 7 and their bf16 twins, once each), held
   against ``F.layer_norm``.
9. main path 5, MoE training (``bench.py --moe``, ``bench_moe``): the
   training config (V=32768, d=512, H=4, L=6, T=1024, B=8) with flash
   attention, fused add+LN, RoPE, bf16 compute over f32 master weights,
   AdamW lr 3e-4, top-1 MoE FFNs at capacity factor 1.25, weights from a
   seeded generator, bench's one batch ``synthetic_lm(8, 1024, 32768,
   seed=3)`` every step. First, at E = 4 and 8, step-1 gradients of the
   ``ragged`` dispatch with the grouped-dW backward against the stock one
   on the same weights (equal losses: the forward is the same code;
   gradients within BF16_PAIR_GRAD_RTOL). Then, with the launch counts
   zeroed just before and read just after, MOE_STEPS steps of
   ``make_train_step_body`` for each E ∈ {4, 8} × {gather, ragged_stock,
   ragged_grouped}: ms/step (eager, one card, no ``fori``), finite losses,
   and launches per run: ragged_grouped exactly 2·L = 12 of kernel 16's
   bf16 twin a step, the other two none, and every run the bf16 flash and
   add+LN kernels of the trunk.
10. main path 6, f32 MoE training through task5: ``build_engine`` with
   ``--attn flash --fused_ln --rope --moe_experts 8 --moe_dispatch
   ragged`` at the training config, Adam lr 1e-3; step-1 gradients against
   the stock dW backward (STEP_GRAD_RTOL, equal losses), then
   MOE_F32_STEPS steps with zeroed counts: 12 launches a step of kernel
   16's f32 twin.
11. main path 7, the north star (``tasks/north_star.py``, ``bench.py``
   ``bench_resnet``): ResNet-18 at CIFAR width (11.17M parameters) with
   BatchNorm, SGD 0.1 / 0.9, weights from a seeded generator. It runs no
   kernel of the port: convolutions go to cuDNN, BatchNorm is PyTorch
   ops. Launch counts are zeroed at its start and must all read 0 at its
   end. (1) One f32 3x3 conv at 512 input channels against f64 on the
   card, within TF32_CONV_REL (TF32 is off for convolutions); the same
   conv with cuDNN's TF32 allowed is printed beside it. (2) f32 at a
   batch of 16 from ``synthetic_classification``: the card's train-mode
   logits, BatchNorm statistics after the forward and step-1 gradients
   against the port's CPU run of the same weights, the CPU run replaying
   the card's ReLU masks (``relu_masks``; how many inputs round to the
   other side of 0 unreplayed is printed), within RESNET_F32_REL and
   STEP_GRAD_RTOL. (3) bf16 against f32 on the card: step-1 gradients in
   norm, per parameter and all together, and logits, within the stated
   bf16 bounds (the f32 run replaying the bf16 run's masks). (4) The
   single-card bf16 step at bench's batch of 1024 (one batch,
   ``synthetic_classification(1024, (32, 32, 3), 10, seed=0)``),
   RESNET_STEPS steps twice from one seed: whether it repeats itself
   bitwise, ms/step, imgs/s and peak memory. (5) ``DataParallel`` at
   world 1 on a one-rank NCCL group from the same weights and batch:
   losses, parameters and BatchNorm buffers bitwise equal to (4) where (4)
   repeats itself, else within DP_GAP_MULT times the gap between its two
   runs; its ms/step and imgs/s, labelled world 1. (6) ``python -m
   tpudml_torch.tasks.north_star --epochs 1`` at its defaults (synthetic
   CIFAR, 390 steps of 128): the loss falls, the test accuracy reaches
   NORTH_STAR_ACC_FLOOR, and its imgs/sec/chip line is printed. cuDNN's
   algorithm choice is left as it is (no ``cudnn.deterministic``).
12. main path 8, expert parallelism at world 1 (``tpudml_torch.parallel.
   ExpertParallel``): task5 ``--parallel ep --attn flash --fused_ln --rope
   --moe_experts 8 --moe_dispatch gather`` at the training config (V=32768,
   d=512, H=4, L=6, T=1024, B=8, f32, Adam lr 1e-3, capacity factor 2.0,
   task5's batches) on a one-rank NCCL group, EP_STEPS steps with the
   launch counts zeroed just before and read just after: exactly
   EP_STEPS × (6, 6, 6, 12, 12) of kernels 1–3, 8, 9 and none of the rest.
   ``--parallel single`` with the same flags runs twice first: the EP
   run's losses and parameters equal its first run bitwise where it
   repeats itself, else lie within DP_GAP_MULT times the gap between its
   two runs. ms/step and peak memory of both, labelled world 1. Then the
   differentiable ``all_to_all`` on the NCCL group at the dispatch buffer
   [E, C, d] = [8, 2048, 512]: forward equal to its plain version (the
   tiled chunk and concat on one rank), backward equal to the plain
   inverse of the cotangent, the inverse bringing the input back; its
   time a call.
13. main path 9, the lab tasks (``tpudml_torch.tasks.task1``,
   ``task1_mlp``, ``task2``, ``task3``) on MNIST: the native data plane
   built and loaded (``tpudml_torch.native.available()``), the synthetic
   MNIST split quantized to u8 and written as IDX files with
   ``write_idx``, read back by ``load_mnist`` (u8 storage, the /255 fused
   into the native gather) and trained on by every entry: task1 at its
   reference defaults (ReferenceAdam lr 5e-4·√200, one epoch of 300 steps
   of 200; neither JAX's task1 nor the port's learns the synthetic set at
   that lr, so its accuracy is printed, not held to a floor) and at the lr
   of JAX's own test (1e-3); task1_mlp for one epoch; task2 at world 1
   (a one-rank NCCL group) with each aggregation and once with
   ``--measure_comm``, one epoch at its defaults; task3 with each
   division at task2's lr and momentum (its reference lr 0.001 is
   MNIST-scaled and learns the synthetic set too slowly for one epoch).
   Each must reach LABS_ACC_FLOOR (LABS_COMM_FLOOR with
   ``--measure_comm``, which reports a positive comm time), JAX's own
   test floors. The world-1 DP LeNet step equals the single-card step
   bitwise where the latter repeats itself (else DP_GAP_MULT times its
   gap). imgs/s and ms/step of task1 and task2, and the device's busy
   share of their steps. No kernel of the port lies on this path.
14. main path 10, dropout: task5's single-card path at the training
   config (main path 2's model, batches and Adam): ``--dropout 0``
   through task5's ``build_engine`` equals main path 2's step bitwise
   where that repeats itself; ``--dropout 0.1`` for DROPOUT_STEPS steps
   with the launch counts zeroed just before and read just after
   (kernels 1–3, 8, 9 in main path 2's counts a step): finite losses, the
   keep share of every mask drawn within 6σ of the binomial's 0.9, and a
   second run from the same seed equal bitwise where main path 2's step
   repeats; then the same under ``DataParallel`` at world 1 (its own
   path, ``dropout_dp``). ms/step against ``--dropout 0``.
15. host infrastructure (``[host_infra]``): checkpoints, the launcher,
   the grad sentinel, the flight recorder and the profiler on task5's f32
   training path at the training config (HOST_TASK5: ``--parallel dp``,
   world 1) and on the serving model. (a) The kill/resume drill through
   ``tpudml_torch.launch`` (one rank on the card, each run a process of
   its own): an uninterrupted run of HOST_STEPS steps saving every
   HOST_CKPT_EVERY; a run killed by ``rank_kill_hook`` (``os._exit``, a
   marker) at step HOST_KILL_AT, which the launcher must report as rc 17
   and failed_rank 0; ``vandalize(..., "truncate")`` tears its step 4,
   which must fail its CRC check; ``--resume`` walks back to step 2 and
   runs to step 6. The resumed run's losses of steps 3–6 and every leaf
   of its step-6 checkpoint (parameters, Adam m, t, v, the step) must
   equal the uninterrupted run's bitwise, and both runs must launch
   kernels 1–3, 8, 9 in main path 2's counts a step (paths
   ``host_drill_ref``, ``host_drill_resumed``, read in the children).
   (b) ``DataParallel(sentinel=True)`` at world 1 on a one-rank NCCL
   group: step HOST_POISON_STEP gets NaN at ``corrupt_microbatch``'s
   seeded positions of the first block's input; its parameters and Adam
   state must equal step 2's bitwise, ``sentinel_stats`` give 1 skip and
   a ``bad_leaf`` that names a leaf, ``bad_micro`` 0, the later losses be
   finite; the update runs under CUDA's sync debug mode "error" (a host
   sync inside it raises); launches in main path 2's counts a step
   (``host_sentinel``); ms/step with the sentinel and without; then the
   training state's checkpoint save, verified restore (bitwise) and
   async save times. (c) ``DataParallel(obs=True)``: one ``train_step``
   span a step, ``step_stats.grad_norm`` within STEP_GRAD_RTOL of the f64
   norm of the aggregated gradients, the trace validating
   (``host_obs``); two steps under ``metrics.profiler.trace`` whose
   Chrome trace names ``flash_fwd_f32_kernel`` once a layer a step and
   whose device time a step fits in each step's span; ms/step with obs
   on and off and a span's host cost. (d) task6 ``--obs --fused_head`` on
   the serving model and workload (HOST_SERVE): ``trace.json`` validates,
   one residency span a request, the prefill's flash launches and one
   head launch a decode step (``host_serve``), streams bitwise equal to
   the same run without ``--obs``.
   The poisoned step's loss must be NaN, as the plain version's is
   (kernel 1 keeps a NaN score's row NaN).
16. the repairs (``[repairs]``): kernel 1, f32 and bf16, at the training
   shape with NaN query rows and NaN key rows (and at B=2, T=200 with
   k_shift=1, whose row 0 sees no key), and kernels 10 and 11 at the
   flagship head with NaN rows of x, a NaN column of W and, at V=1, a
   whole NaN row: NaN exactly where the plain version has it, the finite
   rest at the phase-3 tolerances, the no-key row's out 0 and lse −1e30;
   then kernel 1's phase-3 times beside those before the repair (PERF.md
   §6: f32 0.4066 ms and bf16 0.0996 ms at the training shape, f32
   17.235 ms at long context).
17. main path 11, model parallelism at world 1 (``[gspmd]``, a one-rank
   NCCL group): task4 ``--schedule gspmd`` at the reference's settings on
   the synthetic MNIST IDX files (accuracy ≥ LABS_ACC_FLOOR, imgs/s);
   ``GSPMDParallel(flash_attn=True)`` on TRAIN_MODEL under the stage rule
   (path ``gspmd_stage``) and under ``tensor_parallel_rules`` (path
   ``gspmd_tp``), TRAIN_STEPS steps each, held against
   ``train.make_train_step`` on the same model and batches: bitwise where
   that step repeats itself, else losses within LOSS_TOL and parameters
   within GRAD_TOL; kernels 1–3, 8, 9 in main path 2's counts a step;
   ms/step against the single-card step.
18. main path 12, ZeRO-1 at world 1 (``[zero1]``): the bf16 flagship under
   ``DataParallel(zero1=True)`` (path ``zero1``) and ``zero1_overlap=True``
   at ``accum_steps=2`` (path ``zero1_overlap``) against the same engine
   without ZeRO-1: bitwise where that repeats itself (AdamW's chain is
   elementwise), else within DP_GAP_MULT times its own gap; task2
   ``--zero1`` on the IDX files; the GSPMD (stage rule, Adam) and ZeRO-1
   (AdamW) states through ``checkpoint/sharded.py``: save, verify and
   restore bitwise into fresh engines, with bytes and seconds.
19. main path 13, FSDP and tensor parallelism with the vocab-sharded head
   at world 1 (``[fsdp_tp]``, a one-rank NCCL group): task5 through its
   entry point (``task5.run``) at main path 2's widths (FSDP_TP_TASK5),
   FSDP_TP_STEPS steps, the first a warm-up: ``--parallel fsdp
   --fused_xent`` (saved scores by the auto rule; path ``fsdp_fused``:
   kernels 1–3, 8, 9, 11, 12, 13), ``--parallel tp --fused_xent
   --fused_xent_lean`` (``tp_fused_lean``: 1–3, 8, 9, 10, 14, 15) and
   ``--parallel fsdp --sentinel`` (``fsdp_sentinel``: the reduce-scatter
   gradient rule on the unfused path, 1–3, 8, 9), each launching exactly
   its kernels' counts a step and no other kernel; each run's losses and
   final parameters against the single-card step with the same head
   (``make_lm_fused_train_step`` / ``make_train_step``; Adam in a
   ``GradSentinel`` for the sentinel's run) from the same seed and
   batches: bitwise (a one-rank merge, gather and reduce-scatter are
   exact) or, where they are not, within LOSS_TOL and GRAD_TOL; ms/step
   beside the single-card step's and the engine's wire bytes a step.
   Then the vocab shards at W = 2 and 4 in one process (one card cannot
   host a group of 2): the op's per-shard halves
   (``ops.sharded_xent_in_one_process``) at the flagship head's shape, f32
   and bf16, saved and lean, labels −1 and V among the rows: loss, dX
   (summed) and dW, db (concatenated) against the unsharded kernels and
   the plain version at XENT_ROW_TOL / XENT_GRAD_REL (BF16_REL in bf16);
   each shard's head kernel times and the composition's time beside the
   unsharded kernels' and ``F.cross_entropy``'s chain.
20. main path 14, pipeline parallelism at world 1, one stage (``[pp]``,
   the one-rank NCCL group of ``[gspmd]``): task5 through its entry point
   at main path 2's widths (PP_TASK5: V=32768, d=512, H=4, T=1024, B=8,
   ``--attn flash --fused_ln --rope``, one block a stage) with
   ``--parallel pp --microbatches 4``: ``--schedule gpipe`` (``pp_gpipe``),
   the same with ``--remat`` (``pp_gpipe_remat``), ``1f1b --dropout 0.1``
   (``pp_1f1b_dropout``) and ``interleaved --v_chunks 2``
   (``pp_interleaved``, two blocks on the one stage), four steps each;
   each launching exactly PP_PER_STEP's kernels 1–3, 8, 9 a step and no
   other kernel. Agreement with the single-card step of a
   ``TransformerLM`` holding the pipeline's initial parameters (one block,
   two in chunk order for interleaved) on the same batches: GPipe and
   1F1B at ``--microbatches 1`` bitwise where the single-card step repeats
   itself; at four micro-batches (the micro-batches' gradients sum in
   another order) the step-1 gradients (``GPipe.grads``) within
   STEP_GRAD_RTOL of each parameter's largest, every loss within
   LOSS_TOL, and the final parameters within Adam's reach, 2·lr a step
   (Adam moves an element about lr a step whatever its gradient's size,
   so a near-zero gradient's rounding shows there; the worst is printed);
   the dropout run's loss falls. Then the peak allocated
   bytes of GPipe and 1F1B at ``--microbatches 8``: 1F1B's must be lower.
   ms/step of every run beside the single-card step's.
21. main path 15, tensor-parallel serving at world 1 (``[tp_serve]``, a
   one-rank NCCL group): first kernel 1 at the prefill chunk's shape with
   the head counts a rank holds at W = 2 (h_local 4, kv_local 1
   GQA-repeated; causal and not, and the 512-token window at start 384
   through ``chunk_flash_window``) against its plain version at FLASH_TOL,
   and W = 4 refused (2 kv heads); then ``ServingEngine(mesh={"model":
   1})`` on SERVE_MODEL, SERVE_CFG and WORKLOAD, fused head off, with the
   f32 and the int8 cache (paths ``tp_serve_f32``, ``tp_serve_int8``):
   kernel 1 launches exactly ``expected_flash_calls`` a run and nothing
   else; the streams hold against the teacher-forced full forward (f32)
   and equal the dense engine's on the same requests (``compare_streams``:
   a divergence only at a near-tie, as the TP step adds the row-parallel
   bias after the sum: TIE_GAP in f32, INT8_TIE_GAP with the int8 cache),
   the event logs equal; tokens/s and the decode step's wall beside the
   dense engine's.
22. main path 16, context parallelism at world 1 (``[cp]``, a one-rank
   NCCL group): task5 ``--parallel cp`` through its entry point at main
   path 2's widths with ``--fused_ln --rope --fused_xent`` (CP_TASK5, f32,
   CP_STEPS steps): ``--attn ring`` contiguous (``cp_ring``) and striped
   (``cp_ring_striped``), each bitwise equal to the single-card ``--attn
   flash`` step (step-1 gradients, losses, final parameters) where that
   step repeats itself (at world 1 the ring is one diagonal fold, and the
   merge of one block returns it), and ``--attn ulysses``
   (``cp_ulysses``: the plain attention, no attention kernel; within
   STEP_GRAD_RTOL, LOSS_TOL and Adam's 2·lr a step); each launching
   exactly CP_PER_STEP; then the ring at LONG_TASK5's shape (T=16384, the
   lean head; ``cp_long``) beside the single card's ms/step. Then W ranks
   in one process (``parallel.cp.ring_attention_in_one_process``, each
   rank's K/V block taken by index: the real multi-block folds a one-card
   group never makes) through kernels 1–3 at CP_SIM's shapes, W = 2 and
   4, contiguous and striped, f32 and bf16 at W = 2, and W = 4 at the
   long shape: the output and dq, dk, dv against ``flash_attention`` over
   the whole sequence (FLASH_TOL; GRAD_RTOL, GRAD_ATOL; BF16_REL), the
   folds (W(W+1)/2 contiguous, W² striped, and kernel 1's launches equal
   to them), the striped folds with k_shift = 1 (W(W−1)/2); the ring's
   forward and forward+backward device times beside the whole-sequence
   kernels'.
23. main path 17, the planner at world 1 (``[plan]``): ``python -m
   tpudml_torch.plan --world 1`` in this process at the training widths
   (PLAN_SPEC, f32), the HBM budget the card's memory: the winner
   (PLAN_WINNER, path ``plan_winner``) verified by one step on a one-rank
   NCCL group, launching kernels 1–3 once a layer and nothing else; the
   ranking's top, the measured peak beside ``estimate_hbm``'s and the
   step's wall printed; a second emission byte-identical to the first;
   then the best-ranked ``fused_xent`` survivor verified (``plan_fused``:
   1–3 once a layer, 11–13 once) and its engine's step held against the
   single-card ``make_lm_fused_train_step`` (bitwise, else LOSS_TOL and
   AdamW's 2·lr, the differing parameter named); then ``--plan``: the
   plan's knobs fill task2's defaults, an explicit ``--accum_steps`` wins,
   and task2 ``--plan`` trains one epoch on the card.
24. main path 18, the elastic controller (``[elastic]``): ``run_drill`` at
   world 1 with the restart policy (one NCCL rank killed at step 13,
   re-formed on a fresh port, resumed from step 10), its final parameter
   CRC bitwise the uninterrupted run's; the MTTR figures (backoff,
   restart latency, steps lost). The ranks are child processes training
   a ForwardMLP, which runs no kernel (``elastic_drill`` counts none).
   The shrink drill needs two NCCL ranks, two cards: it runs on the CPU
   in the tests.
25. main path 19, the MPMD pipelines (``[mpmd]``): (a) two ``StageWorker``
   threads on the card over a ``channel_pair`` (a bf16 trunk with 2
   microbatches feeding an f32 head with 1, global batch 8, widths
   8-16-4), 5 steps against ``reference_step_fn`` on the card (losses and
   parameters within MPMD_TOL); (b) ``run_mpmd_drill`` with its four stage
   processes on the one card (each stage group sums over gloo; boundaries
   over TCP): stage 1 rank 1 killed at step 13, the survivors drain, the
   re-plan fails open, the groups re-form [2, 2] -> [2, 1] in place on
   fresh ports and resume from step 10, every survivor's parameter CRC
   the uninterrupted reference's; the restart latency, the backoff and the
   wall against an uninterrupted run printed; (c) one timed configuration,
   the same split at feature 1024, hidden 4096x3, classes 1024, global
   batch 256, two stage threads sharing the card: ms a step, frames and
   ``p2p_wire_bytes`` a step, the busy share. The stage programs are plain
   products, as JAX's are outside any Pallas kernel, so the path launches
   no kernel of the port (``mpmd`` counts none).
26. main path 20, the serving fleet (``[fleet]``): (a) ``FleetRouter`` with
   3 replicas of main path 1's model and engine (virtual clock 0.01 s a
   step, deadline 2 s, a line of 6), 48 requests at 120 req/s (twice the
   fleet's capacity, as ``bench.py:1394-1395`` sets it; prompts 64-512,
   16-64 new tokens), four runs, each after an uncounted warm-up on its
   own zeroed counts: ``fleet_no_kill`` (dense, unfused), ``fleet_kill``
   (replica 1 killed at step 12, re-formed 6 steps later),
   ``fleet_paged_kill`` (pages of 128, prefix sharing, the same kill) and
   ``fleet_mixed_kill`` (f32, f32 and int8 replicas with the fused head,
   priced by a loose SLO, the same kill). Every request ends in exactly
   one terminal state and a finished one holds its budget; the drains are
   the victim's tenants at the kill; a second ``fleet_kill`` run's event
   log is byte-identical; the finished streams equal ``fleet_no_kill``'s
   (or, on the int8 replica, a single int8 engine's at INT8_TIE_GAP) and
   every token its replica's full forward's, apart from near-ties; the
   mixed run's first 8 admits go to the int8 replica. Kernel 1 launches
   exactly what the admitted prompts (continuations too) need, from the
   event log; kernel 4 once a decode step of each fused f32 replica with
   tenants, 5 once a decode step of the int8 replica; nothing else. The
   virtual-clock tokens/s, TTFT and TPOT are printed as such, beside the
   wall. (b) the KV handoff at pages of 128 with prefix sharing, f32 and
   int8 caches (``fleet_handoff``, ``fleet_handoff_int8``): a 385-token
   prompt's prefill (36 launches of kernel 1) handed off as 3 pages; the
   adopting engine's prefill launches kernel 1 no time against a local
   prefill's 36, its stream bitwise the local one's; a truncated handoff
   adopts no page and gives the same stream. (c) ``run_fleet_drill`` at
   world 2 with its two replica processes on the one card, rank 1
   SIGKILLed: ok, the token CRCs the in-process reference's, at least one
   re-form; restart latency, recovery and wall printed (``fleet_drill``
   counts this process's reference, kernel 1 only).
27. main path 21, the analyzers on the card (``[analysis]``): (a) ``python
   -m tpudml_torch.analysis --strict`` in a child process on the card:
   exit 0, ``0 finding(s)``, no stale allowlist entry; then every one of
   the 16 entrypoints captured here on the card and on the CPU, each rule
   set the same on both. (b) One captured step of the bf16 flagship at
   full width (TRAIN_MODEL, flash, fused add+LN, the fused head saving its
   scores, AdamW): the capture names each launch, FLAGSHIP_PER_STEP's and
   no other, equal to the launch counters' deltas, the backward's among
   them (run on autograd's device thread); its rules are the CPU
   ``lm_bf16`` entrypoint's; J111 fires, and is silent on the same step
   with the grad sentinel. (c) The dense decode step at SERVE_MODEL width
   and SERVE_CFG's 8 slots, unfused and fused: kernel 4 once in the fused
   step's trace, J119 on the unfused step only, J110 on neither. (d) One
   step of the bf16 ragged MoE (MOE_MODEL, E = 4): kernel 16's bf16 twin
   twice a layer in the trace. Each capture prints its wall beside the
   same step uncaptured (the capture's overhead). (e) What the markers cost
   the uncaptured steps: a marked call's and a launch report's host time
   with no capture running (timeit, best of ANALYSIS_MARKER_REPEATS), times
   the regions and launches each step of (b) and (c) makes: under 1% of
   the step.
28. one JSON line of per-kernel numbers (launches summed over the main
   paths, and by path), the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

TIE_GAP = 1e-5  # plain top-2 logit gap under which a pick may differ
# Two runs on the int8 KV cache: a cached K/V element rounds to one of 255
# codes of its row's largest value, so two computations of one value that
# differ in the last f32 bit (the TP step adds the row-parallel bias after
# the sum, the dense step before it) can take neighbouring codes and move a
# logit by far more than TIE_GAP (1.8e-3 seen on the card). Each int8 run's
# logits lie within 0.25 of the f32 ones (tests/test_serve.py's int8 cache
# contract), so two of them can part only where the plain top-2 gap is
# under twice that.
INT8_TIE_GAP = 0.5
# The bf16-compute serving model's tie gap: four bf16 steps (2^-6 each) at
# its largest logits (|logit| in [2, 4) for the random serving model). The
# decode path rounds activations to bf16 in other places than the full
# forward (cached K/V, the window attention, the fused tail's f32 head) through
# six blocks, which moves a logit by a few such steps.
BF16_TIE_GAP = 4 * 2.0 ** -6
FLASH_TOL = 1e-5  # max |err| of O and of lse, kernel vs plain (f32 sums in another order)
HEAD_TOL = 1e-4  # max |err| of max logit and lse (512-term f32 dots in another order; lse ~ 10)
# Flash dQ/dK/dV, elementwise |err| <= atol + rtol·|plain|: the JAX
# package's own tolerance for these kernels (f32 sums over up to T keys
# or rows, in another order than the plain version's matmuls).
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5
LN_ROW_TOL = 1e-5  # max |err| of s, y, mean, rstd, dx (d-term row sums in another order; rsqrtf <= 2 ulp)
LN_COL_RTOL = 1e-5  # max |err| of dγ, dβ over max |plain| (N-row sums, block order vs one reduction)
# Training: step-1 gradients, per parameter, max |err| <= STEP_GRAD_RTOL ·
# max |plain grad| (f32 sums over 8192 tokens and 1024 keys in another
# order, ten times the CPU parity tests' 1e-5); per-step losses within
# LOSS_TOL (Adam's first step moves every parameter by ±lr, so a gradient
# whose sign differs under f32 rounding puts that parameter 2·lr apart;
# 1e-3 on a loss of ~10 holds a few such flips).
STEP_GRAD_RTOL = 1e-4
LOSS_TOL = 1e-3
# bf16 twins of the flash and add+LN kernels: what they store in bf16
# (O, dQ, dK, dV; y, dx) within BF16_REL of the plain output's max |value|
# (both round to bf16, 2^-8 relative, after f32 sums in another order that
# may put a value, or a rounded p or ds feeding it, one bf16 step away);
# what stays f32 (lse, s, mean, rstd, dγ, dβ) at the f32 tolerances.
BF16_REL = 2e-2
# Fused linear-xent (#10–13): lse, picked and the saved scores |err| <=
# XENT_ROW_TOL·(1 + |plain|) (d-term f32 dots, then V-term sums, in another
# order); dX, dW, db within XENT_GRAD_REL of the plain output's max |value|
# in f32 (N- or V-term sums) and BF16_REL in bf16 (dlog and the stored
# gradient rounded to bf16 on both sides); db is f32 in both.
XENT_ROW_TOL = 1e-5
XENT_GRAD_REL = 1e-4
# The bf16 flagship (phase 6). Step-1 gradients: each bf16 run within
# BF16_STEP_GRAD_RTOL of the f32 gradient's max |value| per parameter (bf16
# keeps 8 bits; a few hundred roundings per layer compound through 6
# blocks and the backward; on the CPU at the smoke config the port's bf16
# gradients lie within 2.1e-2 of the f32 ones), and the kernel run within
# BF16_PAIR_GRAD_RTOL of the plain bf16 run (two such errors). Losses of
# the two bf16 runs within BF16_LOSS_TOL: the materialized head rounds the
# logits to bf16 (2^-8 of |logit|) where the fused head keeps f32 scores,
# and AdamW's first step moves every parameter by ±lr.
BF16_STEP_GRAD_RTOL = 3e-2
BF16_PAIR_GRAD_RTOL = 5e-2
BF16_LOSS_TOL = 2e-2
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores, H100 SXM data sheet

SERVE_MODEL = dict(vocab_size=32768, embed_dim=512, num_heads=8,
                   num_kv_heads=2, num_layers=6, max_len=1024, rope=True)
SERVE_CFG = dict(slots=8, max_len=1024, prefill_chunk=128)
WORKLOAD = dict(n_requests=16, prompt_len=(64, 512), new_tokens=(16, 64))
# The repo's chip training config (bench.py:325-326), task5 flags
# --vocab 32768 --embed_dim 512 --num_heads 4 --num_layers 6 --seq_len 1024
# --batch_size 8 --attn flash --fused_ln --rope.
TRAIN_MODEL = dict(vocab_size=32768, embed_dim=512, num_heads=4, num_layers=6,
                   max_len=1024, rope=True)
TRAIN_BATCH = 8
TRAIN_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
TRAIN_LR = 1e-3
# Launches of one training step at L=6: flash fwd, dQ, dK/dV one per layer;
# add+LN 2L junctions per direction (the first block's ln1 stays plain).
PER_STEP = {"flash_forward_lse": 6, "flash_dq": 6, "flash_dkdv": 6,
            "add_layernorm_fwd": 12, "add_layernorm_bwd": 12}
# The wide trunk (phase 5b, train_wide): task5's --embed_dim 2048
# --num_heads 16 --num_layers 2 --seq_len 1024 --batch_size 8 --attn flash
# --fused_ln --rope (head dim 128, materialized logits), the width of a
# GPT-3 1.3B trunk at the depth the time limit allows; its add+LN rows
# take the wide instances of kernels 8 and 9.
WIDE_MODEL = dict(vocab_size=32768, embed_dim=2048, num_heads=16, num_layers=2,
                  max_len=1024, rope=True)
WIDE_PER_STEP = {"flash_forward_lse": 2, "flash_dq": 2, "flash_dkdv": 2,
                 "add_layernorm_fwd": 4, "add_layernorm_bwd": 4}
# The flagship (bench.py:320-358): the training config in bf16 compute with
# f32 master weights, AdamW lr 3e-4, the fused head in saved-scores mode,
# bench's one batch synthetic_lm(8, 1024, 32768, seed=1) every step.
FLAGSHIP_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
FLAGSHIP_LR = 3e-4
FLAGSHIP_PER_STEP = {"xent_fwd_save": 1, "xent_dx_s": 1, "xent_dw_s": 1,
                     "flash_forward_lse_bf16": 6, "flash_dq_bf16": 6,
                     "flash_dkdv_bf16": 6, "add_layernorm_fwd_bf16": 12,
                     "add_layernorm_bwd_bf16": 12}
XENT_SHAPE = (8192, 512, 32768)  # N = B·T, d, V of the flagship head
# Long-context training (BASELINE.md:45), task5 flags; --fused_xent in its
# auto mode, which resolves to the lean head at N = B·T = 32768, V = 32768.
LONG_TASK5 = ["--parallel", "single", "--attn", "flash", "--seq_len", "16384",
              "--batch_size", "2", "--vocab", "32768", "--embed_dim", "512",
              "--num_heads", "4", "--num_layers", "6", "--rope", "--steps", "30",
              "--lr", "0.001", "--fused_xent"]
LONG_STEPS = 3  # the first is the warm-up; ms/step is taken over the rest
LONG_PER_STEP = {"flash_forward_lse": 6, "flash_dq": 6, "flash_dkdv": 6,
                 "xent_fwd": 1, "xent_dx_lean": 1, "xent_dw_lean": 1}
LEAN_MEM_GAP = 3 * 1024**3  # the saved run keeps 4 GiB of f32 scores more
LEAN_PATH_N = 32768  # the long-context head: B·T = 2·16384
LEAN_BIG_N = 131072  # BASELINE.md:46's batch, B=32·T=4096 (4096 row tiles of dX)
LEAN_CHUNK = 16384  # rows per call of the plain version at LEAN_BIG_N
# N·d > 2³¹ at the widest d the kernels take: the offsets of x and dX need
# 64 bits (the lean kernels never index N·V), dX has 65537 row tiles (more
# than a grid's y extent holds) and two d chunks; a narrow vocabulary keeps
# the run short.
LEAN_WIDE = (2_097_184, 1024, 256)
LEAN_WIDE_CHUNK = 262144
LONG_FLASH_SHAPE = (2, 16384, 4, 128)  # B, T, H, D of the long-context path
LN_SHAPE = (8192, 512)  # the plain LayerNorm op at the training rows
# Past the old grid-y edges: 65,537 row tiles of 128 (kernels 10–12 held
# 8,388,480 rows) and B·H = 65,537 (the flash kernels held 65,535).
XENT_EDGE = (8_388_609, 8, 128)
# Widths past the narrow instances (phase 3). LayerNorm rows past the 1024
# columns a warp holds in registers: the timed sweep LN_SWEEP at N·d =
# LN_SWEEP_ELEMS (each width checked there too), then LN_CHECKS (N, d, the
# rows' base offset in elements): N = 1, N below the backward's block
# count, ragged bf16 widths (1025, 1100, 4100), a base 4 or 2 bytes off 16,
# and widths that take the looped instances (12000 staged, 20000 shared,
# 40000 device for the backward). xent d no multiple of 8 and past the
# lean kernels' 512-column chunk (clusters of blocks), timed at
# XENT_WIDE_TIMED (N, d, V); the decode head past one 8-row group's stage.
LN_SWEEP = (1536, 2048, 4096, 8192, 16384)
LN_SWEEP_ELEMS = 1 << 25
LN_CHECKS = ((1, 4096, 0), (100, 2048, 0), (300, 1025, 0), (300, 1100, 0), (300, 4100, 0),
             (300, 8192, 0), (300, 4096, 1), (40, 12000, 0), (20, 20000, 0), (10, 40000, 0))
XENT_WIDE = (12, 1032, 2048)
# The forward's tile and slice edges (N, d, V), phase 3: one row and one
# column; a ragged bf16 x row (d = 520) past one 128-row tile and one
# 128-column f32 step; 64 row tiles and a row, d past two 512-wide chunks,
# V short of a step; one column past 32768 at d = 4096.
XENT_FWD_EDGES = ((1, 1, 1), (65, 520, 129), (8193, 1032, 127), (256, 4096, 32769))
XENT_WIDE_TIMED = (4096, 2048, 8192)
HEAD_WIDE = (8, 8192, 32768)
FLASH_D256_SHAPE = (8, 1024, 4, 256)  # B, T, H, D: the training shape at the widest D
XENT_EDGE_CHUNK = 1 << 21
FLASH_EDGE = (65_537, 16, 1, 32)  # B, T, H, D
# MoE (bench.py:586-661, bench_moe): the training config in bf16 with
# top-1 MoE FFNs at capacity factor 1.25, AdamW 3e-4, bench's one batch.
MOE_MODEL = dict(TRAIN_MODEL, impl="flash", fused_ln=True, moe_capacity_factor=1.25,
                 moe_top_k=1)
MOE_EXPERTS = (4, 8)
MOE_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
MOE_LR = 3e-4
# Launches of one bench_moe step at L=6 whatever the variant (bf16 flash,
# add+LN); ragged_grouped adds kernel 16's bf16 twin twice a layer.
MOE_PER_STEP = {"flash_forward_lse_bf16": 6, "flash_dq_bf16": 6, "flash_dkdv_bf16": 6,
                "add_layernorm_fwd_bf16": 12, "add_layernorm_bwd_bf16": 12}
# The f32 MoE path: task5 at the training config, dropless ragged dispatch.
MOE_F32_TASK5 = ["--parallel", "single", "--attn", "flash", "--fused_ln", "--rope",
                 "--moe_experts", "8", "--moe_dispatch", "ragged", "--vocab", "32768",
                 "--embed_dim", "512", "--num_heads", "4", "--num_layers", "6",
                 "--seq_len", "1024", "--batch_size", "8", "--lr", "0.001"]
MOE_F32_STEPS = 3
MOE_F32_PER_STEP = {"flash_forward_lse": 6, "flash_dq": 6, "flash_dkdv": 6,
                    "add_layernorm_fwd": 12, "add_layernorm_bwd": 12, "grouped_dw": 12}
# Kernel 16 in phase 3: the MoE step's rows and both FFN products.
GDW_M = 8192
GDW_SHAPES = ((512, 2048), (2048, 512))  # (k, n) of dW1 and dW2
GDW_TOL = 1e-5  # of max |plain|: both sum the same products in f32, in another order
GDW_LONG = (65536, 512, 2048)  # M, k, n of phase 3's long slab (past the bf16 chunk cap)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# A torch.profiler session on the H100 now and then records no device
# activity, although the calls it profiles launch kernels every time
# (F.layer_norm's bf16 backward, once in four runs of this script): such a
# session is taken again, up to PROFILE_TRIES times.
PROFILE_TRIES = 3


def device_profile(fn, calls: int = 200) -> tuple[float, float]:
    """(ms, kernels) a call: the summed device durations of what ``calls``
    back-to-back calls of ``fn`` launch, and how many device operations
    they launch, over ``calls``, from ``torch.profiler``: a kernel under
    ~0.13 ms is paced by the host through its Python wrapper, so its
    CUDA-event time moves with the host and this is its own time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(ev.time_range.elapsed_us() for ev in events)
        if us > 0:
            return us / 1e3 / calls, len(events) / calls
    check(False, f"the profiler recorded no device time in {PROFILE_TRIES} tries")


def device_ms(fn, calls: int = 200) -> float:
    """The device ms a call of ``device_profile``."""
    return device_profile(fn, calls)[0]


def one_a_call(per_call: float) -> bool:
    """Whether ``device_profile``'s operations a call show one kernel a call:
    never more than one (a second kernel or a memset a call would make it
    two), and the profiler now and then drops an event of a session (199 of
    200 and 48 of 50 seen on the H100), so a count under one passes."""
    return 0.5 < per_call <= 1.0


COLD_FLUSH_BYTES = 256 << 20  # written between calls: five times the 50 MB L2


def cold_ms(fn, calls: int = 50) -> float:
    """Mean device time of one call of ``fn`` that finds the L2 cold: a
    COLD_FLUSH_BYTES write before each call, CUDA events around the call
    alone (the write keeps the card busy while the host enqueues it)."""
    import torch

    flush = torch.empty(COLD_FLUSH_BYTES // 4, device="cuda")
    fn()
    pairs = []
    for _ in range(calls):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / calls


def timed(fn, ref, nbytes: float, flops: float, peak: float = H100_F32_FLOPS, lib=None,
          iters: int = 10) -> dict:
    """Kernel, plain and (where given) library ms of one call, and the bound."""
    ms = cuda_ms(fn, iters=iters, warmup=2)
    plain_ms = cuda_ms(ref, iters=max(iters // 2, 2), warmup=1)
    lib_ms = None if lib is None else cuda_ms(lib, iters=iters, warmup=2)
    bnd, by = bound(nbytes, flops, peak)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)


def bound(nbytes: float, flops: float, peak: float = H100_F32_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak`` (f32 by default; the
    bf16 tensor-core rate for bf16 work)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tflops(flops: float, ms: float) -> float:
    """The rate of ``flops`` operations done in ``ms`` milliseconds."""
    return flops / ms / 1e9


def rel_to_max(got, want) -> float:
    """max |got − want| / max |want|, in f32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


# ------------------------------------------------------------ phase 3


def flash_phase(gen) -> dict:
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import FLASH_FORWARD, flash_forward_lse, flash_forward_lse_reference

    b, h, d = 1, 8, 64
    worst = 0.0
    timed = None
    for t, causal, k_shift in ((128, True, 0), (128, False, 0), (77, True, 0),
                               (128, True, 1)):
        q, k, v = (torch.randn((b, t, h, d), generator=gen).cuda() for _ in range(3))
        o, lse = flash_forward_lse(q, k, v, causal=causal, k_shift=k_shift)
        ro, rlse = flash_forward_lse_reference(q, k, v, causal=causal, k_shift=k_shift)
        torch.cuda.synchronize()
        eo = (o - ro).abs().max().item()
        el = (lse - rlse).abs().max().item()
        print(f"[kernel] flash_forward_lse T={t} causal={causal} k_shift={k_shift}: "
              f"max|dO|={eo:.3e} max|dlse|={el:.3e} (tol {FLASH_TOL:g} each)")
        check(eo <= FLASH_TOL and el <= FLASH_TOL,
              f"flash kernel disagrees with its plain version (T={t}, "
              f"causal={causal}, k_shift={k_shift})")
        worst = max(worst, eo, el)
        if timed is None:  # the main path's diagonal block: T = chunk = 128, causal
            timed = (q, k, v, t)
    q, k, v, t = timed
    ms = cuda_ms(lambda: flash_forward_lse(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: flash_forward_lse_reference(q, k, v, causal=True))
    dev = device_ms(lambda: flash_forward_lse(q, k, v, causal=True))
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    lib_ms, lib_dev = cuda_ms(sdpa), device_ms(sdpa)
    pairs = t * (t + 1) // 2
    bnd, by = bound(4 * (4 * b * t * h * d + b * h * t), 4 * d * pairs * b * h)
    print(f"[kernel] flash_forward_lse B={b} T={t} H={h} D={d} causal: "
          f"kernel {ms:.4f} ms (device {dev:.5f}), plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms (device {lib_dev:.5f}), bound {bnd:.5f} ms ({by})")
    row = dict(name=FLASH_FORWARD.name, route="cuda", source=FLASH_FORWARD.source,
               replaces=FLASH_FORWARD.replaces, max_abs_err=worst, ms=ms, device_ms=dev,
               plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
               library_device_ms=lib_dev, shape=f"B={b} T={t} H={h} D={d} causal (serving)")
    row["at_train_shape"] = flash_train_shape(gen)
    return row


def flash_train_shape(gen) -> dict:
    """The flash forward at the training slice's shape (B=8, T=1024, H=4,
    D=128, causal): agreement with the plain version and times."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import flash_forward_lse, flash_forward_lse_reference

    b, t, h, d = 8, 1024, 4, 128
    q, k, v = (torch.randn((b, t, h, d), generator=gen).cuda() for _ in range(3))
    o, lse = flash_forward_lse(q, k, v, causal=True)
    ro, rlse = flash_forward_lse_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
    check(err <= FLASH_TOL, f"flash kernel disagrees with its plain version at "
          f"the training shape (max |err| {err:.3e})")
    ms = cuda_ms(lambda: flash_forward_lse(q, k, v, causal=True), iters=20)
    plain_ms = cuda_ms(lambda: flash_forward_lse_reference(q, k, v, causal=True), iters=20)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
                     iters=20)
    pairs = b * h * t * (t + 1) // 2
    bnd, by = bound(4 * (4 * b * t * h * d + b * h * t), 4 * d * pairs)
    rate = tflops(4 * d * pairs, ms)
    print(f"[kernel] flash_forward_lse B={b} T={t} H={h} D={d} causal: max|err| "
          f"{err:.3e} (tol {FLASH_TOL:g}); kernel {ms:.4f} ms ({rate:.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
    return dict(shape=f"B={b} T={t} H={h} D={d} causal (training)", max_abs_err=err,
                ms=ms, tflops=rate, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib_ms)


def _bh(x, i: int, j: int):
    """The (batch i, head j) slice of a [B, T, H, D] tensor or of a
    [B, H, T] statistic."""
    return x[i:i + 1, :, j:j + 1] if x.dim() == 4 else x[i:i + 1, j:j + 1]


def flash_long_phase(gen, fwd_row: dict, dq_row: dict, dkdv_row: dict) -> None:
    """Kernels 1–3 at the long-context path's shape (B=2, T=16384, H=4,
    D=128, causal), where they take most of its step: each kernel on the
    full shape against its plain version on every (batch, head) slice (its
    [T, T] f32 scores are 1 GiB a slice), then timed beside the plain
    version over all slices, the bound and SDPA. Adds ``at_long_context``
    to the three rows and folds the errors into their ``max_abs_err``."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        flash_dkdv, flash_dkdv_reference, flash_dq, flash_dq_reference, flash_forward_lse,
        flash_forward_lse_reference,
    )

    b, t, h, d = LONG_FLASH_SHAPE
    slices = [(i, j) for i in range(b) for j in range(h)]
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda() for _ in range(4))
    o, lse = flash_forward_lse(q, k, v, causal=True)
    ro, rlse = torch.empty_like(o), torch.empty_like(lse)
    for i, j in slices:
        so, slse = flash_forward_lse_reference(*(_bh(x, i, j) for x in (q, k, v)),
                                               causal=True)
        _bh(ro, i, j).copy_(so)
        _bh(rlse, i, j).copy_(slse)
    torch.cuda.synchronize()
    e_fwd = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
    print(f"[kernel] flash_forward_lse B={b} T={t} H={h} D={d} causal (plain per (batch, "
          f"head) slice): max|err| of O, lse {e_fwd:.3e} (tol {FLASH_TOL:g})")
    check(e_fwd <= FLASH_TOL, "flash kernel disagrees with its plain version at the "
          "long-context shape")
    del o, lse
    delta = (do * ro).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta)
    dq = flash_dq(*args, causal=True)
    check(torch.equal(dq, flash_dq(*args, causal=True)),
          "flash dQ is not bitwise repeatable at the long-context shape")
    dk, dv = flash_dkdv(*args, causal=True)
    e_dq = e_dkdv = 0.0
    for i, j in slices:
        part = [_bh(x, i, j) for x in args]
        e_dq = max(e_dq, _grad_err(_bh(dq, i, j), flash_dq_reference(*part, causal=True)))
        rdk, rdv = flash_dkdv_reference(*part, causal=True)
        e_dkdv = max(e_dkdv, _grad_err(_bh(dk, i, j), rdk), _grad_err(_bh(dv, i, j), rdv))
        del rdk, rdv
    print(f"[kernel] flash_dq / flash_dkdv B={b} T={t} H={h} D={d} causal (plain per "
          f"(batch, head) slice): max|ddq| {e_dq:.3e}, max|ddk|,|ddv| {e_dkdv:.3e} "
          f"(|err| <= {GRAD_ATOL:g} + {GRAD_RTOL:g}·|plain|); dq repeat bitwise equal")
    del dq, dk, dv
    torch.cuda.empty_cache()

    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    sdpa_f = cuda_ms(sdpa, iters=3, warmup=1)
    sdpa_b = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), iters=3,
                     warmup=1) - sdpa_f
    del qh, kh, vh, doh
    pairs = b * h * t * (t + 1) // 2
    io = b * t * h * d
    for row, fn, ref, ins, err, nbytes, flops, lib, lib_name in (
        (fwd_row, flash_forward_lse, flash_forward_lse_reference, (q, k, v), e_fwd,
         4 * (4 * io + b * h * t), 4 * d * pairs, sdpa_f, "sdpa"),
        (dq_row, flash_dq, flash_dq_reference, args, e_dq, 4 * (5 * io + 2 * b * h * t),
         6 * d * pairs, sdpa_b, "sdpa fwd+bwd minus fwd (dq, dk, dv)"),
        (dkdv_row, flash_dkdv, flash_dkdv_reference, args, e_dkdv,
         4 * (6 * io + 2 * b * h * t), 8 * d * pairs, sdpa_b,
         "sdpa fwd+bwd minus fwd (dq, dk, dv)"),
    ):
        ms = cuda_ms(lambda: fn(*ins, causal=True), iters=3, warmup=1)
        plain_ms = cuda_ms(lambda: [ref(*(_bh(x, i, j) for x in ins), causal=True)
                                    for i, j in slices], iters=2, warmup=1)
        torch.cuda.empty_cache()
        bnd, by = bound(nbytes, flops)
        rate = tflops(flops, ms)
        print(f"[kernel] {row['name']} B={b} T={t} H={h} D={d} causal: kernel {ms:.3f} ms "
              f"({rate:.1f} TFLOP/s), plain (per slice, {len(slices)} calls) {plain_ms:.3f} "
              f"ms, {lib_name} {lib:.3f} ms, bound {bnd:.5f} ms ({by})")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["at_long_context"] = dict(
            shape=f"B={b} T={t} H={h} D={d} causal (long-context training)",
            max_abs_err=err, ms=ms, tflops=rate, plain_ms=plain_ms,
            plain=f"per (batch, head) slice, {len(slices)} calls", bound_ms=bnd,
            bound_by=by, library_ms=lib, library=lib_name)
    torch.cuda.empty_cache()


def _grad_err(got, want) -> float:
    """max |got − want|, after checking |err| <= GRAD_ATOL + GRAD_RTOL·|want|
    elementwise."""
    diff = (got - want).abs()
    ok = bool((diff <= GRAD_ATOL + GRAD_RTOL * want.abs()).all())
    err = diff.max().item()
    check(ok, f"flash backward disagrees with its plain version (max |err| {err:.3e})")
    return err


def flash_bwd_phase(gen) -> list[dict]:
    """dQ (#2) and dK/dV (#3) against their plain versions: the training
    shape (B=8, T=1024, H=4, D=128, causal), a small non-causal case, odd
    T and k_shift=1, through ``flash_block_grads``; then each kernel timed
    at the training shape beside its plain version, its bound and SDPA's
    backward (forward+backward minus forward)."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        FLASH_DKDV, FLASH_DQ, flash_block_grads, flash_block_grads_reference,
        flash_dkdv, flash_dkdv_reference, flash_dq, flash_dq_reference,
        flash_forward_lse_reference,
    )

    err_dq = err_dkdv = 0.0
    main = None
    for b, t, h, d, causal, k_shift in ((8, 1024, 4, 128, True, 0),
                                        (2, 256, 4, 128, False, 0),
                                        (2, 1000, 4, 128, True, 0),
                                        (2, 256, 4, 128, True, 1)):
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda() for _ in range(4))
        # Statistics of a k_shift=0 forward: every row has a finite lse.
        o, lse = flash_forward_lse_reference(q, k, v, causal=causal)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        got = flash_block_grads(*args, causal=causal, k_shift=k_shift)
        want = flash_block_grads_reference(*args, causal=causal, k_shift=k_shift)
        torch.cuda.synchronize()
        e = [_grad_err(g, w) for g, w in zip(got, want)]
        print(f"[kernel] flash_block_grads B={b} T={t} H={h} D={d} causal={causal} "
              f"k_shift={k_shift}: max|ddq|={e[0]:.3e} max|ddk|={e[1]:.3e} "
              f"max|ddv|={e[2]:.3e} (|err| <= {GRAD_ATOL:g} + {GRAD_RTOL:g}·|plain|)")
        err_dq, err_dkdv = max(err_dq, e[0]), max(err_dkdv, e[1], e[2])
        if main is None:
            main = (args, b, t, h, d)
    del got, want
    args, b, t, h, d = main
    dq = flash_dq(*args, causal=True)
    e = _grad_err(dq, flash_dq_reference(*args, causal=True))
    same = torch.equal(dq, flash_dq(*args, causal=True))
    print(f"[kernel] flash_dq B={b} T={t} H={h} D={d} causal: max|err| {e:.3e} (|err| <= "
          f"{GRAD_ATOL:g} + {GRAD_RTOL:g}·|plain|); repeat call bitwise equal: {same}")
    check(same, "flash dQ is not bitwise repeatable")
    del dq
    q, k, v, do = args[:4]
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    lib_ms = (cuda_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), iters=20)
              - cuda_ms(sdpa, iters=20))
    pairs = b * h * t * (t + 1) // 2
    io = b * t * h * d
    rows = []
    for kernel, fn, ref, err, nbytes, flops in (
        (FLASH_DQ, flash_dq, flash_dq_reference, err_dq,
         4 * (5 * io + 2 * b * h * t), 6 * d * pairs),
        (FLASH_DKDV, flash_dkdv, flash_dkdv_reference, err_dkdv,
         4 * (6 * io + 2 * b * h * t), 8 * d * pairs),
    ):
        ms = cuda_ms(lambda: fn(*args, causal=True), iters=20)
        plain_ms = cuda_ms(lambda: ref(*args, causal=True), iters=10)
        bnd, by = bound(nbytes, flops)
        rate = tflops(flops, ms)
        print(f"[kernel] {kernel.name} B={b} T={t} H={h} D={d} causal: kernel {ms:.4f} ms "
              f"({rate:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa backward (dq+dk+dv) "
              f"{lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms, tflops=rate,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                         library_ms=lib_ms, library="sdpa fwd+bwd minus fwd (dq, dk, dv)",
                         shape=f"B={b} T={t} H={h} D={d} causal (training)"))
    return rows


def add_ln_phase(gen) -> list[dict]:
    """add+LN forward (#8) and backward (#9) against their plain versions
    at the training shape (N = B·T = 8192, d = 512) and at N = 1000 (not a
    multiple of a block), the backward with and without ds; then timed
    beside the bound and ``F.layer_norm(x + r)`` (its backward: forward+
    backward minus forward)."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        ADD_LN_BACKWARD, ADD_LN_FORWARD, add_layernorm_backward,
        add_layernorm_backward_reference, add_layernorm_forward,
        add_layernorm_forward_reference,
    )

    err_f = err_b = 0.0
    main = None
    for n, d in ((8192, 512), (1000, 512)):
        x, r, dy, ds = (torch.randn((n, d), generator=gen).cuda() for _ in range(4))
        scale = (1 + 0.1 * torch.randn((d,), generator=gen)).cuda()
        bias = (0.1 * torch.randn((d,), generator=gen)).cuda()
        got = add_layernorm_forward(x, r, scale, bias)
        want = add_layernorm_forward_reference(x, r, scale, bias)
        ef = max((a - w).abs().max().item() for a, w in zip(got, want))
        check(ef <= LN_ROW_TOL, f"add+LN forward disagrees with its plain version "
              f"(N={n}, max |err| {ef:.3e})")
        s, _, mean, rstd = want
        for dsv in (ds, None):
            gdx, gdg, gdb = add_layernorm_backward(s, scale, dy, dsv, mean, rstd)
            wdx, wdg, wdb = add_layernorm_backward_reference(s, scale, dy, dsv, mean, rstd)
            edx = (gdx - wdx).abs().max().item()
            ecol = max(((a - w).abs().max() / w.abs().max()).item()
                       for a, w in ((gdg, wdg), (gdb, wdb)))
            print(f"[kernel] add_layernorm N={n} d={d} ds={'None' if dsv is None else 'given'}: "
                  f"fwd max|err| {ef:.3e}, dx max|err| {edx:.3e} (tol {LN_ROW_TOL:g} each), "
                  f"dgamma/dbeta max|err|/max|plain| {ecol:.3e} (tol {LN_COL_RTOL:g})")
            check(edx <= LN_ROW_TOL and ecol <= LN_COL_RTOL,
                  f"add+LN backward disagrees with its plain version (N={n})")
            err_b = max(err_b, edx, (gdg - wdg).abs().max().item(),
                        (gdb - wdb).abs().max().item())
        err_f = max(err_f, ef)
        if main is None:
            main = (x, r, scale, bias, dy, ds, s, mean, rstd, n, d)
    x, r, scale, bias, dy, ds, s, mean, rstd, n, d = main
    leaves = [t.clone().requires_grad_() for t in (x, r, scale, bias)]

    def lib_fwd():
        s_ = leaves[0] + leaves[1]
        return s_, F.layer_norm(s_, (d,), leaves[2], leaves[3], 1e-5)

    lib_f = cuda_ms(lib_fwd)
    lib_b = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, (ds, dy))) - lib_f
    dev_f = device_ms(lib_fwd)
    dev_b = device_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, (ds, dy))) - dev_f
    rows = []
    for kernel, fn, ref, err, nbytes, flops, lib, lib_dev in (
        (ADD_LN_FORWARD, lambda: add_layernorm_forward(x, r, scale, bias),
         lambda: add_layernorm_forward_reference(x, r, scale, bias), err_f,
         4 * (4 * n * d + 2 * d + 2 * n), 8 * n * d, lib_f, dev_f),
        (ADD_LN_BACKWARD, lambda: add_layernorm_backward(s, scale, dy, ds, mean, rstd),
         lambda: add_layernorm_backward_reference(s, scale, dy, ds, mean, rstd), err_b,
         4 * (4 * n * d + 3 * d + 2 * n), 12 * n * d, lib_b, dev_b),
    ):
        ms = cuda_ms(fn)
        dev = device_ms(fn)
        plain_ms = cuda_ms(ref)
        bnd, by = bound(nbytes, flops)
        print(f"[kernel] {kernel.name} N={n} d={d}: kernel {ms:.4f} ms (device {dev:.4f}), "
              f"plain {plain_ms:.4f} ms, F.layer_norm(x + r) {lib:.4f} ms (device "
              f"{lib_dev:.4f}), bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms, device_ms=dev,
                         library_device_ms=lib_dev,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                         library="F.layer_norm(x + r)" + (" fwd+bwd minus fwd"
                                                          if kernel is ADD_LN_BACKWARD else ""),
                         shape=f"N={n} d={d} f32 (training)"))
    return rows


def flash_bf16_phase(gen) -> list[dict]:
    """The bf16 twins of the flash forward (#1), dQ (#2) and dK/dV (#3) at
    the training shape (B=8, T=1024, H=4, D=128, causal), also T=1000
    non-causal: agreement with the plain versions and times beside the
    bf16 bound and SDPA in bf16."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        FLASH_DKDV_BF16, FLASH_DQ_BF16, FLASH_FORWARD_BF16, flash_block_grads,
        flash_block_grads_reference, flash_dkdv, flash_dkdv_reference, flash_dq,
        flash_dq_reference, flash_forward_lse, flash_forward_lse_reference,
    )

    errs = {"fwd": 0.0, "dq": 0.0, "dkdv": 0.0}
    main = None
    for b, t, h, d, causal in ((8, 1024, 4, 128, True), (2, 1000, 4, 128, False)):
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda().bfloat16()
                       for _ in range(4))
        o, lse = flash_forward_lse(q, k, v, causal=causal)
        ro, rlse = flash_forward_lse_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        eo, el = rel_to_max(o, ro), (lse - rlse).abs().max().item()
        check(o.dtype == torch.bfloat16 and eo <= BF16_REL and el <= FLASH_TOL,
              f"bf16 flash forward disagrees with its plain version (T={t})")
        delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, rlse, delta)
        got = flash_block_grads(*args, causal=causal)
        want = flash_block_grads_reference(*args, causal=causal)
        torch.cuda.synchronize()
        e = [rel_to_max(g, w) for g, w in zip(got, want)]
        print(f"[kernel] bf16 flash B={b} T={t} H={h} D={d} causal={causal}: O "
              f"max|err|/max|plain| {eo:.3e}, max|dlse| {el:.3e}; dq/dk/dv "
              f"{e[0]:.3e}/{e[1]:.3e}/{e[2]:.3e} (tol {BF16_REL:g} of max; lse {FLASH_TOL:g})")
        check(max(e) <= BF16_REL and all(g.dtype == torch.bfloat16 for g in got),
              f"bf16 flash backward disagrees with its plain version (T={t})")
        errs["fwd"] = max(errs["fwd"], (o.float() - ro.float()).abs().max().item(), el)
        errs["dq"] = max(errs["dq"], (got[0].float() - want[0].float()).abs().max().item())
        errs["dkdv"] = max(errs["dkdv"], *((g.float() - w.float()).abs().max().item()
                                           for g, w in zip(got[1:], want[1:])))
        if main is None:
            main = (args, b, t, h, d)
        del got, want
    args, b, t, h, d = main
    same = torch.equal(flash_dq(*args, causal=True), flash_dq(*args, causal=True))
    print(f"[kernel] flash_dq_bf16 B={b} T={t} H={h} D={d} causal: repeat call bitwise "
          f"equal: {same}")
    check(same, "bf16 flash dQ is not bitwise repeatable")
    q, k, v, do = args[:4]
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa(), (qh, kh, vh), doh)

    lib_f = cuda_ms(sdpa, iters=20)
    lib_b = cuda_ms(sdpa_bwd, iters=20) - lib_f
    dev_f = device_ms(sdpa)
    dev_b = device_ms(sdpa_bwd) - dev_f
    pairs = b * h * t * (t + 1) // 2
    io = b * t * h * d
    rows = []
    for kernel, fn, ref, err, nbytes, flops, lib, lib_dev, lib_name in (
        (FLASH_FORWARD_BF16, lambda: flash_forward_lse(q, k, v, causal=True),
         lambda: flash_forward_lse_reference(q, k, v, causal=True), errs["fwd"],
         2 * 4 * io + 4 * b * h * t, 4 * d * pairs, lib_f, dev_f, "sdpa bf16 forward"),
        (FLASH_DQ_BF16, lambda: flash_dq(*args, causal=True),
         lambda: flash_dq_reference(*args, causal=True), errs["dq"],
         2 * 5 * io + 8 * b * h * t, 6 * d * pairs, lib_b, dev_b,
         "sdpa bf16 fwd+bwd minus fwd (dq, dk, dv)"),
        (FLASH_DKDV_BF16, lambda: flash_dkdv(*args, causal=True),
         lambda: flash_dkdv_reference(*args, causal=True), errs["dkdv"],
         2 * 6 * io + 8 * b * h * t, 8 * d * pairs, lib_b, dev_b,
         "sdpa bf16 fwd+bwd minus fwd (dq, dk, dv)"),
    ):
        ms = cuda_ms(fn, iters=20)
        dev = device_ms(fn)
        plain_ms = cuda_ms(ref, iters=10)
        bnd, by = bound(nbytes, flops, H100_BF16_FLOPS)
        rate = tflops(flops, ms)
        print(f"[kernel] {kernel.name} B={b} T={t} H={h} D={d} causal: kernel {ms:.4f} ms "
              f"({rate:.1f} TFLOP/s; device {dev:.4f}), plain {plain_ms:.4f} ms, {lib_name} "
              f"{lib:.4f} ms (device {lib_dev:.4f}), bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms, tflops=rate,
                         device_ms=dev, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                         library_ms=lib, library_device_ms=lib_dev, library=lib_name,
                         shape=f"B={b} T={t} H={h} D={d} causal bf16 (flagship)"))
    return rows


def flash_head_dim_phase(gen, rows: dict) -> None:
    """Kernels 1–3 (f32 and bf16) at head dims between their compiled widths
    and at the widest, D = 48, 80, 200 and 256, at small T: causal T=200
    (not a multiple of a tile) and non-causal T=77, against their plain
    versions with the tolerances above. Adds ``at_head_dims`` to the rows
    and folds the errors into their ``max_abs_err``; then times dQ and
    dK/dV at D = 256 (``at_d256``)."""
    import torch

    from tpudml_torch.ops import (
        flash_dkdv, flash_dkdv_reference, flash_dq, flash_dq_reference, flash_forward_lse,
        flash_forward_lse_reference,
    )

    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        errs = {"flash_forward_lse": {}, "flash_dkdv": {}, "flash_dq": {}}
        for d in (48, 80, 200, 256):
            for b, t, h, causal in ((2, 200, 3, True), (1, 77, 2, False)):
                q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda().to(dtype)
                               for _ in range(4))
                o, lse = flash_forward_lse(q, k, v, causal=causal)
                ro, rlse = flash_forward_lse_reference(q, k, v, causal=causal)
                torch.cuda.synchronize()
                el = (lse - rlse).abs().max().item()
                if dtype == torch.float32:
                    eo = (o - ro).abs().max().item()
                    ok = eo <= FLASH_TOL and el <= FLASH_TOL
                else:
                    eo = rel_to_max(o, ro)
                    ok = o.dtype == dtype and eo <= BF16_REL and el <= FLASH_TOL
                check(ok, f"flash forward disagrees with its plain version at D={d} "
                      f"({dtype}, T={t}, causal={causal})")
                fe = errs["flash_forward_lse"]
                fe[d] = max(fe.get(d, 0.0), (o.float() - ro.float()).abs().max().item(), el)
                delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
                args = (q, k, v, do, rlse, delta)
                got = (flash_dq(*args, causal=causal), *flash_dkdv(*args, causal=causal))
                want = (flash_dq_reference(*args, causal=causal),
                        *flash_dkdv_reference(*args, causal=causal))
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    e = [_grad_err(g_, w) for g_, w in zip(got, want)]
                    tol = (f"tol {FLASH_TOL:g}; grads |err| <= {GRAD_ATOL:g} + "
                           f"{GRAD_RTOL:g}·|plain|")
                else:
                    e = [rel_to_max(g_, w) for g_, w in zip(got, want)]
                    check(max(e) <= BF16_REL and all(g_.dtype == dtype for g_ in got),
                          f"bf16 flash backward disagrees with its plain version at D={d}")
                    tol = f"tol {BF16_REL:g} of max; lse {FLASH_TOL:g}"
                for name, gs, ws in (("flash_dq", got[:1], want[:1]),
                                     ("flash_dkdv", got[1:], want[1:])):
                    errs[name][d] = max(errs[name].get(d, 0.0), *(
                        (g_.float() - w.float()).abs().max().item() for g_, w in zip(gs, ws)))
                print(f"[kernel] flash head dim D={d} {str(dtype)[6:]} B={b} T={t} H={h} "
                      f"causal={causal}: O {eo:.3e}, lse {el:.3e}; dq/dk/dv "
                      f"{e[0]:.3e}/{e[1]:.3e}/{e[2]:.3e} ({tol})")
        for name, by_d in errs.items():
            row = rows[name + suffix]
            row["at_head_dims"] = {f"D={d}": e for d, e in by_d.items()}
            row["max_abs_err"] = max(row["max_abs_err"], *by_d.values())
        flash_d256_times(gen, dtype, rows["flash_dq" + suffix], rows["flash_dkdv" + suffix])
    torch.cuda.empty_cache()


def flash_d256_times(gen, dtype, dq_row: dict, dkdv_row: dict) -> None:
    """dQ and dK/dV at the training shape with D = 256 (B=8, T=1024, H=4,
    causal): kernel, plain and SDPA-backward ms, the bound and the rate,
    into ``at_d256`` of the two rows."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        flash_dkdv, flash_dkdv_reference, flash_dq, flash_dq_reference,
        flash_forward_lse_reference,
    )

    b, t, h, d = FLASH_D256_SHAPE
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda().to(dtype)
                   for _ in range(4))
    o, lse = flash_forward_lse_reference(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    lib_b = (cuda_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), iters=10)
             - cuda_ms(sdpa, iters=10))
    bf16 = dtype == torch.bfloat16
    e, peak = (2, H100_BF16_FLOPS) if bf16 else (4, H100_F32_FLOPS)
    pairs = b * h * t * (t + 1) // 2
    io = b * t * h * d
    for row, fn, ref, nbytes, flops in (
        (dq_row, flash_dq, flash_dq_reference, e * 5 * io + 8 * b * h * t, 6 * d * pairs),
        (dkdv_row, flash_dkdv, flash_dkdv_reference, e * 6 * io + 8 * b * h * t,
         8 * d * pairs),
    ):
        r = timed(lambda: fn(*args, causal=True), lambda: ref(*args, causal=True),
                  nbytes, flops, peak, iters=10)
        r.update(library_ms=lib_b, library="sdpa fwd+bwd minus fwd (dq, dk, dv)",
                 tflops=tflops(flops, r["ms"]),
                 shape=f"B={b} T={t} H={h} D={d} causal {str(dtype)[6:]}")
        print(f"[kernel] {row['name']} B={b} T={t} H={h} D={d} causal: kernel {r['ms']:.4f} "
              f"ms ({r['tflops']:.1f} TFLOP/s), plain {r['plain_ms']:.4f} ms, sdpa backward "
              f"{lib_b:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
        row["at_d256"] = r
    del qh, kh, vh, doh


def add_ln_bf16_phase(gen) -> list[dict]:
    """The bf16 twins of add+LN forward (#8) and backward (#9) at N=8192,
    d=512 (also N=1000, and ds=None): agreement and times beside the bound
    and ``F.layer_norm(x + r)`` in bf16."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        ADD_LN_BACKWARD_BF16, ADD_LN_FORWARD_BF16, add_layernorm_backward,
        add_layernorm_backward_reference, add_layernorm_forward,
        add_layernorm_forward_reference,
    )

    err_f = err_b = 0.0
    main = None
    for n, d in ((8192, 512), (1000, 512)):
        x, r, dy, ds = (torch.randn((n, d), generator=gen).cuda().bfloat16() for _ in range(4))
        scale = (1 + 0.1 * torch.randn((d,), generator=gen)).cuda()
        bias = (0.1 * torch.randn((d,), generator=gen)).cuda()
        s, y, mean, rstd = add_layernorm_forward(x, r, scale, bias)
        rs, ry, rmean, rrstd = add_layernorm_forward_reference(x, r, scale, bias)
        ey = rel_to_max(y, ry)
        estat = max((mean - rmean).abs().max().item(), (rstd - rrstd).abs().max().item())
        check(torch.equal(s, rs) and ey <= BF16_REL and estat <= LN_ROW_TOL,
              f"bf16 add+LN forward disagrees with its plain version (N={n})")
        for dsv in (ds, None):
            dx, dg, db = add_layernorm_backward(rs, scale, dy, dsv, rmean, rrstd)
            rdx, rdg, rdb = add_layernorm_backward_reference(rs, scale, dy, dsv, rmean, rrstd)
            edx = rel_to_max(dx, rdx)
            ecol = max(rel_to_max(dg, rdg), rel_to_max(db, rdb))
            print(f"[kernel] bf16 add_layernorm N={n} d={d} ds={'None' if dsv is None else 'given'}: "
                  f"s equal, y {ey:.3e}, dx {edx:.3e} of max (tol {BF16_REL:g}); mean/rstd "
                  f"{estat:.3e} (tol {LN_ROW_TOL:g}); dgamma/dbeta {ecol:.3e} of max "
                  f"(tol {LN_COL_RTOL:g})")
            check(edx <= BF16_REL and ecol <= LN_COL_RTOL,
                  f"bf16 add+LN backward disagrees with its plain version (N={n})")
            err_b = max(err_b, (dx.float() - rdx.float()).abs().max().item(),
                        (dg - rdg).abs().max().item(), (db - rdb).abs().max().item())
        err_f = max(err_f, (y.float() - ry.float()).abs().max().item(), estat)
        if main is None:
            main = (x, r, scale, bias, dy, ds, rs, rmean, rrstd, n, d)
    x, r, scale, bias, dy, ds, s, mean, rstd, n, d = main
    leaves = [t.clone().requires_grad_() for t in (x, r, scale, bias)]

    def lib_fwd():  # F.layer_norm takes γ, β in the rows' dtype
        s_ = leaves[0] + leaves[1]
        return s_, F.layer_norm(s_, (d,), leaves[2].bfloat16(), leaves[3].bfloat16(), 1e-5)

    lib_f = cuda_ms(lib_fwd)
    lib_b = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, (ds, dy))) - lib_f
    dev_f = device_ms(lib_fwd)
    dev_b = device_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, (ds, dy))) - dev_f
    rows = []
    for kernel, fn, ref, err, nbytes, lib, lib_dev in (
        (ADD_LN_FORWARD_BF16, lambda: add_layernorm_forward(x, r, scale, bias),
         lambda: add_layernorm_forward_reference(x, r, scale, bias), err_f,
         2 * 4 * n * d + 4 * (2 * d + 2 * n), lib_f, dev_f),
        (ADD_LN_BACKWARD_BF16, lambda: add_layernorm_backward(s, scale, dy, ds, mean, rstd),
         lambda: add_layernorm_backward_reference(s, scale, dy, ds, mean, rstd), err_b,
         2 * 4 * n * d + 4 * (3 * d + 2 * n), lib_b, dev_b),
    ):
        ms = cuda_ms(fn)
        dev = device_ms(fn)
        plain_ms = cuda_ms(ref)
        flops = (8 if kernel is ADD_LN_FORWARD_BF16 else 12) * n * d
        bnd, by = bound(nbytes, flops, H100_BF16_FLOPS)
        print(f"[kernel] {kernel.name} N={n} d={d}: kernel {ms:.4f} ms (device {dev:.4f}), "
              f"plain {plain_ms:.4f} ms, F.layer_norm(x + r) bf16 {lib:.4f} ms (device "
              f"{lib_dev:.4f}), bound {bnd:.5f} ms ({by})")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=err, ms=ms, device_ms=dev,
                         library_device_ms=lib_dev,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                         library="F.layer_norm(x + r) bf16" + (
                             " fwd+bwd minus fwd" if kernel is ADD_LN_BACKWARD_BF16 else ""),
                         shape=f"N={n} d={d} bf16 (flagship)"))
    return rows


def _xent_inputs(gen, n, d, v, dtype, bad_labels):
    import torch

    dev = gen.device  # a CUDA generator makes large inputs on the card
    x = torch.randn((n, d), generator=gen, device=dev).cuda().to(dtype)
    w = ((torch.rand((d, v), generator=gen, device=dev) * 2 - 1) / d ** 0.5).cuda().to(dtype)
    b = ((torch.rand((v,), generator=gen, device=dev) * 2 - 1) / d ** 0.5).cuda().to(dtype)
    y = torch.randint(0, v, (n,), generator=gen, dtype=torch.int32, device=dev)
    if bad_labels:
        y[0], y[-1] = -1, v
    return x, w, b, y.cuda()


def xent_check(gen, n, d, v, dtype, bad_labels) -> dict:
    """Kernels 10–13 against their plain versions at one shape: returns
    max |err| per kernel."""
    import torch

    from tpudml_torch.ops import (
        xent_dw, xent_dw_reference, xent_dx, xent_dx_reference, xent_forward,
        xent_forward_save, xent_forward_save_reference,
    )

    x, w, b, y = _xent_inputs(gen, n, d, v, dtype, bad_labels)
    lse0, picked0 = xent_forward(x, w, b, y)
    lse, picked, s = xent_forward_save(x, w, b, y)
    rlse, rpicked, rs = xent_forward_save_reference(x, w, b, y)
    torch.cuda.synchronize()

    def row_err(got, want, what):
        err = (got - want).abs()
        check(bool((err <= XENT_ROW_TOL * (1 + want.abs())).all()),
              f"xent {what} disagrees with its plain version (N={n}, V={v}, {dtype})")
        return err.max().item()

    e10 = max(row_err(lse0, rlse, "fwd lse"), row_err(picked0, rpicked, "fwd picked"))
    e11 = max(row_err(lse, rlse, "fwd-save lse"), row_err(picked, rpicked, "fwd-save picked"),
              row_err(s, rs, "saved scores"))
    if bad_labels:
        check(picked[0].item() == picked[-1].item() == 0.0, "an out-of-range label picked")
    del s
    rel = XENT_GRAD_REL if dtype == torch.float32 else BF16_REL
    dx = xent_dx(rs, w, y, rlse, 1.0 / n)
    rdx = xent_dx_reference(rs, w, y, rlse, 1.0 / n)
    dw, db = xent_dw(rs, x, y, rlse, 1.0 / n)
    rdw, rdb = xent_dw_reference(rs, x, y, rlse, 1.0 / n)
    torch.cuda.synchronize()
    r_dx, r_dw, r_db = rel_to_max(dx, rdx), rel_to_max(dw, rdw), rel_to_max(db, rdb)
    tag = "f32" if dtype == torch.float32 else "bf16"
    print(f"[kernel] xent N={n} d={d} V={v} {tag}{' labels -1, V' if bad_labels else ''}: "
          f"fwd max|dlse|,|dpicked| {e10:.3e}, fwd-save (+scores) {e11:.3e} "
          f"(|err| <= {XENT_ROW_TOL:g}·(1+|plain|)); dx {r_dx:.3e}, dw {r_dw:.3e}, "
          f"db {r_db:.3e} of max (tol {rel:g}; db {XENT_GRAD_REL:g})")
    check(r_dx <= rel and r_dw <= rel and r_db <= XENT_GRAD_REL,
          f"xent backward disagrees with its plain version (N={n}, V={v}, {tag})")
    return {"xent_fwd": e10, "xent_fwd_save": e11,
            "xent_dx_s": (dx.float() - rdx.float()).abs().max().item(),
            "xent_dw_s": max((dw.float() - rdw.float()).abs().max().item(),
                             (db - rdb).abs().max().item())}


PRODUCT_NAME = "cuBLAS product alone on a dlog materialized in the operand dtype"


def xent_times(gen, dtype, shape=XENT_SHAPE, label="flagship head", only=None) -> dict:
    """Kernels 10–13 (or the names in ``only``) at ``shape`` (N, d, V; the
    flagship head's by default) in ``dtype``: kernel, plain and library ms
    and the bound, by kernel name. Library: the forward is
    ``torch.logsumexp(x@W+b)`` plus the label pick; the backward the
    autograd of ``F.cross_entropy`` over the materialized logits minus its
    forward (dx, dW, db together: the whole head's backward, not one
    kernel). Every row gives its rate at 2·N·d·V, and rows 12 and 13, as a
    yardstick of their product that is not their function (the port never
    calls it), ``product_ms``: cuBLAS's dlog·Wᵀ or xᵀ·dlog on a dlog that
    is already materialized in the operand dtype."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        XENT_DW, XENT_DX, XENT_FORWARD, XENT_FORWARD_SAVE, xent_dw, xent_dw_reference,
        xent_dx, xent_dx_reference, xent_forward, xent_forward_reference,
        xent_forward_save, xent_forward_save_reference,
    )
    from tpudml_torch.ops.xent_kernel import _dlog

    n, d, v = shape
    x, w, b, y = _xent_inputs(gen, n, d, v, dtype, bad_labels=False)
    yl = y.long()
    lse, _, s = xent_forward_save(x, w, b, y)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    dlog = _dlog(s, y, lse, 1.0 / n).to(dtype)
    product = {XENT_DX: lambda: dlog @ w.T, XENT_DW: lambda: x.T @ dlog}

    def lib_fwd():
        logits = torch.addmm(b, x, w)
        return torch.logsumexp(logits, dim=-1), logits.gather(1, yl[:, None])

    def ce():
        return F.cross_entropy(torch.addmm(leaves[2], leaves[0], leaves[1]), yl)

    lib_f = cuda_ms(lib_fwd, iters=10)
    lib_b = cuda_ms(lambda: torch.autograd.grad(ce(), leaves), iters=10) - cuda_ms(ce, iters=10)
    e = x.element_size()
    io = n * d * e + d * v * e + v * e + 4 * n  # x, W, b, labels
    mm = 2 * n * d * v
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    out = {}
    cases = (
        (XENT_FORWARD, lambda: xent_forward(x, w, b, y),
         lambda: xent_forward_reference(x, w, b, y), io + 8 * n, mm + 4 * n * v,
         lib_f, "logsumexp(x@W+b) + pick"),
        (XENT_FORWARD_SAVE, lambda: xent_forward_save(x, w, b, y),
         lambda: xent_forward_save_reference(x, w, b, y), io + 8 * n + 4 * n * v,
         mm + 4 * n * v, lib_f, "logsumexp(x@W+b) + pick"),
        (XENT_DX, lambda: xent_dx(s, w, y, lse, 1.0 / n),
         lambda: xent_dx_reference(s, w, y, lse, 1.0 / n),
         4 * n * v + d * v * e + 8 * n + n * d * e, mm + 4 * n * v, lib_b,
         "F.cross_entropy fwd+bwd minus fwd (dx, dW, db)"),
        (XENT_DW, lambda: xent_dw(s, x, y, lse, 1.0 / n),
         lambda: xent_dw_reference(s, x, y, lse, 1.0 / n),
         4 * n * v + n * d * e + 8 * n + d * v * e + 4 * v, mm + 5 * n * v, lib_b,
         "F.cross_entropy fwd+bwd minus fwd (dx, dW, db)"),
    )
    tag = str(dtype)[6:]
    for kernel, fn, ref, nbytes, flops, lib, lib_name in cases:
        if only is not None and kernel.name not in only:
            continue
        ms = cuda_ms(fn, iters=10, warmup=2)
        plain_ms = cuda_ms(ref, iters=5, warmup=1)
        bnd, by = bound(nbytes, flops, peak)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                   library=f"{lib_name}, {tag}", shape=f"N={n} d={d} V={v} {tag} ({label})")
        row["tflops"] = tflops(mm, ms)
        extra = f" ({row['tflops']:.1f} TFLOP/s at 2·N·d·V)"
        if kernel in product:
            row.update(product_ms=cuda_ms(product[kernel], iters=10, warmup=2),
                       product=f"{PRODUCT_NAME} (a yardstick, not this kernel's function)")
            extra += f"; yardstick {PRODUCT_NAME}: {row['product_ms']:.3f} ms"
        print(f"[kernel] {kernel.name} N={n} d={d} V={v} {tag}: kernel {ms:.3f} ms{extra}, "
              f"plain {plain_ms:.3f} ms, {lib_name} {lib:.3f} ms, bound {bnd:.5f} ms ({by})")
        out[kernel.name] = row
    del s, dlog
    torch.cuda.empty_cache()
    return out


def xent_phase(gen) -> list[dict]:
    """The fused linear-xent kernels 10–13: agreement with their plain
    versions at the flagship head's shape, at N=V=1000 and at
    XENT_FWD_EDGES with labels −1 and V, in f32 and bf16; times at the
    flagship shape in bf16 (the row) and f32 (``at_f32``), and for 11–13
    in f32 at the long context's N=32768 with saved scores
    (``at_long_context``)."""
    import torch

    from tpudml_torch.ops import XENT_DW, XENT_DX, XENT_FORWARD, XENT_FORWARD_SAVE

    n, d, v = XENT_SHAPE
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, bad in (((1000, d, 1000), True), ((n, d, v), False),
                           *((edge, True) for edge in XENT_FWD_EDGES)):
            for name, e in xent_check(gen, *shape, dtype, bad).items():
                worst[name] = max(worst.get(name, 0.0), e)
            torch.cuda.empty_cache()
    times = {dt: xent_times(gen, dt) for dt in (torch.bfloat16, torch.float32)}
    long = xent_times(gen, torch.float32, (LEAN_PATH_N, d, v), "long context, saved scores",
                      only=(XENT_FORWARD_SAVE.name, XENT_DX.name, XENT_DW.name))
    rows = []
    for kernel in (XENT_FORWARD, XENT_FORWARD_SAVE, XENT_DX, XENT_DW):
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=worst[kernel.name],
                         **times[torch.bfloat16][kernel.name],
                         at_f32=times[torch.float32][kernel.name]))
        if kernel.name in long:
            rows[-1]["at_long_context"] = long[kernel.name]
    torch.cuda.empty_cache()
    return rows


def xent_lean_check(gen, n, d, v, dtype, bad_labels, chunk=None) -> dict:
    """Kernels 14 and 15, and kernel 10 that gives them lse, against their
    plain versions at one shape, the plain versions applied in row chunks
    of ``chunk`` rows when given (their [N, V] scores would not fit
    otherwise): returns max |err| per kernel."""
    import torch

    from tpudml_torch.ops import (
        xent_dw_lean, xent_dw_lean_reference, xent_dx_lean, xent_dx_lean_reference,
        xent_forward, xent_forward_reference,
    )

    x, w, b, y = _xent_inputs(gen, n, d, v, dtype, bad_labels)
    step = chunk or n
    rows = [slice(i, i + step) for i in range(0, n, step)]
    ref = [xent_forward_reference(x[r], w, b, y[r]) for r in rows]
    lse, picked = (torch.cat([p[i] for p in ref]) for i in (0, 1))
    del ref
    klse, kpicked = xent_forward(x, w, b, y)
    dx = xent_dx_lean(x, w, b, y, lse, 1.0 / n)
    dw, db = xent_dw_lean(x, w, b, y, lse, 1.0 / n)
    torch.cuda.synchronize()
    e10 = 0.0
    for got, want in ((klse, lse), (kpicked, picked)):
        err = (got - want).abs()
        check(bool((err <= XENT_ROW_TOL * (1 + want.abs())).all()),
              f"xent_fwd disagrees with its plain version (N={n}, V={v}, {dtype})")
        e10 = max(e10, err.max().item())
    e_dx = m_dx = 0.0
    rdw = rdb = 0.0
    for r in rows:
        rdx = xent_dx_lean_reference(x[r], w, b, y[r], lse[r], 1.0 / n).float()
        e_dx = max(e_dx, (dx[r].float() - rdx).abs().max().item())
        m_dx = max(m_dx, rdx.abs().max().item())
        pw, pb = xent_dw_lean_reference(x[r], w, b, y[r], lse[r], 1.0 / n)
        rdw, rdb = rdw + pw.float(), rdb + pb
    del rdx, pw, pb
    rdw = rdw.to(dtype)
    rel = XENT_GRAD_REL if dtype == torch.float32 else BF16_REL
    r_dx, r_dw, r_db = e_dx / max(m_dx, 1e-30), rel_to_max(dw, rdw), rel_to_max(db, rdb)
    tag = "f32" if dtype == torch.float32 else "bf16"
    print(f"[kernel] xent lean N={n} d={d} V={v} {tag}{' labels -1, V' if bad_labels else ''}"
          f"{f' (plain in {step}-row chunks)' if chunk else ''}: fwd max|dlse|,|dpicked| "
          f"{e10:.3e} (|err| <= {XENT_ROW_TOL:g}·(1+|plain|)); dx {r_dx:.3e}, dw "
          f"{r_dw:.3e}, db {r_db:.3e} of max (tol {rel:g}; db {XENT_GRAD_REL:g})")
    check(dx.dtype == dw.dtype == dtype and db.dtype == torch.float32,
          "lean xent gradients in the wrong dtype")
    check(r_dx <= rel and r_dw <= rel and r_db <= XENT_GRAD_REL,
          f"lean xent backward disagrees with its plain version (N={n}, V={v}, {tag})")
    return {"xent_fwd": e10, "xent_dx_lean": e_dx,
            "xent_dw_lean": max((dw.float() - rdw.float()).abs().max().item(),
                                (db - rdb).abs().max().item())}


def xent_lean_times(gen, n, dtype, iters=3, with_fwd=False, dv=XENT_SHAPE[1:]) -> dict:
    """Kernels 14 and 15 (and with ``with_fwd`` kernel 10, which runs
    before them) at N rows of width d and vocabulary V (``dv``, the
    flagship head's by default) in ``dtype``:
    kernel, plain and library ms and the bound, by kernel name. Library:
    the autograd of ``F.cross_entropy`` over the materialized logits minus
    its forward (dx, dW, db together), as rows 12 and 13 use; for kernel
    10, ``torch.logsumexp(x@W+b)`` plus the label pick. The bound counts
    both products each backward kernel does (the recompute and the
    gradient)."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        XENT_DW_LEAN, XENT_DX_LEAN, XENT_FORWARD, xent_dw_lean, xent_dw_lean_reference,
        xent_dx_lean, xent_dx_lean_reference, xent_forward, xent_forward_reference,
    )

    d, v = dv
    x, w, b, y = _xent_inputs(gen, n, d, v, dtype, bad_labels=False)
    yl = y.long()
    lse, _ = xent_forward_reference(x, w, b, y)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]

    def ce():
        return F.cross_entropy(torch.addmm(leaves[2], leaves[0], leaves[1]), yl)

    def lib_fwd():
        logits = torch.addmm(b, x, w)
        return torch.logsumexp(logits, dim=-1), logits.gather(1, yl[:, None])

    lib_b = (cuda_ms(lambda: torch.autograd.grad(ce(), leaves), iters=iters, warmup=1)
             - cuda_ms(ce, iters=iters, warmup=1))
    lib_f = cuda_ms(lib_fwd, iters=iters, warmup=1) if with_fwd else None
    del leaves
    e = x.element_size()
    io = n * d * e + d * v * e + v * e + 8 * n  # x, W, b, labels, lse
    mm = 4 * n * d * v  # the recompute and the gradient product
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    tag = str(dtype)[6:]
    lib_name = "F.cross_entropy fwd+bwd minus fwd (dx, dW, db)"
    cases = [
        (XENT_DX_LEAN, lambda: xent_dx_lean(x, w, b, y, lse, 1.0 / n),
         lambda: xent_dx_lean_reference(x, w, b, y, lse, 1.0 / n),
         io + n * d * e, mm + 4 * n * v, lib_b, lib_name),
        (XENT_DW_LEAN, lambda: xent_dw_lean(x, w, b, y, lse, 1.0 / n),
         lambda: xent_dw_lean_reference(x, w, b, y, lse, 1.0 / n),
         io + d * v * e + 4 * v, mm + 5 * n * v, lib_b, lib_name),
    ]
    if with_fwd:  # x, W, b, labels in; lse, picked out
        cases.insert(0, (XENT_FORWARD, lambda: xent_forward(x, w, b, y),
                         lambda: xent_forward_reference(x, w, b, y), io,
                         mm // 2 + 4 * n * v, lib_f, "logsumexp(x@W+b) + pick"))
    out = {}
    for kernel, fn, ref, nbytes, flops, lib, name in cases:
        ms = cuda_ms(fn, iters=iters, warmup=1)
        plain_ms = cuda_ms(ref, iters=2, warmup=1)
        bnd, by = bound(nbytes, flops, peak)
        rate = tflops(mm if kernel is not XENT_FORWARD else mm // 2, ms)
        print(f"[kernel] {kernel.name} N={n} d={d} V={v} {tag}: kernel {ms:.3f} ms "
              f"({rate:.1f} TFLOP/s at {'2' if kernel is XENT_FORWARD else '4'}·N·d·V), plain "
              f"{plain_ms:.3f} ms, {name} {lib:.3f} ms, bound {bnd:.5f} ms ({by})")
        out[kernel.name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                                library_ms=lib, library=f"{name}, {tag}", tflops=rate,
                                shape=f"N={n} d={d} V={v} {tag}")
        torch.cuda.empty_cache()
    return out


def xent_lean_phase(gen, fwd_row: dict) -> list[dict]:
    """The lean head's kernels 14 and 15, with kernel 10 that feeds them:
    agreement with their plain versions at the flagship head's shape and
    at N=V=1000 with labels −1 and V (f32 and bf16), and in f32 at the
    long-context path's N=32768, at N=131072 and at LEAN_WIDE (N·d > 2³¹);
    times at the path's shape in f32 (the rows of 14 and 15, kernel 10's
    ``at_long_context``) and at the flagship's N=8192 in bf16 and f32."""
    import torch

    from tpudml_torch.ops import XENT_DW_LEAN, XENT_DX_LEAN

    n, d, v = XENT_SHAPE
    worst = {}
    cases = [((1000, d, 1000), torch.float32, True, None),
             ((n, d, v), torch.float32, False, None),
             ((1000, d, 1000), torch.bfloat16, True, None),
             ((n, d, v), torch.bfloat16, False, None),
             ((LEAN_PATH_N, d, v), torch.float32, False, None),
             ((LEAN_BIG_N, d, v), torch.float32, False, LEAN_CHUNK),
             (LEAN_WIDE, torch.float32, False, LEAN_WIDE_CHUNK)]
    for shape, dtype, bad, chunk in cases:
        g = torch.Generator(device="cuda").manual_seed(1) if shape == LEAN_WIDE else gen
        for name, e in xent_lean_check(g, *shape, dtype, bad, chunk).items():
            worst[name] = max(worst.get(name, 0.0), e)
        torch.cuda.empty_cache()
    path = xent_lean_times(gen, LEAN_PATH_N, torch.float32, with_fwd=True)
    fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], worst["xent_fwd"])
    fwd_row["at_long_context"] = path["xent_fwd"]
    fwd_row["at_long_context"]["shape"] += " (long-context head)"
    flagship = {dt: xent_lean_times(gen, n, dt, iters=5) for dt in (torch.bfloat16,
                                                                    torch.float32)}
    rows = []
    for kernel in (XENT_DX_LEAN, XENT_DW_LEAN):
        row = dict(name=kernel.name, route="cuda", source=kernel.source,
                   replaces=kernel.replaces, max_abs_err=worst[kernel.name],
                   **path[kernel.name])
        row["shape"] += " (long-context head)"
        row["at_flagship_bf16"] = flagship[torch.bfloat16][kernel.name]
        row["at_flagship_f32"] = flagship[torch.float32][kernel.name]
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def ln_phase(gen) -> list[dict]:
    """The plain LayerNorm forward (#6) and backward (#7) and their bf16
    twins against their plain versions at N=8192 and N=1000, d=512; then
    timed at N=8192 beside the bound and ``F.layer_norm`` (its backward:
    forward+backward minus forward)."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        LN_BACKWARD, LN_BACKWARD_BF16, LN_FORWARD, LN_FORWARD_BF16, layernorm_backward,
        layernorm_backward_reference, layernorm_forward, layernorm_forward_reference,
    )

    rows = []
    for dtype, fwd_k, bwd_k in ((torch.float32, LN_FORWARD, LN_BACKWARD),
                                (torch.bfloat16, LN_FORWARD_BF16, LN_BACKWARD_BF16)):
        tag = str(dtype)[6:]
        bf16 = dtype == torch.bfloat16
        err_f = err_b = 0.0
        main = None
        for n, d in (LN_SHAPE, (1000, LN_SHAPE[1])):
            x, dy = (torch.randn((n, d), generator=gen).cuda().to(dtype) for _ in range(2))
            scale = (1 + 0.1 * torch.randn((d,), generator=gen)).cuda()
            bias = (0.1 * torch.randn((d,), generator=gen)).cuda()
            y, mean, rstd = layernorm_forward(x, scale, bias)
            ry, rmean, rrstd = layernorm_forward_reference(x, scale, bias)
            dx, dg, db = layernorm_backward(x, scale, dy, rmean, rrstd)
            rdx, rdg, rdb = layernorm_backward_reference(x, scale, dy, rmean, rrstd)
            torch.cuda.synchronize()
            estat = max((mean - rmean).abs().max().item(), (rstd - rrstd).abs().max().item())
            ey = rel_to_max(y, ry) if bf16 else (y - ry).abs().max().item()
            edx = rel_to_max(dx, rdx) if bf16 else (dx - rdx).abs().max().item()
            ecol = max(rel_to_max(dg, rdg), rel_to_max(db, rdb))
            row_tol = BF16_REL if bf16 else LN_ROW_TOL
            print(f"[kernel] layernorm N={n} d={d} {tag}: y {ey:.3e}, dx {edx:.3e} "
                  f"({'of max, ' if bf16 else ''}tol {row_tol:g}); mean/rstd {estat:.3e} "
                  f"(tol {LN_ROW_TOL:g}); dgamma/dbeta {ecol:.3e} of max (tol {LN_COL_RTOL:g})")
            check(y.dtype == dx.dtype == dtype and ey <= row_tol and edx <= row_tol
                  and estat <= LN_ROW_TOL and ecol <= LN_COL_RTOL,
                  f"LayerNorm kernels disagree with their plain versions (N={n}, {tag})")
            err_f = max(err_f, (y.float() - ry.float()).abs().max().item(), estat)
            err_b = max(err_b, (dx.float() - rdx.float()).abs().max().item(),
                        (dg - rdg).abs().max().item(), (db - rdb).abs().max().item())
            if main is None:
                main = (x, scale, bias, dy, rmean, rrstd, n, d)
        x, scale, bias, dy, mean, rstd, n, d = main
        leaves = [t.clone().requires_grad_() for t in (x, scale.to(dtype), bias.to(dtype))]

        def lib_fwd():  # F.layer_norm takes γ, β in the rows' dtype
            return F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)

        lib_f = cuda_ms(lib_fwd)
        lib_b = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, dy)) - lib_f
        dev_f = device_ms(lib_fwd)
        dev_b = device_ms(lambda: torch.autograd.grad(lib_fwd(), leaves, dy)) - dev_f
        e = x.element_size()
        peak = H100_BF16_FLOPS if bf16 else H100_F32_FLOPS
        for kernel, fn, ref, err, nbytes, flops, lib, lib_dev in (
            (fwd_k, lambda: layernorm_forward(x, scale, bias),
             lambda: layernorm_forward_reference(x, scale, bias), err_f,
             2 * n * d * e + 4 * (2 * d + 2 * n), 8 * n * d, lib_f, dev_f),
            (bwd_k, lambda: layernorm_backward(x, scale, dy, mean, rstd),
             lambda: layernorm_backward_reference(x, scale, dy, mean, rstd), err_b,
             3 * n * d * e + 4 * (3 * d + 2 * n), 12 * n * d, lib_b, dev_b),
        ):
            ms = cuda_ms(fn)
            dev = device_ms(fn)
            plain_ms = cuda_ms(ref)
            bnd, by = bound(nbytes, flops, peak)
            lib_name = f"F.layer_norm {tag}" + (" fwd+bwd minus fwd" if kernel is bwd_k else "")
            print(f"[kernel] {kernel.name} N={n} d={d}: kernel {ms:.4f} ms (device {dev:.4f}), "
                  f"plain {plain_ms:.4f} ms, {lib_name} {lib:.4f} ms (device {lib_dev:.4f}), "
                  f"bound {bnd:.5f} ms ({by})")
            rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                             replaces=kernel.replaces, max_abs_err=err, ms=ms, device_ms=dev,
                             library_device_ms=lib_dev,
                             plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                             library=lib_name, shape=f"N={n} d={d} {tag} (op path)"))
    return rows


def _top2_gap(logits):
    import torch

    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def head_phase(gen) -> list[dict]:
    import torch

    from tpudml_torch.ops import (
        DECODE_HEAD, DECODE_HEAD_INT8, fused_decode_head, fused_decode_head_int8,
        reference_head, reference_head_int8,
    )
    from tpudml_torch.serve.fleet.quant import _dequant_kernel, _quant_kernel

    b, d, v = 8, 512, 32768
    x = torch.randn((b, d), generator=gen).cuda()
    w = ((torch.rand((d, v), generator=gen) * 2 - 1) / d ** 0.5).cuda()
    bias = ((torch.rand((v,), generator=gen) * 2 - 1) / d ** 0.5).cuda()
    wq, scale = _quant_kernel(w)
    rows = []
    for kernel, fn, ref, weights, wbytes in (
        (DECODE_HEAD, fused_decode_head, reference_head, (w,), 4 * d * v),
        (DECODE_HEAD_INT8, fused_decode_head_int8, reference_head_int8,
         (wq, scale), d * v + 4 * v),
    ):
        tok, mx, lse = fn(x, *weights, bias)
        rt, rm, rl = ref(x, *weights, bias)
        torch.cuda.synchronize()
        wf = weights[0] if len(weights) == 1 else _dequant_kernel(*weights)
        gap = _top2_gap(x @ wf + bias)
        diff = (tok != rt).nonzero().flatten().tolist()
        for i in diff:
            print(f"[kernel] {kernel.name}: row {i} picked {tok[i].item()} vs plain "
                  f"{rt[i].item()} at plain top-2 gap {gap[i].item():.3e}")
            check(gap[i].item() < TIE_GAP, f"{kernel.name}: token differs off a near-tie")
        em = (mx - rm).abs().max().item()
        el = (lse - rl).abs().max().item()
        print(f"[kernel] {kernel.name} B={b} d={d} V={v}: tokens {b - len(diff)}/{b} "
              f"equal, max|dmax|={em:.3e} max|dlse|={el:.3e} (tol {HEAD_TOL:g} each)")
        check(em <= HEAD_TOL and el <= HEAD_TOL,
              f"{kernel.name} statistics disagree with the plain version")
        ms = cuda_ms(lambda: fn(x, *weights, bias))
        plain_ms = cuda_ms(lambda: ref(x, *weights, bias))

        def library(wf=wf):
            logits = torch.addmm(bias, x, wf)
            return torch.argmax(logits, dim=-1), torch.logsumexp(logits, dim=-1)

        lib_ms = cuda_ms(library)
        dev, per_call = device_profile(lambda: fn(x, *weights, bias))
        check(one_a_call(per_call), f"{kernel.name}: {per_call} device operations a call")
        lib_dev = device_ms(library)
        cold = cold_ms(lambda: fn(x, *weights, bias))
        bnd, by = bound(wbytes + 4 * (b * d + v) + 12 * b, 2 * b * d * v + b * v)
        print(f"[kernel] {kernel.name}: kernel {ms:.4f} ms (device {dev:.4f}, "
              f"{per_call:g} device kernel a call; cold L2 {cold:.4f}), plain "
              f"{plain_ms:.4f} ms, addmm+argmax+logsumexp {lib_ms:.4f} ms (device "
              f"{lib_dev:.4f}), bound {bnd:.5f} ms ({by}; {bnd / cold:.0%} of it cold, "
              f"{bnd / dev:.0%} warm)")
        rows.append(dict(name=kernel.name, route="cuda", source=kernel.source,
                         replaces=kernel.replaces, max_abs_err=max(em, el), ms=ms,
                         device_ms=dev, cold_ms=cold, plain_ms=plain_ms, bound_ms=bnd,
                         bound_by=by, library_ms=lib_ms, library_device_ms=lib_dev))
    return rows


def _router_groups(gen, m: int, e: int):
    """Group sizes [E] int32 on the card: a real router's top-1 over seeded
    features ([m, 512] @ [512, E], skewed toward expert 0 by a bias) for
    m − 192 rows, leaving 192 tail rows; and a set with empty groups and a
    collapsed one (every row but the tail in one expert)."""
    import torch

    used = m - 192
    feats = torch.randn((used, 512), generator=gen).cuda()
    router = (torch.randn((512, e), generator=gen) / 512 ** 0.5).cuda()
    bias = torch.linspace(1.0, 0.0, e, device=feats.device)
    top1 = torch.argmax(torch.softmax(feats @ router + bias, dim=-1), dim=-1)
    routed = torch.bincount(top1, minlength=e).to(torch.int32)
    empty = torch.zeros(e, dtype=torch.int32, device=feats.device)
    empty[::2] = used // ((e + 1) // 2)
    empty[0] += used - int(empty.sum())
    collapsed = torch.zeros(e, dtype=torch.int32, device=feats.device)
    collapsed[e - 1] = used
    return {"router": routed, "empty": empty, "collapsed": collapsed}


def _grouped_mm(x, g, gs, want):
    """``torch._grouped_mm(xᵀ, g, offs=cumsum(sizes))``, the one PyTorch call
    that computes the grouped dW: (call, output dtype, max|err|/max|plain|),
    or (None, why the card's torch refused it, None). A yardstick the port
    never calls; its output is in the operand dtype."""
    import torch

    offs = torch.cumsum(gs, 0).to(torch.int32)
    try:
        got = torch._grouped_mm(x.t(), g, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, AttributeError, NotImplementedError) as err:
        return None, f"{type(err).__name__}: {str(err).splitlines()[0][:160]}", None
    return (lambda: torch._grouped_mm(x.t(), g, offs=offs)), str(got.dtype)[6:], \
        rel_to_max(got, want)


def grouped_dw_phase(gen) -> list[dict]:
    """Kernel 16 and its bf16 twin against ``grouped_dw_reference`` at the
    MoE step's shapes (module docstring, phase 3), bitwise equal on a
    repeat; times at E = 8 and E = 4, dW1 and dW2 shapes, on the router's
    groups and on the collapsed set (every routed row in one expert: the
    case the row split is for; its ratio to the router's time), beside the
    bound (data-dependent: the routed rows' bytes and products; the tail
    rows are never read), the plain version, per-expert ``torch.matmul``
    and ``torch._grouped_mm`` (``library_ms`` where the card's torch takes
    it, else the per-expert chain); then one slab of 60000 rows (GDW_LONG),
    past the bf16 twin's 2048-row chunk cap."""
    import torch

    from tpudml_torch.ops import (
        GROUPED_DW, GROUPED_DW_BF16, grouped_dw, grouped_dw_plan, grouped_dw_reference,
    )

    rows = []
    for dtype, kernel in ((torch.float32, GROUPED_DW), (torch.bfloat16, GROUPED_DW_BF16)):
        tag = str(dtype)[6:]
        worst, times = 0.0, {}
        for e in MOE_EXPERTS:
            sets = _router_groups(gen, GDW_M, e)
            for k, n in GDW_SHAPES:
                x = torch.randn((GDW_M, k), generator=gen).cuda().to(dtype)
                g = (torch.randn((GDW_M, n), generator=gen) / GDW_M ** 0.5).cuda().to(dtype)
                for name, gs in sets.items():
                    got = grouped_dw(x, g, gs)
                    again = grouped_dw(x, g, gs)
                    want = grouped_dw_reference(x, g, gs)
                    torch.cuda.synchronize()
                    err = rel_to_max(got, want)
                    print(f"[kernel] {kernel.name} M={GDW_M} k={k} n={n} E={e} {name} groups "
                          f"{gs.tolist()}: max|err|/max|plain| {err:.3e} (tol {GDW_TOL:g}); "
                          f"repeat bitwise equal: {torch.equal(got, again)}")
                    check(err <= GDW_TOL and got.dtype == torch.float32,
                          f"{kernel.name} disagrees with its plain version (E={e}, k={k}, "
                          f"{name} groups)")
                    check(torch.equal(got, again), f"{kernel.name} is not bitwise repeatable")
                    worst = max(worst, (got - want).abs().max().item())
                gs = sets["router"]
                sizes = gs.tolist()
                slabs, lo = [], 0
                for size in sizes:
                    slabs.append((lo, lo + size))
                    lo += size
                ms = cuda_ms(lambda: grouped_dw(x, g, gs), iters=20)
                collapsed = sets["collapsed"]
                collapsed_ms = cuda_ms(lambda: grouped_dw(x, g, collapsed), iters=20)
                plain_ms = cuda_ms(lambda: grouped_dw_reference(x, g, gs), iters=10)
                chain_ms = cuda_ms(lambda: [torch.matmul(x[a:b].T, g[a:b]) for a, b in slabs],
                                   iters=10)
                gmm, gmm_dtype, gmm_err = _grouped_mm(x, g, gs, grouped_dw_reference(x, g, gs))
                gmm_ms = None if gmm is None else cuda_ms(gmm, iters=20)
                esz = x.element_size()
                nbytes = sum(sizes) * (k + n) * esz + e * k * n * 4 + 4 * e
                flops = 2 * sum(sizes) * k * n
                peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
                bnd, by = bound(nbytes, flops, peak)
                gmm_text = (f"torch._grouped_mm {gmm_ms:.4f} ms ({gmm_dtype} out, max|err|/max "
                            f"{gmm_err:.2e})" if gmm is not None else
                            f"torch._grouped_mm refused ({gmm_dtype})")
                print(f"[kernel] {kernel.name} M={GDW_M} k={k} n={n} E={e} {tag} router groups: "
                      f"kernel {ms:.4f} ms ({tflops(flops, ms):.1f} TFLOP/s), collapsed "
                      f"{collapsed_ms:.4f} ms ({collapsed_ms / ms:.3f}x router), plain "
                      f"{plain_ms:.4f} ms, per-expert torch.matmul {chain_ms:.4f} ms, "
                      f"{gmm_text}, bound {bnd:.5f} ms ({by})")
                row = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                    library_ms=chain_ms if gmm is None else gmm_ms,
                    library=(f"per-expert torch.matmul(x[slab].T, g[slab]), {tag} "
                             f"(torch._grouped_mm refused: {gmm_dtype})" if gmm is None else
                             f"torch._grouped_mm(x.T, g, offs), {gmm_dtype} out"),
                    chain_ms=chain_ms, collapsed_ms=collapsed_ms,
                    shape=f"M={GDW_M} k={k} n={n} E={e} {tag} (router groups {sizes})")
                if dtype == torch.bfloat16:  # near 0.1 ms: the device's own time too
                    row["device_ms"] = device_ms(lambda: grouped_dw(x, g, gs))
                    row["collapsed_device_ms"] = device_ms(lambda: grouped_dw(x, g, collapsed))
                    if gmm is not None:
                        row["library_device_ms"] = device_ms(gmm)
                    print(f"[kernel] {kernel.name} M={GDW_M} k={k} n={n} E={e} {tag} device: "
                          f"router {row['device_ms']:.4f} ms, collapsed "
                          f"{row['collapsed_device_ms']:.4f} ms, torch._grouped_mm "
                          f"{row.get('library_device_ms')}")
                times[(e, k, n)] = row
            torch.cuda.empty_cache()
        # A slab past the bf16 twin's chunk cap: R = 2048 rows in bf16 (one
        # wgmma chain a chunk), 8000 in f32.
        m, k, n = GDW_LONG
        x = torch.randn((m, k), generator=gen).cuda().to(dtype)
        g = torch.randn((m, n), generator=gen).cuda().to(dtype)
        gs = torch.tensor([0, m - 5536, 0, 0], dtype=torch.int32).cuda()
        got, want = grouped_dw(x, g, gs), grouped_dw_reference(x, g, gs)
        err = rel_to_max(got, want)
        rows_r = grouped_dw_plan(m, k, n, 4, dtype)["rows"]
        print(f"[kernel] {kernel.name} M={m} k={k} n={n} one slab of {m - 5536} rows in "
              f"chunks of <= {rows_r}: max|err|/max|plain| {err:.3e} (tol {GDW_TOL:g})")
        check(err <= GDW_TOL and torch.equal(got, grouped_dw(x, g, gs)),
              f"{kernel.name} disagrees with its plain version on a long slab")
        del x, g, got, want
        torch.cuda.empty_cache()
        main = (8, *GDW_SHAPES[0])
        row = dict(name=kernel.name, route="cuda", source=kernel.source,
                   replaces=kernel.replaces, max_abs_err=worst, **times[main])
        row["shape"] += " (MoE dW1)"
        row["at"] = [t for key, t in times.items() if key != main]
        rows.append(row)
    return rows


def _fold_width(row: dict, key: str, err: float, times: dict | None = None) -> None:
    """Record a wide instance's error (and times) under ``at_widths[key]``
    of ``row`` and fold the error into its ``max_abs_err``."""
    at = row.setdefault("at_widths", {}).setdefault(key, {"max_abs_err": 0.0})
    at["max_abs_err"] = max(at["max_abs_err"], err)
    if times:
        at.update(times)
    row["max_abs_err"] = max(row["max_abs_err"], err)


def _ln_wide_check(gen, n: int, d: int, dtype, offset: int = 0) -> tuple:
    """Kernels 6–9 (the twin of ``dtype``) at rows [n, d] whose base lies
    ``offset`` elements into their buffers, against their plain versions
    with the tolerances of the main shapes; the backward (ds given and
    None) bitwise equal on a repeat. Returns (errors by kernel name, the
    rows, the forward and backward plans)."""
    import torch

    from tpudml_torch.ops import (
        add_layernorm_backward, add_layernorm_backward_reference, add_layernorm_forward,
        add_layernorm_forward_reference, layernorm_backward, layernorm_backward_reference,
        layernorm_forward, layernorm_forward_reference,
    )
    from tpudml_torch.ops.layernorm_kernel import plan_for

    bf16 = dtype == torch.bfloat16
    row_tol = BF16_REL if bf16 else LN_ROW_TOL
    tag = f"N={n} d={d} {'bf16' if bf16 else 'f32'}" + (f" base+{offset}" if offset else "")

    def err_of(got, want):  # stored in the rows' dtype: of max in bf16
        return rel_to_max(got, want) if bf16 else (got - want).abs().max().item()

    def rows_():
        buf = torch.randn((n * d + offset,), generator=gen).to(dtype).cuda()
        return buf[offset:].view(n, d)

    x, r, dy, ds = rows_(), rows_(), rows_(), rows_()
    scale = (1 + 0.1 * torch.randn((d,), generator=gen)).cuda()
    bias = (0.1 * torch.randn((d,), generator=gen)).cuda()
    s, y, mean, rstd = add_layernorm_forward(x, r, scale, bias)
    rs, ry, rmean, rrstd = add_layernorm_forward_reference(x, r, scale, bias)
    estat = max((mean - rmean).abs().max().item(), (rstd - rrstd).abs().max().item())
    ef = max(err_of(s, rs), err_of(y, ry))
    check(ef <= row_tol and estat <= LN_ROW_TOL,
          f"add+LN forward disagrees with its plain version at {tag}")
    eb = 0.0
    for dsv in (ds, None):
        got = add_layernorm_backward(rs, scale, dy, dsv, rmean, rrstd)
        again = add_layernorm_backward(rs, scale, dy, dsv, rmean, rrstd)
        rdx, rdg, rdb = add_layernorm_backward_reference(rs, scale, dy, dsv, rmean, rrstd)
        ecol = max(rel_to_max(got[1], rdg), rel_to_max(got[2], rdb))
        check(err_of(got[0], rdx) <= row_tol and ecol <= LN_COL_RTOL,
              f"add+LN backward disagrees with its plain version at {tag}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"add+LN backward is not bitwise equal on a repeat at {tag}")
        eb = max(eb, err_of(got[0], rdx), ecol)
    ly, lmean, lrstd = layernorm_forward(x, scale, bias)
    rly, _, _ = layernorm_forward_reference(x, scale, bias)
    lx, lg, lb = layernorm_backward(x, scale, dy, lmean, lrstd)
    rlx, rlg, rlb = layernorm_backward_reference(x, scale, dy, lmean, lrstd)
    el = err_of(ly, rly)
    elcol = max(rel_to_max(lg, rlg), rel_to_max(lb, rlb))
    check(el <= row_tol and err_of(lx, rlx) <= row_tol and elcol <= LN_COL_RTOL,
          f"LayerNorm kernels disagree with their plain versions at {tag}")
    fplan, bplan = plan_for(x, r, scale, bias, backward=False), plan_for(x, scale, dy, ds,
                                                                         backward=True)
    print(f"[kernel] wide LayerNorm {tag}: forward {fplan.instance}"
          f"{'' if fplan.vector else ' scalar'} ({fplan.threads} threads), backward "
          f"{bplan.instance}{'' if bplan.vector else ' scalar'} ({bplan.threads} threads, "
          f"G={bplan.blocks}, {bplan.rows_per_block} rows a block); add+LN s, y {ef:.3e}, "
          f"mean/rstd {estat:.3e}, dx and dgamma/dbeta {eb:.3e}; LN y {el:.3e}, dx and "
          f"dgamma/dbeta {max(err_of(lx, rlx), elcol):.3e} (rows tol {row_tol:g}"
          f"{' of max' if bf16 else ''}, stats {LN_ROW_TOL:g}, columns {LN_COL_RTOL:g} of "
          f"max); backward bitwise equal on a repeat")
    errs = {"add_layernorm_fwd": max(ef, estat), "add_layernorm_bwd": eb,
            "layernorm_fwd": el, "layernorm_bwd": max(err_of(lx, rlx), elcol)}
    return errs, (x, r, dy, ds, scale, bias, rs, rmean, rrstd, lmean, lrstd), fplan, bplan


def ln_wide_phase(gen, rows: dict) -> None:
    """Kernels 6–9 and their bf16 twins at widths past the 1024 columns a
    warp holds in registers (their wide instances): at each width of
    LN_SWEEP, N·d = LN_SWEEP_ELEMS, add+LN forward and backward (ds given
    and None) and the plain LayerNorm against the plain versions, then
    timed beside the bound and ``F.layer_norm`` (forward, and
    forward+backward minus forward), with device times; then at each of
    LN_CHECKS against the plain versions only."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        add_layernorm_backward, add_layernorm_backward_reference, add_layernorm_forward,
        add_layernorm_forward_reference, layernorm_backward, layernorm_backward_reference,
        layernorm_forward, layernorm_forward_reference,
    )

    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        sfx, tag = ("_bf16", "bf16") if bf16 else ("", "f32")
        e = 2 if bf16 else 4
        peak = H100_BF16_FLOPS if bf16 else H100_F32_FLOPS
        for d in LN_SWEEP:
            n = LN_SWEEP_ELEMS // d
            errs, held, fplan, bplan = _ln_wide_check(gen, n, d, dtype)
            x, r, dy, ds, scale, bias, rs, rmean, rrstd, lmean, lrstd = held
            # F.layer_norm with γ, β in the rows' dtype; its backward is
            # forward+backward minus forward, as at the main shapes.
            leaves = [t.clone().requires_grad_() for t in (x, r, scale.to(dtype),
                                                           bias.to(dtype))]
            ln_leaves = [leaves[0], leaves[2], leaves[3]]

            def lib_add():
                s_ = leaves[0] + leaves[1]
                return s_, F.layer_norm(s_, (d,), leaves[2], leaves[3], 1e-5)

            def lib_ln():
                return F.layer_norm(ln_leaves[0], (d,), ln_leaves[1], ln_leaves[2], 1e-5)

            lib = {}
            for name, lib_fwd, lib_grad in (
                ("add_layernorm", lib_add,
                 lambda: torch.autograd.grad(lib_add(), leaves, (ds, dy))),
                ("layernorm", lib_ln, lambda: torch.autograd.grad(lib_ln(), ln_leaves, dy)),
            ):
                f_ms, f_dev = cuda_ms(lib_fwd, iters=20), device_ms(lib_fwd)
                lib[name + "_fwd"] = (f_ms, f_dev)
                lib[name + "_bwd"] = (cuda_ms(lib_grad, iters=20) - f_ms,
                                      device_ms(lib_grad) - f_dev)
            cases = (
                ("add_layernorm_fwd", lambda: add_layernorm_forward(x, r, scale, bias),
                 lambda: add_layernorm_forward_reference(x, r, scale, bias),
                 4 * n * d * e + 4 * (2 * d + 2 * n), 8 * n * d),
                ("add_layernorm_bwd",
                 lambda: add_layernorm_backward(rs, scale, dy, ds, rmean, rrstd),
                 lambda: add_layernorm_backward_reference(rs, scale, dy, ds, rmean, rrstd),
                 4 * n * d * e + 4 * (3 * d + 2 * n), 12 * n * d),
                ("layernorm_fwd", lambda: layernorm_forward(x, scale, bias),
                 lambda: layernorm_forward_reference(x, scale, bias),
                 2 * n * d * e + 4 * (2 * d + 2 * n), 8 * n * d),
                ("layernorm_bwd", lambda: layernorm_backward(x, scale, dy, lmean, lrstd),
                 lambda: layernorm_backward_reference(x, scale, dy, lmean, lrstd),
                 3 * n * d * e + 4 * (3 * d + 2 * n), 12 * n * d),
            )
            for name, fn, ref, nbytes, flops in cases:
                lib_name = ("F.layer_norm(x + r)" if name.startswith("add") else
                            "F.layer_norm") + (" fwd+bwd minus fwd" if name.endswith("bwd")
                                               else "")
                plan = bplan if name.endswith("bwd") else fplan
                t = timed(fn, ref, nbytes, flops, peak, iters=20)
                t.update(device_ms=device_ms(fn), library_ms=lib[name][0],
                         library_device_ms=lib[name][1], library=f"{lib_name} {tag}",
                         shape=f"N={n} d={d} {tag}",
                         instance=plan.instance + ("" if plan.vector else " scalar"))
                print(f"[kernel] {name}{sfx} N={n} d={d} ({t['instance']}): kernel "
                      f"{t['ms']:.4f} ms (device {t['device_ms']:.5f}, "
                      f"{t['bound_ms'] / t['device_ms']:.0%} of the bound), plain "
                      f"{t['plain_ms']:.4f} ms, {lib_name} {t['library_ms']:.4f} ms (device "
                      f"{t['library_device_ms']:.5f}), bound {t['bound_ms']:.5f} ms "
                      f"({t['bound_by']})")
                _fold_width(rows[name + sfx], f"d={d}", errs[name], t)
            del leaves, ln_leaves, held, x, r, dy, ds, rs
            torch.cuda.empty_cache()
        for n, d, offset in LN_CHECKS:
            errs, *_ = _ln_wide_check(gen, n, d, dtype, offset)
            key = f"d={d}" + (f" base+{offset}" if offset else "")
            for name, err in errs.items():
                _fold_width(rows[name + sfx], key, err)
        torch.cuda.empty_cache()


def xent_wide_phase(gen, rows: dict) -> None:
    """Kernels 10–15 at widths no multiple of the forward's 8-deep stage and
    past the lean kernels' 512-column chunk (XENT_WIDE), f32
    and bf16, N = V = 1000 with labels −1 and V, against their plain
    versions with the tolerances of the main shapes; then timed in f32 at
    XENT_WIDE_TIMED (all six) and at d = 12 (the forward's ragged
    instance)."""
    import torch

    for d in XENT_WIDE:
        for dtype in (torch.float32, torch.bfloat16):
            errs = xent_check(gen, 1000, d, 1000, dtype, True)
            for name, e in xent_lean_check(gen, 1000, d, 1000, dtype, True).items():
                errs[name] = max(errs.get(name, 0.0), e)
            for name, e in errs.items():
                _fold_width(rows[name], f"d={d}", e)
        torch.cuda.empty_cache()
    n, d, v = XENT_WIDE_TIMED
    times = xent_times(gen, torch.float32, (n, d, v), "wide head")
    times.update(xent_lean_times(gen, n, torch.float32, dv=(d, v)))
    for name, t in times.items():
        _fold_width(rows[name], f"d={d}", 0.0, t)
    n, _, v = XENT_SHAPE
    for name, t in xent_times(gen, torch.float32, (n, XENT_WIDE[0], v), "ragged d").items():
        if name in ("xent_fwd", "xent_fwd_save"):
            _fold_width(rows[name], f"d={XENT_WIDE[0]}", 0.0, t)
    torch.cuda.empty_cache()


def head_wide_phase(gen, rows: dict) -> None:
    """Kernels 4 and 5 at d = 8192 (HEAD_WIDE), where each warp stages its
    1024 (f32) or 2048 (int8) rows of x in chunks of 128 or 256, against
    the plain version, one launch and one device kernel a call, timed
    (wrapper and device) beside the bound and the library call."""
    import torch

    from tpudml_torch.ops import (
        DECODE_HEAD, DECODE_HEAD_INT8, fused_decode_head, fused_decode_head_int8,
        reference_head, reference_head_int8,
    )
    from tpudml_torch.serve.fleet.quant import _dequant_kernel, _quant_kernel

    b, d, v = HEAD_WIDE
    x = torch.randn((b, d), generator=gen).cuda()
    w = ((torch.rand((d, v), generator=gen) * 2 - 1) / d ** 0.5).cuda()
    bias = ((torch.rand((v,), generator=gen) * 2 - 1) / d ** 0.5).cuda()
    wq, scale = _quant_kernel(w)
    for kernel, fn, ref, weights, wbytes in (
        (DECODE_HEAD, fused_decode_head, reference_head, (w,), 4 * d * v),
        (DECODE_HEAD_INT8, fused_decode_head_int8, reference_head_int8,
         (wq, scale), d * v + 4 * v),
    ):
        before = kernel.launches
        tok, mx, lse = fn(x, *weights, bias)
        rt, rm, rl = ref(x, *weights, bias)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"{kernel.name} at d={d}: not one launch")
        wf = weights[0] if len(weights) == 1 else _dequant_kernel(*weights)
        gap = _top2_gap(x @ wf + bias)
        diff = (tok != rt).nonzero().flatten().tolist()
        for i in diff:
            check(gap[i].item() < TIE_GAP, f"{kernel.name}: token differs off a near-tie at d={d}")
        em, el = (mx - rm).abs().max().item(), (lse - rl).abs().max().item()
        check(em <= HEAD_TOL and el <= HEAD_TOL,
              f"{kernel.name} statistics disagree with the plain version at d={d}")

        def library(wf=wf):
            logits = torch.addmm(bias, x, wf)
            return torch.argmax(logits, dim=-1), torch.logsumexp(logits, dim=-1)

        t = timed(lambda: fn(x, *weights, bias), lambda: ref(x, *weights, bias),
                  wbytes + 4 * (b * d + v) + 12 * b, 2 * b * d * v + b * v, lib=library,
                  iters=20)
        dev, per_call = device_profile(lambda: fn(x, *weights, bias), calls=50)
        check(one_a_call(per_call), f"{kernel.name} at d={d}: {per_call} device operations a call")
        t.update(shape=f"B={b} d={d} V={v}", library="addmm+argmax+logsumexp",
                 device_ms=dev, library_device_ms=device_ms(library, calls=50))
        print(f"[kernel] {kernel.name} B={b} d={d} V={v} (x staged in chunks): tokens "
              f"{b - len(diff)}/{b} equal, max|dmax| {em:.3e}, max|dlse| {el:.3e} (tol "
              f"{HEAD_TOL:g}); kernel {t['ms']:.4f} ms (device {dev:.4f}, {per_call:g} "
              f"device kernel a call), plain {t['plain_ms']:.4f} ms, addmm+argmax+logsumexp "
              f"{t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f}), bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}; {t['bound_ms'] / dev:.0%} of it)")
        _fold_width(rows[kernel.name], f"d={d}", max(em, el), t)
        del wf
    del x, w, wq
    torch.cuda.empty_cache()


def grid_edge_phase(gen) -> None:
    """Kernels 10–13 and the flash forward, dQ and dK/dV past the old
    grid-y edges (module docstring, phase 3), against their plain versions
    in row chunks (xent; kernel 13's plain dW and db summed over the
    chunks) or on the whole batch (flash)."""
    import torch

    from tpudml_torch.ops import (
        flash_dkdv, flash_dkdv_reference, flash_dq, flash_dq_reference, flash_forward_lse,
        flash_forward_lse_reference, xent_dw, xent_dw_reference, xent_dx, xent_dx_reference,
        xent_forward, xent_forward_save, xent_forward_save_reference,
    )

    n, d, v = XENT_EDGE
    cgen = torch.Generator(device="cuda").manual_seed(2)
    x, w, b, y = _xent_inputs(cgen, n, d, v, torch.float32, bad_labels=True)
    lse0, picked0 = xent_forward(x, w, b, y)
    lse, picked, s = xent_forward_save(x, w, b, y)
    dx = xent_dx(s, w, y, lse, 1.0 / n)
    dw, db = xent_dw(s, x, y, lse, 1.0 / n)
    torch.cuda.synchronize()
    e_fwd = e_dx = m_dx = 0.0
    rdw = rdb = 0.0
    for r in (slice(i, i + XENT_EDGE_CHUNK) for i in range(0, n, XENT_EDGE_CHUNK)):
        rlse, rpicked, rs = xent_forward_save_reference(x[r], w, b, y[r])
        for got, want in ((lse0[r], rlse), (lse[r], rlse), (picked0[r], rpicked),
                          (picked[r], rpicked), (s[r], rs)):
            err = (got - want).abs()
            check(bool((err <= XENT_ROW_TOL * (1 + want.abs())).all()),
                  f"xent forward disagrees with its plain version at N={n}")
            e_fwd = max(e_fwd, err.max().item())
        rdx = xent_dx_reference(rs, w, y[r], rlse, 1.0 / n)
        e_dx = max(e_dx, (dx[r] - rdx).abs().max().item())
        m_dx = max(m_dx, rdx.abs().max().item())
        pw, pb = xent_dw_reference(rs, x[r], y[r], rlse, 1.0 / n)
        rdw, rdb = rdw + pw, rdb + pb
    del x, s, dx
    torch.cuda.empty_cache()
    r_dw, r_db = rel_to_max(dw, rdw), rel_to_max(db, rdb)
    print(f"[kernel] xent N={n} d={d} V={v} f32 (65,537 row tiles, plain in "
          f"{XENT_EDGE_CHUNK}-row chunks): kernels 10, 11 max|dlse|,|dpicked|,|ds| {e_fwd:.3e} "
          f"(|err| <= {XENT_ROW_TOL:g}·(1+|plain|)); kernel 12 dx {e_dx / m_dx:.3e}, kernel 13 "
          f"dw {r_dw:.3e}, db {r_db:.3e} of max (tol {XENT_GRAD_REL:g}; plain dW, db summed "
          f"over the chunks)")
    check(e_dx <= XENT_GRAD_REL * m_dx, f"xent dx disagrees with its plain version at N={n}")
    check(r_dw <= XENT_GRAD_REL and r_db <= XENT_GRAD_REL,
          f"xent dw/db disagree with their plain version at N={n}")

    bsz, t, h, hd = FLASH_EDGE
    q, k, v_, do = (torch.randn((bsz, t, h, hd), generator=gen).cuda() for _ in range(4))
    o, lse = flash_forward_lse(q, k, v_, causal=True)
    ro, rlse = flash_forward_lse_reference(q, k, v_, causal=True)
    torch.cuda.synchronize()
    e_f = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
    check(e_f <= FLASH_TOL, f"flash forward disagrees with its plain version at B·H={bsz * h}")
    delta = (do * ro).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v_, do, rlse, delta)
    e_dq = _grad_err(flash_dq(*args, causal=True), flash_dq_reference(*args, causal=True))
    e_kv = max(_grad_err(a, c) for a, c in zip(flash_dkdv(*args, causal=True),
                                               flash_dkdv_reference(*args, causal=True)))
    print(f"[kernel] flash B={bsz} T={t} H={h} D={hd} causal (B·H = {bsz * h}): fwd max|err| "
          f"{e_f:.3e} (tol {FLASH_TOL:g}); dq {e_dq:.3e}, dk/dv {e_kv:.3e} (|err| <= "
          f"{GRAD_ATOL:g} + {GRAD_RTOL:g}·|plain|)")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 4


def teacher_forced_check(model, requests, streams, label: str,
                         tie_gap: float = TIE_GAP) -> int:
    """Hold every generated token against the argmax of a full forward
    (plain attention, no cache, no kernel) over prompt + the tokens
    before it; a mismatch must be a near-tie (top-2 gap < ``tie_gap``).
    Returns the mismatches."""
    import torch

    mismatches = 0
    with torch.inference_mode():
        for req in requests:
            toks = streams[req.rid]
            seq = torch.tensor(list(req.prompt) + toks[:-1], device=model.device)
            logits = model(seq[None])[0, len(req.prompt) - 1:]
            pick = torch.argmax(logits, dim=-1).tolist()
            gap = _top2_gap(logits)
            for i, (a, r) in enumerate(zip(toks, pick)):
                if a != r:
                    mismatches += 1
                    print(f"[serve] {label}: request {req.rid} token {i}: "
                          f"{a} vs full-forward {r}, top-2 gap {gap[i].item():.3e}")
                    check(gap[i].item() < tie_gap,
                          f"{label}: stream disagrees with the full forward off a near-tie")
    return mismatches


def compare_streams(model, requests, a, b, label: str, tie_gap: float = TIE_GAP) -> None:
    """Streams of two runs must match; a divergence is allowed only where
    the plain logits at the first differing token are a near-tie (top-2 gap
    under ``tie_gap``)."""
    import torch

    for req in requests:
        sa, sb = a[req.rid], b[req.rid]
        if sa == sb:
            continue
        i = next(j for j, (x, y) in enumerate(zip(sa, sb)) if x != y)
        seq = torch.tensor(list(req.prompt) + sa[:i], device=model.device)
        with torch.inference_mode():
            gap = _top2_gap(model(seq[None])[0, -1]).item()
        print(f"[serve] {label}: request {req.rid} diverges at token {i} "
              f"({sa[i]} vs {sb[i]}), plain top-2 gap {gap:.3e}")
        check(gap < tie_gap, f"{label}: streams diverge off a near-tie")


def expected_flash_calls(requests, chunk: int, layers: int) -> int:
    """Flash launches one prefill of these requests needs: chunk j of a
    prompt runs j+1 window blocks per layer (its last token is decoded,
    not prefilled)."""
    n = 0
    for req in requests:
        chunks = -(-(len(req.prompt) - 1) // chunk)
        n += layers * chunks * (chunks + 1) // 2
    return n


def expected_flash_calls_shared(requests, shared: dict, page_size: int, chunk: int,
                                layers: int) -> int:
    """Flash launches one prefill of these requests needs when request
    ``rid`` maps ``shared[rid]`` prefix pages: chunk j of a prompt runs j+1
    window blocks per layer, and the chunks below the shared pages run
    none."""
    n = 0
    for req in requests:
        chunks = -(-(len(req.prompt) - 1) // chunk)
        first = shared[req.rid] * page_size // chunk
        n += layers * sum(j + 1 for j in range(first, chunks))
    return n


def serve_phase(gen) -> dict[str, int]:
    import torch

    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.serve import ServeConfig, ServingEngine, poisson_workload

    model = TransformerLM(**SERVE_MODEL, device="cuda", generator=gen)
    requests, ledger = poisson_workload(
        WORKLOAD["n_requests"], float("inf"), 0, vocab_size=SERVE_MODEL["vocab_size"],
        prompt_len=WORKLOAD["prompt_len"], new_tokens=WORKLOAD["new_tokens"],
    )
    runs = (("unfused", {}), ("fused_head", {"fused_head": True}),
            ("fused_head_int8", {"fused_head": True, "weight_quant": "int8"}),
            ("unfused_int8_sim", {"weight_quant": "int8_sim"}))
    engines = {name: ServingEngine(model, ServeConfig(**SERVE_CFG, **kw), device="cuda")
               for name, kw in runs}
    for eng in engines.values():  # warm-up (library handles, allocator); not counted
        eng.run(requests[:2])
    torch.cuda.synchronize()

    reset_launch_counts()  # ---- the main path starts here
    reports, per_run = {}, {}
    for name, _ in runs:
        before = {k.name: k.launches for k in KERNELS}
        reports[name] = engines[name].run(requests)
        per_run[name] = {k.name: k.launches - before[k.name] for k in KERNELS}
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here

    streams = {}
    for name, _ in runs:
        rep = reports[name]
        lat = rep.latency_summary()
        print(f"[serve] {name}: {rep.generated_tokens} tokens, {rep.decode_steps} decode "
              f"steps, {rep.tokens_per_sec:.1f} tok/s, per-token p50/p99 "
              f"{lat['per_token_p50_s'] * 1e3:.3f}/{lat['per_token_p99_s'] * 1e3:.3f} ms, "
              f"ttft p50/p99 {lat['ttft_p50_s'] * 1e3:.1f}/{lat['ttft_p99_s'] * 1e3:.1f} ms, "
              f"launches {per_run[name]}")
        owed = sum(o["max_new_tokens"] for o in ledger.values())
        check(rep.generated_tokens == owed, f"{name}: generated {rep.generated_tokens} "
              f"tokens, the workload owes {owed}")
        streams[name] = {rid: st.tokens for rid, st in rep.requests.items()}
        check(all(0 <= t < SERVE_MODEL["vocab_size"] for s in streams[name].values()
                  for t in s), f"{name}: token out of range")

    flash_need = expected_flash_calls(requests, SERVE_CFG["prefill_chunk"],
                                      SERVE_MODEL["num_layers"])
    for name, _ in runs:
        got = per_run[name]
        check(got["flash_forward_lse"] == flash_need,
              f"{name}: {got['flash_forward_lse']} flash launches, prefill needs {flash_need}")
    steps = {name: reports[name].decode_steps for name, _ in runs}
    check(per_run["fused_head"]["fused_decode_head"] == steps["fused_head"],
          "fused f32 head must launch once per decode step")
    check(per_run["fused_head_int8"]["fused_decode_head_int8"] == steps["fused_head_int8"],
          "fused int8 head must launch once per decode step")
    check(launches["fused_decode_head"] == steps["fused_head"]
          and launches["fused_decode_head_int8"] == steps["fused_head_int8"],
          "head kernels launched outside their runs")
    print(f"[serve] launches on the main path: {launches} (flash per run {flash_need}, "
          f"one head launch = both passes of one decode step)")

    mism = teacher_forced_check(engines["unfused"].model, requests, streams["unfused"], "unfused")
    mism += teacher_forced_check(engines["fused_head"].model, requests,
                                 streams["fused_head"], "fused_head")
    mism += teacher_forced_check(engines["fused_head_int8"].model, requests,
                                 streams["fused_head_int8"], "fused_head_int8")
    compare_streams(model, requests, streams["unfused"], streams["fused_head"],
                    "fused_head vs unfused")
    compare_streams(engines["unfused_int8_sim"].model, requests,
                    streams["unfused_int8_sim"], streams["fused_head_int8"],
                    "fused_head_int8 vs unfused_int8_sim")
    print(f"[serve] streams hold against the teacher-forced full forward "
          f"({mism} near-tie mismatches) and across fused/unfused runs")
    return launches


SLO_SLOTS = 4  # the SLO run's budget: the cost model's step at 4 active slots
PAGE_SIZE = 16  # the paged runs' page (the prefix run's is the prefill chunk)
SPEC_K = 3
SPEC_DAMP = 0.25  # block parameters scaled as bench.py's spec row (bench.py:1036)
PREFIX_HEAD = 384  # tokens of the shared head: 3 pages of 128
PREFIX_WORKLOAD = dict(n_requests=8, tail=(16, 64), new_tokens=(16, 64))


def _serve_line(name: str, rep, launches: dict, extra: str = "") -> None:
    lat = rep.latency_summary()
    used = {k: v for k, v in launches.items() if v}
    print(f"[serve_levers] {name}: {rep.generated_tokens} tokens, {rep.decode_steps} "
          f"decode steps, {rep.tokens_per_sec:.1f} tok/s, per-token p50/p99 "
          f"{lat['per_token_p50_s'] * 1e3:.3f}/{lat['per_token_p99_s'] * 1e3:.3f} ms, "
          f"ttft p50/p99 {lat['ttft_p50_s'] * 1e3:.1f}/{lat['ttft_p99_s'] * 1e3:.1f} ms, "
          f"occupancy {rep.occupancy:.3f}, mean accepted {rep.mean_accepted_len:.3f}, "
          f"pool {rep.pool_stats}, launches {used}{extra}")


def _prefix_workload():
    """8 requests on one seeded 384-token head with seeded divergent tails."""
    import numpy as np

    from tpudml_torch.serve import Request

    rng = np.random.default_rng(7)
    v = SERVE_MODEL["vocab_size"]
    head = rng.integers(0, v, PREFIX_HEAD).astype(np.int32)
    lo, hi = PREFIX_WORKLOAD["tail"]
    nlo, nhi = PREFIX_WORKLOAD["new_tokens"]
    return [Request(rid=i, prompt=np.concatenate(
                [head, rng.integers(0, v, int(rng.integers(lo, hi + 1))).astype(np.int32)]),
                    max_new_tokens=int(rng.integers(nlo, nhi + 1)), arrival_time=0.0)
            for i in range(PREFIX_WORKLOAD["n_requests"])]


def serve_window_check(gen, rows: dict) -> None:
    """Kernel 1's bf16 twin at the block the serving levers give it,
    [1, 128, 8, 64] causal and not, against its plain version (BF16_REL of
    max on O, FLASH_TOL on lse; f32 at this block is flash_phase's). Then
    the paged prefill's window for both instances: chunk 3 (start 384) of
    a SERVE_MODEL layer, its K/V written through a scattered page table
    (page PAGE_SIZE, 2 kv heads), read back with ``read_row_prefix``,
    GQA-repeated and run through ``chunk_flash_window`` (4 launches),
    against the plain causal attention at the chunk's offset: f32 within
    |err| <= FLASH_TOL + FLASH_TOL·|plain|, bf16 within BF16_REL of max.
    Folds the errors into the rows (``at_serving_window``)."""
    import torch

    from tpudml_torch.nn.attention import chunk_flash_window, dot_product_attention
    from tpudml_torch.ops import (
        FLASH_FORWARD, FLASH_FORWARD_BF16, flash_forward_lse, flash_forward_lse_reference,
    )
    from tpudml_torch.serve.paged import init_pool, read_row_prefix, write_chunk

    c = SERVE_CFG["prefill_chunk"]
    h, kvh = SERVE_MODEL["num_heads"], SERVE_MODEL["num_kv_heads"]
    d = SERVE_MODEL["embed_dim"] // h
    start = 3 * c
    pages = (start + c) // PAGE_SIZE
    worst = {FLASH_FORWARD.name: 0.0, FLASH_FORWARD_BF16.name: 0.0}
    for causal in (True, False):
        q, k, v = (torch.randn((1, c, h, d), generator=gen).cuda().bfloat16() for _ in range(3))
        o, lse = flash_forward_lse(q, k, v, causal=causal)
        ro, rlse = flash_forward_lse_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        eo, el = rel_to_max(o, ro), (lse - rlse).abs().max().item()
        print(f"[serve_levers] {FLASH_FORWARD_BF16.name} B=1 T={c} H={h} D={d} "
              f"causal={causal}: O max|err|/max|plain| {eo:.3e}, max|dlse| {el:.3e} "
              f"(tol {BF16_REL:g} of max; lse {FLASH_TOL:g})")
        check(o.dtype == torch.bfloat16 and eo <= BF16_REL and el <= FLASH_TOL,
              f"bf16 flash forward disagrees with its plain version at the serving block "
              f"(causal={causal})")
        worst[FLASH_FORWARD_BF16.name] = max(worst[FLASH_FORWARD_BF16.name], el,
                                             (o.float() - ro.float()).abs().max().item())

    pool = init_pool(2 * pages + 1, PAGE_SIZE, kvh, d, "f32", "cuda")
    table_row = (torch.randperm(2 * pages, generator=gen)[:pages] + 1).cuda()
    kv = [[torch.randn((1, c, kvh, d), generator=gen).cuda() for _ in range(2)]
          for _ in range(start // c + 1)]
    for j, (k_new, v_new) in enumerate(kv):
        write_chunk(pool, k_new, v_new, table_row, j * c)
    written = [torch.cat([x[i] for x in kv], dim=1) for i in (0, 1)]
    for dtype, kernel in ((torch.float32, FLASH_FORWARD), (torch.bfloat16, FLASH_FORWARD_BF16)):
        k, v = read_row_prefix(pool, table_row, start + c, dtype)
        check(torch.equal(k, written[0].to(dtype)) and torch.equal(v, written[1].to(dtype)),
              "read_row_prefix does not give back the K/V written through the page table")
        k, v = (torch.repeat_interleave(x, h // kvh, dim=2) for x in (k, v))
        q = torch.randn((1, c, h, d), generator=gen).cuda().to(dtype)
        before = kernel.launches
        o = chunk_flash_window(q, k, v, start)
        n = kernel.launches - before
        ro = dot_product_attention(q, k, v, causal=True, q_offset=start)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        if dtype == torch.float32:
            ok = ((o - ro).abs() - FLASH_TOL * ro.abs()).max().item() <= FLASH_TOL
            tol = f"|err| <= {FLASH_TOL:g} + {FLASH_TOL:g}·|plain|"
        else:
            ok = rel_to_max(o, ro) <= BF16_REL
            tol = f"max|err|/max|plain| {rel_to_max(o, ro):.3e}, tol {BF16_REL:g} of max"
        print(f"[serve_levers] {kernel.name} paged prefill window: chunk [{start}, "
              f"{start + c}) over {start + c} rows read through a table of {pages} pages, "
              f"{n} launches, max|err| {err:.3e} ({tol})")
        check(n == start // c + 1, f"chunk_flash_window made {n} {kernel.name} launches, "
              f"its window needs {start // c + 1}")
        check(o.dtype == dtype and ok,
              f"{kernel.name}: the paged prefill window disagrees with the plain attention")
        worst[kernel.name] = max(worst[kernel.name], err)
    for name, err in worst.items():
        rows[name]["at_serving_window"] = err
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)


def serve_levers_phase(gen, rows: dict) -> dict[str, dict[str, int]]:
    """The serving levers at SERVE_MODEL's width (module docstring, phase
    4): first :func:`serve_window_check`, then each run, its launches its
    own path."""
    import torch

    serve_window_check(gen, rows)

    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.serve import (
        DecodeCostModel, ServeConfig, ServingEngine, SLOConfig, cache_bytes,
        poisson_workload, pool_bytes,
    )

    def lm(**kw):
        return TransformerLM(**SERVE_MODEL, device="cuda",
                             generator=torch.Generator().manual_seed(0), **kw)

    requests, ledger = poisson_workload(
        WORKLOAD["n_requests"], float("inf"), 0, vocab_size=SERVE_MODEL["vocab_size"],
        prompt_len=WORKLOAD["prompt_len"], new_tokens=WORKLOAD["new_tokens"],
    )
    prefix_reqs = _prefix_workload()
    chunk, layers = SERVE_CFG["prefill_chunk"], SERVE_MODEL["num_layers"]
    model = lm()
    damped = lm()
    with torch.no_grad():
        for name, p in damped.named_parameters():
            if name.startswith("block"):
                p.mul_(SPEC_DAMP)
    model_bf16 = lm(compute_dtype=torch.bfloat16)
    max_pages = -(-SERVE_CFG["max_len"] // PAGE_SIZE)
    probe = DecodeCostModel(model, ServeConfig(**SERVE_CFG),
                            SLOConfig(tpot_budget_s=1.0, hbm_gbps=H100_BYTES_PER_S / 1e9))
    slo = SLOConfig(tpot_budget_s=probe.step_seconds(SLO_SLOTS),
                    hbm_gbps=H100_BYTES_PER_S / 1e9)
    paged = dict(cache_layout="paged", page_size=PAGE_SIZE)
    runs = {  # path: (model, ServeConfig extras, workload)
        "serve_paged": (model, paged, requests),
        "serve_paged_starved": (model, dict(
            paged, num_pages=SERVE_CFG["slots"] * max_pages // 4 + 1), requests),
        "serve_prefix": (model, dict(cache_layout="paged", page_size=chunk,
                                     prefix_sharing=True), prefix_reqs),
        "serve_spec": (damped, dict(spec_k=SPEC_K), requests),
        "serve_spec_paged": (damped, dict(paged, spec_k=SPEC_K), requests),
        "serve_slo": (model, dict(slo=slo), requests),
        "serve_bf16": (model_bf16, {}, requests),
        "serve_bf16_fused_head": (model_bf16, dict(fused_head=True), requests),
        "serve_bf16_paged": (model_bf16, paged, requests),
    }

    def engine(m, kw):
        return ServingEngine(m, ServeConfig(**SERVE_CFG, **kw), device="cuda")

    def warmed(m, kw, wl):
        engine(m, kw).run(wl[:2])  # warm-up, on an engine of its own
        return engine(m, kw)

    # References, outside every counted window: the dense unfused runs on
    # the f32 and the damped weights, the prefix workload unshared.
    dense_eng = warmed(model, {}, requests)
    dense = dense_eng.run(requests)
    dense_mib = sum(cache_bytes(c) for c in dense_eng.caches) / 2**20
    dense_damped = warmed(damped, {}, requests).run(requests)
    unshared = warmed(model, dict(cache_layout="paged", page_size=chunk),
                      prefix_reqs).run(prefix_reqs)
    for name, rep in (("reference dense", dense), ("reference dense, damped", dense_damped),
                      ("reference prefix unshared", unshared)):
        _serve_line(name, rep, {})
    paths, reports = {}, {}
    for path, (m, kw, wl) in runs.items():
        eng = warmed(m, kw, wl)
        torch.cuda.synchronize()
        reset_launch_counts()  # ---- this path starts here
        reports[path] = eng.run(wl)
        paths[path] = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        extra = ""
        if kw.get("cache_layout") == "paged":
            extra = (f", pool {sum(pool_bytes(c) for c in eng.caches) / 2**20:.1f} MiB "
                     f"against the dense cache's {dense_mib:.1f} MiB")
        _serve_line(path, reports[path], paths[path], extra)
        owed = sum(r.max_new_tokens for r in wl)
        check(reports[path].generated_tokens == owed,
              f"{path}: generated {reports[path].generated_tokens} tokens, owes {owed}")
        check(all(st.finished is not None for st in reports[path].requests.values()),
              f"{path}: a request did not complete")

    def streams(rep):
        return {rid: st.tokens for rid, st in rep.requests.items()}

    flash_need = expected_flash_calls(requests, chunk, layers)
    for path in ("serve_paged", "serve_paged_starved", "serve_slo"):
        check(paths[path]["flash_forward_lse"] == flash_need,
              f"{path}: {paths[path]['flash_forward_lse']} flash launches, prefill needs "
              f"{flash_need}")
    for path in ("serve_paged", "serve_paged_starved", "serve_slo"):
        compare_streams(model, requests, streams(dense), streams(reports[path]),
                        f"{path} vs dense unfused")
    check(any(e[0] == "defer" for e in reports["serve_paged_starved"].events),
          "serve_paged_starved: no admission was deferred")

    rep = reports["serve_prefix"]
    shared = {rid: st.shared_pages for rid, st in rep.requests.items()}
    head_pages = PREFIX_HEAD // chunk
    check(rep.pool_stats["prefix_hits"] > 0, "serve_prefix: no prefix hit")
    check(shared == {r.rid: (0 if r.rid == 0 else head_pages) for r in prefix_reqs},
          f"serve_prefix: shared pages {shared}, the head implies {head_pages} from request 1")
    need = expected_flash_calls_shared(prefix_reqs, shared, chunk, chunk, layers)
    check(paths["serve_prefix"]["flash_forward_lse"] == need,
          f"serve_prefix: {paths['serve_prefix']['flash_forward_lse']} flash launches, the "
          f"unshared chunks need {need} (unshared run "
          f"{expected_flash_calls(prefix_reqs, chunk, layers)})")
    compare_streams(model, prefix_reqs, streams(unshared), streams(rep),
                    "serve_prefix vs unshared")

    draft_layers = layers // 2
    for path in ("serve_spec", "serve_spec_paged"):
        rep = reports[path]
        compare_streams(damped, requests, streams(dense_damped), streams(rep),
                        f"{path} vs dense on the same weights")
        check(rep.mean_accepted_len > 0, f"{path}: no draft token accepted")
        per_rid: dict[int, int] = {}
        for e in rep.events:
            if e[0] == "spec":
                per_rid[e[1]] = per_rid.get(e[1], 0) + e[4] + 1
        check(per_rid == {rid: len(st.tokens) for rid, st in rep.requests.items()},
              f"{path}: the spec events do not account for every committed token")
        need = flash_need + expected_flash_calls(requests, chunk, draft_layers)
        check(paths[path]["flash_forward_lse"] == need,
              f"{path}: {paths[path]['flash_forward_lse']} flash launches, the target's "
              f"and the draft's prefill need {need}")

    rep = reports["serve_slo"]
    live, most = set(), 0
    for e in rep.events:
        if e[0] == "admit":
            live.add(e[1])
            most = max(most, len(live))
        elif e[0] in ("evict", "expire"):
            live.discard(e[1])
    check(most <= SLO_SLOTS, f"serve_slo: {most} active slots, the budget allows {SLO_SLOTS}")
    check(any(e[0] == "defer" for e in rep.events), "serve_slo: no admission was deferred")
    again = engine(model, dict(slo=slo)).run(requests)
    check(repr(again.events).encode() == repr(rep.events).encode(),
          "serve_slo: a second run's event log differs")
    print(f"[serve_levers] serve_slo: budget {slo.tpot_budget_s * 1e6:.3f} us a step (the "
          f"cost model's {SLO_SLOTS}-slot step at {slo.hbm_gbps:.0f} GB/s), at most {most} "
          f"active slots, a second run's event log byte-identical")

    for path in ("serve_bf16", "serve_bf16_fused_head", "serve_bf16_paged"):
        got = paths[path]
        check(got["flash_forward_lse_bf16"] == flash_need and got["flash_forward_lse"] == 0,
              f"{path}: {got['flash_forward_lse_bf16']} bf16 flash launches "
              f"({got['flash_forward_lse']} f32), prefill needs {flash_need}")
        mism = teacher_forced_check(model_bf16, requests, streams(reports[path]), path,
                                    BF16_TIE_GAP)
        print(f"[serve_levers] {path}: streams hold against the bf16 full forward "
              f"({mism} near-tie mismatches, gap < {BF16_TIE_GAP:g})")
    check(paths["serve_bf16_fused_head"]["fused_decode_head"]
          == reports["serve_bf16_fused_head"].decode_steps,
          "serve_bf16_fused_head: the f32 head must launch once a decode step")
    print(f"[serve_levers] flash per run {flash_need}, the spec runs add the draft's "
          f"{expected_flash_calls(requests, chunk, draft_layers)}; owed "
          f"{sum(o['max_new_tokens'] for o in ledger.values())} tokens a run")
    return paths


# ------------------------------------------------------------ phase 5


def _grads(loss_fn, model, tokens, labels):
    """(loss, {name: f32 gradient}) of one loss evaluation."""
    import torch

    from tpudml_torch.train import params_of

    params = params_of(model)
    loss, _ = loss_fn(tokens, labels)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), {n: g.float() for n, g in zip(params, grads)}


def _worst(got: dict, want: dict, scale: dict) -> tuple[float, str]:
    """(largest max |got − want| / max |scale|, its parameter's name)."""
    return max((((got[n] - want[n]).abs().max()
                 / scale[n].abs().max().clamp_min(1e-30)).item(), n) for n in want)


def _train_run(ts, step, batches):
    """One step per batch ([B, T+1] token rows): (losses, ms/step over the
    steps after the first, the warm-up)."""
    import torch

    losses, t0 = [], None
    for i, batch in enumerate(batches):
        ts, metrics = step(ts, batch[:, :-1], batch[:, 1:])
        losses.append(metrics["loss"])
        if i == 0:  # warm-up step done
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    return [float(x) for x in losses], ms


def train_phase(config: dict = TRAIN_MODEL, per_step: dict = PER_STEP,
                tag: str = "train") -> dict[str, int]:
    """Main path 2: the training slice at full width (module docstring,
    phase 5), or the same path on another ``config`` with its launches
    ``per_step`` (phase 5b, the wide trunk). Returns the launch counts of
    the kernel run."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam
    from tpudml_torch.train import TrainState, make_loss_fn, make_train_step

    kernel_model = TransformerLM(**config, impl="flash", fused_ln=True, device="cuda",
                                 generator=torch.Generator().manual_seed(1))
    plain_model = TransformerLM(**config, impl="full", fused_ln=False, device="cuda",
                                generator=torch.Generator().manual_seed(2))
    plain_model.load_state_dict(kernel_model.state_dict())  # one initial state
    n_params = sum(p.numel() for p in kernel_model.parameters())
    t, v = config["max_len"], config["vocab_size"]
    seqs = synthetic_lm(4 * TRAIN_BATCH, t, v, seed=0)
    rng = np.random.default_rng(0)  # task5's row sampling
    batches = [seqs[rng.integers(0, len(seqs), size=TRAIN_BATCH)] for _ in range(TRAIN_STEPS)]

    # Step-1 gradients of both models from the initial state (before the
    # counted run; the optimizer is not involved).
    tokens, labels = (torch.from_numpy(x).long().cuda()
                      for x in (batches[0][:, :-1], batches[0][:, 1:]))
    grads = {name: _grads(make_loss_fn(model), model, tokens, labels)[1]
             for name, model in (("kernel", kernel_model), ("plain", plain_model))}
    worst, worst_name = _worst(grads["kernel"], grads["plain"], grads["plain"])
    print(f"[{tag}] step-1 gradients, kernel vs plain run: worst max|err|/max|plain| "
          f"{worst:.3e} ({worst_name}; tol {STEP_GRAD_RTOL:g}) over {len(grads['plain'])} "
          f"parameters, {n_params} values")
    check(worst <= STEP_GRAD_RTOL, f"step-1 gradient {worst_name} disagrees with the plain run")
    del grads, tokens, labels

    def train(model):
        opt = Adam(lr=TRAIN_LR)
        return _train_run(TrainState.create(model, opt), make_train_step(model, opt), batches)

    reset_launch_counts()  # ---- the main path starts here
    k_losses, k_ms = train(kernel_model)
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    p_losses, p_ms = train(plain_model)
    check({k.name: k.launches for k in KERNELS} == launches,
          "the plain run launched a kernel")
    for name, n in launches.items():
        need = TRAIN_STEPS * per_step.get(name, 0)
        check(n == need, f"{tag} launched {name} {n} times, {TRAIN_STEPS} steps need {need}")
    tok = TRAIN_BATCH * t
    for label, losses, ms in (("kernel (flash + fused add+LN)", k_losses, k_ms),
                              ("plain (full attention, unfused LN)", p_losses, p_ms)):
        print(f"[{tag}] {label}: losses {' '.join(f'{x:.6f}' for x in losses)}; "
              f"{ms:.2f} ms/step, {tok / ms * 1e3:.0f} tokens/s (steady state, "
              f"{TRAIN_STEPS - 1} steps after one warm-up)")
    check(all(np.isfinite(k_losses + p_losses)), "a training loss is not finite")
    diffs = [abs(a - b) for a, b in zip(k_losses, p_losses)]
    print(f"[{tag}] per-step |loss difference| {' '.join(f'{x:.2e}' for x in diffs)} "
          f"(tol {LOSS_TOL:g}); launches {launches} = {TRAIN_STEPS} x {per_step}")
    check(max(diffs) <= LOSS_TOL, "training losses disagree with the plain run")
    return launches


def train_wide_phase() -> dict[str, int]:
    """Phase 5b: phase 5's path on the wide trunk (WIDE_MODEL), whose
    add+LN rows are wider than the narrow instances hold."""
    import torch

    from tpudml_torch.ops.layernorm_kernel import REGISTER_DIM, layernorm_plan

    d, tokens = WIDE_MODEL["embed_dim"], TRAIN_BATCH * WIDE_MODEL["max_len"]
    check(d > REGISTER_DIM, f"the wide trunk's d={d} takes the narrow LayerNorm instances")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = layernorm_plan(tokens, d, 4, True, sms, backward=True)
    print(f"[train_wide] d={d} > {REGISTER_DIM}: add+LN rows [{tokens}, {d}] take the "
          f"{plan.instance} instances (backward G={plan.blocks} on {sms} SMs)")
    return train_phase(WIDE_MODEL, WIDE_PER_STEP, "train_wide")


# ------------------------------------------------------------ phase 6


def flagship_phase() -> dict[str, dict[str, int]]:
    """Main path 3: the flagship step (module docstring, phase 6). Returns
    the launch counts of the bf16 kernel run ("flagship") and of the
    no-grad evaluation ("eval")."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import AdamW
    from tpudml_torch.train import (
        TrainState, make_lm_fused_loss_fn, make_lm_fused_train_step, make_loss_fn,
        make_train_step,
    )

    t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
    batch = synthetic_lm(TRAIN_BATCH, t, v, seed=1)  # bench.py:351-352
    tokens, labels = (torch.from_numpy(x).long().cuda() for x in (batch[:, :-1], batch[:, 1:]))

    def model(seed, **kw):
        return TransformerLM(**TRAIN_MODEL, **kw, device="cuda",
                             generator=torch.Generator().manual_seed(seed))

    kernel_model = model(3, impl="flash", fused_ln=True, compute_dtype=torch.bfloat16)
    state = kernel_model.state_dict()

    # (a) f32 gradients through the fused head vs the materialized logits.
    f32_model = model(4, impl="flash", fused_ln=True)
    f32_model.load_state_dict(state)
    lf, g_fused = _grads(make_lm_fused_loss_fn(f32_model, save_scores=True), f32_model,
                         tokens, labels)
    lm, g_f32 = _grads(make_loss_fn(f32_model), f32_model, tokens, labels)
    worst, name = _worst(g_fused, g_f32, g_f32)
    print(f"[flagship] (a) f32 step-1 gradients, fused head vs materialized logits: worst "
          f"max|err|/max|plain| {worst:.3e} ({name}; tol {STEP_GRAD_RTOL:g}); losses "
          f"{lf:.6f} vs {lm:.6f} (tol {LOSS_TOL:g})")
    check(worst <= STEP_GRAD_RTOL, f"f32 fused-head gradient {name} disagrees")
    check(abs(lf - lm) <= LOSS_TOL, "f32 fused-head loss disagrees")
    del f32_model, g_fused
    torch.cuda.empty_cache()

    # (b) the bf16 flagship against the kernel-free bf16 step.
    plain_model = model(5, impl="full", fused_ln=False, compute_dtype=torch.bfloat16)
    plain_model.load_state_dict(state)
    _, g_kernel = _grads(make_lm_fused_loss_fn(kernel_model, save_scores=True), kernel_model,
                         tokens, labels)
    _, g_plain = _grads(make_loss_fn(plain_model), plain_model, tokens, labels)
    wk, nk = _worst(g_kernel, g_f32, g_f32)
    wp, np_ = _worst(g_plain, g_f32, g_f32)
    wkp, nkp = _worst(g_kernel, g_plain, g_plain)
    print(f"[flagship] (b) bf16 step-1 gradients vs the f32 ones: kernel run {wk:.3e} ({nk}), "
          f"plain run {wp:.3e} ({np_}) of max (tol {BF16_STEP_GRAD_RTOL:g}); kernel vs plain "
          f"{wkp:.3e} ({nkp}; tol {BF16_PAIR_GRAD_RTOL:g})")
    check(max(wk, wp) <= BF16_STEP_GRAD_RTOL, "a bf16 step-1 gradient is off the f32 one")
    check(wkp <= BF16_PAIR_GRAD_RTOL, f"bf16 gradient {nkp}: kernel and plain runs disagree")
    del g_kernel, g_plain, g_f32
    torch.cuda.empty_cache()

    def run(m, fused):
        opt = AdamW(lr=FLAGSHIP_LR)
        step = (make_lm_fused_train_step(m, opt, save_scores=True) if fused
                else make_train_step(m, opt))
        return _train_run(TrainState.create(m, opt), step, [batch] * FLAGSHIP_STEPS)

    reset_launch_counts()  # ---- main path 3 starts here
    k_losses, k_ms = run(kernel_model, True)
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    p_losses, p_ms = run(plain_model, False)
    check({k.name: k.launches for k in KERNELS} == launches, "the plain bf16 run launched a kernel")
    for name, n in launches.items():
        need = FLAGSHIP_STEPS * FLAGSHIP_PER_STEP.get(name, 0)
        check(n == need, f"the flagship launched {name} {n} times, {FLAGSHIP_STEPS} steps "
              f"need {need}")
    tok = TRAIN_BATCH * t
    for label, losses, ms in (("kernel (bf16 flash, fused add+LN, fused xent head)",
                               k_losses, k_ms),
                              ("plain (bf16 full attention, unfused LN, materialized logits)",
                               p_losses, p_ms)):
        print(f"[flagship] {label}: losses {' '.join(f'{x:.6f}' for x in losses)}; "
              f"{ms:.2f} ms/step, {tok / ms * 1e3:.0f} tokens/s (steady state, "
              f"{FLAGSHIP_STEPS - 1} steps after one warm-up)")
    check(all(np.isfinite(k_losses + p_losses)), "a flagship loss is not finite")
    diffs = [abs(a - b) for a, b in zip(k_losses, p_losses)]
    print(f"[flagship] per-step |loss difference| {' '.join(f'{x:.2e}' for x in diffs)} "
          f"(tol {BF16_LOSS_TOL:g}); launches {launches} = {FLAGSHIP_STEPS} x "
          f"{FLAGSHIP_PER_STEP}")
    check(max(diffs) <= BF16_LOSS_TOL, "flagship losses disagree with the plain bf16 run")
    del plain_model
    torch.cuda.empty_cache()

    # (c) an evaluation loss under no_grad: kernel 10.
    reset_launch_counts()  # ---- the evaluation path starts here
    with torch.no_grad():
        fused_eval, _ = make_lm_fused_loss_fn(kernel_model, save_scores=True)(tokens, labels)
    eval_launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    with torch.no_grad():
        mat_eval, _ = make_loss_fn(kernel_model)(tokens, labels)
    diff = abs(fused_eval.item() - mat_eval.item())
    print(f"[flagship] (c) no-grad loss through kernel 10 {fused_eval.item():.6f} vs "
          f"materialized bf16 logits {mat_eval.item():.6f}: |diff| {diff:.2e} (tol "
          f"{BF16_LOSS_TOL:g}); launches {dict((k, n) for k, n in eval_launches.items() if n)}")
    check(eval_launches["xent_fwd"] == 1 and eval_launches["xent_fwd_save"] == 0,
          "the no-grad loss did not run kernel 10 alone")
    check(diff <= BF16_LOSS_TOL, "kernel 10's loss disagrees with the materialized loss")
    return {"flagship": launches, "eval": eval_launches}


# ------------------------------------------------------------ phase 6b


DP_SPLIT_STEPS = 3  # the split step's run; every step's comm span is checked
DP_TASK5 = ["--parallel", "dp", "--n_devices", "1", "--vocab", "32768", "--embed_dim", "512",
            "--num_heads", "4", "--num_layers", "6", "--seq_len", "1024", "--batch_size", "8",
            "--attn", "flash", "--fused_ln", "--rope", "--fused_xent", "--steps", "8",
            "--log_every", "1", "--lr", "1e-3"]
DP_BENCH = ["--device", "cuda", "--iters", "20"]
# Where the single-card step does not repeat itself, the world-1 DP run
# may differ from it by at most this many times the gap between two
# single-card runs (in losses and in parameters).
DP_GAP_MULT = 4


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _bitwise(a: dict, b: dict) -> bool:
    import torch

    return all(torch.equal(a[n], b[n]) for n in a)


def dp_phase() -> dict[str, dict[str, int]]:
    """Main path 3b: the flagship step data-parallel at world 1 over NCCL
    (module docstring, phase 6b). Returns the launch counts of the DP
    flagship run ("dp") and of the split step ("dp_split")."""
    import contextlib
    import io
    import math
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch.comm import AGGREGATORS, bench
    from tpudml_torch.core import DistributedConfig, process_count, process_group
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam, AdamW
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.tasks import task5_longcontext as task5
    from tpudml_torch.tools.profile_train import collective_breakdown, describe_aggregation
    from tpudml_torch.train import TrainState, make_lm_fused_train_step

    t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
    batch = synthetic_lm(TRAIN_BATCH, t, v, seed=1)  # the flagship phase's
    bf16 = dict(compute_dtype=torch.bfloat16)

    def model(seed, **kw):
        return TransformerLM(**TRAIN_MODEL, **kw, device="cuda",
                             generator=torch.Generator().manual_seed(seed))

    with tempfile.TemporaryDirectory() as tmp, process_group(
            DistributedConfig(coordinator_address=f"file://{tmp}/store", num_processes=1),
            device="cuda") as group:
        check(torch.distributed.get_backend(group) == "nccl", "the DP group is not NCCL's")
        check(process_count(group) == 1, "the DP group is not one rank")
        print(f"[dp] world 1: a one-rank NCCL group (torch.distributed, file store); "
              f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}")

        # (1) Does the single-card flagship step repeat itself bitwise?
        def single():
            m = model(3, impl="flash", fused_ln=True, **bf16)
            opt = AdamW(lr=FLAGSHIP_LR)
            losses, ms = _train_run(TrainState.create(m, opt),
                                    make_lm_fused_train_step(m, opt, save_scores=True),
                                    [batch] * FLAGSHIP_STEPS)
            return losses, ms, _params(m)

        s1_losses, s1_ms, s1_params = single()
        s2_losses, s2_ms, s2_params = single()
        repeats = s1_losses == s2_losses and _bitwise(s1_params, s2_params)
        print(f"[dp] single-card flagship step repeats itself bitwise over {FLAGSHIP_STEPS} "
              f"steps: {repeats}")
        torch.cuda.empty_cache()

        # (2) The DP flagship: the launches of its run are the path's.
        dp_model = model(3, impl="full", fused_ln=True, **bf16)
        check(_bitwise(_params(dp_model), _params(model(3, impl="flash", fused_ln=True, **bf16))),
              "the DP and single-card models start apart")
        dp = DataParallel(dp_model, AdamW(lr=FLAGSHIP_LR), group, fused_xent=True,
                          save_scores=True, flash_attn=True)
        check(dp_model.impl == "flash", "flash_attn did not swap the trunk")
        ts = dp.create_state()
        reset_launch_counts()  # ---- main path 3b starts here
        d_losses, d_ms = _train_run(ts, dp.make_train_step(), [batch] * FLAGSHIP_STEPS)
        launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        d_params = _params(dp_model)
        for name, n in launches.items():
            need = FLAGSHIP_STEPS * FLAGSHIP_PER_STEP.get(name, 0)
            check(n == need, f"the DP flagship launched {name} {n} times, {FLAGSHIP_STEPS} "
                  f"steps need {need}")
        print(f"[dp] DP flagship losses {' '.join(f'{x:.6f}' for x in d_losses)}; single-card "
              f"{' '.join(f'{x:.6f}' for x in s1_losses)}; launches {launches} = "
              f"{FLAGSHIP_STEPS} x {FLAGSHIP_PER_STEP}")
        if repeats:
            check(d_losses == s1_losses, "world-1 DP losses differ from the single-card step's")
            check(_bitwise(d_params, s1_params), "world-1 DP parameters differ from the "
                  "single-card step's")
            print("[dp] world-1 DP step equals the single-card step bitwise (losses and all "
                  f"{len(d_params)} parameters)")
        else:
            def gaps(losses, params):
                return (max(abs(a - b) for a, b in zip(losses, s1_losses)),
                        max((params[n] - s1_params[n]).abs().max().item() for n in params))

            (ldiff, worst), (lgap, pgap) = gaps(d_losses, d_params), gaps(s2_losses, s2_params)
            print(f"[dp] the single-card step is not deterministic (two runs differ by "
                  f"|loss| {lgap:.2e}, |param| {pgap:.2e}): world-1 DP vs single |loss diff| "
                  f"{ldiff:.2e}, max |param diff| {worst:.2e} (tol {DP_GAP_MULT} x the gap)")
            check(ldiff <= DP_GAP_MULT * lgap and worst <= DP_GAP_MULT * pgap,
                  "world-1 DP disagrees with the single-card step")
        check(all(np.isfinite(d_losses)), "a DP flagship loss is not finite")

        # The collective alone on the flagship's gradients (52.5M f32).
        grads, _ = dp.local_grads(ts, batch[:, :-1], batch[:, 1:])
        nbytes = sum(g.numel() * g.element_size() for g in grads.values())
        for name, aggregator in AGGREGATORS.items():
            agg = lambda aggregator=aggregator: aggregator(grads, group)  # noqa: E731
            wall = cuda_ms(agg, iters=20, warmup=3)
            p = collective_breakdown(agg, 20)
            print(f"[dp] world 1 {name} of the flagship gradients ({len(grads)} tensors, "
                  f"{nbytes / 1e6:.1f} MB f32): {wall:.4f} ms a call (CUDA events); "
                  f"{describe_aggregation(p)}")
            check(p["dispatched"] >= 1, f"the world-1 {name} dispatched no collective")
        print(f"[dp] world 1 flagship step: DP {d_ms:.2f} ms/step vs single-card "
              f"{s1_ms:.2f}, {s2_ms:.2f} ms/step (steady state, {FLAGSHIP_STEPS - 1} steps)")
        del dp, dp_model, ts, grads, s1_params, s2_params, d_params
        torch.cuda.empty_cache()

        # (3) The split step (measure_comm, materialized logits, f32) against
        # the fused one on the training phase's config and batches.
        seqs = synthetic_lm(4 * TRAIN_BATCH, t, v, seed=0)
        rng = np.random.default_rng(0)
        batches = [seqs[rng.integers(0, len(seqs), size=TRAIN_BATCH)]
                   for _ in range(DP_SPLIT_STEPS)]

        def dp_run(measure_comm):
            m = model(1, impl="full", fused_ln=True)
            eng = DataParallel(m, Adam(lr=TRAIN_LR), group, measure_comm=measure_comm,
                               flash_attn=True)
            losses, ms = _train_run(eng.create_state(), eng.make_train_step(), batches)
            return losses, ms, eng.comm_stats, _params(m)

        reset_launch_counts()  # ---- the split step's path starts here
        sp_losses, sp_ms, stats, sp_params = dp_run(True)
        split_launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        fu_losses, fu_ms, _, fu_params = dp_run(False)
        for name, n in split_launches.items():
            need = DP_SPLIT_STEPS * PER_STEP.get(name, 0)
            check(n == need, f"the split step launched {name} {n} times, need {need}")
        print(f"[dp] split step (measure_comm, f32, flash, fused add+LN): losses "
              f"{' '.join(f'{x:.6f}' for x in sp_losses)} vs fused DP step "
              f"{' '.join(f'{x:.6f}' for x in fu_losses)}; {stats.calls} comm spans "
              f"{' '.join(f'{x * 1e3:.3f}' for x in stats.per_call_s)} ms; {sp_ms:.2f} vs "
              f"{fu_ms:.2f} ms/step; {stats.report()}")
        check(stats.calls == DP_SPLIT_STEPS, "the split step did not record a span a step")
        check(all(x > 0 for x in stats.per_call_s), "a comm span is not positive")
        check(sp_losses == fu_losses, "split-step losses differ from the fused step's")
        check(_bitwise(sp_params, fu_params), "split-step parameters differ from the fused "
              "step's")
        print(f"[dp] split step equals the fused DP step bitwise (losses and all "
              f"{len(sp_params)} parameters)")
        del sp_params, fu_params
        torch.cuda.empty_cache()

        # (4) task5 --parallel dp at world 1.
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = task5.main(DP_TASK5 + ["--log_dir", f"{tmp}/logs"])
        steps = [float(line.split()[-1]) for line in out.getvalue().splitlines()
                 if line.startswith("step ")]
        print(f"[dp] task5 --parallel dp: {out.getvalue().splitlines()[-1]}; losses "
              f"{' '.join(f'{x:.4f}' for x in steps)}")
        check(res["devices"] == 1, "task5 --parallel dp did not report one device")
        check(len(steps) == 8 and steps[-1] < steps[0] and math.isfinite(steps[-1]),
              "task5 --parallel dp did not learn")
        torch.cuda.empty_cache()

        # (5) comm.bench at world 1, every aggregator.
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            recs = bench.main(DP_BENCH)
        for rec in recs:
            print(f"[dp] comm.bench world {rec['world']} {rec['strategy']} "
                  f"{rec['elements']} f32: {rec['mean_ms']:.4f} ms")
        check({r["strategy"] for r in recs} == {"allreduce", "allgather", "reducescatter"}
              and all(r["world"] == 1 and r["mean_ms"] > 0 for r in recs),
              "comm.bench did not time every aggregator at world 1")
    check(not torch.distributed.is_initialized(), "the DP group outlived its phase")
    return {"dp": launches, "dp_split": split_launches}


# ------------------------------------------------------------ phase 7


def long_phase() -> dict[str, int]:
    """Main path 4: long-context training through task5's engine with the
    lean head (module docstring, phase 7). Returns the launch counts of
    the lean run."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.ops.xent_kernel import _auto_save_s
    from tpudml_torch.tasks import task5_longcontext as task5
    from tpudml_torch.train import make_lm_fused_loss_fn, make_loss_fn

    args = task5.parse_args(LONG_TASK5)
    b, t, v = args.batch_size, args.seq_len, args.vocab
    ts, step = task5.build_engine(args, torch.device("cuda"))
    lean_auto = args._save_scores is None and not _auto_save_s(b * t, v, 256, 2048)
    print(f"[long] task5 {' '.join(LONG_TASK5)}: N = B·T = {b * t}, V = {v}; save_scores "
          f"{args._save_scores} resolves to {'lean' if lean_auto else 'saved scores'}")
    check(lean_auto, "the long-context --fused_xent did not resolve to the lean head")
    sargs = task5.parse_args(LONG_TASK5 + ["--fused_xent_scores"])
    sts, sstep = task5.build_engine(sargs, torch.device("cuda"))
    sts.model.load_state_dict(ts.model.state_dict())  # one initial state
    seqs = synthetic_lm(4 * b, t, v, seed=args.seed)
    rng = np.random.default_rng(args.seed)  # task5's row sampling
    batches = [seqs[rng.integers(0, len(seqs), size=b)] for _ in range(LONG_STEPS)]

    # Step-1 gradients from the initial state, before the counted run.
    tokens, labels = (torch.from_numpy(x).long().cuda()
                      for x in (batches[0][:, :-1], batches[0][:, 1:]))
    l_lean, g_lean = _grads(make_lm_fused_loss_fn(ts.model, args._save_scores), ts.model,
                            tokens, labels)
    l_saved, g_saved = _grads(make_lm_fused_loss_fn(sts.model, True), sts.model,
                              tokens, labels)
    worst, name = _worst(g_lean, g_saved, g_saved)
    print(f"[long] step-1 gradients, lean vs saved-scores head: worst max|err|/max|saved| "
          f"{worst:.3e} ({name}; tol {STEP_GRAD_RTOL:g}); losses {l_lean:.6f} vs "
          f"{l_saved:.6f}")
    check(worst <= STEP_GRAD_RTOL, f"lean step-1 gradient {name} disagrees with saved scores")
    check(abs(l_lean - l_saved) <= LOSS_TOL, "lean and saved-scores losses disagree")
    del g_saved
    torch.cuda.empty_cache()
    l_mat, g_mat = _grads(make_loss_fn(ts.model), ts.model, tokens, labels)
    head = [n for n in g_mat if n.startswith("head.")]
    w_head, n_head = _worst({n: g_lean[n] for n in head}, {n: g_mat[n] for n in head}, g_mat)
    w_all, n_all = _worst(g_lean, g_mat, g_mat)
    print(f"[long] step-1 gradients, lean vs materialized logits: head worst "
          f"{w_head:.3e} ({n_head}), all parameters {w_all:.3e} ({n_all}; tol "
          f"{STEP_GRAD_RTOL:g}); losses {l_lean:.6f} vs {l_mat:.6f} (tol {LOSS_TOL:g})")
    check(w_all <= STEP_GRAD_RTOL, f"lean step-1 gradient {n_all} disagrees with the "
          "materialized logits")
    check(abs(l_lean - l_mat) <= LOSS_TOL, "lean and materialized-logits losses disagree")
    del g_lean, g_mat, tokens, labels
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # ---- main path 4 starts here
    l_losses, l_ms = _train_run(ts, step, batches)
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    lean_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s_losses, s_ms = _train_run(sts, sstep, batches)
    saved_peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        need = LONG_STEPS * LONG_PER_STEP.get(name, 0)
        check(n == need, f"long-context training launched {name} {n} times, "
              f"{LONG_STEPS} steps need {need}")
    tok = b * t
    for label, losses, ms, peak in (("lean head (kernels 10, 14, 15)", l_losses, l_ms,
                                     lean_peak),
                                    ("saved-scores head (kernels 11, 12, 13)", s_losses,
                                     s_ms, saved_peak)):
        print(f"[long] {label}: losses {' '.join(f'{x:.6f}' for x in losses)}; {ms:.2f} "
              f"ms/step, {tok / ms * 1e3:.0f} tokens/s (steady state, {LONG_STEPS - 1} "
              f"steps after one warm-up); peak {peak / 2**30:.3f} GiB")
    check(all(np.isfinite(l_losses + s_losses)), "a long-context loss is not finite")
    diffs = [abs(a - c) for a, c in zip(l_losses, s_losses)]
    gap = saved_peak - lean_peak
    print(f"[long] per-step |loss difference| {' '.join(f'{x:.2e}' for x in diffs)} (tol "
          f"{LOSS_TOL:g}); peak gap {gap / 2**30:.3f} GiB (need >= "
          f"{LEAN_MEM_GAP / 2**30:g}); launches {launches} = {LONG_STEPS} x {LONG_PER_STEP}")
    check(max(diffs) <= LOSS_TOL, "lean and saved-scores training losses disagree")
    check(gap >= LEAN_MEM_GAP, "the lean run's peak memory is not 3 GiB under the "
          "saved-scores run's: the O(N) contract does not hold")
    return launches


# ------------------------------------------------------------ phase 8


def ln_op_phase(gen) -> dict[str, int]:
    """The plain LayerNorm op path (module docstring, phase 8). Returns
    its launch counts."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import KERNELS, fused_layernorm, reset_launch_counts

    n, d = LN_SHAPE
    x, dy = (torch.randn((n, d), generator=gen).cuda() for _ in range(2))
    scale = (1 + 0.1 * torch.randn((d,), generator=gen)).cuda()
    bias = (0.1 * torch.randn((d,), generator=gen)).cuda()
    got = {}
    reset_launch_counts()  # ---- the op path starts here
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [x.to(dtype).requires_grad_(), scale.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
        y = fused_layernorm(*leaves)
        got[dtype] = (y, *torch.autograd.grad(y, leaves, dy.to(dtype)))
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    need = {"layernorm_fwd": 1, "layernorm_bwd": 1, "layernorm_fwd_bf16": 1,
            "layernorm_bwd_bf16": 1}
    check(launches == {k.name: need.get(k.name, 0) for k in KERNELS},
          f"the LayerNorm op path launched {launches}, not {need}")
    for dtype, (y, dx, dg, db) in got.items():
        leaves = [x.to(dtype).float().requires_grad_(), scale.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
        ry = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)
        rdx, rdg, rdb = torch.autograd.grad(ry, leaves, dy.to(dtype).float())
        bf16 = dtype == torch.bfloat16
        ey, edx = ((rel_to_max(y, ry), rel_to_max(dx, rdx)) if bf16 else
                   ((y - ry).abs().max().item(), (dx - rdx).abs().max().item()))
        ecol = max(rel_to_max(dg, rdg), rel_to_max(db, rdb))
        tol = BF16_REL if bf16 else LN_ROW_TOL
        print(f"[ln_op] fused_layernorm [{n}, {d}] {str(dtype)[6:]} vs F.layer_norm: y "
              f"{ey:.3e}, dx {edx:.3e} ({'of max, ' if bf16 else ''}tol {tol:g}); "
              f"dgamma/dbeta {ecol:.3e} of max (tol {LN_COL_RTOL:g})")
        check(y.dtype == dx.dtype == dtype and ey <= tol and edx <= tol
              and ecol <= LN_COL_RTOL, f"fused_layernorm disagrees with F.layer_norm "
              f"({dtype})")
    print(f"[ln_op] launches {dict((k, c) for k, c in launches.items() if c)}")
    return launches


# ------------------------------------------------------------ phase 9


def _set_ragged_dw(model, ragged_dw: str) -> None:
    for block in model.blocks():
        block.moe.ragged_dw = ragged_dw


def moe_phase() -> dict[str, int]:
    """Main path 5: bench_moe's six rows (module docstring, phase 9).
    Returns the launch counts of the six runs together."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import AdamW
    from tpudml_torch.tools.profile_train import MOE_VARIANTS
    from tpudml_torch.train import TrainState, make_loss_fn, make_train_step_body

    t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
    batch = torch.from_numpy(synthetic_lm(TRAIN_BATCH, t, v, seed=3)).long().cuda()  # bench.py:604
    tokens, labels = batch[:, :-1], batch[:, 1:]

    def model(e, **kw):
        return TransformerLM(**MOE_MODEL, moe_experts=e, **kw, compute_dtype=torch.bfloat16,
                             device="cuda", generator=torch.Generator().manual_seed(6))

    # Step-1 gradients: grouped-dW backward vs the stock one, same weights.
    for e in MOE_EXPERTS:
        m = model(e, moe_dispatch="ragged")
        lg, gg = _grads(make_loss_fn(m), m, tokens, labels)
        _set_ragged_dw(m, "stock")
        ls, gs = _grads(make_loss_fn(m), m, tokens, labels)
        worst, name = _worst(gg, gs, gs)
        dw = [n for n in gg if ".moe.experts.w" in n]
        wdw, ndw = _worst({n: gg[n] for n in dw}, {n: gs[n] for n in dw}, gs)
        print(f"[moe] E={e} step-1, ragged grouped-dW vs stock backward: losses {lg:.6f} vs "
              f"{ls:.6f}; gradients worst max|err|/max|stock| {worst:.3e} ({name}; tol "
              f"{BF16_PAIR_GRAD_RTOL:g}), of dW1/dW2 {wdw:.3e} ({ndw})")
        check(lg == ls, "grouped and stock ragged losses differ: the forward is the same code")
        check(worst <= BF16_PAIR_GRAD_RTOL, f"grouped-dW gradient {name} disagrees with stock")
        del m, gg, gs
        torch.cuda.empty_cache()

    reset_launch_counts()  # ---- main path 5 starts here
    per_run, results = {}, {}
    for e in MOE_EXPERTS:
        for variant, kw in MOE_VARIANTS.items():
            m = model(e, **kw)
            opt = AdamW(lr=MOE_LR)
            step = make_train_step_body(m, opt)
            before = {k.name: k.launches for k in KERNELS}
            results[(e, variant)] = _train_run(TrainState.create(m, opt), step,
                                               [batch] * MOE_STEPS)
            per_run[(e, variant)] = {k.name: k.launches - before[k.name] for k in KERNELS}
            del m, opt, step
            torch.cuda.empty_cache()
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    tok = TRAIN_BATCH * t
    for (e, variant), (losses, ms) in results.items():
        got = per_run[(e, variant)]
        per_step = dict(MOE_PER_STEP)
        if variant == "ragged_grouped":  # dW1 and dW2 of every layer
            per_step["grouped_dw_bf16"] = 2 * TRAIN_MODEL["num_layers"]
        need = {name: MOE_STEPS * n for name, n in per_step.items()}
        print(f"[moe] E={e} {variant}: losses {' '.join(f'{x:.6f}' for x in losses)}; "
              f"{ms:.2f} ms/step, {tok / ms * 1e3:.0f} tokens/s (eager, one card, no fori; "
              f"{MOE_STEPS - 1} steps after one warm-up); launches "
              f"{dict((k, c) for k, c in got.items() if c)}")
        check(all(np.isfinite(losses)), f"a MoE loss is not finite (E={e}, {variant})")
        check(got == {k.name: need.get(k.name, 0) for k in KERNELS},
              f"MoE E={e} {variant} launched {got}, {MOE_STEPS} steps need {need}")
    return launches


# ------------------------------------------------------------ phase 10


def moe_f32_phase() -> dict[str, int]:
    """Main path 6: f32 MoE training through task5 (module docstring,
    phase 10). Returns its launch counts."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.tasks import task5_longcontext as task5
    from tpudml_torch.train import make_loss_fn

    args = task5.parse_args(MOE_F32_TASK5)
    b, t, v = args.batch_size, args.seq_len, args.vocab
    ts, step = task5.build_engine(args, torch.device("cuda"))
    seqs = synthetic_lm(4 * b, t, v, seed=args.seed)
    rng = np.random.default_rng(args.seed)  # task5's row sampling
    batches = [seqs[rng.integers(0, len(seqs), size=b)] for _ in range(MOE_F32_STEPS)]
    tokens, labels = (torch.from_numpy(x).long().cuda()
                      for x in (batches[0][:, :-1], batches[0][:, 1:]))
    lg, gg = _grads(make_loss_fn(ts.model), ts.model, tokens, labels)
    _set_ragged_dw(ts.model, "stock")
    ls, gs = _grads(make_loss_fn(ts.model), ts.model, tokens, labels)
    _set_ragged_dw(ts.model, "grouped")
    worst, name = _worst(gg, gs, gs)
    print(f"[moe_f32] task5 {' '.join(MOE_F32_TASK5)}: step-1 grouped-dW vs stock backward: "
          f"losses {lg:.6f} vs {ls:.6f}; gradients worst max|err|/max|stock| {worst:.3e} "
          f"({name}; tol {STEP_GRAD_RTOL:g})")
    check(lg == ls, "f32 grouped and stock ragged losses differ")
    check(worst <= STEP_GRAD_RTOL, f"f32 grouped-dW gradient {name} disagrees with stock")
    del gg, gs, tokens, labels
    torch.cuda.empty_cache()

    reset_launch_counts()  # ---- main path 6 starts here
    losses, ms = _train_run(ts, step, batches)
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    need = {k.name: MOE_F32_STEPS * MOE_F32_PER_STEP.get(k.name, 0) for k in KERNELS}
    print(f"[moe_f32] losses {' '.join(f'{x:.6f}' for x in losses)}; {ms:.2f} ms/step, "
          f"{b * t / ms * 1e3:.0f} tokens/s (eager, one card; {MOE_F32_STEPS - 1} steps after "
          f"one warm-up); launches {dict((k, c) for k, c in launches.items() if c)}")
    check(all(np.isfinite(losses)), "an f32 MoE loss is not finite")
    check(launches == need, f"the f32 MoE path launched {launches}, not {need}")
    return launches


# ------------------------------------------------------------ phase 11

# The north star (tasks/north_star.py; bench.py:200-246 bench_resnet):
# ResNet-18 at CIFAR width, bf16 compute over f32 masters, SGD 0.1 / 0.9.
RESNET_BATCH = 1024  # bench.py:215, the per-chip batch
RESNET_CHECK_BATCH = 16  # card against the CPU (step 2), bf16 against f32 (step 3)
RESNET_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
RESNET_SGD = dict(lr=0.1, momentum=0.9)
# Step 1: an f32 3x3 conv at 512 input channels (4608-term sums) against the
# same conv in f64, within TF32_CONV_REL of max |f64|; TF32 keeps 10 bits
# of each operand and misses that by about 100 times.
TF32_CONV_REL = 1e-5
# Steps 2 and 3 compare two runs of the model with the second replaying the
# first's ReLU masks (``relu_masks``): an input that rounds to the other
# side of 0 in one run moves a gradient by that element's share (on the
# CPU, two such flips between the port's f32 and f64 runs move one conv
# kernel's gradient by 5.6% of its max), and the replay leaves the
# rounding alone to compare.
# Step 2 (f32, the card against the port's CPU run): logits and the BN
# statistics after the forward within RESNET_F32_REL of max |CPU|, each
# parameter's step-1 gradient within STEP_GRAD_RTOL of its max |CPU| (f32
# sums over up to 16·32·32 rows a channel and 4608-term windows in another
# order; on the CPU the port's f32 run lies within 6.1e-6 of its f64 run).
RESNET_F32_REL = 1e-4
# Step 3 (bf16 against f32 on the card, the f32 run replaying the bf16
# run's masks): each parameter's step-1 gradient within
# RESNET_BF16_GRAD_REL of the f32 one in norm, all of them together within
# RESNET_BF16_ALL_REL (on the CPU 0.051 and 0.024: bf16 rounds every
# activation to 8 bits, and a BatchNorm parameter's gradient is a sum that
# mostly cancels); logits within RESNET_BF16_LOGIT_REL of max |f32| (CPU:
# 1.6e-2).
RESNET_BF16_GRAD_REL = 0.1
RESNET_BF16_ALL_REL = 0.05
RESNET_BF16_LOGIT_REL = 3e-2
# Step 6: the north star's entry at its defaults for one epoch (390 steps
# of 128 on the 50000-image synthetic CIFAR split); chance is 0.1.
NORTH_STAR_EPOCH_STEPS = 50000 // 128
NORTH_STAR_ACC_FLOOR = 0.5


@contextlib.contextmanager
def relu_masks(replay=None):
    """Record each ``tpudml_torch.nn.layers.relu`` the model calls as its
    ``x > 0`` mask, into the yielded list; or, given ``replay`` (such a
    list), apply those masks instead: ``x · mask``, whose gradient is the
    mask."""
    from tpudml_torch.nn import layers

    relu, masks = layers.relu, []
    masks_in = None if replay is None else iter(replay)

    def patched(x, *args, **kw):
        if masks_in is not None:
            return x * next(masks_in).to(x.device)
        masks.append(x.detach() > 0)
        return relu(x, *args, **kw)

    layers.relu = patched
    try:
        yield masks
    finally:
        layers.relu = relu


def _image_run(ts, step, images, labels, steps: int):
    """``steps`` steps on one batch: (losses, ms/step over the steps after
    the first, the warm-up)."""
    import torch

    losses, t0 = [], None
    for i in range(steps):
        ts, metrics = step(ts, images, labels)
        losses.append(metrics["loss"])
        if i == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    return [float(x) for x in losses], (time.perf_counter() - t0) * 1e3 / (steps - 1)


def _state(model) -> dict:
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


def resnet_phase() -> dict[str, int]:
    """Main path 7, the north star (module docstring, phase 11). Returns its
    launch counts: none, as no kernel of the port lies on it."""
    import io
    import math
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from tpudml_torch.core import DistributedConfig, process_count, process_group
    from tpudml_torch.data import synthetic_classification
    from tpudml_torch.models import ResNet18
    from tpudml_torch.nn import Conv2D
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Sgd
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.tasks import north_star
    from tpudml_torch.train import TrainState, make_loss_fn, make_train_step, params_of

    reset_launch_counts()  # ---- the resnet path starts here
    gen = torch.Generator().manual_seed(11)

    # (1) TF32 is off for convolutions.
    conv = Conv2D(512, 512, 3, 1, "SAME", use_bias=False, generator=gen).cuda()
    x = torch.randn(8, 512, 16, 16, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        want = F.conv2d(x.double(), conv.kernel.double(), padding=1)
        err = rel_to_max(conv(x), want)
        torch.backends.cudnn.allow_tf32 = True
        tf32_err = rel_to_max(conv(x), want)
        torch.backends.cudnn.allow_tf32 = False
    print(f"[resnet] f32 3x3 conv, 512 -> 512 channels, 16x16: max|err|/max|f64| {err:.3e} "
          f"(tol {TF32_CONV_REL:g}); with cuDNN's TF32 allowed {tf32_err:.3e}")
    check(err <= TF32_CONV_REL, "an f32 convolution runs in TF32")
    del conv, x, want

    # (2) The card against the port's CPU run, f32.
    images, labels = synthetic_classification(RESNET_CHECK_BATCH, (32, 32, 3), 10, seed=0)

    def model(device, dtype=torch.float32):
        return ResNet18(compute_dtype=dtype, device=device,
                        generator=torch.Generator().manual_seed(3))

    def step1(m, replay=None):
        """(logits, BN buffers after the forward, step-1 gradients, masks)."""
        dev = next(m.parameters()).device
        x, y = torch.from_numpy(images).to(dev), torch.from_numpy(labels).long().to(dev)
        with relu_masks(replay) as masks:
            loss, logits = make_loss_fn(m)(x, y)
            grads = torch.autograd.grad(loss, list(params_of(m).values()))
        return (logits.detach().float().cpu(),
                {n: b.detach().cpu() for n, b in m.named_buffers()},
                {n: g.float().cpu() for n, g in zip(params_of(m), grads)}, masks)

    card = step1(model("cuda"))
    with torch.no_grad(), relu_masks() as cpu_masks:
        model("cpu")(torch.from_numpy(images))
    flips = sum(int((a.cpu() != b).sum()) for a, b in zip(card[3], cpu_masks))
    cpu = step1(model("cpu"), replay=card[3])
    logit_err = rel_to_max(card[0], cpu[0])
    buf_err, buf_name = _worst(card[1], cpu[1], cpu[1])
    grad_err, grad_name = _worst(card[2], cpu[2], cpu[2])
    n_masked = sum(m.numel() for m in card[3])
    print(f"[resnet] ResNet-18 f32, batch {RESNET_CHECK_BATCH}, card vs the port's CPU run "
          f"(the card's ReLU masks replayed; {flips} of {n_masked} ReLU inputs round to the "
          f"other side of 0 unreplayed): logits {logit_err:.3e}, BN statistics {buf_err:.3e} "
          f"({buf_name}) (tol {RESNET_F32_REL:g}); step-1 gradients worst max|err|/max|cpu| "
          f"{grad_err:.3e} ({grad_name}; tol {STEP_GRAD_RTOL:g}) over {len(cpu[2])} parameters")
    check(logit_err <= RESNET_F32_REL, "f32 logits on the card disagree with the CPU's")
    check(buf_err <= RESNET_F32_REL, f"BN statistic {buf_name} disagrees with the CPU's")
    check(grad_err <= STEP_GRAD_RTOL, f"step-1 gradient {grad_name} disagrees with the CPU's")
    del cpu, cpu_masks

    # (3) bf16 against f32 on the card.
    bf = step1(model("cuda", torch.bfloat16))
    f32 = step1(model("cuda"), replay=bf[3])

    def norm_rel(got, want):
        return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()

    per = {n: norm_rel(bf[2][n], f32[2][n]) for n in f32[2]}
    worst_name = max(per, key=per.get)
    flat = lambda g: torch.cat([t.flatten() for t in g.values()])  # noqa: E731
    all_rel = norm_rel(flat(bf[2]), flat(f32[2]))
    natural = norm_rel(flat(bf[2]), flat(card[2]))
    logit_err = rel_to_max(bf[0], card[0])
    print(f"[resnet] bf16 vs f32 on the card (the bf16 run's ReLU masks replayed in f32): "
          f"step-1 gradients |err|/|f32| worst {per[worst_name]:.3e} ({worst_name}; tol "
          f"{RESNET_BF16_GRAD_REL:g}), all {all_rel:.3e} (tol {RESNET_BF16_ALL_REL:g}; "
          f"unreplayed {natural:.3e}); logits {logit_err:.3e} (tol {RESNET_BF16_LOGIT_REL:g})")
    check(per[worst_name] <= RESNET_BF16_GRAD_REL, f"bf16 gradient {worst_name} is off f32")
    check(all_rel <= RESNET_BF16_ALL_REL, "bf16 gradients are off f32")
    check(logit_err <= RESNET_BF16_LOGIT_REL, "bf16 logits are off f32")
    del card, bf, f32
    torch.cuda.empty_cache()

    # (4) The single-card bf16 step at bench_resnet's batch, twice from one seed.
    x, y = synthetic_classification(RESNET_BATCH, (32, 32, 3), 10, seed=0)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).long().cuda()

    def single():
        m = model("cuda", torch.bfloat16)
        opt = Sgd(**RESNET_SGD)
        torch.cuda.reset_peak_memory_stats()
        losses, ms = _image_run(TrainState.create(m, opt), make_train_step(m, opt), x, y,
                                RESNET_STEPS)
        return losses, ms, _state(m), torch.cuda.max_memory_allocated() / 1e9

    s1_losses, s1_ms, s1_state, peak = single()
    s2_losses, s2_ms, s2_state, _ = single()
    repeats = s1_losses == s2_losses and _bitwise(s1_state, s2_state)
    print(f"[resnet] single-card bf16 step, batch {RESNET_BATCH}, SGD 0.1 / 0.9: losses "
          f"{' '.join(f'{v:.6f}' for v in s1_losses)}; {s1_ms:.2f}, {s2_ms:.2f} ms/step, "
          f"{RESNET_BATCH / s1_ms * 1e3:.0f}, {RESNET_BATCH / s2_ms * 1e3:.0f} imgs/s (steady "
          f"state, {RESNET_STEPS - 1} steps after one warm-up), peak {peak:.2f} GB; repeats "
          f"itself bitwise: {repeats}")
    check(all(np.isfinite(s1_losses)), "a single-card ResNet loss is not finite")

    # (5) DataParallel at world 1, from the same weights and batch.
    with tempfile.TemporaryDirectory() as tmp, process_group(
            DistributedConfig(coordinator_address=f"file://{tmp}/store", num_processes=1),
            device="cuda") as group:
        check(torch.distributed.get_backend(group) == "nccl" and process_count(group) == 1,
              "the DP group is not a one-rank NCCL group")
        m = model("cuda", torch.bfloat16)
        dp = DataParallel(m, Sgd(**RESNET_SGD), group, stacked_batches=True)
        d_losses, d_ms = _image_run(dp.create_state(), dp.make_train_step(), x[None], y[None],
                                    RESNET_STEPS)
        d_state = _state(m)
        del dp, m
    print(f"[resnet] DataParallel world 1 (one-rank NCCL group): losses "
          f"{' '.join(f'{v:.6f}' for v in d_losses)}; {d_ms:.2f} ms/step, "
          f"{RESNET_BATCH / d_ms * 1e3:.0f} imgs/s at world 1")
    if repeats:
        check(d_losses == s1_losses, "world-1 DP losses differ from the single-card step's")
        check(_bitwise(d_state, s1_state), "world-1 DP parameters or BN buffers differ from "
              "the single-card step's")
        print(f"[resnet] world-1 DP step equals the single-card step bitwise (losses, "
              f"{len(d_state)} parameters and buffers)")
    else:
        def gaps(losses, state):
            return (max(abs(a - b) for a, b in zip(losses, s1_losses)),
                    max((state[n].float() - s1_state[n].float()).abs().max().item()
                        for n in state))

        (ldiff, worst), (lgap, pgap) = gaps(d_losses, d_state), gaps(s2_losses, s2_state)
        print(f"[resnet] the single-card step is not deterministic (two runs differ by |loss| "
              f"{lgap:.2e}, |param or buffer| {pgap:.2e}): world-1 DP vs single |loss diff| "
              f"{ldiff:.2e}, max |diff| {worst:.2e} (tol {DP_GAP_MULT} x the gap)")
        check(ldiff <= DP_GAP_MULT * lgap and worst <= DP_GAP_MULT * pgap,
              "world-1 DP disagrees with the single-card step")
    del x, y, s1_state, s2_state, d_state
    torch.cuda.empty_cache()

    # (6) The north star's entry, one epoch at its defaults.
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
        metrics = north_star.main(["--epochs", "1", "--log_dir", f"{tmp}/logs"])
    lines = out.getvalue().splitlines()
    losses = [float(ln.split()[-1]) for ln in lines if ln.startswith("epoch ")]
    print(f"[resnet] north star (python -m tpudml_torch.tasks.north_star --epochs 1, world "
          f"{metrics['world']}): {lines[-1]}; {metrics['steps']} steps in "
          f"{metrics['train_time_s']:.1f} s; logged losses {losses[0]:.4f} ... "
          f"{losses[-1]:.4f} (every 20 steps)")
    check(metrics["steps"] == NORTH_STAR_EPOCH_STEPS, "the north star's epoch is not 390 steps")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          "the north star's loss did not fall")
    check(metrics["test_accuracy"] >= NORTH_STAR_ACC_FLOOR,
          f"the north star's test accuracy {metrics['test_accuracy']} is under "
          f"{NORTH_STAR_ACC_FLOOR}")
    check(not torch.distributed.is_initialized(), "the north star's group outlived its run")

    # (7) No kernel of the port lies on this path.
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    print(f"[resnet] launches on the path: {sum(launches.values())} (every kernel 0)")
    check(not any(launches.values()), f"the resnet path launched a kernel: {launches}")
    return launches


# ------------------------------------------------------------ phase 12

# Expert parallelism (slice 8): task5 --parallel ep at MOE_F32_TASK5's width
# with the gather dispatch (EP ships static capacity buffers; ragged is
# single-shard), against --parallel single with the same flags.
EP_TASK5 = ["--parallel", "ep", "--attn", "flash", "--fused_ln", "--rope", "--moe_experts", "8",
            "--moe_dispatch", "gather", "--vocab", "32768", "--embed_dim", "512",
            "--num_heads", "4", "--num_layers", "6", "--seq_len", "1024", "--batch_size", "8",
            "--lr", "0.001"]
EP_STEPS = 3
EP_PER_STEP = {"flash_forward_lse": 6, "flash_dq": 6, "flash_dkdv": 6,
               "add_layernorm_fwd": 12, "add_layernorm_bwd": 12}


def ep_phase() -> dict[str, int]:
    """Main path 8: expert parallelism at world 1 over NCCL (module
    docstring, phase 12). Returns the launch counts of the EP run."""
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch.comm import all_to_all
    from tpudml_torch.core import DistributedConfig, process_count, process_group
    from tpudml_torch.core.dist import collective_device
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.nn.moe import MoELayer
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.tasks import task5_longcontext as task5

    ep_args = task5.parse_args(EP_TASK5)
    single_args = task5.parse_args(EP_TASK5 + ["--parallel", "single"])
    b, t, v = ep_args.batch_size, ep_args.seq_len, ep_args.vocab
    seqs = synthetic_lm(4 * b, t, v, seed=ep_args.seed)
    rng = np.random.default_rng(ep_args.seed)  # task5's row sampling
    batches = [seqs[rng.integers(0, len(seqs), size=b)] for _ in range(EP_STEPS)]
    cuda = torch.device("cuda")

    def run(args):
        torch.cuda.reset_peak_memory_stats()
        ts, step = task5.build_engine(args, cuda)
        losses, ms = _train_run(ts, step, batches)
        return losses, ms, _params(ts.model), torch.cuda.max_memory_allocated() / 1e9

    # (1) Does the single-card gather step repeat itself bitwise?
    s1_losses, s1_ms, s1_params, s1_peak = run(single_args)
    s2_losses, s2_ms, s2_params, s2_peak = run(single_args)
    repeats = s1_losses == s2_losses and _bitwise(s1_params, s2_params)
    print(f"[ep] task5 {' '.join(EP_TASK5)}: the single-card gather step (--parallel single) "
          f"repeats itself bitwise over {EP_STEPS} steps: {repeats}")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp, process_group(
            DistributedConfig(coordinator_address=f"file://{tmp}/store", num_processes=1),
            device="cuda") as group:
        check(torch.distributed.get_backend(group) == "nccl", "the EP group is not NCCL's")
        check(process_count(group) == 1, "the EP group is not one rank")
        print(f"[ep] world 1: a one-rank NCCL group (torch.distributed, file store); "
              f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}")

        # (2) The EP step: the launches of its run are the path's.
        reset_launch_counts()  # ---- main path 8 starts here
        e_losses, e_ms, e_params, e_peak = run(ep_args)
        launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        need = {k.name: EP_STEPS * EP_PER_STEP.get(k.name, 0) for k in KERNELS}
        print(f"[ep] world 1 EP losses {' '.join(f'{x:.6f}' for x in e_losses)}; single-card "
              f"{' '.join(f'{x:.6f}' for x in s1_losses)}; launches "
              f"{dict((k, c) for k, c in launches.items() if c)} = {EP_STEPS} x {EP_PER_STEP}")
        check(launches == need, f"the EP path launched {launches}, not {need}")
        check(all(np.isfinite(e_losses)), "an EP loss is not finite")
        if repeats:
            check(e_losses == s1_losses, "world-1 EP losses differ from the single-card step's")
            check(_bitwise(e_params, s1_params), "world-1 EP parameters differ from the "
                  "single-card step's")
            print(f"[ep] world-1 EP step equals the single-card step bitwise (losses and all "
                  f"{len(e_params)} parameters)")
        else:
            def gaps(losses, params):
                return (max(abs(a - b) for a, b in zip(losses, s1_losses)),
                        max((params[n] - s1_params[n]).abs().max().item() for n in params))

            (ldiff, worst), (lgap, pgap) = gaps(e_losses, e_params), gaps(s2_losses, s2_params)
            print(f"[ep] the single-card step is not deterministic (two runs differ by |loss| "
                  f"{lgap:.2e}, |param| {pgap:.2e}): world-1 EP vs single |loss diff| "
                  f"{ldiff:.2e}, max |param diff| {worst:.2e} (tol {DP_GAP_MULT} x the gap)")
            check(ldiff <= DP_GAP_MULT * lgap and worst <= DP_GAP_MULT * pgap,
                  "world-1 EP disagrees with the single-card step")
        print(f"[ep] world 1 EP step {e_ms:.2f} ms/step, {b * t / e_ms * 1e3:.0f} tokens/s, "
              f"peak {e_peak:.2f} GB; single-card gather step {s1_ms:.2f}, {s2_ms:.2f} ms/step, "
              f"peak {s1_peak:.2f}, {s2_peak:.2f} GB (eager, {EP_STEPS - 1} steps after one "
              f"warm-up)")
        del e_params, s1_params, s2_params
        torch.cuda.empty_cache()

        # (3) The differentiable all_to_all on the NCCL group at the dispatch's
        # [E, C, d] (C = B·T·capacity factor / E), forward and backward,
        # against its plain version: the tiled chunk/concat on one rank.
        e, d = ep_args.moe_experts, ep_args.embed_dim
        c = MoELayer(1, e, capacity_factor=2.0)._capacity(b * t)  # TransformerLM's default
        dev = collective_device(group)
        gen = torch.Generator(device=dev).manual_seed(12)
        x = torch.randn(e, c, d, device=dev, generator=gen, requires_grad=True)
        w = torch.randn(e, c, d, device=dev, generator=gen)
        y = all_to_all(x, group, split_axis=0, concat_axis=1)
        (y * w).sum().backward()
        back = all_to_all(y.detach(), group, split_axis=1, concat_axis=0)
        plain_y = torch.cat(x.detach().chunk(1, dim=0), dim=1)
        plain_dx = torch.cat(w.chunk(1, dim=1), dim=0)
        ms = cuda_ms(lambda: all_to_all(x.detach(), group, split_axis=0, concat_axis=1))
        print(f"[ep] differentiable all_to_all on NCCL at world 1, [E, C, d] = [{e}, {c}, {d}] "
              f"f32 ({x.numel() * 4 / 1e6:.1f} MB): forward = plain {torch.equal(y, plain_y)}, "
              f"backward = the plain inverse {torch.equal(x.grad, plain_dx)}, round trip "
              f"{torch.equal(back, x.detach())}; {ms:.4f} ms a call (CUDA events)")
        check(torch.equal(y, plain_y) and y.shape == (e, c, d),
              "the all_to_all forward disagrees with its plain version")
        check(torch.equal(x.grad, plain_dx), "the all_to_all backward is not the plain inverse")
        check(torch.equal(back, x.detach()), "the inverse all_to_all does not bring x back")
    check(not torch.distributed.is_initialized(), "the EP group outlived its phase")
    return launches


# ------------------------------------------------------------ phase 13

# The lab tasks (slice 9) on the synthetic MNIST split written as u8 IDX
# files. JAX's own test floors: test accuracy > 0.5, > 0.4 with
# --measure_comm (tests/test_task1.py:27, tests/test_task2.py:29,50).
LABS_ACC_FLOOR = 0.5
LABS_COMM_FLOOR = 0.4
TASK1_TEST_LR = "1e-3"  # tests/test_task1.py's lr (the reference lr does not learn this set)
TASK3_FLAGS = ["--lr", "0.01", "--momentum", "0.9"]  # task2's reference lr and momentum
LABS_BUSY_ITERS = 30


def _lab(module, argv: list[str]) -> tuple[dict, list[str]]:
    """``module.main(argv)`` with its stdout captured: (metrics, lines)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = module.main(argv)
    return metrics, out.getvalue().splitlines()


def _write_mnist_idx(root) -> int:
    """The synthetic MNIST splits quantized to u8, written as torchvision's
    ``MNIST/raw`` IDX files under ``root``; returns the bytes written."""
    import numpy as np

    from tpudml_torch.data import load_mnist, write_idx

    raw = root / "MNIST" / "raw"
    raw.mkdir(parents=True)
    nbytes = 0
    for split, stem in (("train", "train"), ("test", "t10k")):
        ds = load_mnist(str(root / "none"), split, storage="f32")  # the synthetic fallback
        images = (ds.images[..., 0] * 255.0).round().astype(np.uint8)
        write_idx(raw / f"{stem}-images-idx3-ubyte", images)
        write_idx(raw / f"{stem}-labels-idx1-ubyte", ds.labels.astype(np.uint8))
        nbytes += images.nbytes + len(ds.labels)
    return nbytes


def labs_phase() -> dict[str, int]:
    """Main path 9, the lab tasks (module docstring, phase 13). Returns its
    launch counts: none, as no kernel of the port lies on it."""
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch import native
    from tpudml_torch.core import DistributedConfig, process_count, process_group
    from tpudml_torch.core.prng import seed_key
    from tpudml_torch.data import load_mnist, synthetic_classification
    from tpudml_torch.models import LeNet
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import ReferenceAdam, Sgd
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.tasks import task1, task1_mlp, task2, task3
    from tpudml_torch.tools.profile_serve import _measure
    from tpudml_torch.train import TrainState, make_train_step

    reset_launch_counts()  # ---- the labs path starts here
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # (1) The native data plane and the IDX files.
        t0 = time.perf_counter()
        check(native.available(), "the native data plane is not built")
        nbytes = _write_mnist_idx(root)
        train = load_mnist(tmp, "train")
        idx = np.random.default_rng(0).integers(0, len(train), size=256)
        got = train.gather(idx)
        want = train.images[idx].astype(np.float32) * train.scale
        print(f"[labs] native data plane {native._LIB_PATH.name} built and loaded; synthetic "
              f"MNIST written as u8 IDX ({nbytes / 1e6:.1f} MB) and read back as "
              f"{train.name} {train.images.dtype} {train.images.shape} in "
              f"{time.perf_counter() - t0:.1f} s; fused gather of 256 rows = numpy's "
              f"{np.array_equal(got[0], want)}")
        check(train.name == "mnist-train" and train.images.dtype == np.uint8
              and len(train) == 60000, "the u8 IDX files did not load as MNIST")
        check(np.array_equal(got[0], want) and np.array_equal(got[1], train.labels[idx]),
              "the native gather disagrees with numpy")
        common = ["--data_dir", tmp, "--log_dir", f"{tmp}/logs", "--device", "cuda"]

        def report(tag, m, lines, batch, world=1):
            ms = m["train_time_s"] * 1e3 / m["steps"]
            print(f"[labs] {tag}: test accuracy {m['test_accuracy']:.4f}, {m['steps']} steps "
                  f"in {m['train_time_s']:.2f} s: {ms:.3f} ms/step, "
                  f"{batch * world * m['steps'] / m['train_time_s']:.0f} imgs/s "
                  f"(world {world}); last line: {lines[-1]}")

        # (2) task1: reference defaults, then the JAX test's lr.
        for tag, extra in (("task1 reference defaults (adam_ref, lr 5e-4*sqrt(200))", []),
                           (f"task1 --lr {TASK1_TEST_LR}", ["--lr", TASK1_TEST_LR])):
            m, lines = _lab(task1, common + ["--log_every", "100"] + extra)
            report(tag, m, lines, 200)
            check(m["steps"] == 300 and np.isfinite(m["loss"]), f"{tag} did not run its epoch")
        check(m["test_accuracy"] > LABS_ACC_FLOOR, "task1 is under its floor")

        # (3) task1_mlp, one epoch.
        m, lines = _lab(task1_mlp, common + ["--epochs", "1", "--log_every", "0"])
        report("task1_mlp --epochs 1 (Model API, SGD 0.01, batch 32)", m, lines, 32)
        check(m["steps"] == 1875 and m["test_accuracy"] > LABS_ACC_FLOOR,
              "task1_mlp is under its floor")

        # (4) task2 at world 1, each aggregation, then the comm-timed split step.
        task2_ms = {}
        for agg in ("allreduce", "allgather", "reducescatter"):
            m, lines = _lab(task2, common + ["--epochs", "1", "--log_every", "0",
                                             "--aggregation", agg])
            report(f"task2 --aggregation {agg}", m, lines, 32)
            task2_ms[agg] = m["train_time_s"] * 1e3 / m["steps"]
            check(m["world"] == 1 and m["test_accuracy"] > LABS_ACC_FLOOR,
                  f"task2 {agg} is under its floor")
        m, lines = _lab(task2, common + ["--epochs", "1", "--log_every", "0",
                                         "--measure_comm"])
        report("task2 --measure_comm", m, lines, 32)
        print(f"[labs] task2 --measure_comm: {lines[-2]}")
        check(m["comm_time_s"] > 0 and m["test_accuracy"] > LABS_COMM_FLOOR,
              "task2 --measure_comm is under its floor or timed no communication")

        # (5) task3, each division.
        for division in ("partition", "sampling"):
            m, lines = _lab(task3, common + ["--epochs", "1", "--log_every", "0",
                                             "--division", division] + TASK3_FLAGS)
            report(f"task3 --division {division} {' '.join(TASK3_FLAGS)}", m, lines, 32)
            check(m["test_accuracy"] > LABS_ACC_FLOOR, f"task3 {division} is under its floor")
    check(not torch.distributed.is_initialized(), "a lab's group outlived its run")

    # (6) The world-1 DP LeNet step against the single-card step, and the
    # busy share of task1's and task2's steps.
    batches = [synthetic_classification(32, (28, 28, 1), 10, seed=i) for i in range(3)]

    def lenet():
        return LeNet(device="cuda", generator=torch.Generator().manual_seed(0))

    def run(m, step, ts, stacked):
        losses = [step(ts, x[None] if stacked else x, y[None] if stacked else y)[1]["loss"]
                  for x, y in batches]
        return [float(v) for v in losses], _params(m)

    singles = []
    for _ in range(2):
        m = lenet()
        opt = Sgd(lr=0.01, momentum=0.9)
        singles.append(run(m, make_train_step(m, opt), TrainState.create(m, opt), False))
    (s1_losses, s1_params), (s2_losses, s2_params) = singles
    repeats = s1_losses == s2_losses and _bitwise(s1_params, s2_params)
    x1, y1 = synthetic_classification(200, (28, 28, 1), 10, seed=5)
    m = lenet()
    opt = ReferenceAdam(lr=1e-3)
    ts, step = TrainState.create(m, opt), make_train_step(
        m, opt, rng_root=seed_key(0).fold_in(0x0D0))
    busy1 = _measure(lambda: step(ts, x1, y1), LABS_BUSY_ITERS)
    with tempfile.TemporaryDirectory() as tmp, process_group(
            DistributedConfig(coordinator_address=f"file://{tmp}/store", num_processes=1),
            device="cuda") as group:
        check(torch.distributed.get_backend(group) == "nccl" and process_count(group) == 1,
              "the labs DP group is not a one-rank NCCL group")
        m = lenet()
        dp = DataParallel(m, Sgd(lr=0.01, momentum=0.9), group, stacked_batches=True)
        d_losses, d_params = run(m, dp.make_train_step(), dp.create_state(), True)
        dts, dstep = dp.create_state(), dp.make_train_step()
        x2, y2 = batches[0][0][None], batches[0][1][None]
        busy2 = _measure(lambda: dstep(dts, x2, y2), LABS_BUSY_ITERS)
    if repeats:
        check(d_losses == s1_losses and _bitwise(d_params, s1_params),
              "the world-1 DP LeNet step differs from the single-card step")
        print(f"[labs] world-1 DP LeNet step (SGD 0.01 / 0.9, batch 32, one-rank NCCL group) "
              f"equals the single-card step bitwise over {len(batches)} steps (losses and all "
              f"{len(d_params)} parameters)")
    else:
        lgap = max(abs(a - b) for a, b in zip(s1_losses, s2_losses))
        pgap = max((s2_params[n] - s1_params[n]).abs().max().item() for n in s1_params)
        ldiff = max(abs(a - b) for a, b in zip(d_losses, s1_losses))
        worst = max((d_params[n] - s1_params[n]).abs().max().item() for n in s1_params)
        print(f"[labs] the single-card LeNet step is not deterministic (two runs differ by "
              f"|loss| {lgap:.2e}, |param| {pgap:.2e}): world-1 DP vs single |loss diff| "
              f"{ldiff:.2e}, max |param diff| {worst:.2e} (tol {DP_GAP_MULT} x the gap)")
        check(ldiff <= DP_GAP_MULT * lgap and worst <= DP_GAP_MULT * pgap,
              "world-1 DP LeNet disagrees with the single-card step")
    for tag, r, batch in (("task1 step (LeNet, adam_ref, batch 200, numpy batch in)", busy1,
                           200),
                          ("task2 step (DataParallel world 1, allreduce, batch 32)", busy2, 32)):
        print(f"[labs] {tag}: wall {r['wall_ms']:.3f} ms/step, {batch / r['wall_ms'] * 1e3:.0f} "
              f"imgs/s, {r['kernels_per_call']:.0f} device kernels summing "
              f"{r['kernel_ms_per_call']:.3f} ms: busy {r['busy_share']:.3f} "
              f"({LABS_BUSY_ITERS} steps; torch.profiler over 5)")
    print(f"[labs] task2 ms/step by aggregation (one epoch each): "
          f"{', '.join(f'{k} {v:.3f}' for k, v in task2_ms.items())}")

    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    print(f"[labs] launches on the path: {sum(launches.values())} (every kernel 0)")
    check(not any(launches.values()), f"the labs path launched a kernel: {launches}")
    return launches


# ------------------------------------------------------------ phase 14

# Dropout on task5's single-card path at the training config (main path
# 2's model seed, batches and Adam).
DROPOUT_TASK5 = ["--attn", "flash", "--fused_ln", "--rope", "--vocab", "32768",
                 "--embed_dim", "512", "--num_heads", "4", "--num_layers", "6",
                 "--seq_len", "1024", "--batch_size", "8", "--lr", "1e-3", "--seed", "1"]
DROPOUT_STEPS = 3
DROPOUT_RATE = 0.1


def dropout_phase() -> dict[str, dict[str, int]]:
    """Main path 10, dropout (module docstring, phase 14). Returns the launch
    counts of the single-card run ("dropout") and of the world-1 DP run
    ("dropout_dp")."""
    import math
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.core.prng import seed_key
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.nn import layers
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam
    from tpudml_torch.tasks import task5_longcontext as task5
    from tpudml_torch.train import TrainState, make_train_step

    t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
    seqs = synthetic_lm(4 * TRAIN_BATCH, t, v, seed=0)
    rng = np.random.default_rng(0)  # main path 2's batches
    batches = [seqs[rng.integers(0, len(seqs), size=TRAIN_BATCH)] for _ in range(DROPOUT_STEPS)]
    cuda = torch.device("cuda")

    def phase5_step():
        m = TransformerLM(**TRAIN_MODEL, impl="flash", fused_ln=True, device="cuda",
                          generator=torch.Generator().manual_seed(1))
        opt = Adam(lr=TRAIN_LR)
        losses, ms = _train_run(TrainState.create(m, opt), make_train_step(m, opt), batches)
        return losses, ms, _params(m)

    def task5_run(rate, parallel="single"):
        args = task5.parse_args(DROPOUT_TASK5 + ["--dropout", str(rate), "--parallel", parallel])
        ts, step = task5.build_engine(args, cuda)
        losses, ms = _train_run(ts, step, batches)
        return losses, ms, _params(ts.model)

    # (1) Main path 2's step twice, and task5's --dropout 0 model through
    # the step with a dropout key (task5's own ``key(seed ^ 0xD0)``).
    p1, p2 = phase5_step(), phase5_step()
    repeats = p1[0] == p2[0] and _bitwise(p1[2], p2[2])
    ts, _ = task5.build_engine(task5.parse_args(DROPOUT_TASK5 + ["--dropout", "0"]), cuda)
    keyed = make_train_step(ts.model, Adam(lr=TRAIN_LR), rng_root=seed_key(1 ^ 0xD0))
    off = (*_train_run(ts, keyed, batches), _params(ts.model))
    del ts, keyed
    print(f"[dropout] main path 2's step repeats itself bitwise over {DROPOUT_STEPS} steps: "
          f"{repeats}; task5 --dropout 0 with a dropout key: losses "
          f"{' '.join(f'{x:.6f}' for x in off[0])}")
    if repeats:
        check(off[0] == p1[0] and _bitwise(off[2], p1[2]),
              "--dropout 0 differs from main path 2's step")
        print(f"[dropout] --dropout 0 equals main path 2's step bitwise (losses and all "
              f"{len(off[2])} parameters): the key plumbing changes nothing when off")
    del p2
    torch.cuda.empty_cache()

    # (2) --dropout 0.1: the keep share of every mask drawn, and the launches.
    draw = layers.dropout_mask
    kept = [0, 0, 0]  # kept, drawn, masks

    def counting(key, keep, shape, device):
        mask = draw(key, keep, shape, device)
        kept[0] += int(mask.sum())
        kept[1] += mask.numel()
        kept[2] += 1
        return mask

    layers.dropout_mask = counting
    try:
        reset_launch_counts()  # ---- main path 10 starts here
        on = task5_run(DROPOUT_RATE)
        launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    finally:
        layers.dropout_mask = draw
    need = {k.name: DROPOUT_STEPS * PER_STEP.get(k.name, 0) for k in KERNELS}
    keep = 1.0 - DROPOUT_RATE
    share = kept[0] / kept[1]
    sigma = math.sqrt(keep * (1 - keep) / kept[1])
    print(f"[dropout] task5 --dropout {DROPOUT_RATE}: losses "
          f"{' '.join(f'{x:.6f}' for x in on[0])}; {kept[2]} masks, keep share {share:.6f} of "
          f"{kept[1]} draws (binomial {keep} +- 6 sigma = {6 * sigma:.2e}); launches "
          f"{dict((k, c) for k, c in launches.items() if c)} = {DROPOUT_STEPS} x {PER_STEP}")
    check(launches == need, f"the dropout path launched {launches}, not {need}")
    check(all(np.isfinite(on[0])), "a dropout loss is not finite")
    check(abs(share - keep) <= 6 * sigma, f"the keep share {share} is off {keep}")
    check(kept[2] == DROPOUT_STEPS * 2 * TRAIN_MODEL["num_layers"],
          "not two masks a layer a step")
    check(on[0] != off[0], "--dropout 0.1 trained as --dropout 0 did")

    # (3) A second run from the same seed.
    again = task5_run(DROPOUT_RATE)
    same = again[0] == on[0] and _bitwise(again[2], on[2])
    print(f"[dropout] a second --dropout {DROPOUT_RATE} run from the same seed repeats the "
          f"losses and parameters bitwise: {same}")
    if repeats:
        check(same, "the dropout run does not repeat itself where main path 2's step does")
    del again
    torch.cuda.empty_cache()

    # (4) The same under DataParallel at world 1.
    with tempfile.TemporaryDirectory() as tmp, process_group(
            DistributedConfig(coordinator_address=f"file://{tmp}/store", num_processes=1),
            device="cuda") as group:
        check(torch.distributed.get_backend(group) == "nccl", "the dropout group is not NCCL's")
        reset_launch_counts()  # ---- the dropout_dp path starts here
        dp1 = task5_run(DROPOUT_RATE, "dp")
        dp_launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        dp2 = task5_run(DROPOUT_RATE, "dp")
    dp_same = dp1[0] == dp2[0] and _bitwise(dp1[2], dp2[2])
    print(f"[dropout] --parallel dp --dropout {DROPOUT_RATE} at world 1 (the replica folds rank "
          f"0 into its keys): losses {' '.join(f'{x:.6f}' for x in dp1[0])}; two runs equal "
          f"bitwise: {dp_same}; launches {dict((k, c) for k, c in dp_launches.items() if c)}")
    check(dp_launches == need, f"the DP dropout path launched {dp_launches}, not {need}")
    check(all(np.isfinite(dp1[0])), "a DP dropout loss is not finite")
    if repeats:
        check(dp_same, "the DP dropout run does not repeat itself")
    check(not torch.distributed.is_initialized(), "the dropout group outlived its phase")
    print(f"[dropout] ms/step (steady state, {DROPOUT_STEPS - 1} steps after one warm-up): "
          f"--dropout {DROPOUT_RATE} {on[1]:.2f}, DP {dp1[1]:.2f}, {dp2[1]:.2f}; --dropout 0 "
          f"{off[1]:.2f}; main path 2's step {p1[1]:.2f}")
    return {"dropout": launches, "dropout_dp": dp_launches}



# ------------------------------------------------------------ phase 15

# Host infrastructure on task5's f32 training path (--parallel dp at world
# 1: the training config with flash attention, fused add+LN, RoPE, Adam)
# and on the serving model: the checkpoint store, the launcher, the grad
# sentinel, the flight recorder and the profiler.
HOST_TASK5 = ["--parallel", "dp", "--vocab", "32768", "--embed_dim", "512", "--num_heads", "4",
              "--num_layers", "6", "--seq_len", "1024", "--batch_size", "8", "--attn", "flash",
              "--fused_ln", "--rope", "--lr", "1e-3", "--seed", "1", "--log_every", "1",
              "--device", "cuda"]
HOST_STEPS = 6
HOST_CKPT_EVERY = 2
HOST_KILL_AT = 5  # the killed run saved steps 2 and 4; the vandal tears step 4
HOST_KILL_RC = 17
HOST_POISON_STEP = 3
HOST_OBS_STEPS = 3
HOST_TIMED_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
HOST_CHILD_TIMEOUT_S = 300.0
HOST_SERVE = ["--vocab", "32768", "--embed_dim", "512", "--num_heads", "8", "--num_kv_heads", "2",
              "--num_layers", "6", "--max_len", "1024", "--slots", "8", "--prefill_chunk", "128",
              "--n_requests", "16", "--qps", "inf", "--prompt_len", "64", "512",
              "--new_tokens", "16", "64", "--fused_head", "--device", "cuda"]
# One launched run of task5's loop: its hooks get the kill (where the
# environment asks for it), and it writes its launch counts at the end.
DRILL_CHILD = """
import json, os, sys
from tpudml_torch.device import no_tf32
from tpudml_torch.ops import KERNELS
from tpudml_torch.resilience import rank_kill_hook
from tpudml_torch.tasks import task5_longcontext as task5
no_tf32("cuda")
hooks = []
if os.environ.get("DRILL_KILL_AT"):
    hooks.append(rank_kill_hook(int(os.environ["DRILL_KILL_AT"]),
                                exit_code=int(os.environ["DRILL_KILL_RC"]),
                                marker=os.environ["DRILL_MARKER"]))
res = task5.run(task5.parse_args(sys.argv[1:]), hooks=hooks)
with open(os.environ["DRILL_OUT"], "w") as f:
    json.dump({"launches": {k.name: k.launches for k in KERNELS},
               "final_loss": res["final_loss"]}, f)
"""


def _drill_run(tmp: Path, tag: str, extra: list[str], env: dict) -> tuple:
    """One launched task5 run at world 1 (``tpudml_torch.launch``): (the
    LaunchResult, its rank-tagged output, its launch counts or None, its
    per-step losses from ``metrics.jsonl``)."""
    import io

    from tpudml_torch.launch import ClusterSpec, launch

    out = tmp / f"{tag}.json"
    spec = ClusterSpec(num_processes=1, timeout_s=HOST_CHILD_TIMEOUT_S,
                       env=dict(env, DRILL_OUT=str(out)))
    sink = io.StringIO()
    t0 = time.perf_counter()
    res = launch([sys.executable, "-c", DRILL_CHILD, *HOST_TASK5, "--log_dir",
                  str(tmp / f"logs_{tag}"), *extra], spec, sink=sink)
    text = sink.getvalue()
    losses = {}
    for f in (tmp / f"logs_{tag}").rglob("metrics.jsonl"):
        for line in f.read_text().splitlines():
            rec = json.loads(line)
            if rec["tag"] == "Train Loss":
                losses[rec["step"]] = rec["value"]
    counts = json.loads(out.read_text())["launches"] if out.exists() else None
    print(f"[host_infra] {tag}: rc {res.returncodes}, failed_rank {res.failed_rank}, "
          f"{time.perf_counter() - t0:.1f} s; losses "
          f"{' '.join(f'{k}:{v:.6f}' for k, v in sorted(losses.items()))}")
    return res, text, counts, losses


def _npz_leaves(step_dir: Path) -> list:
    import numpy as np

    with np.load(step_dir / "leaves.npz") as data:
        return [data[k] for k in sorted(data.files)]


def host_drill(tmp: Path) -> dict[str, dict[str, int]]:
    """(a) The kill/resume drill through the launcher (module docstring,
    phase 15). Returns the launch counts of the uninterrupted and the
    resumed run."""
    import numpy as np

    from tpudml_torch.checkpoint import CheckpointCorruptError, verify_checkpoint
    from tpudml_torch.resilience import vandalize

    ref_dir, run_dir = tmp / "ckpt_ref", tmp / "ckpt_run"
    ckpt = ["--steps", str(HOST_STEPS), "--ckpt_every", str(HOST_CKPT_EVERY)]
    ref, _, ref_counts, ref_losses = _drill_run(tmp, "uninterrupted", ckpt + [
        "--ckpt_dir", str(ref_dir)], {})
    check(ref.success, f"the uninterrupted run failed: {ref.returncodes}")
    kill_env = {"DRILL_KILL_AT": str(HOST_KILL_AT), "DRILL_KILL_RC": str(HOST_KILL_RC),
                "DRILL_MARKER": str(tmp / "killed.marker")}
    killed, _, _, _ = _drill_run(tmp, "killed", ckpt + ["--ckpt_dir", str(run_dir)], kill_env)
    check(killed.returncodes == [HOST_KILL_RC] and killed.failed_rank == 0,
          f"the killed run ended {killed.returncodes}, failed_rank {killed.failed_rank}")
    saved = sorted(p.name for p in run_dir.iterdir() if p.name.startswith("step_"))
    check(saved == ["step_2", "step_4"], f"the killed run left {saved}")
    torn = vandalize(str(run_dir), "truncate")
    try:
        verify_checkpoint(run_dir / "step_4")
        torn_ok = False
    except CheckpointCorruptError:
        torn_ok = True
    check(torn_ok, "the truncated step_4 still verifies")
    check(verify_checkpoint(run_dir / "step_2") == 2, "step_2 does not verify")
    print(f"[host_infra] the vandal truncated {Path(torn).relative_to(tmp)}; step_4 fails its "
          f"CRC check, step_2 verifies")
    resumed, text, res_counts, res_losses = _drill_run(
        tmp, "resumed", ckpt + ["--ckpt_dir", str(run_dir), "--resume"], kill_env)
    check(resumed.success, f"the resumed run failed: {resumed.returncodes}\n{text[-2000:]}")
    check("resumed from step 2" in text, "the resume did not walk back to step 2")
    check(sorted(res_losses) == list(range(3, HOST_STEPS + 1)),
          f"the resumed run logged steps {sorted(res_losses)}")
    check(all(res_losses[i] == ref_losses[i] for i in res_losses),
          "the resumed run's losses differ from the uninterrupted run's")
    a = _npz_leaves(ref_dir / f"step_{HOST_STEPS}")
    b = _npz_leaves(run_dir / f"step_{HOST_STEPS}")
    check(len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)),
          "the resumed run's state (parameters, Adam moments, step) differs from the "
          "uninterrupted run's")
    need = {k: HOST_STEPS * n for k, n in PER_STEP.items()}
    for tag, counts, steps in (("uninterrupted", ref_counts, HOST_STEPS),
                               ("resumed", res_counts, HOST_STEPS - 2)):
        want = {k: steps * n for k, n in PER_STEP.items()}
        got = {k: c for k, c in counts.items() if c}
        check(got == want, f"the {tag} run launched {got}, not {want}")
    print(f"[host_infra] kill/resume drill: killed at step {HOST_KILL_AT} (rc {HOST_KILL_RC}, "
          f"failed_rank 0), restored step 2 past the torn step 4, resumed to step "
          f"{HOST_STEPS}: losses of steps 3-{HOST_STEPS} and all {len(a)} leaves (parameters, "
          f"Adam m, t, v, step) bitwise equal to the uninterrupted run; launches "
          f"{need} and 4/6 of them")
    return {"host_drill_ref": ref_counts, "host_drill_resumed": res_counts}


class _NoHostSync:
    """An optimizer whose ``update`` runs under CUDA's sync debug mode
    "error": a host synchronization inside it raises."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        import torch

        torch.cuda.set_sync_debug_mode("error")
        try:
            return self.inner.update(grads, state, params)
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _host_batches(steps: int):
    import numpy as np

    from tpudml_torch.data import synthetic_lm

    seqs = synthetic_lm(4 * TRAIN_BATCH, TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"],
                        seed=0)
    rng = np.random.default_rng(0)  # main path 2's batches
    return [seqs[rng.integers(0, len(seqs), size=TRAIN_BATCH)] for _ in range(steps)]


def _host_model():
    import torch

    from tpudml_torch.models import TransformerLM

    return TransformerLM(**TRAIN_MODEL, impl="flash", fused_ln=True, device="cuda",
                         generator=torch.Generator().manual_seed(1))


def _timed_steps(ts, step, batches) -> tuple:
    """(the state after the batches, ms/step over the batches after the
    first)."""
    import torch

    for i, b in enumerate(batches):
        ts, _ = step(ts, b[:, :-1], b[:, 1:])
        if i == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    return ts, (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)


def _opt_tensors(state) -> list:
    import torch

    if isinstance(state, torch.Tensor):
        return [state.detach().clone()]
    if isinstance(state, dict):
        return [t for v in state.values() for t in _opt_tensors(v)]
    return []


def host_sentinel(tmp: Path) -> dict[str, int]:
    """(b) The sentinel on the DP step, then the checkpoint store's save and
    restore times of that state. Returns the sentinel run's launches."""
    import numpy as np
    import torch

    from tpudml_torch.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam
    from tpudml_torch.parallel import DataParallel
    from tpudml_torch.resilience import corrupt_microbatch, param_leaf_names, sentinel_stats

    batches = _host_batches(HOST_STEPS)
    d = TRAIN_MODEL["embed_dim"]
    poison = torch.from_numpy(corrupt_microbatch(
        np.zeros((TRAIN_BATCH, TRAIN_MODEL["max_len"], d), np.float32), "nan",
        seed=HOST_POISON_STEP)).cuda()
    model = _host_model()
    dp = DataParallel(model, Adam(lr=TRAIN_LR), sentinel=True, stacked_batches=False)
    check(dp.sentinel is not None, "DataParallel(sentinel=True) has no sentinel")
    dp.optimizer = _NoHostSync(dp.optimizer)
    armed = {"on": False}
    # The poisoned micro-batch: NaN at corrupt_microbatch's seeded
    # positions of the first block's input (token ids cannot hold a NaN).
    hook = model.block0.ln1.register_forward_pre_hook(
        lambda mod, args: (args[0] + poison,) if armed["on"] else None)
    # What kernel 1 makes of the NaN rows, read after the step.
    attn_out = []
    watch = model.block0.attn.register_forward_hook(
        lambda mod, args, out: attn_out.append(out.detach()) if armed["on"] else None)
    ts, step = dp.create_state(), dp.make_train_step()
    losses, snaps = [], {}
    reset_launch_counts()  # ---- the sentinel path starts here
    for i, b in enumerate(batches, start=1):
        armed["on"] = i == HOST_POISON_STEP
        ts, m = step(ts, b[:, :-1], b[:, 1:])
        losses.append(m["loss"])
        if i in (HOST_POISON_STEP - 1, HOST_POISON_STEP):
            snaps[i] = (_params(model), _opt_tensors(ts.opt_state["base"]),
                        sentinel_stats(ts.opt_state), int(m["bad_micro"]))
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    hook.remove()
    watch.remove()
    nan_in = int(torch.isnan(poison).any(-1).sum())
    nan_out = int((~torch.isfinite(attn_out[0])).sum())
    losses = [float(x) for x in losses]
    before, after = snaps[HOST_POISON_STEP - 1], snaps[HOST_POISON_STEP]
    st = sentinel_stats(ts.opt_state)
    names = param_leaf_names(model)
    check(_bitwise(before[0], after[0]), "the skipped step changed a parameter")
    check(len(before[1]) == len(after[1])
          and all(torch.equal(x, y) for x, y in zip(before[1], after[1])),
          "the skipped step changed the Adam state (m, v or t)")
    check(after[2]["skips"] == 1 and after[2]["consecutive"] == 1 and st["skips"] == 1
          and st["consecutive"] == 0, f"sentinel counters {after[2]} then {st}")
    check(0 <= after[2]["bad_leaf"] < len(names), f"bad_leaf {after[2]['bad_leaf']}")
    check(after[3] == 0 and before[3] == -1, f"bad_micro {before[3]}, {after[3]}")
    check(all(np.isfinite(losses[HOST_POISON_STEP:])), "a loss after the skip is not finite")
    # The poisoned step's loss is the plain version's: NaN (kernel 1 keeps a
    # NaN score's row NaN, as its plain version and the TPU kernel do).
    check(np.isnan(losses[HOST_POISON_STEP - 1]) and nan_out > 0,
          f"the poisoned step's loss {losses[HOST_POISON_STEP - 1]} is not NaN "
          f"({nan_out} non-finite values in the first block's attention output)")
    need = {k.name: HOST_STEPS * PER_STEP.get(k.name, 0) for k in KERNELS}
    check(launches == need, f"the sentinel path launched {launches}, not {need}")
    print(f"[host_infra] sentinel: step {HOST_POISON_STEP} poisoned with NaN "
          f"(corrupt_microbatch seed {HOST_POISON_STEP}), skipped: parameters and Adam state "
          f"bitwise those of step {HOST_POISON_STEP - 1}, skips {st['skips']}, bad_leaf "
          f"{after[2]['bad_leaf']} {names[after[2]['bad_leaf']]}, bad_micro 0; losses "
          f"{' '.join(f'{x:.6f}' for x in losses)}; the update ran under sync debug mode "
          f"'error' (no host sync); the poisoned step: {nan_in} of {poison[..., 0].numel()} "
          f"rows hold a NaN, the first block's attention output (kernel 1) {nan_out} "
          f"non-finite values of {attn_out[0].numel()}")

    # ms/step with the sentinel and without, from the same weights.
    timed = _host_batches(HOST_TIMED_STEPS)
    ms = {}
    for tag, kw in (("without", {}), ("with", {"sentinel": True}),
                    ("without (again)", {}), ("with (again)", {"sentinel": True})):
        m2 = _host_model()
        eng = DataParallel(m2, Adam(lr=TRAIN_LR), stacked_batches=False, **kw)
        ms[tag] = _timed_steps(eng.create_state(), eng.make_train_step(), timed)[1]
        del m2, eng
    print(f"[host_infra] ms/step (steady state, {HOST_TIMED_STEPS - 1} steps after one "
          f"warm-up): " + ", ".join(f"{k} sentinel {v:.2f}" for k, v in ms.items()))

    # The checkpoint store on this state (52M parameters and two moments, f32).
    nbytes = sum(p.numel() * 4 for p in model.parameters()) * 3
    t0 = time.perf_counter()
    path = save_checkpoint(tmp / "ckpt_state", ts, ts.step)
    save_ms = (time.perf_counter() - t0) * 1e3
    want = (_params(model), _opt_tensors(ts.opt_state))
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    t0 = time.perf_counter()
    restore_checkpoint(path, ts)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(_bitwise(want[0], _params(model))
          and all(torch.equal(x, y) for x, y in zip(want[1], _opt_tensors(ts.opt_state))),
          "the restored state differs from the saved one")
    mgr = CheckpointManager(tmp / "ckpt_async", async_write=True)
    t0 = time.perf_counter()
    mgr.save(ts, ts.step)
    async_ms = (time.perf_counter() - t0) * 1e3
    mgr.wait()
    async_total = (time.perf_counter() - t0) * 1e3
    print(f"[host_infra] checkpoint of the training state ({nbytes / 1e6:.1f} MB of f32 "
          f"parameters and moments, the sentinel's counters): save {save_ms:.1f} ms, restore "
          f"with CRC verification {restore_ms:.1f} ms (bitwise); async save returns in "
          f"{async_ms:.1f} ms, on disk after {async_total:.1f} ms")
    return launches


def host_obs(tmp: Path) -> dict[str, int]:
    """(c) The flight recorder on the DP step, and the profiler over two
    steps. Returns the obs run's launches."""
    import torch

    from tpudml_torch.metrics.profiler import trace
    from tpudml_torch.obs import Tracer, validate_chrome_trace
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam
    from tpudml_torch.parallel import DataParallel

    batches = _host_batches(HOST_OBS_STEPS + 2)
    model = _host_model()
    dp = DataParallel(model, Adam(lr=TRAIN_LR), obs=True, stacked_batches=False)
    check(isinstance(dp.tracer, Tracer), "DataParallel(obs=True) has no tracer")
    grads_seen = []
    aggregate = dp._aggregate

    def capture(grads):
        out = aggregate(grads)
        grads_seen.append(torch.sqrt(sum(g.double().square().sum() for g in out.values())))
        return out

    dp._aggregate = capture
    ts, step = dp.create_state(), dp.make_train_step()
    stats = []
    reset_launch_counts()  # ---- the obs path starts here
    for b in batches[:HOST_OBS_STEPS]:
        ts, m = step(ts, b[:, :-1], b[:, 1:])
        stats.append(m["step_stats"])
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    spans = [(s.cat, s.name) for s in dp.tracer.events]
    check(spans == [("step", "train_step")] * HOST_OBS_STEPS, f"spans {spans}")
    errs = []
    for s, ref in zip(stats, grads_seen):
        got = float(s.grad_norm)
        errs.append(abs(got - float(ref)) / float(ref))
        check(errs[-1] <= STEP_GRAD_RTOL, f"grad_norm {got} against {float(ref)}")
        check(int(s.skips) == 0 and float(s.comm_bytes) == 0.0, "StepStats at world 1")
    doc = dp.tracer.chrome_trace()
    validate_chrome_trace(doc)
    need = {k.name: HOST_OBS_STEPS * PER_STEP.get(k.name, 0) for k in KERNELS}
    check(launches == need, f"the obs path launched {launches}, not {need}")

    # Two steps under the profiler: its trace names the flash kernels, and
    # each step's span (closed after a synchronize) holds its kernels' time.
    n0 = len(dp.tracer.events)
    with trace(tmp / "profile") as prof:
        for b in batches[HOST_OBS_STEPS:]:
            ts, m = step(ts, b[:, :-1], b[:, 1:])
    prof_doc = json.loads(Path(prof.trace_path).read_text())
    kernels = [e for e in prof_doc["traceEvents"] if e.get("cat") == "kernel"]
    flash = [e for e in kernels if "flash_fwd_f32_kernel" in e.get("name", "")]
    check(len(flash) == 2 * PER_STEP["flash_forward_lse"],
          f"the profiler's trace names flash_fwd_f32_kernel {len(flash)} times")
    kernel_ms = sum(e.get("dur", 0) for e in kernels) / 1e3 / 2
    span_ms = [s.dur_us / 1e3 for s in dp.tracer.events[n0:]]
    check(all(ms >= 0.95 * kernel_ms for ms in span_ms),
          f"train_step spans {span_ms} ms hold less than the {kernel_ms:.2f} device ms a step")
    step_ms = ", ".join(f"{s.dur_us / 1e3:.2f}" for s in dp.tracer.events[:n0])
    print(f"[host_infra] obs: {HOST_OBS_STEPS} train_step spans ({step_ms} ms), "
          f"grad_norm against the f64 norm of the aggregated gradients within "
          f"{max(errs):.2e}; trace.json validates; profiler trace {Path(prof.trace_path).name}: "
          f"{len(kernels)} device kernels in 2 steps, flash_fwd_f32_kernel x{len(flash)} "
          f"('{flash[0]['name'][:60] if flash else ''}'), {kernel_ms:.2f} device ms a step "
          f"inside spans of "
          f"{', '.join(f'{x:.2f}' for x in span_ms)} ms (profiled)")

    # ms/step with obs on and off, and the tracer's own cost a span.
    timed = _host_batches(HOST_TIMED_STEPS)
    ms = {}
    for tag, kw in (("off", {}), ("on", {"obs": True}), ("off (again)", {}),
                    ("on (again)", {"obs": True})):
        m2 = _host_model()
        eng = DataParallel(m2, Adam(lr=TRAIN_LR), stacked_batches=False, **kw)
        ms[tag] = _timed_steps(eng.create_state(), eng.make_train_step(), timed)[1]
        del m2, eng
    cost = {}
    for tag, tr in (("on", Tracer()), ("off", Tracer(enabled=False))):
        t0 = time.perf_counter()
        for _ in range(20000):
            with tr.span("x", cat="bench"):
                pass
        cost[tag] = (time.perf_counter() - t0) / 20000 * 1e6
    print(f"[host_infra] ms/step (steady state, {HOST_TIMED_STEPS - 1} steps after one "
          f"warm-up): " + ", ".join(f"obs {k} {v:.2f}" for k, v in ms.items())
          + f"; a span costs {cost['on']:.2f} us on, {cost['off']:.3f} us off (host, empty body)")
    return launches


def host_serve(tmp: Path) -> dict[str, int]:
    """(d) task6 ``--obs --fused_head`` on the serving workload. Returns its
    launches."""
    from tpudml_torch.obs import validate_chrome_trace
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.serve import poisson_workload
    from tpudml_torch.tasks import task6_serve as task6

    argv = HOST_SERVE + ["--log_dir", str(tmp / "serve")]
    plain = task6.main(argv)  # the stream without --obs (and a warm-up)
    reset_launch_counts()  # ---- the serving obs path starts here
    res = task6.main(argv + ["--obs"])
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    doc = json.loads(Path(res["trace_path"]).read_text())
    validate_chrome_trace(doc)
    slots = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"].startswith("slot")]
    n = WORKLOAD["n_requests"]
    check(sorted(e["args"]["rid"] for e in slots) == list(range(n)),
          f"{len(slots)} residency spans for {n} requests")
    requests, _ = poisson_workload(n, float("inf"), 0, vocab_size=SERVE_MODEL["vocab_size"],
                                   prompt_len=WORKLOAD["prompt_len"],
                                   new_tokens=WORKLOAD["new_tokens"])
    flash_need = expected_flash_calls(requests, SERVE_CFG["prefill_chunk"],
                                      SERVE_MODEL["num_layers"])
    check(launches["flash_forward_lse"] == flash_need,
          f"{launches['flash_forward_lse']} flash launches, prefill needs {flash_need}")
    check(launches["fused_decode_head"] == res["decode_steps"] > 0,
          f"{launches['fused_decode_head']} head launches for {res['decode_steps']} steps")
    check(res["streams"] == plain["streams"], "the --obs run's streams differ from the run "
          "without --obs")
    print(f"[host_infra] task6 --obs --fused_head: trace.json validates, {len(slots)} residency "
          f"spans = {n} requests, {len(doc['traceEvents']) - 1} events; launches "
          f"{dict((k, c) for k, c in launches.items() if c)}; streams bitwise equal to the run "
          f"without --obs; {res['tokens_per_sec']:.1f} tok/s (without: "
          f"{plain['tokens_per_sec']:.1f})")
    return launches


def host_infra_phase() -> dict[str, dict[str, int]]:
    """Phase 15, host infrastructure (module docstring). Returns the launch
    counts of its paths."""
    import tempfile

    import torch

    from tpudml_torch.core import DistributedConfig, process_group

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = host_drill(tmp)
        with process_group(DistributedConfig(coordinator_address=f"file://{tmp}/store",
                                             num_processes=1), device="cuda") as group:
            check(torch.distributed.get_backend(group) == "nccl", "the group is not NCCL's")
            paths["host_sentinel"] = host_sentinel(tmp)
            torch.cuda.empty_cache()
            paths["host_obs"] = host_obs(tmp)
        torch.cuda.empty_cache()
        paths["host_serve"] = host_serve(tmp)
    check(not torch.distributed.is_initialized(), "the host_infra group outlived its phase")
    torch.cuda.synchronize()
    print(f"[host_infra] phase {time.perf_counter() - t0:.1f} s")
    return paths



# ------------------------------------------------------------ the repairs

# PERF.md §6's kernel-1 times before the NaN repair (H100 80GB HBM3 at
# 700 W): f32 and bf16 at the training shape, f32 at long context.
K1_BEFORE = {"f32": 0.4066, "bf16": 0.0996, "f32 long": 17.235}


def _same_nans(got, want, tol: float | None = None, rel: float | None = None) -> float:
    """NaN exactly where ``want`` has it (else fail); returns max |err| of
    the finite rest, checked against ``tol`` (absolute, scaled by 1 +
    |want| when ``rel`` is None) or ``rel`` of the finite max."""
    import torch

    gn, wn = torch.isnan(got), torch.isnan(want)
    check(torch.equal(gn, wn), f"NaN in {int(gn.sum())} places where the plain version has "
          f"{int(wn.sum())}")
    keep = ~wn
    g, w = got[keep].float(), want[keep].float()
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if rel is not None:
        check(err <= rel * w.abs().max().item(), f"finite values off by {err:.3e}")
    else:
        check(bool(((g - w).abs() <= tol * (1 + w.abs())).all()),
              f"finite values off by {err:.3e}")
    return err


def repairs_phase(gen, by_name: dict) -> None:
    """Phase 16: the NaN cases of kernels 1, 10 and 11 against their plain
    versions, and kernel 1's re-timed rows (module docstring)."""
    import torch

    from tpudml_torch.ops import (
        flash_forward_lse, flash_forward_lse_reference, xent_forward, xent_forward_save,
        xent_forward_save_reference,
    )

    t0 = time.perf_counter()
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for b, t, h, d, k_shift in ((8, 1024, 4, 128, 0), (2, 200, 2, 64, 1)):
            q, k, v = (torch.randn((b, t, h, d), generator=gen).cuda().to(dtype)
                       for _ in range(3))
            rows = torch.randperm(t, generator=gen)[: max(t // 16, 2)].cuda()
            half = rows.numel() // 2
            q[:, rows[:half], 0, :] = float("nan")
            k[:, rows[half:], h - 1, 3] = float("nan")
            o, lse = flash_forward_lse(q, k, v, causal=True, k_shift=k_shift)
            ro, rl = flash_forward_lse_reference(q, k, v, causal=True, k_shift=k_shift)
            torch.cuda.synchronize()
            eo = _same_nans(o, ro, rel=BF16_REL) if dtype == torch.bfloat16 \
                else _same_nans(o, ro, tol=FLASH_TOL)
            el = _same_nans(lse, rl, tol=FLASH_TOL)
            line = (f"[repairs] flash_forward_lse {tag} B={b} T={t} H={h} D={d} causal "
                    f"k_shift={k_shift}, NaN in {half} query rows and {rows.numel() - half} "
                    f"key rows: O NaN at {int(torch.isnan(o).sum())} places = plain's, lse "
                    f"{int(torch.isnan(lse).sum())} = plain's; finite max|dO| {eo:.3e}, "
                    f"max|dlse| {el:.3e}")
            if k_shift:
                check(torch.equal(o[:, :k_shift], torch.zeros_like(o[:, :k_shift]))
                      and bool((lse[:, :, :k_shift] == -1e30).all()),
                      "a row that sees no key lost its out 0 / lse -1e30")
                line += "; row 0 (no key) keeps out 0, lse -1e30"
            print(line)
    n, d, v = XENT_SHAPE
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for poison, (nn_, vv) in (("x rows", (n, v)), ("W column", (n, v)),
                                  ("a whole row, V=1", (37, 1))):
            x, w, bias, y = _xent_inputs(gen, nn_, d, vv, dtype, bad_labels=True)
            if poison == "x rows":
                x[torch.randperm(nn_, generator=gen)[: nn_ // 50].cuda(), d // 2] = float("nan")
            elif poison == "W column":
                w[:, vv // 2] = float("nan")
            else:
                x[nn_ // 2] = float("nan")
            lse0, picked0 = xent_forward(x, w, bias, y)
            lse, picked, s = xent_forward_save(x, w, bias, y)
            rlse, rpicked, rs = xent_forward_save_reference(x, w, bias, y)
            torch.cuda.synchronize()
            check(bool(torch.isnan(rlse).any()), "the plain xent forward kept no NaN")
            errs = [_same_nans(g, r, tol=XENT_ROW_TOL) for g, r in
                    ((lse0, rlse), (picked0, rpicked), (lse, rlse), (picked, rpicked), (s, rs))]
            print(f"[repairs] xent forward (kernels 10, 11) {tag} N={nn_} d={d} V={vv}, NaN in "
                  f"{poison}: lse NaN in {int(torch.isnan(lse).sum())} rows = plain's (both "
                  f"kernels), picked and scores likewise; finite max|err| {max(errs):.3e}")
            del x, w, s, rs
            torch.cuda.empty_cache()
    fwd, fwd16 = by_name["flash_forward_lse"], by_name["flash_forward_lse_bf16"]
    now = {"f32": fwd["at_train_shape"]["ms"], "bf16": fwd16["ms"],
           "f32 long": fwd["at_long_context"]["ms"]}
    print("[repairs] kernel 1 after the NaN repair (phase 3's times): " + "; ".join(
        f"{k} {now[k]:.4f} ms (before {K1_BEFORE[k]:g} ms, {now[k] / K1_BEFORE[k]:.3f}x)"
        for k in K1_BEFORE) + f"; bf16 device {fwd16['device_ms']:.5f} ms")
    print(f"[repairs] {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------ model parallelism, ZeRO-1

GSPMD_RULES = ("stage", "tp")  # paths gspmd_stage, gspmd_tp


def _one_rank_group(tmp):
    from tpudml_torch.core import DistributedConfig, process_group

    return process_group(DistributedConfig(coordinator_address=f"file://{tmp}/store",
                                           num_processes=1), device="cuda")


def _close_params(got: dict, want: dict) -> float:
    """max over parameters of max |got − want| − GRAD_RTOL·|want| (≤ GRAD_ATOL
    passes: the JAX package's GRAD_TOL, rtol 1e-4, atol 1e-6)."""
    return max(((got[n].float() - want[n].float()).abs()
                - 1e-4 * want[n].float().abs()).max().item() for n in want)


def gspmd_phase() -> dict[str, dict[str, int]]:
    """Main path 11 (module docstring, phase 17). Returns the launch counts of
    task4 and of the two TRAIN_MODEL runs."""
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch.core import process_count
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam
    from tpudml_torch.parallel import GSPMDParallel, tensor_parallel_rules
    from tpudml_torch.tasks import task4
    from tpudml_torch.train import TrainState, make_train_step

    t0 = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp, _one_rank_group(tmp) as group:
        check(torch.distributed.get_backend(group) == "nccl" and process_count(group) == 1,
              "the GSPMD group is not a one-rank NCCL group")
        root = Path(tmp)
        _write_mnist_idx(root)
        reset_launch_counts()  # ---- task4's path starts here
        m, lines = _lab(task4, ["--data_dir", tmp, "--log_dir", f"{tmp}/logs", "--device",
                                "cuda", "--log_every", "0"])
        paths["task4"] = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        ms = m["train_time_s"] * 1e3 / m["steps"]
        print(f"[gspmd] world 1 (one-rank NCCL group): task4 --schedule gspmd at the "
              f"reference's settings (SGD lr 0.01, batch 32, one epoch): test accuracy "
              f"{m['test_accuracy']:.4f}, {m['steps']} steps in {m['train_time_s']:.2f} s: "
              f"{ms:.3f} ms/step, {32 * m['steps'] / m['train_time_s']:.0f} imgs/s; "
              f"{lines[-1]}")
        check(m["test_accuracy"] >= LABS_ACC_FLOOR and m["world"] == 1, "task4 did not learn")

        t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
        seqs = synthetic_lm(4 * TRAIN_BATCH, t, v, seed=0)
        rng = np.random.default_rng(0)
        batches = [seqs[rng.integers(0, len(seqs), size=TRAIN_BATCH)]
                   for _ in range(TRAIN_STEPS)]

        def model(impl):
            return TransformerLM(**TRAIN_MODEL, impl=impl, fused_ln=True, device="cuda",
                                 generator=torch.Generator().manual_seed(1))

        def single():
            mm = model("flash")
            opt = Adam(lr=TRAIN_LR)
            losses, ms = _train_run(TrainState.create(mm, opt), make_train_step(mm, opt),
                                    batches)
            return losses, ms, _params(mm)

        s1, s2 = single(), single()
        repeats = s1[0] == s2[0] and _bitwise(s1[2], s2[2])
        print(f"[gspmd] single-card f32 training step repeats itself bitwise over "
              f"{TRAIN_STEPS} steps: {repeats}")
        for rule in GSPMD_RULES:
            mm = model("full")
            kw = (dict(mesh={"stage": 1}) if rule == "stage" else
                  dict(mesh={"model": 1}, rule=tensor_parallel_rules("model"),
                       axis_name="model"))
            mp = GSPMDParallel(mm, Adam(lr=TRAIN_LR), flash_attn=True, **kw)
            ts = mp.create_state()
            sharded = sum(mp.is_sharded(n) for n in mp.param_specs)
            reset_launch_counts()  # ---- main path 11 (this rule) starts here
            losses, g_ms = _train_run(ts, mp.make_train_step(), batches)
            launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
            params = mp.gather_params()
            for name, n in launches.items():
                need = TRAIN_STEPS * PER_STEP.get(name, 0)
                check(n == need, f"gspmd ({rule}) launched {name} {n} times, need {need}")
            if repeats:
                check(losses == s1[0] and _bitwise(params, s1[2]),
                      f"gspmd ({rule}) at world 1 differs from the single-card step")
                agree = "bitwise (losses and every parameter)"
            else:
                ldiff = max(abs(a - b) for a, b in zip(losses, s1[0]))
                worst = _close_params(params, s1[2])
                check(ldiff <= LOSS_TOL and worst <= 1e-6,
                      f"gspmd ({rule}) disagrees with the single-card step")
                agree = (f"within LOSS_TOL ({ldiff:.2e}) and GRAD_TOL (the single-card step "
                         "itself does not repeat)")
            print(f"[gspmd] GSPMDParallel(flash_attn=True), {rule} rule, {sharded} of "
                  f"{len(mp.param_specs)} parameters sharded over a size-1 axis (each "
                  f"all-gathered a step through NCCL): losses "
                  f"{' '.join(f'{x:.6f}' for x in losses)}; equals the single-card step "
                  f"{agree}; {g_ms:.2f} ms/step vs single-card {s1[1]:.2f}, {s2[1]:.2f} "
                  f"ms/step; launches {launches} = {TRAIN_STEPS} x {PER_STEP}")
            paths[f"gspmd_{rule}"] = launches
            del mm, mp, ts, params
            torch.cuda.empty_cache()
    check(not torch.distributed.is_initialized(), "the GSPMD group outlived its phase")
    torch.cuda.synchronize()
    print(f"[gspmd] {time.perf_counter() - t0:.1f} s")
    return paths


# FSDP and TP with the vocab-sharded head (slice 13): task5 at main path 2's
# widths (TRAIN_MODEL, TRAIN_BATCH, TRAIN_LR), through its entry point.
FSDP_TP_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
FSDP_TP_TASK5 = ["--vocab", "32768", "--embed_dim", "512", "--num_heads", "4", "--num_layers",
                 "6", "--seq_len", "1024", "--batch_size", "8", "--lr", "0.001", "--attn",
                 "flash", "--fused_ln", "--rope", "--steps", str(FSDP_TP_STEPS),
                 "--log_every", "0", "--device", "cuda"]
# path: (flags, the reference's head flags, the head kernels a step)
FSDP_TP_PATHS = {
    "fsdp_fused": (["--parallel", "fsdp", "--fused_xent"], ["--fused_xent"],
                   ("xent_fwd_save", "xent_dx_s", "xent_dw_s")),
    "tp_fused_lean": (["--parallel", "tp", "--fused_xent", "--fused_xent_lean"],
                      ["--fused_xent", "--fused_xent_lean"],
                      ("xent_fwd", "xent_dx_lean", "xent_dw_lean")),
    "fsdp_sentinel": (["--parallel", "fsdp", "--sentinel"], [], ()),
}
VOCAB_SHARDS = (2, 4)


def _task5_run(task5, argv: list[str]) -> tuple[dict, list[float], dict, object]:
    """task5's entry point on ``argv`` (inside the caller's group): its
    result, every step's loss, the final parameters in full and the
    engine."""
    args = task5.parse_args(argv)
    losses = []
    out = task5.run(args, hooks=[lambda step, train_state, metrics: losses.append(
        float(metrics["loss"]))])
    return out, losses, args._sharded.gather_params(), args._sharded


def _single_card_run(task5, argv: list[str], sentinel: bool) -> tuple[list[float], float, dict]:
    """The single-card step (``make_lm_fused_train_step`` or
    ``make_train_step``, through task5's ``build_engine`` for ``--parallel
    single``) on task5's batches from the same seed, its Adam wrapped in a
    ``GradSentinel`` as the engine's is with ``sentinel`` (the sentinel's
    Adam divides by bias corrections held on the device): (losses, ms/step
    after one warm-up, the final parameters)."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.optim import make_optimizer
    from tpudml_torch.resilience import attach_sentinel
    from tpudml_torch.train import TrainState, make_train_step

    args = task5.parse_args(argv)
    ts, step = task5.build_engine(args, torch.device(args.device))
    if sentinel:
        opt = attach_sentinel(make_optimizer("adam", args.lr))
        ts, step = TrainState.create(ts.model, opt), make_train_step(ts.model, opt)
    seqs = synthetic_lm(4 * args.batch_size, args.seq_len, args.vocab, seed=args.seed)
    rng = np.random.default_rng(args.seed)  # task5's row sampling
    batches = [seqs[rng.integers(0, len(seqs), size=args.batch_size)] for _ in range(args.steps)]
    losses, ms = _train_run(ts, step, batches)
    return losses, ms, _params(ts.model)


def _vocab_shard_check(gen, dtype, shards: int, save_s: bool) -> str:
    """The op's halves over ``shards`` vocab shards in one process at the
    flagship head (XENT_SHAPE, labels −1 and V among the rows) against the
    unsharded kernels and the plain version; returns the printed line's
    numbers and times."""
    import torch
    import torch.nn.functional as F

    from tpudml_torch.ops import (
        sharded_xent_backward, sharded_xent_forward, sharded_xent_in_one_process, xent_dw,
        xent_dw_lean, xent_dw_reference, xent_dx, xent_dx_lean, xent_dx_reference, xent_forward,
        xent_forward_save, xent_forward_save_reference,
    )

    n, d, v = XENT_SHAPE
    x, w, b, y = _xent_inputs(gen, n, d, v, dtype, bad_labels=True)
    loss, dx, dw, db = sharded_xent_in_one_process(x, w, b, y, shards, save_s)
    if save_s:
        lse, picked, s = xent_forward_save(x, w, b, y)
        udx, (udw, udb) = xent_dx(s, w, y, lse, 1.0 / n), xent_dw(s, x, y, lse, 1.0 / n)
        del s
    else:
        lse, picked = xent_forward(x, w, b, y)
        udx = xent_dx_lean(x, w, b, y, lse, 1.0 / n)
        udw, udb = xent_dw_lean(x, w, b, y, lse, 1.0 / n)
    rlse, rpicked, rs = xent_forward_save_reference(x, w, b, y)
    rloss = (rlse - rpicked).mean()
    rdx = xent_dx_reference(rs, w, y, rlse, 1.0 / n)
    rdw, rdb = xent_dw_reference(rs, x, y, rlse, 1.0 / n)
    del rs
    torch.cuda.synchronize()
    rel = XENT_GRAD_REL if dtype == torch.float32 else BF16_REL
    tag = f"W={shards} {'saved' if save_s else 'lean'} {str(dtype)[6:]}"
    lerr, uerr = abs(loss.item() - rloss.item()), abs(loss.item() - (lse - picked).mean().item())
    errs = {"dx": (rel_to_max(dx, rdx), rel_to_max(dx, udx)),
            "dw": (rel_to_max(dw, rdw), rel_to_max(dw, udw)),
            "db": (rel_to_max(db, rdb), rel_to_max(db, udb))}
    check(lerr <= XENT_ROW_TOL * (1 + abs(rloss.item())) and uerr <= XENT_ROW_TOL * (
        1 + abs(rloss.item())), f"vocab shards {tag}: the loss disagrees ({lerr:.3e})")
    for name, (e_plain, e_unsharded) in errs.items():
        tol = XENT_GRAD_REL if name == "db" else rel
        check(e_plain <= tol and e_unsharded <= tol,
              f"vocab shards {tag}: {name} disagrees ({e_plain:.3e}, {e_unsharded:.3e})")
    # Times: each shard's head kernels, the whole composition, the unsharded
    # kernels, and the library chain (F.cross_entropy forward and backward).
    vl = v // shards
    ws, bs = w[:, :vl].contiguous(), b[:vl].contiguous()
    ln, slse, _, ss = sharded_xent_forward(x, ws, bs, y, 0, save_s)
    fwd_ms = cuda_ms(lambda: sharded_xent_forward(x, ws, bs, y, 0, save_s), iters=10)
    dx_ms = cuda_ms(lambda: sharded_xent_backward(x, ws, bs, ln, slse, ss, 1.0 / n,
                                                  need_dw=False), iters=10)
    dw_ms = cuda_ms(lambda: sharded_xent_backward(x, ws, bs, ln, slse, ss, 1.0 / n,
                                                  need_dx=False), iters=10)
    del ss
    all_ms = cuda_ms(lambda: sharded_xent_in_one_process(x, w, b, y, shards, save_s),
                     iters=5, warmup=1)
    if save_s:
        def unsharded():
            lse_, _, s_ = xent_forward_save(x, w, b, y)
            return xent_dx(s_, w, y, lse_, 1.0 / n), xent_dw(s_, x, y, lse_, 1.0 / n)
    else:
        def unsharded():
            lse_, _ = xent_forward(x, w, b, y)
            return (xent_dx_lean(x, w, b, y, lse_, 1.0 / n),
                    xent_dw_lean(x, w, b, y, lse_, 1.0 / n))
    un_ms = cuda_ms(unsharded, iters=5, warmup=1)

    def plain():
        lse_, _, s_ = xent_forward_save_reference(x, w, b, y)
        return (xent_dx_reference(s_, w, y, lse_, 1.0 / n),
                xent_dw_reference(s_, x, y, lse_, 1.0 / n))

    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    yl = y.long().clamp(0, v - 1)  # F.cross_entropy takes no label outside [0, V)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        F.cross_entropy(torch.addmm(leaves[2], leaves[0], leaves[1]), yl), leaves), iters=5,
        warmup=1)
    e = x.element_size()
    nbytes = 2 * (n * d + d * v) * e + v * (e + 4) + 4 * n  # x, W, b, labels in; dX, dW, db out
    bnd, by = bound(nbytes, 6 * n * d * v,
                    H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS)
    return (f"{tag}: loss |err| {lerr:.3e} vs plain, {uerr:.3e} vs unsharded kernels; "
            + ", ".join(f"{k} {a:.3e} / {u:.3e}" for k, (a, u) in errs.items())
            + f" of max (plain / unsharded; tol {rel:g}, db {XENT_GRAD_REL:g}); a shard "
            f"[{d}, {vl}]: fwd {fwd_ms:.3f} ms, dX {dx_ms:.3f} ms, dW+db {dw_ms:.3f} ms; "
            f"all {shards} shards with the merge {all_ms:.3f} ms vs the unsharded kernels "
            f"{un_ms:.3f} ms, the plain version {plain_ms:.3f} ms and F.cross_entropy fwd+bwd "
            f"{lib_ms:.3f} ms; bound {bnd:.5f} ms "
            f"({by}, 6·N·d·V)")


def fsdp_tp_phase(gen) -> dict[str, dict[str, int]]:
    """Main path 13 (module docstring, phase 19). Returns the launch counts
    of the three task5 runs."""
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch.core import process_count
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.tasks import task5_longcontext as task5

    t0 = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp, _one_rank_group(tmp) as group:
        check(torch.distributed.get_backend(group) == "nccl" and process_count(group) == 1,
              "the FSDP/TP group is not a one-rank NCCL group")
        base = FSDP_TP_TASK5 + ["--log_dir", f"{tmp}/logs"]
        tokens = TRAIN_BATCH * TRAIN_MODEL["max_len"]
        for path, (flags, head, kernels) in FSDP_TP_PATHS.items():
            ref_losses, ref_ms, ref_params = _single_card_run(task5, base + head,
                                                              "--sentinel" in flags)
            torch.cuda.empty_cache()
            reset_launch_counts()  # ---- main path 13 (this path) starts here
            out, losses, params, eng = _task5_run(task5, base + flags)
            launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
            per_step = dict(PER_STEP, **{k: 1 for k in kernels})
            need = {k.name: FSDP_TP_STEPS * per_step.get(k.name, 0) for k in KERNELS}
            check(launches == need, f"{path} launched {launches}, not {need}")
            check(out["devices"] == 1 and all(np.isfinite(losses)), f"{path} did not train")
            bitwise = losses == ref_losses and _bitwise(params, ref_params)
            if bitwise:
                agree = "bitwise (losses and every parameter)"
            else:
                ldiff = max(abs(a - b) for a, b in zip(losses, ref_losses))
                worst = _close_params(params, ref_params)
                check(ldiff <= LOSS_TOL and worst <= 1e-6,
                      f"{path} disagrees with the single-card step ({ldiff:.2e}, {worst:.2e})")
                agree = (f"within LOSS_TOL ({ldiff:.2e}) and GRAD_TOL (rtol {STEP_GRAD_RTOL:g}, "
                         f"atol 1e-6), not bitwise")
            ms = tokens / out["tokens_per_sec"] * 1e3
            sharded = sum(eng.is_sharded(n) for n in eng.param_specs)
            ref_name = ("make_lm_fused_train_step" if head else "make_train_step") + (
                " (Adam in a GradSentinel)" if "--sentinel" in flags else "")
            print(f"[fsdp_tp] world 1 (one-rank NCCL group): task5 {' '.join(flags)}: losses "
                  f"{' '.join(f'{x:.6f}' for x in losses)}; equals the single-card "
                  f"{ref_name} {agree}; {ms:.2f} ms/step vs single-card {ref_ms:.2f} "
                  f"ms/step ({FSDP_TP_STEPS - 1} steps after one warm-up); {sharded} of "
                  f"{len(eng.param_specs)} parameters sharded (head kernel "
                  f"{eng.param_specs['head.kernel']}), wire bytes a step (ring model) "
                  f"{eng.step_wire_bytes():.0f}; launches "
                  f"{dict((k, c) for k, c in launches.items() if c)}")
            paths[path] = launches
            del params, ref_params, eng
            torch.cuda.empty_cache()
    check(not torch.distributed.is_initialized(), "the FSDP/TP group outlived its phase")
    for dtype in (torch.float32, torch.bfloat16):
        for shards in VOCAB_SHARDS:
            for save_s in (True, False):
                print(f"[fsdp_tp] vocab shards in one process, N={XENT_SHAPE[0]} "
                      f"d={XENT_SHAPE[1]} V={XENT_SHAPE[2]}, "
                      f"{_vocab_shard_check(gen, dtype, shards, save_s)}")
                torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"[fsdp_tp] {time.perf_counter() - t0:.1f} s")
    return paths


# Pipeline parallelism (slice 14): task5 --parallel pp at main path 2's
# widths, one stage (world 1), through its entry point.
PP_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
PP_TASK5 = ["--vocab", "32768", "--embed_dim", "512", "--num_heads", "4", "--seq_len", "1024",
            "--batch_size", "8", "--lr", "0.001", "--attn", "flash", "--fused_ln", "--rope",
            "--steps", str(PP_STEPS), "--log_every", "0", "--device", "cuda", "--parallel", "pp"]
# Launches of kernels 1-3, 8, 9 a step at one stage, M = 4: a micro-batch's
# block runs flash forward, dQ, dK/dV once and its ln2 junction through
# add+LN once each way; GPipe's head normalizes the whole batch once (its
# ln_f is kernel 8 on (x, 0), as the LM's fused trunk closes its last
# add), 1F1B's once a micro-batch inside the last stage's backward;
# --remat repeats the block's forward; interleaved's first chunk runs its
# forward twice (the forward unit, then the backward's recompute).
PP_PER_STEP = {
    "pp_gpipe": {"flash_forward_lse": 4, "flash_dq": 4, "flash_dkdv": 4,
                 "add_layernorm_fwd": 5, "add_layernorm_bwd": 5},
    "pp_gpipe_remat": {"flash_forward_lse": 8, "flash_dq": 4, "flash_dkdv": 4,
                       "add_layernorm_fwd": 9, "add_layernorm_bwd": 5},
    "pp_1f1b_dropout": {"flash_forward_lse": 4, "flash_dq": 4, "flash_dkdv": 4,
                        "add_layernorm_fwd": 8, "add_layernorm_bwd": 8},
    "pp_interleaved": {"flash_forward_lse": 12, "flash_dq": 8, "flash_dkdv": 8,
                       "add_layernorm_fwd": 16, "add_layernorm_bwd": 12},
}
# path: (flags, micro-batches, the single-card LM's blocks or None)
PP_PATHS = {
    "pp_gpipe_m1": (["--schedule", "gpipe"], 1, 1),
    "pp_1f1b_m1": (["--schedule", "1f1b"], 1, 1),
    "pp_gpipe": (["--schedule", "gpipe"], 4, 1),
    "pp_gpipe_remat": (["--schedule", "gpipe", "--remat"], 4, 1),
    "pp_1f1b_dropout": (["--schedule", "1f1b", "--dropout", "0.1"], 4, None),
    "pp_interleaved": (["--schedule", "interleaved", "--v_chunks", "2"], 4, 2),
}
PP_PER_STEP_M1 = {"flash_forward_lse": 1, "flash_dq": 1, "flash_dkdv": 1,
                  "add_layernorm_fwd": 2, "add_layernorm_bwd": 2}
PP_MEM_MICRO = 8


def _pp_single_run(task5, argv: list[str], init: dict, layers: int):
    """The single-card step of a ``TransformerLM`` of ``layers`` blocks
    holding ``init`` (a pipeline's initial parameters) on task5's batches
    for ``argv``: (losses, ms/step after one warm-up, final parameters)."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.optim import Adam
    from tpudml_torch.train import TrainState, make_train_step

    args = task5.parse_args(argv)
    lm = TransformerLM(**dict(TRAIN_MODEL, num_layers=layers), impl="flash", fused_ln=True,
                       device="cuda")
    lm.load_state_dict(init)
    opt = Adam(lr=args.lr)
    seqs = synthetic_lm(4 * args.batch_size, args.seq_len, args.vocab, seed=args.seed)
    rng = np.random.default_rng(args.seed)  # task5's row sampling
    batches = [seqs[rng.integers(0, len(seqs), size=args.batch_size)] for _ in range(args.steps)]
    losses, ms = _train_run(TrainState.create(lm, opt), make_train_step(lm, opt), batches)
    params = _params(lm)
    del lm
    torch.cuda.empty_cache()
    return losses, ms, params


def _pp_single_grads(task5, argv: list[str], init: dict, layers: int):
    """((tokens, labels) of task5's first batch, the single-card LM's
    step-1 gradients there from ``init``)."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.train import make_loss_fn

    args = task5.parse_args(argv)
    lm = TransformerLM(**dict(TRAIN_MODEL, num_layers=layers), impl="flash", fused_ln=True,
                       device="cuda")
    lm.load_state_dict(init)
    seqs = synthetic_lm(4 * args.batch_size, args.seq_len, args.vocab, seed=args.seed)
    batch = seqs[np.random.default_rng(args.seed).integers(0, len(seqs), size=args.batch_size)]
    x, y = (torch.from_numpy(a).long().to(lm.device) for a in (batch[:, :-1], batch[:, 1:]))
    grads = _grads(make_loss_fn(lm), lm, x, y)[1]
    del lm
    return (batch[:, :-1], batch[:, 1:]), grads


def pp_phase() -> dict[str, dict[str, int]]:
    """Main path 14 (module docstring, phase 20). Returns the launch counts
    of the four pipeline paths."""
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch.core import process_count
    from tpudml_torch.interop import lm_params_from_pipeline
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.tasks import task5_longcontext as task5

    t0 = time.perf_counter()
    paths, refs = {}, {}
    tokens = TRAIN_BATCH * TRAIN_MODEL["max_len"]
    with tempfile.TemporaryDirectory() as tmp, _one_rank_group(tmp) as group:
        check(torch.distributed.get_backend(group) == "nccl" and process_count(group) == 1,
              "the pipeline group is not a one-rank NCCL group")
        base = PP_TASK5 + ["--log_dir", f"{tmp}/logs"]
        for path, (flags, micro, layers) in PP_PATHS.items():
            argv = base + flags + ["--microbatches", str(micro)]
            grad_note = ""
            if layers is not None:
                # The pipeline's initial parameters (the entry draws the same
                # from the same seed) and its step-1 gradients.
                v = 2 if layers == 2 else None
                args = task5.parse_args(argv)
                task5.build_engine(args, torch.device("cuda"))
                eng = args._sharded
                init = lm_params_from_pipeline(
                    {n: t.clone() for n, t in eng.gather_params().items()}, v)
                if layers not in refs:
                    # The single-card step from them, twice (does it repeat
                    # itself bitwise?), and its step-1 gradients.
                    runs = [_pp_single_run(task5, argv, init, layers) for _ in range(2)]
                    repeats = runs[0][0] == runs[1][0] and _bitwise(runs[0][2], runs[1][2])
                    refs[layers] = (runs[0], runs[1][1], repeats, _pp_single_grads(
                        task5, argv, init, layers))
                    print(f"[pp] single-card TransformerLM({layers} block"
                          f"{'s' * (layers > 1)}) from the pipeline's initial parameters: "
                          f"{runs[0][1]:.2f}, {runs[1][1]:.2f} ms/step; repeats itself "
                          f"bitwise: {repeats}")
                    del runs
                if micro > 1:
                    x0, y0 = refs[layers][3][0]
                    got_g = lm_params_from_pipeline(
                        {n: g.float() for n, g in eng.grads(x0, y0)[0].items()}, v)
                    gworst, gname = _worst(got_g, refs[layers][3][1], refs[layers][3][1])
                    check(gworst <= STEP_GRAD_RTOL,
                          f"{path}: step-1 gradient {gname} disagrees ({gworst:.3e})")
                    grad_note = (f"; step-1 gradients worst max|err|/max|single| {gworst:.3e} "
                                 f"({gname}; tol {STEP_GRAD_RTOL:g})")
                    del got_g
                del args, eng
            torch.cuda.empty_cache()
            reset_launch_counts()  # ---- main path 14 (this path) starts here
            out, losses, params, eng = _task5_run(task5, argv)
            launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
            per_step = PP_PER_STEP.get(path, PP_PER_STEP_M1)
            need = {k.name: PP_STEPS * per_step.get(k.name, 0) for k in KERNELS}
            check(launches == need, f"{path} launched {launches}, not {need}")
            check(out["devices"] == 1 and all(np.isfinite(losses)), f"{path} did not train")
            ms = tokens / out["tokens_per_sec"] * 1e3
            if layers is None:
                check(losses[-1] < losses[0], f"{path}: the loss did not fall")
                agree = f"its own dropout masks; loss {losses[0]:.6f} -> {losses[-1]:.6f}"
            else:
                (ref_losses, ref_ms, ref_params), ref_ms2, repeats, _ = refs[layers]
                got = lm_params_from_pipeline(params, 2 if layers == 2 else None)
                if micro == 1 and repeats:
                    check(losses == ref_losses and _bitwise(got, ref_params),
                          f"{path} differs from the single-card step")
                    agree = "bitwise (losses and every parameter)"
                else:
                    ldiff = max(abs(a - b) for a, b in zip(losses, ref_losses))
                    pworst, pname = _worst(got, ref_params, ref_params)
                    pabs = max((got[n].float() - ref_params[n].float()).abs().max().item()
                               for n in ref_params)
                    check(ldiff <= LOSS_TOL, f"{path}: a loss disagrees with the single-card "
                          f"step ({ldiff:.2e})")
                    # Adam moves an element about lr a step whatever its
                    # gradient's size, so an element whose gradient is near
                    # 0 (where the sum order tells) can part by up to 2·lr
                    # a step: the bound on the final parameters.
                    check(pabs <= 2 * TRAIN_LR * PP_STEPS, f"{path}: a final parameter parts "
                          f"from the single-card step's by {pabs:.3e}")
                    agree = (f"losses within LOSS_TOL ({ldiff:.2e}){grad_note}; final "
                             f"parameters max|err| {pabs:.3e} (Adam's bound 2·lr·steps "
                             f"{2 * TRAIN_LR * PP_STEPS:g}), worst max|err|/max|single| "
                             f"{pworst:.3e} ({pname})")
                agree += f"; single-card {ref_ms:.2f}, {ref_ms2:.2f} ms/step"
            print(f"[pp] world 1, one stage (one-rank NCCL group): task5 {' '.join(flags)} "
                  f"--microbatches {micro}: losses {' '.join(f'{x:.6f}' for x in losses)}; "
                  f"{agree}; {ms:.2f} ms/step ({PP_STEPS - 1} steps after one warm-up); "
                  f"launches {dict((k, c) for k, c in launches.items() if c)}")
            if path in PP_PER_STEP:
                paths[path] = launches
            del params, eng
            torch.cuda.empty_cache()
        # Memory: GPipe keeps every micro-batch's graph, 1F1B one input slot.
        peaks = {}
        for schedule in ("gpipe", "1f1b"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out, _, _, eng = _task5_run(task5, base + ["--schedule", schedule, "--microbatches",
                                                       str(PP_MEM_MICRO)])
            peaks[schedule] = torch.cuda.max_memory_allocated()
            del eng
        check(peaks["1f1b"] < peaks["gpipe"], f"1F1B's peak {peaks} is not under GPipe's")
        print(f"[pp] world 1, one stage, --microbatches {PP_MEM_MICRO}: peak allocated "
              f"GPipe {peaks['gpipe']} B ({peaks['gpipe'] / 2**30:.3f} GiB), 1F1B "
              f"{peaks['1f1b']} B ({peaks['1f1b'] / 2**30:.3f} GiB), "
              f"{peaks['1f1b'] / peaks['gpipe']:.3f}x")
    check(not torch.distributed.is_initialized(), "the pipeline group outlived its phase")
    print(f"[pp] {time.perf_counter() - t0:.1f} s")
    return paths


# ------------------------------------------------- TP serving (phase 21)

TP_LOCAL_HEADS = (4, 1)  # SERVE_MODEL's (h, kv) heads a rank holds at W = 2
TP_WINDOW_START = 384  # the local-heads prefill window: chunk 4 of a 512-token prompt


def _tp_local_heads_check(gen) -> str:
    """Kernel 1 at the prefill chunk's shape with the local head counts
    that W = 2 gives SERVE_MODEL (h_local 4, kv_local 1 GQA-repeated to 4):
    one block causal and one not against the plain version, and the
    chunked window (``chunk_flash_window``, four blocks) against the plain
    masked attention. Launches outside the counted path."""
    import torch

    from tpudml_torch.nn.attention import chunk_flash_window, dot_product_attention
    from tpudml_torch.ops import flash_forward_lse, flash_forward_lse_reference

    h, kv = TP_LOCAL_HEADS
    c, d = SERVE_CFG["prefill_chunk"], SERVE_MODEL["embed_dim"] // SERVE_MODEL["num_heads"]
    t = TP_WINDOW_START + c
    q = torch.randn((1, c, h, d), generator=gen).cuda()
    k, v = (torch.randn((1, t, kv, d), generator=gen).cuda().repeat_interleave(h // kv, dim=2)
            for _ in range(2))
    errs = []
    for causal in (True, False):
        kb, vb = k[:, -c:], v[:, -c:]
        o, lse = flash_forward_lse(q, kb, vb, causal=causal)
        ro, rl = flash_forward_lse_reference(q, kb, vb, causal=causal)
        errs.append(max((o - ro).abs().max().item(), (lse - rl).abs().max().item()))
    win = chunk_flash_window(q, k, v, TP_WINDOW_START)
    ref = dot_product_attention(q, k, v, causal=True, q_offset=TP_WINDOW_START)
    errs.append((win - ref).abs().max().item())
    check(max(errs) <= FLASH_TOL, f"kernel 1 at the local heads disagrees ({errs})")
    return (f"kernel 1 at B=1, T={c}, h_local={h} (kv_local={kv}), D={d}: causal "
            f"{errs[0]:.2e}, non-causal {errs[1]:.2e}, the {t}-token window at start "
            f"{TP_WINDOW_START} {errs[2]:.2e} (tol {FLASH_TOL:g})")


def tp_serve_phase(gen) -> dict[str, dict[str, int]]:
    """Main path 15 (module docstring, phase 21). Returns the launch counts
    of the TP engine's f32 and int8-cache runs."""
    import tempfile

    import torch

    from tpudml_torch.core import process_count
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.serve import ServeConfig, ServingEngine, poisson_workload
    from tpudml_torch.serve.tp import TPServing

    t0 = time.perf_counter()
    print(f"[tp_serve] {_tp_local_heads_check(gen)}")
    model = TransformerLM(**SERVE_MODEL, device="cuda", generator=gen)
    requests, ledger = poisson_workload(
        WORKLOAD["n_requests"], float("inf"), 0, vocab_size=SERVE_MODEL["vocab_size"],
        prompt_len=WORKLOAD["prompt_len"], new_tokens=WORKLOAD["new_tokens"],
    )
    owed = sum(o["max_new_tokens"] for o in ledger.values())
    refusal = None
    try:
        TPServing(model, {"model": 4}, "model", ServeConfig(**SERVE_CFG))
    except ValueError as e:  # the refusal this check expects
        refusal = str(e)
    check(refusal is not None and "kv_heads (2) divisible" in refusal,
          f"W = 4 was not refused for its kv heads: {refusal}")
    print(f"[tp_serve] W = 4 refused: {refusal}")
    kinds = ("f32", "int8")
    dense = {k: ServingEngine(model, ServeConfig(**SERVE_CFG, cache_kind=k), device="cuda")
             for k in kinds}
    paths, reports = {}, {}
    with tempfile.TemporaryDirectory() as tmp, _one_rank_group(tmp) as group:
        check(torch.distributed.get_backend(group) == "nccl" and process_count(group) == 1,
              "the TP group is not a one-rank NCCL group")
        tp = {k: ServingEngine(model, ServeConfig(**SERVE_CFG, cache_kind=k), device="cuda",
                               mesh={"model": 1}) for k in kinds}
        held = sum(p.numel() for p in tp["f32"].tp.local.parameters())
        check(held == sum(p.numel() for p in model.parameters()),
              "a one-rank TP shard does not hold the whole model")
        for eng in (*tp.values(), *dense.values()):  # warm-up; not counted
            eng.run(requests[:2])
        torch.cuda.synchronize()
        for k in kinds:
            reset_launch_counts()  # ---- main path 15 (this run) starts here
            reports[f"tp_{k}"] = tp[k].run(requests)
            paths[f"tp_serve_{k}"] = {x.name: x.launches for x in KERNELS}  # ---- ends here
    check(not torch.distributed.is_initialized(), "the TP group outlived its phase")
    for k in kinds:
        reports[f"dense_{k}"] = dense[k].run(requests)
    need = expected_flash_calls(requests, SERVE_CFG["prefill_chunk"], SERVE_MODEL["num_layers"])
    streams = {}
    for name, rep in reports.items():
        lat = rep.latency_summary()
        step_ms = rep.wall_time / rep.decode_steps * 1e3
        world = "world 1 (one-rank NCCL group)" if name.startswith("tp") else "dense engine"
        print(f"[tp_serve] {name}, {world}: {rep.generated_tokens} tokens, {rep.decode_steps} "
              f"decode steps, {rep.tokens_per_sec:.1f} tok/s, wall {rep.wall_time:.3f} s "
              f"({step_ms:.3f} ms a decode step, prefill included), per-token p50/p99 "
              f"{lat['per_token_p50_s'] * 1e3:.3f}/{lat['per_token_p99_s'] * 1e3:.3f} ms")
        check(rep.generated_tokens == owed, f"{name}: generated {rep.generated_tokens}, "
              f"the workload owes {owed}")
        streams[name] = {rid: st.tokens for rid, st in rep.requests.items()}
    for k in kinds:
        got = paths[f"tp_serve_{k}"]
        check(got == {x.name: need if x.name == "flash_forward_lse" else 0 for x in KERNELS},
              f"tp_serve_{k} launched {got}, the prefill needs {need} of kernel 1 and nothing "
              "else")
        check(reports[f"tp_{k}"].events == reports[f"dense_{k}"].events,
              f"the TP {k} run's schedule differs from the dense engine's")
        compare_streams(model, requests, streams[f"tp_{k}"], streams[f"dense_{k}"],
                        f"tp_{k} vs dense_{k}", INT8_TIE_GAP if k == "int8" else TIE_GAP)
    mism = teacher_forced_check(model, requests, streams["tp_f32"], "tp_f32")
    print(f"[tp_serve] kernel 1 launched {need} times a run (the prefill's blocks), no other "
          f"kernel; streams equal the dense engine's (near-ties allowed) and hold against "
          f"the teacher-forced full forward ({mism} near-tie mismatches); event logs equal; "
          f"{time.perf_counter() - t0:.1f} s")
    return paths


# ------------------------------------------------ context parallel (phase 22)

CP_STEPS = 4  # the first is the warm-up; ms/step is taken over the rest
CP_TASK5 = ["--vocab", "32768", "--embed_dim", "512", "--num_heads", "4", "--num_layers", "6",
            "--seq_len", "1024", "--batch_size", "8", "--lr", "0.001", "--fused_ln", "--rope",
            "--fused_xent", "--steps", str(CP_STEPS), "--log_every", "0", "--device", "cuda"]
# path: the flags after --parallel cp; the kernels a step beyond the ring's
CP_PATHS = {
    "cp_ring": ["--attn", "ring"],
    "cp_ring_striped": ["--attn", "ring", "--cp_layout", "striped"],
    "cp_ulysses": ["--attn", "ulysses"],
}
# Launches a step at world 1: one diagonal fold a layer (kernel 1 forward,
# 2 and 3 backward), the fused trunk's 12 junctions each way, and the
# saved-scores head (N = 8192); Ulysses runs the plain attention.
CP_HEAD = {"xent_fwd_save": 1, "xent_dx_s": 1, "xent_dw_s": 1}
CP_PER_STEP = {
    "cp_ring": {**PER_STEP, **CP_HEAD},
    "cp_ring_striped": {**PER_STEP, **CP_HEAD},
    "cp_ulysses": {"add_layernorm_fwd": 12, "add_layernorm_bwd": 12, **CP_HEAD},
}
CP_LONG_STEPS = LONG_STEPS
# The W ranks in one process: (W, B, T, H, D, dtype, layouts).
CP_SIM = ((2, 8, 1024, 4, 128, "f32", ("contiguous", "striped")),
          (4, 8, 1024, 4, 128, "f32", ("contiguous", "striped")),
          (2, 8, 1024, 4, 128, "bf16", ("contiguous", "striped")),
          (4, 2, 16384, 4, 128, "f32", ("contiguous", "striped")))


def _drop_flags(argv: list[str], names: tuple) -> list[str]:
    """``argv`` without the flags ``names`` and the value after each."""
    out, skip = [], False
    for a in argv:
        if skip or a in names:
            skip = not skip
            continue
        out.append(a)
    return out


def _cp_run(task5, argv: list[str]):
    """task5 on ``argv`` (inside the caller's group): (losses, ms/step after
    the first step, the final parameters)."""
    import torch

    args = task5.parse_args(argv)
    losses, last, marks = [], {}, []

    def hook(step, train_state, metrics):
        losses.append(float(metrics["loss"]))
        last["model"] = train_state.model
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    task5.run(args, hooks=[hook])
    ms = (marks[-1] - marks[0]) * 1e3 / (len(marks) - 1)
    return losses, ms, _params(last["model"])


def _cp_step1_grads(task5, argv: list[str]):
    """The step-1 gradients of task5's engine for ``argv`` (its fused loss
    on task5's first batch, from the entry's initial parameters)."""
    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.train import make_lm_fused_loss_fn

    args = task5.parse_args(argv)
    ts, _ = task5.build_engine(args, torch.device("cuda"))
    seqs = synthetic_lm(4 * args.batch_size, args.seq_len, args.vocab, seed=args.seed)
    batch = seqs[np.random.default_rng(args.seed).integers(0, len(seqs), size=args.batch_size)]
    x, y = (torch.from_numpy(a).long().cuda() for a in (batch[:, :-1], batch[:, 1:]))
    loss, grads = _grads(make_lm_fused_loss_fn(ts.model, args._save_scores), ts.model, x, y)
    del ts
    return loss, grads


def _cp_sim_check(w, b, t, h, d, dtype, layout) -> str:
    """W ranks' ring in one process through kernels 1–3
    (``ring_attention_in_one_process``, each rank's K/V block taken by
    index) against ``flash_attention`` over the whole sequence: output,
    dq, dk, dv; the folds; kernel 1's k_shift = 1 calls (striped); the
    ring's forward and forward+backward device times beside the
    whole-sequence kernel's."""
    from unittest import mock

    import torch

    import tpudml_torch.ops as ops
    from tpudml_torch.ops import FLASH_FORWARD, FLASH_FORWARD_BF16, flash_attention
    from tpudml_torch.parallel.cp import (
        _stripe_time, _unstripe_time, ring_attention_in_one_process,
    )

    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    gen = torch.Generator().manual_seed(w * 10 + (layout == "striped"))
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen).cuda().to(dt) for _ in range(4))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    want = flash_attention(qr, kr, vr, causal=True)
    want.backward(do)
    striped = layout == "striped"
    lay = (lambda x: _stripe_time(x, w)) if striped else (lambda x: x)
    back = (lambda x: _unstripe_time(x, w)) if striped else (lambda x: x)
    shards = [list(lay(x).chunk(w, dim=1)) for x in (q, k, v, do)]
    shifts = []
    real = ops.flash_forward_lse
    kernel = FLASH_FORWARD_BF16 if dtype == "bf16" else FLASH_FORWARD

    def spy(*a, **kw):
        shifts.append(kw.get("k_shift", 0))
        return real(*a, **kw)

    before = kernel.launches
    with mock.patch.object(ops, "flash_forward_lse", spy):
        (outs, _, dqs, dks, dvs), folds = ring_attention_in_one_process(
            *shards, causal=True, layout=layout)
    need = w * w if striped else w * (w + 1) // 2
    check(folds == (need, need), f"W={w} {layout}: {folds} folds, not {need} each way")
    check(kernel.launches - before == need, f"W={w} {layout}: kernel 1 launched "
          f"{kernel.launches - before} times for {need} folds")
    n_shift = shifts.count(1)
    check(n_shift == (w * (w - 1) // 2 if striped else 0),
          f"W={w} {layout}: {n_shift} folds with k_shift = 1")
    errs = {}
    for name, got, ref in (("out", outs, want), ("dq", dqs, qr.grad), ("dk", dks, kr.grad),
                           ("dv", dvs, vr.grad)):
        got, ref = back(torch.cat(got, dim=1)).float(), ref.float()
        if dtype == "bf16":
            errs[name] = rel_to_max(got, ref)
            check(errs[name] <= BF16_REL, f"W={w} {layout} bf16 {name}: {errs[name]:.3e}")
        elif name == "out":
            errs[name] = (got - ref).abs().max().item()
            check(errs[name] <= FLASH_TOL, f"W={w} {layout} out: {errs[name]:.3e}")
        else:
            errs[name] = (got - ref).abs().max().item()
            excess = ((got - ref).abs() - GRAD_RTOL * ref.abs()).max().item()
            check(excess <= GRAD_ATOL, f"W={w} {layout} {name}: max|err| {errs[name]:.3e}")
    del outs, dqs, dks, dvs
    ring_fwd = cuda_ms(lambda: ring_attention_in_one_process(*shards[:3], causal=True,
                                                             layout=layout), iters=3, warmup=1)
    ring_all = cuda_ms(lambda: ring_attention_in_one_process(*shards, causal=True,
                                                             layout=layout), iters=3, warmup=1)
    one_fwd = cuda_ms(lambda: ops.flash_forward_lse(q, k, v, causal=True), iters=3, warmup=1)

    def whole():
        out = flash_attention(qr, kr, vr, causal=True)
        torch.autograd.grad(out, (qr, kr, vr), do)

    one_all = cuda_ms(whole, iters=3, warmup=1)
    tol = "BF16_REL" if dtype == "bf16" else "FLASH_TOL / GRAD_RTOL, GRAD_ATOL"
    return (f"W={w} {layout} {dtype} B={b} T={t} H={h} D={d}: {folds[0]} folds each way "
            f"({n_shift} with k_shift = 1); err " + ", ".join(f"{n} {e:.2e}" for n, e in
                                                               errs.items())
            + f" ({tol}); ring forward {ring_fwd:.4f} ms, forward+backward {ring_all:.4f} "
            f"ms over the W ranks, against the whole-sequence kernel 1 {one_fwd:.4f} ms, "
            f"kernels 1-3 {one_all:.4f} ms")


def cp_phase() -> dict[str, dict[str, int]]:
    """Main path 16 (module docstring, phase 22). Returns the launch counts
    of the cp paths."""
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch.core import process_count
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.tasks import task5_longcontext as task5

    t0 = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = CP_TASK5 + ["--log_dir", f"{tmp}/logs"]
        single = base + ["--parallel", "single", "--attn", "flash"]
        runs = [_cp_run(task5, single) for _ in range(2)]
        repeats = runs[0][0] == runs[1][0] and _bitwise(runs[0][2], runs[1][2])
        s_loss, s_grads = _cp_step1_grads(task5, single)
        print(f"[cp] single-card --attn flash: {runs[0][1]:.2f}, {runs[1][1]:.2f} ms/step; "
              f"repeats itself bitwise: {repeats}")
        with _one_rank_group(tmp) as group:
            check(torch.distributed.get_backend(group) == "nccl" and process_count(group) == 1,
                  "the cp group is not a one-rank NCCL group")
            for path, flags in CP_PATHS.items():
                argv = base + ["--parallel", "cp"] + flags
                c_loss, c_grads = _cp_step1_grads(task5, argv)
                gworst, gname = _worst(c_grads, s_grads, s_grads)
                gbit = c_loss == s_loss and _bitwise(c_grads, s_grads)
                del c_grads
                torch.cuda.empty_cache()
                reset_launch_counts()  # ---- main path 16 (this path) starts here
                losses, ms, params = _cp_run(task5, argv)
                launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
                need = {k.name: CP_STEPS * CP_PER_STEP[path].get(k.name, 0) for k in KERNELS}
                check(launches == need, f"{path} launched {launches}, not {need}")
                check(all(np.isfinite(losses)), f"{path}: a loss is not finite")
                bit = losses == runs[0][0] and _bitwise(params, runs[0][2])
                ldiff = max(abs(a - c) for a, c in zip(losses, runs[0][0]))
                pabs = max((params[n] - runs[0][2][n]).abs().max().item() for n in params)
                if path != "cp_ulysses" and repeats:
                    check(gbit and bit, f"{path} is not the single-card flash step bitwise "
                          f"(step-1 gradients {gworst:.3e} off, {gname}; losses {ldiff:.2e})")
                else:
                    check(gworst <= STEP_GRAD_RTOL, f"{path}: step-1 gradient {gname} "
                          f"disagrees ({gworst:.3e})")
                    check(ldiff <= LOSS_TOL and pabs <= 2 * TRAIN_LR * CP_STEPS,
                          f"{path}: losses {ldiff:.2e} / parameters {pabs:.3e} off")
                print(f"[cp] world 1 (one-rank NCCL group): task5 --parallel cp "
                      f"{' '.join(flags)} at the training widths: losses "
                      f"{' '.join(f'{x:.6f}' for x in losses)}; against the single-card "
                      f"--attn flash step: step-1 gradients bitwise {gbit} (worst "
                      f"max|err|/max|single| {gworst:.3e}, {gname}), losses and final "
                      f"parameters bitwise {bit} (max |loss diff| {ldiff:.2e}, max |param "
                      f"diff| {pabs:.3e}); {ms:.2f} ms/step ({CP_STEPS - 1} steps after one "
                      f"warm-up) against {runs[0][1]:.2f}; launches "
                      f"{dict((k, c) for k, c in launches.items() if c)}")
                paths[path] = launches
                del params
                torch.cuda.empty_cache()
            del runs, s_grads
            torch.cuda.empty_cache()
            # Long context: the ring at LONG_TASK5's shape, beside the single card.
            long_base = _drop_flags(LONG_TASK5, ("--parallel", "--attn", "--steps")) + [
                "--steps", str(CP_LONG_STEPS), "--log_every", "0", "--device", "cuda",
                "--log_dir", f"{tmp}/logs"]
            s_l, s_ms, _ = _cp_run(task5, long_base + ["--parallel", "single", "--attn",
                                                       "flash"])
            torch.cuda.empty_cache()
            reset_launch_counts()  # ---- main path 16 (cp_long) starts here
            c_l, c_ms, _ = _cp_run(task5, long_base + ["--parallel", "cp", "--attn", "ring"])
            launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
            need = {k.name: CP_LONG_STEPS * LONG_PER_STEP.get(k.name, 0) for k in KERNELS}
            check(launches == need, f"cp_long launched {launches}, not {need}")
            ldiff = max(abs(a - c) for a, c in zip(c_l, s_l))
            check(ldiff <= LOSS_TOL, f"cp_long: losses {ldiff:.2e} off the single card's")
            largs = task5.parse_args(long_base)
            tok = largs.batch_size * largs.seq_len
            print(f"[cp] world 1: task5 --parallel cp --attn ring at LONG_TASK5's shape "
                  f"(T={largs.seq_len}, B={largs.batch_size}, lean head): losses "
                  f"{' '.join(f'{x:.6f}' for x in c_l)} "
                  f"(max |diff| from the single card {ldiff:.2e}); {c_ms:.2f} ms/step, "
                  f"{tok / c_ms * 1e3:.0f} tokens/s, against the single card --attn flash "
                  f"{s_ms:.2f} ms/step ({CP_LONG_STEPS - 1} steps after one warm-up); "
                  f"launches {dict((k, c) for k, c in launches.items() if c)}")
            paths["cp_long"] = launches
    check(not torch.distributed.is_initialized(), "the cp group outlived its phase")
    torch.cuda.empty_cache()
    for w, b, t, h, d, dtype, layouts in CP_SIM:
        for layout in layouts:
            print(f"[cp] in one process: {_cp_sim_check(w, b, t, h, d, dtype, layout)}")
            torch.cuda.empty_cache()
    print(f"[cp] {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------- the planner (phase 23)

# The planner's spec at the training widths (TRAIN_MODEL, TRAIN_BATCH rows a
# device, f32); the HBM budget is the card's memory.
PLAN_SPEC = dict(vocab_size=TRAIN_MODEL["vocab_size"], embed_dim=TRAIN_MODEL["embed_dim"],
                 num_heads=TRAIN_MODEL["num_heads"], num_layers=TRAIN_MODEL["num_layers"],
                 seq_len=TRAIN_MODEL["max_len"], per_chip_batch=TRAIN_BATCH)
PLAN_WINNER = "dp[data=1]z00a1f0s0o0t0"  # compute sets the step: f0 and f1 tie, f0 first
# A verification step at L = 6: kernels 1–3 once a layer; the fused head's
# saved-scores kernels 11–13 once (N = 8192 rows, the scores kept).
PLAN_PER_STEP = {"flash_forward_lse": 6, "flash_dq": 6, "flash_dkdv": 6}
PLAN_HEAD = {"xent_fwd_save": 1, "xent_dx_s": 1, "xent_dw_s": 1}
PLAN_TASK2_BATCH = 256  # task2 --plan's one epoch on the card, 234 steps


def _plan_cli(argv: list[str]) -> list[str]:
    """``python -m tpudml_torch.plan``'s ``main(argv)`` in this process,
    its stdout captured; returns its lines."""
    import io

    from tpudml_torch.plan.__main__ import main as plan_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = plan_main(argv)
    check(rc == 0, f"python -m tpudml_torch.plan {' '.join(argv)} exited {rc}")
    return out.getvalue().splitlines()


def plan_phase() -> dict[str, dict[str, int]]:
    """Main path 17 (module docstring, phase 23). Returns the launch counts
    of the winner's and the fused candidate's verification steps."""
    import tempfile

    import torch

    from tpudml_torch.core import build_parser, config_from_args
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import make_optimizer
    from tpudml_torch.parallel.dp import _use_flash
    from tpudml_torch.plan import Candidate, ModelSpec, build_candidate, load_plan
    from tpudml_torch.plan import verify_candidate
    from tpudml_torch.plan.emit import _batch, _model
    from tpudml_torch.tasks import task2
    from tpudml_torch.train import TrainState, make_lm_fused_train_step

    t0 = time.perf_counter()
    paths = {}
    spec = ModelSpec(**PLAN_SPEC)
    budget_mb = torch.cuda.get_device_properties(0).total_memory / 1e6
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = Path(tmp) / "spec.json"
        spec_path.write_text(json.dumps(spec.to_dict()))
        argv = ["--world", "1", "--spec", str(spec_path), "--hbm_budget", f"{budget_mb:.0f}",
                "--top", "4"]
        reset_launch_counts()  # ---- main path 17 (plan_winner) starts here
        lines = _plan_cli(argv + ["--out", f"{tmp}/plan.json"])
        launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        need = {k.name: PLAN_PER_STEP.get(k.name, 0) for k in KERNELS}
        check(launches == need, f"the winner's verification launched {launches}, not {need}")
        paths["plan_winner"] = launches
        for line in lines:
            if line.strip():
                print(f"[plan] {line}")
        plan = load_plan(f"{tmp}/plan.json")
        winner = plan["winner"]
        check(winner["candidate"]["key"] == PLAN_WINNER,
              f"the world-1 winner is {winner['candidate']['key']}, not {PLAN_WINNER}")
        check(plan["verification"]["ok"] and not plan["verification"]["demoted"],
              f"the winner did not verify: {plan['verification']}")
        wall = float(re.search(r"step_wall_s=([0-9.]+)", "\n".join(lines)).group(1))
        peak, est = plan["predicted"]["peak_hbm_bytes"], winner["score"]["est_hbm_bytes"]
        print(f"[plan] world 1 (one-rank NCCL group): winner {PLAN_WINNER} verified by one "
              f"step on the card in {wall * 1e3:.1f} ms; measured peak {peak} bytes beside "
              f"estimate_hbm's {est} (measured / estimate {peak / est:.3f}); launches "
              f"{dict((k, c) for k, c in launches.items() if c)}")
        again = _plan_cli(argv + ["--out", f"{tmp}/plan_again.json"])
        first, second = load_plan(f"{tmp}/plan.json"), load_plan(f"{tmp}/plan_again.json")
        same = Path(f"{tmp}/plan.json").read_bytes() == Path(f"{tmp}/plan_again.json").read_bytes()
        wall2 = float(re.search(r"step_wall_s=([0-9.]+)", "\n".join(again)).group(1))
        print(f"[plan] the second --world 1 emission is byte-identical to the first: {same} "
              f"({len(Path(f'{tmp}/plan.json').read_bytes())} bytes; its verification step "
              f"{wall2 * 1e3:.1f} ms)")
        check(same, "two --world 1 emissions of the same plan differ: "
              + str({k: (first[k], second[k]) for k in first if first[k] != second[k]}))

        # The best-ranked fused_xent survivor, verified, then its engine's
        # step held against the single-card fused step.
        entry = next(e for e in plan["ranking"] if e["candidate"]["fused_xent"])
        cand = Candidate.from_dict(entry["candidate"])
        torch.cuda.empty_cache()
        reset_launch_counts()  # ---- main path 17 (plan_fused) starts here
        v = verify_candidate(spec, cand, int(budget_mb * 1e6), device="cuda")
        launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        need = {k.name: PLAN_PER_STEP.get(k.name, 0) + PLAN_HEAD.get(k.name, 0)
                for k in KERNELS}
        check(launches == need, f"the fused candidate launched {launches}, not {need}")
        check(v["ok"], f"{cand.key()} did not verify: {v['findings']}")
        paths["plan_fused"] = launches
        fpeak, fest = v["predicted"]["peak_hbm_bytes"], entry["score"]["est_hbm_bytes"]
        x, y = _batch(spec, 1)
        with _one_rank_group(tmp):
            eng, ts, step, _ = build_candidate(spec, cand, "cuda")
            ts, m = step(ts, x, y)
            e_loss = m["loss"].item()
            e_params = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
            del eng, ts, step, m
        single = _model(spec, torch.device("cuda"))
        _use_flash(single)  # DataParallel(flash_attn=True)'s swap
        opt = make_optimizer("adamw", 3e-4)
        _, m1 = make_lm_fused_train_step(single, opt)(TrainState.create(single, opt), x, y)
        s_loss = m1["loss"].item()
        s_params = {n: p.detach() for n, p in single.named_parameters()}
        bit = e_loss == s_loss and _bitwise(e_params, s_params)
        diff, name = max(((e_params[n] - s_params[n]).abs().max().item(), n) for n in s_params)
        if not bit:
            check(abs(e_loss - s_loss) <= LOSS_TOL and diff <= 2 * 3e-4,
                  f"{cand.key()}'s step differs from the single-card step: loss "
                  f"{e_loss} vs {s_loss}, parameter {name} {diff:.3e} off")
        print(f"[plan] the best fused_xent survivor {cand.key()} (rank "
              f"{plan['ranking'].index(entry) + 1}) verified in {v['step_wall_s'] * 1e3:.1f} "
              f"ms; measured peak {fpeak} bytes beside estimate_hbm's {fest} (measured / "
              f"estimate {fpeak / fest:.3f}); its step against the single-card "
              f"make_lm_fused_train_step: loss {e_loss:.6f} vs {s_loss:.6f}, bitwise "
              f"(loss and every parameter) {bit}, max |param diff| {diff:.3e} ({name}); "
              f"launches {dict((k, c) for k, c in launches.items() if c)}")
        del single, s_params, e_params
        torch.cuda.empty_cache()

        # --plan in a task: the plan's knobs fill task2's defaults, an
        # explicit flag wins, and task2 runs one epoch on the card.
        ec = plan["engine_config"]
        cfg = config_from_args(build_parser().parse_args(["--plan", f"{tmp}/plan.json"]))
        merged = {k: getattr(cfg, k) for k in ("zero1", "accum_steps", "sentinel", "obs",
                                               "aggregation")}
        check(all(merged[k] == ec[k] for k in merged), f"--plan merged {merged}, plan {ec}")
        cfg2 = config_from_args(build_parser().parse_args(
            ["--plan", f"{tmp}/plan.json", "--accum_steps", "2"]))
        check(cfg2.accum_steps == 2, "an explicit --accum_steps did not beat the plan")
        root = Path(tmp) / "mnist"
        root.mkdir()
        _write_mnist_idx(root)
        m, tlines = _lab(task2, ["--data_dir", str(root), "--log_dir", f"{tmp}/logs",
                                 "--device", "cuda", "--epochs", "1", "--log_every", "0",
                                 "--batch_size", str(PLAN_TASK2_BATCH), "--plan",
                                 f"{tmp}/plan.json"])
        check(m["steps"] > 0 and m["test_accuracy"] >= LABS_ACC_FLOOR,
              f"task2 --plan did not learn: {m['test_accuracy']}")
        print(f"[plan] task2 --plan on the card, one epoch at batch {PLAN_TASK2_BATCH}: merged "
              f"knobs {merged} (the plan's engine_config); --accum_steps 2 beside --plan "
              f"gives accum_steps {cfg2.accum_steps}; test accuracy "
              f"{m['test_accuracy']:.4f} in {m['steps']} steps, "
              f"{m['train_time_s'] * 1e3 / m['steps']:.3f} ms/step")
    check(not torch.distributed.is_initialized(), "the plan's group outlived its phase")
    print(f"[plan] {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------- the elastic controller (phase 24)

ELASTIC_TIMEOUT_S = 300.0


def elastic_phase() -> dict[str, dict[str, int]]:
    """Main path 18 (module docstring, phase 24). Returns the launch counts
    of this process during the drill: none, as its ranks are child
    processes training an MLP, which runs no kernel of the port."""
    import tempfile

    from tpudml_torch.elastic.drill import run_drill
    from tpudml_torch.ops import KERNELS, reset_launch_counts

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()  # ---- main path 18 (elastic_drill) starts here
        rep = run_drill(tmp, world=1, kill_rank=0, device="cuda",
                        timeout_s=ELASTIC_TIMEOUT_S)
        launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    check(rep["ok"] and rep["bit_exact"] and rep["reforms"] == 1,
          f"the restart drill failed: {rep}")
    check(rep["resume_step"] == 10 and rep["steps_lost"] == 3 and rep["fresh_port"],
          f"the drill resumed from step {rep['resume_step']}: {rep}")
    print(f"[elastic] restart drill at world 1 (one NCCL rank; ForwardMLP under "
          f"DataParallel, SGD momentum, {rep['steps']} steps, sharded checkpoints every 5): "
          f"rank {rep['killed_rank_observed']} killed at step {rep['kill_step']}, re-formed "
          f"on a fresh port ({rep['coordinator_ports'][0]} -> {rep['coordinator_ports'][1]}) "
          f"after {rep['backoff_s']:.3f} s of backoff, resumed from step {rep['resume_step']} "
          f"({rep['steps_lost']} steps lost); restart latency (the failed round's end to the "
          f"resume) {rep['restart_latency_s']:.3f} s; final parameter CRC "
          f"{rep['params_crc']} bitwise the uninterrupted run's: {rep['bit_exact']}; wall "
          f"{rep['drill_wall_s']:.2f} s against {rep['clean_wall_s']:.2f} s uninterrupted "
          f"(+{rep['overhead_vs_clean_frac'] * 100:.1f}%)")
    print(f"[elastic] {time.perf_counter() - t0:.1f} s")
    return {"elastic_drill": launches}


# ---------------------------------------------- the MPMD pipelines (phase 25)

MPMD_TIMEOUT_S = 300.0
# (a): tests/test_mpmd_pipeline.py's spec and widths: a bf16 trunk with 2
# microbatches feeding an f32 head with 1, global batch 8, 5 steps.
MPMD_KW = dict(feature_dim=8, hidden=(16,), classes=4, seed=0, lr=0.1, momentum=0.9)
MPMD_STEPS = 5
MPMD_TOL = dict(rtol=1e-5, atol=1e-6)
# (c): the same split at feature 1024, hidden 4096,4096,4096, classes 1024,
# global batch 256; ms a step the median of MPMD_TIMED steps after
# MPMD_WARMUP.
MPMD_TIMED_KW = dict(feature_dim=1024, hidden=(4096, 4096, 4096), classes=1024, seed=0,
                     lr=0.01, momentum=0.9)
MPMD_TIMED_BATCH = 256
MPMD_WARMUP, MPMD_TIMED = 3, 10


def _mpmd_spec(global_batch: int):
    from tpudml_torch.mpmd import PipelineSpec, StageSpec

    return PipelineSpec(stages=(StageSpec("trunk", microbatches=2, dtype="bfloat16"),
                                StageSpec("head", microbatches=1, dtype="float32")),
                        global_batch=global_batch)


def _mpmd_pair(spec, kw: dict, batch_for):
    """Two stage workers on the card over one ``channel_pair``."""
    from tpudml_torch.comm.p2p import channel_pair
    from tpudml_torch.mpmd import runtime as rt

    edge = "s0r0->s1r0"
    a, b = channel_pair(edge, timeout_s=120.0)
    trunk = rt.StageWorker(spec, 0, 0, program=rt.StageProgram(spec, 0, device="cuda", **kw),
                           batch_for=batch_for, down_channels={edge: a})
    up = rt.stage_layer_dims(kw["feature_dim"], kw["hidden"], kw["classes"], 2)[0][-1][1]
    head = rt.StageWorker(spec, 1, 0, program=rt.StageProgram(spec, 1, device="cuda", **kw),
                          batch_for=batch_for, up_features=up, up_channels={edge: b})
    return trunk, head, (a, b)


def _mpmd_steps(trunk, head, steps) -> list[float]:
    """Run ``steps`` on both stage threads at once; the head's losses."""
    import torch

    from tpudml_torch.mpmd import runtime as rt

    out = rt.run_stage_threads({"trunk": trunk, "head": head}, steps)["head"]
    torch.cuda.synchronize()
    return out


def mpmd_phase() -> dict[str, dict[str, int]]:
    """Main path 19 (module docstring, phase 25). Returns its launch counts:
    none, as the stage programs are plain products (JAX computes them
    outside any Pallas kernel) and the drill's stages are child
    processes."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch.comm.p2p import p2p_wire_bytes
    from tpudml_torch.mpmd import runtime as rt
    from tpudml_torch.mpmd.drill import run_mpmd_drill
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.tools.profile_serve import _kernel_breakdown

    t0 = time.perf_counter()
    reset_launch_counts()  # ---- main path 19 (mpmd) starts here
    # (a) Heterogeneous 1F1B, two stage threads on the card, against the
    # single-program reference on the card.
    spec = _mpmd_spec(8)
    batch_for = rt.make_batch_fn(8, MPMD_KW["feature_dim"], MPMD_KW["classes"], 0)
    trunk, head, chans = _mpmd_pair(spec, MPMD_KW, batch_for)
    losses = _mpmd_steps(trunk, head, range(MPMD_STEPS))
    for ch in chans:
        ch.close()
    params, mom, step_fn = rt.reference_step_fn(spec, device="cuda", **MPMD_KW)
    ref = []
    for k in range(MPMD_STEPS):
        x, y = batch_for(k)
        params, mom, loss, _ = step_fn(params, mom, x, y)
        ref.append(float(loss))
    lgap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref))
    pgap = 0.0
    for want, worker in ((params[0], trunk), (params[1], head)):
        for wl, gl in zip(want, worker.program.params):
            for key in ("w", "b"):
                check(gl[key].is_cuda, "a stage's parameter left the card")
                got, exp = gl[key].double(), wl[key].double()
                check(bool(((got - exp).abs() <= MPMD_TOL["atol"]
                            + MPMD_TOL["rtol"] * exp.abs()).all()),
                      f"[mpmd] stage parameter {key} differs from the reference")
                pgap = max(pgap, float(((got - exp).abs() / exp.abs().clamp_min(1e-30)).max()))
    check(np.allclose(losses, ref, **MPMD_TOL), f"[mpmd] losses {losses} != reference {ref}")
    print(f"[mpmd] (a) heterogeneous 1F1B on the card (trunk bf16, 2 microbatches -> head f32, "
          f"1; global batch 8; widths 8-16-4; two stage threads over a socketpair), "
          f"{MPMD_STEPS} steps against reference_step_fn on the card: losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; max rel |loss diff| {lgap:.3e}, every "
          f"parameter within rtol 1e-5 / atol 1e-6 (max rel {pgap:.3e}); the trunk's wire "
          f"carried {trunk.program.dtype}")

    # (b) The re-mesh drill, its four stage processes on the one card.
    with tempfile.TemporaryDirectory() as tmp:
        rep = run_mpmd_drill(tmp, device="cuda", timeout_s=MPMD_TIMEOUT_S)
    check(rep["ok"] and rep["bit_exact"] and rep["in_place"], f"the MPMD drill failed: {rep}")
    check(rep["final_stage_worlds"] == [2, 1] and rep["resume_step"] == 10
          and rep["steps_lost"] == 3 and rep["fresh_ports"]
          and rep["replan_error"] is None and rep["replan_receipts"]
          and rep["clean_wall_s"] is not None,
          f"the MPMD drill re-formed otherwise: {rep}")
    print(f"[mpmd] (b) re-mesh drill, four stage processes on one H100 (stage groups sum over "
          f"gloo; boundaries over TCP): stage {rep['victim']['stage']} rank "
          f"{rep['victim']['rank']} killed at step {rep['kill_step']}; drains "
          f"{rep['drains']}; re-plan fail-open ({len(rep['replan_receipts'])} receipts, "
          f"error {rep['replan_error']}); [2, 2] -> {rep['final_stage_worlds']} in place on "
          f"fresh ports {rep['coordinator_ports']}; resumed from step {rep['resume_step']} "
          f"({rep['steps_lost']} steps lost); survivors' CRCs {rep['params_crc']} bitwise the "
          f"uninterrupted reference's: {rep['bit_exact']}; backoff {rep['backoff_s']:.3f} s, "
          f"restart latency (the failed round's end to the last resume) "
          f"{rep['restart_latency_s']:.3f} s, re-mesh MTTR (the kill to the last resume) "
          f"{rep['remesh_mttr_s']:.3f} s; wall {rep['drill_wall_s']:.2f} s against "
          f"{rep['clean_wall_s']:.2f} s uninterrupted "
          f"(+{rep['overhead_vs_clean_frac'] * 100:.1f}%)")

    # (c) One timed configuration.
    spec = _mpmd_spec(MPMD_TIMED_BATCH)
    make = rt.make_batch_fn(MPMD_TIMED_BATCH, MPMD_TIMED_KW["feature_dim"],
                            MPMD_TIMED_KW["classes"], 0)
    n = MPMD_WARMUP + MPMD_TIMED + 2 * (PROFILE_TRIES + 1)
    batches = {k: make(k) for k in range(n)}  # set-up: made in bulk before timing
    trunk, head, (a, b) = _mpmd_pair(spec, MPMD_TIMED_KW, batches.__getitem__)
    _mpmd_steps(trunk, head, range(MPMD_WARMUP))
    f0, w0 = a.frames + b.frames, a.bytes_sent + b.bytes_sent
    walls = []
    for k in range(MPMD_WARMUP, MPMD_WARMUP + MPMD_TIMED):
        t1 = time.perf_counter()
        _mpmd_steps(trunk, head, [k])
        walls.append((time.perf_counter() - t1) * 1e3)
    frames = (a.frames + b.frames - f0) / MPMD_TIMED / 2  # each frame counted at both ends
    sent = (a.bytes_sent + b.bytes_sent - w0) / MPMD_TIMED
    ms = statistics.median(walls)
    nxt = iter(range(MPMD_WARMUP + MPMD_TIMED, n))
    for _ in range(PROFILE_TRIES):
        prof = _kernel_breakdown(lambda: _mpmd_steps(trunk, head, [next(nxt)]), 2)
        if prof["kernels_per_call"] > 0:
            break
    check(prof["kernels_per_call"] > 0, "the profiler saw no device activity in the MPMD step")
    for ch in (a, b):
        ch.close()
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    print(f"[mpmd] (c) one card, two stage threads, no cross-card byte: trunk bf16 (1024 -> "
          f"4096 -> 4096, 2 microbatches of 128 rows) -> head f32 (4096 -> 4096 -> 1024, 1 "
          f"microbatch), global batch {MPMD_TIMED_BATCH}: {ms:.3f} ms a step (median of "
          f"{MPMD_TIMED} after {MPMD_WARMUP}; min {min(walls):.3f}, max {max(walls):.3f}); "
          f"{frames:.0f} frames a step, {sent:,.0f} payload bytes, p2p_wire_bytes "
          f"{p2p_wire_bytes(int(sent)):,.0f} a step (host memory through a socketpair); "
          f"{prof['kernels_per_call']:.0f} device kernels summing "
          f"{prof['kernel_ms_per_call']:.3f} ms: busy {prof['kernel_ms_per_call'] / ms:.3f} "
          f"(torch.profiler over 2 steps)")
    print(f"[mpmd] {time.perf_counter() - t0:.1f} s")
    return {"mpmd": launches}


# ------------------------------------------- the serving fleet (phase 26)

FLEET_REPLICAS = 3
# 2x the fleet's capacity, as bench.py:1394-1395 sets it: 3 replicas x 8
# slots / 0.01 s a step / ~40 tokens a request = 60 requests/s.
FLEET_WORKLOAD = dict(n=48, qps=120.0, seed=17, prompt_len=(64, 512), new_tokens=(16, 64))
FLEET_ENGINE = dict(SERVE_CFG, step_time_s=0.01, deadline_s=2.0)
FLEET_KILL = (12, 1)  # (fleet step, replica)
FLEET_REFORM = 6  # fleet steps from the kill to the re-form
FLEET_PAGE = 128
FLEET_SLO_S = 1.0  # loose: the cost models price, never defer (tests/test_fleet.py:315)
FLEET_INT8_SLOTS = SERVE_CFG["slots"]  # the mixed run's first admits fill the int8 replica
HANDOFF_PROMPT = 385  # 3 pages of 128 end before the first decode write at 384
HANDOFF_NEW = 32
FLEET_DRILL_TIMEOUT_S = 300.0


def _fleet_log(report, requests, victim: int | None):
    """Each request's residencies from the fleet's event log, and the
    victim's tenants at its kill. A request admitted at step a and drained
    at step d produced d - a tokens there (every live replica with tenants
    decodes once a fleet step, one token a slot); its last residency
    produced the rest. Returns ({rid: [(replica, prompt length at the
    admit, tokens), ...]}, tenants)."""
    base = {r.rid: len(r.prompt) for r in requests}
    segs = {rid: [] for rid in base}
    live, tenants = {}, None

    def done(rid):
        return sum(n for _, _, n in segs[rid] if n is not None)

    for kind, rid, rep, _, step in report.events:
        if kind == "admit":
            live[rid] = (rep, base[rid] + done(rid), step)
        elif kind in ("evict", "expire") and rep >= 0:
            r, plen, _ = live.pop(rid)
            segs[rid].append((r, plen, None))
        elif kind == "kill" and rep == victim:
            tenants = sum(1 for r, _, _ in live.values() if r == victim)
        elif kind == "drain":
            r, plen, a = live.pop(rid)
            segs[rid].append((r, plen, step - a))
    for rid, seg in segs.items():
        rest = len(report.requests[rid].tokens) - done(rid)
        segs[rid] = [(r, plen, rest if n is None else n) for r, plen, n in seg]
    return segs, tenants


def _fleet_segment_check(models: dict, requests, report, segs, label: str) -> int:
    """Hold every token of every finished request against the argmax of a
    full forward (plain attention) on the weights of the replica that
    produced it; a mismatch must be a near-tie (TIE_GAP). Returns the
    mismatches."""
    import torch

    mism = 0
    with torch.inference_mode():
        for req in requests:
            st = report.requests[req.rid]
            if st.finished is None:
                continue
            base = len(req.prompt)
            seq = torch.tensor(list(req.prompt) + st.tokens[:-1], device="cuda")
            for rep, plen, n in segs[req.rid]:
                start = plen - base
                logits = models[rep](seq[None])[0, plen - 1:plen - 1 + n]
                pick, gap = torch.argmax(logits, dim=-1).tolist(), _top2_gap(logits)
                for i, (a, r) in enumerate(zip(st.tokens[start:start + n], pick)):
                    if a != r:
                        mism += 1
                        print(f"[fleet] {label}: request {req.rid} token {start + i} (replica "
                              f"{rep}): {a} vs full-forward {r}, top-2 gap {gap[i].item():.3e}")
                        check(gap[i].item() < TIE_GAP,
                              f"{label}: a token disagrees with its replica's full forward "
                              f"off a near-tie")
    return mism


def _fleet_line(path: str, rep, wall_s: float, launches: dict) -> None:
    lat = rep.latency_summary()
    used = {k: v for k, v in launches.items() if v}
    busy = [r["busy_slot_steps"] for r in rep.per_replica]
    print(f"[fleet] {path}: {rep.finished} finished, {rep.rejected} rejected, {rep.expired} "
          f"expired of {len(rep.requests)}; {rep.generated_tokens} tokens in {rep.steps} fleet "
          f"steps; virtual clock (step_time_s {FLEET_ENGINE['step_time_s']}): "
          f"{rep.tokens_per_sec:.1f} tok/s (virtual), TTFT p50/p99 "
          f"{lat['ttft_p50_s']:.3f}/{lat['ttft_p99_s']:.3f} s (virtual), TPOT p50/p99 "
          f"{lat['per_token_p50_s']:.3f}/{lat['per_token_p99_s']:.3f} s (virtual); wall "
          f"{wall_s:.3f} s, {wall_s * 1e3 / max(rep.steps, 1):.2f} ms a fleet step (wall); "
          f"kills {rep.kills}, drains {rep.drains}, readmits "
          f"{sum(st.readmits for st in rep.requests.values())}; busy slot-steps a replica "
          f"{busy}, decode steps {[r['decode_steps'] for r in rep.per_replica]}; launches {used}")


def _fleet_handoff(model, kind: str, tmp) -> dict[str, int]:
    """(b) at ``kind``: a 385-token prompt's prefill handed off as 3 pages
    and adopted by a decode engine, against a local-prefill engine and a
    truncated handoff. Returns the launches of its four counted windows,
    summed."""
    import numpy as np

    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.resilience import vandalize
    from tpudml_torch.serve import Request, ServeConfig, ServingEngine
    from tpudml_torch.serve.fleet import adopt_handoff, write_handoff

    cfg = ServeConfig(**SERVE_CFG, cache_kind=kind, cache_layout="paged", page_size=FLEET_PAGE,
                      prefix_sharing=True, step_time_s=FLEET_ENGINE["step_time_s"])
    prompt = np.random.default_rng(23).integers(0, SERVE_MODEL["vocab_size"],
                                                HANDOFF_PROMPT).astype(np.int32)
    req = [Request(rid=0, prompt=prompt, max_new_tokens=HANDOFF_NEW)]
    ServingEngine(model, cfg, device="cuda").run(  # warm-up, not counted
        [Request(rid=0, prompt=prompt[::-1].copy(), max_new_tokens=2)])
    counts = {}

    def counted(tag, fn):
        reset_launch_counts()  # ---- each window starts here
        out = fn()
        counts[tag] = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        return out

    chunk, layers = SERVE_CFG["prefill_chunk"], SERVE_MODEL["num_layers"]
    need = expected_flash_calls(req, chunk, layers)
    t0 = time.perf_counter()
    info = counted("write", lambda: write_handoff(model, cfg, prompt, tmp / kind, device="cuda"))
    t_write = time.perf_counter() - t0
    eng = ServingEngine(model, cfg, device="cuda")
    t0 = time.perf_counter()
    pages = adopt_handoff(eng, tmp / kind)
    t_adopt = time.perf_counter() - t0
    adopted = counted("adopted", lambda: eng.run(req)).requests[0]
    local = counted("local", lambda: ServingEngine(model, cfg, device="cuda").run(req)).requests[0]
    vandalize(str(tmp / kind), "truncate")
    eng = ServingEngine(model, cfg, device="cuda")
    fallback_pages = adopt_handoff(eng, tmp / kind)
    fallback = counted("truncated", lambda: eng.run(req)).requests[0]
    check(info["n_pages"] == pages == 3 and info["covered_tokens"] == 3 * FLEET_PAGE,
          f"handoff {kind}: {info} written, {pages} adopted, 3 pages expected")
    check(adopted.shared_pages == 3 and local.shared_pages == 0 and fallback_pages == 0
          and fallback.shared_pages == 0, f"handoff {kind}: shared pages {adopted.shared_pages}"
          f" / {local.shared_pages} / {fallback.shared_pages}, fallback adopted {fallback_pages}")
    flash = {tag: c["flash_forward_lse"] for tag, c in counts.items()}
    check(flash == {"write": need, "adopted": 0, "local": need, "truncated": need} == {
        "write": 36, "adopted": 0, "local": 36, "truncated": 36},
        f"handoff {kind}: kernel 1 launched {flash}, the prefill needs {need}")
    check(all(v == 0 for c in counts.values() for n, v in c.items() if n != "flash_forward_lse"),
          f"handoff {kind}: a kernel other than 1 launched: {counts}")
    check(adopted.tokens == local.tokens == fallback.tokens,
          f"handoff {kind}: the adopted or truncated stream differs from local prefill's")
    print(f"[fleet] (b) handoff, {kind} cache, page {FLEET_PAGE}, prefix sharing: a "
          f"{HANDOFF_PROMPT}-token prompt handed off as {info['n_pages']} pages "
          f"({info['covered_tokens']} tokens; written in {t_write * 1e3:.1f} ms wall, adopted in "
          f"{t_adopt * 1e3:.1f} ms wall); kernel 1 launches write / adopted decode / local "
          f"prefill / truncated fallback {flash['write']} / {flash['adopted']} / "
          f"{flash['local']} / {flash['truncated']}; the {HANDOFF_NEW}-token streams bitwise "
          f"equal; the truncated handoff adopted {fallback_pages} pages")
    return {n: sum(c[n] for c in counts.values()) for n in counts["write"]}


def fleet_phase() -> dict[str, dict[str, int]]:
    """Main path 20 (module docstring, phase 26): (a) the router at full
    serving width, four runs, each its launches its own path; (b) the KV
    handoff, f32 and int8; (c) the spawned drill at world 2 on one card."""
    import tempfile

    import torch

    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.serve import ServeConfig, ServingEngine, SLOConfig, poisson_workload
    from tpudml_torch.serve.fleet import FleetConfig, FleetRouter, run_fleet_drill
    from tpudml_torch.serve.fleet import drill as fleet_drill

    t_phase = time.perf_counter()
    model = TransformerLM(**SERVE_MODEL, device="cuda", generator=torch.Generator().manual_seed(0))
    w = FLEET_WORKLOAD
    requests, _ = poisson_workload(w["n"], w["qps"], w["seed"],
                                   vocab_size=SERVE_MODEL["vocab_size"],
                                   prompt_len=w["prompt_len"], new_tokens=w["new_tokens"])
    chunk, layers = SERVE_CFG["prefill_chunk"], SERVE_MODEL["num_layers"]
    dense = ServeConfig(**FLEET_ENGINE)
    paged = ServeConfig(**FLEET_ENGINE, cache_layout="paged", page_size=FLEET_PAGE,
                        prefix_sharing=True)
    slo = SLOConfig(tpot_budget_s=FLEET_SLO_S)
    f32 = ServeConfig(**FLEET_ENGINE, slo=slo, fused_head=True)
    i8 = ServeConfig(**FLEET_ENGINE, slo=slo, fused_head=True, weight_quant="int8")
    common = dict(replicas=FLEET_REPLICAS, max_queue=2 * FLEET_REPLICAS)
    kill = dict(common, reform_after_steps=FLEET_REFORM)
    runs = {  # path: (FleetConfig, kills)
        "fleet_no_kill": (FleetConfig(engine=dense, **common), []),
        "fleet_kill": (FleetConfig(engine=dense, **kill), [FLEET_KILL]),
        "fleet_paged_kill": (FleetConfig(engine=paged, **kill), [FLEET_KILL]),
        "fleet_mixed_kill": (FleetConfig(engine=f32, replica_engines=(f32, f32, i8), **kill),
                             [FLEET_KILL]),
    }
    paths, reports, routers = {}, {}, {}
    for path, (cfg, kills) in runs.items():
        FleetRouter(model, cfg, device="cuda").run(requests[:2])  # warm-up, not counted
        router = FleetRouter(model, cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launch_counts()  # ---- this path starts here
        rep = router.run(requests, kills=kills)
        torch.cuda.synchronize()
        paths[path] = {k.name: k.launches for k in KERNELS}  # ---- and ends here
        wall = time.perf_counter() - t0
        reports[path], routers[path] = rep, router
        _fleet_line(path, rep, wall, paths[path])

        victim = kills[0][1] if kills else None
        segs, tenants = _fleet_log(rep, requests, victim)
        for st in rep.requests.values():
            states = sum(x is not None for x in (st.finished, st.rejected, st.expired))
            check(states == 1, f"{path}: request {st.rid} ends in {states} terminal states")
            check(st.finished is None or len(st.tokens) == st.max_new_tokens,
                  f"{path}: request {st.rid} finished with {len(st.tokens)} of "
                  f"{st.max_new_tokens} tokens")
        if kills:
            check(rep.kills == 1 and rep.drains == tenants and tenants > 0,
                  f"{path}: {rep.drains} drains, the victim held {tenants} tenants at the kill")
            check(rep.per_replica[victim]["reformed_at"] == FLEET_KILL[0] + FLEET_REFORM,
                  f"{path}: replica {victim} re-formed at {rep.per_replica[victim]}")
        need = sum(layers * c * (c + 1) // 2 for seg in segs.values()
                   for c in (-(-(plen - 1) // chunk) for _, plen, _ in seg))
        got = paths[path]
        check(got["flash_forward_lse"] == need, f"{path}: {got['flash_forward_lse']} launches "
              f"of kernel 1, the admitted prompts (continuations too) need {need}")
        steps = [r["decode_steps"] for r in rep.per_replica]
        fused = {"fused_decode_head": 0, "fused_decode_head_int8": 0}
        if path == "fleet_mixed_kill":
            fused = {"fused_decode_head": steps[0] + steps[1],
                     "fused_decode_head_int8": steps[2]}
        check({n: got[n] for n in fused} == fused,
              f"{path}: decode heads launched {[got[n] for n in fused]}, the replicas' decode "
              f"steps {steps} need {fused}")
        others = {n: v for n, v in got.items()
                  if v and n not in fused and n != "flash_forward_lse"}
        check(not others, f"{path}: kernels off the fleet's path launched: {others}")

    no_kill = reports["fleet_no_kill"]
    mism = teacher_forced_check(model, requests,
                                {rid: st.tokens for rid, st in no_kill.requests.items()},
                                "fleet_no_kill")

    def finished(rep):
        return {rid for rid, st in rep.requests.items() if st.finished is not None}

    def streams(rep):
        return {rid: st.tokens for rid, st in rep.requests.items()}

    for path in ("fleet_kill", "fleet_paged_kill"):
        both = [r for r in requests if r.rid in finished(no_kill) & finished(reports[path])]
        compare_streams(model, both, streams(no_kill), streams(reports[path]),
                        f"{path} vs fleet_no_kill")
    pools = [r.get("pool", {}) for r in reports["fleet_paged_kill"].per_replica]
    check(all(p.get("prefix_hits") == 0 for p in pools),
          f"fleet_paged_kill: prefix hits {pools} (random prompts share no 128-token page)")

    rep = reports["fleet_mixed_kill"]
    admits = [e[2] for e in rep.events if e[0] == "admit"]
    check(admits[:FLEET_INT8_SLOTS] == [2] * FLEET_INT8_SLOTS,
          f"fleet_mixed_kill: the first admits went to replicas {admits[:FLEET_INT8_SLOTS]}, "
          f"the int8 replica (2) prices cheapest")
    eng_models = {r.idx: r.eng.model for r in routers["fleet_mixed_kill"].replicas}
    segs, _ = _fleet_log(rep, requests, FLEET_KILL[1])
    mism += _fleet_segment_check(eng_models, requests, rep, segs, "fleet_mixed_kill")
    only = {rid: {r for r, _, _ in seg} for rid, seg in segs.items()}
    f32_only = [r for r in requests if r.rid in finished(rep) & finished(no_kill)
                and only[r.rid] <= {0, 1}]
    compare_streams(model, f32_only, streams(no_kill), streams(rep),
                    "fleet_mixed_kill f32 replicas vs fleet_no_kill")
    i8_only = [r for r in requests if r.rid in finished(rep) and only[r.rid] == {2}]
    i8_eng = ServingEngine(model, ServeConfig(**SERVE_CFG, fused_head=True, weight_quant="int8"),
                           device="cuda")
    single = i8_eng.run(i8_only)
    compare_streams(i8_eng.model, i8_only, streams(single), streams(rep),
                    "fleet_mixed_kill int8 replica vs a single int8 engine", INT8_TIE_GAP)

    again = FleetRouter(model, runs["fleet_kill"][0], device="cuda").run(
        requests, kills=runs["fleet_kill"][1])
    check(again.canonical_events() == reports["fleet_kill"].canonical_events(),
          "fleet_kill: a second run's event log differs")
    print(f"[fleet] (a) {FLEET_REPLICAS} replicas of the serving model, {w['n']} requests at "
          f"{w['qps']} req/s (2x capacity), replica {FLEET_KILL[1]} killed at step "
          f"{FLEET_KILL[0]} and re-formed {FLEET_REFORM} steps later: every request in one "
          f"terminal state, drains = the victim's tenants, kernel 1 = the admitted prompts' "
          f"chunks, 4 / 5 = the fused replicas' decode steps; fleet_kill's event log "
          f"byte-identical on a second run (CRC {again.events_crc32():08x}); streams against "
          f"fleet_no_kill and the replicas' full forwards ({mism} near-tie mismatches); "
          f"{len(i8_only)} int8-only streams against a single int8 engine (gap < "
          f"{INT8_TIE_GAP}); the mixed run's first {FLEET_INT8_SLOTS} admits on the int8 replica")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for kind, path in (("f32", "fleet_handoff"), ("int8", "fleet_handoff_int8")):
            paths[path] = _fleet_handoff(model, kind, tmp)
        reset_launch_counts()  # ---- fleet_drill starts here
        drill = run_fleet_drill(tmp / "drill", world=2, kill_rank=1, device="cuda",
                                timeout_s=FLEET_DRILL_TIMEOUT_S)
        paths["fleet_drill"] = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    check(drill["ok"] and drill["crc_ok"] and drill["reforms"] >= 1,
          f"the fleet drill failed: {drill}")
    ref_reqs = fleet_drill._workload(10, 0)
    need = expected_flash_calls(ref_reqs, fleet_drill.SERVE_KW["prefill_chunk"],
                                fleet_drill.MODEL_KW["num_layers"])
    got = {n: v for n, v in paths["fleet_drill"].items() if v}
    check(got == {"flash_forward_lse": need},
          f"fleet_drill: this process launched {got}; its reference's prefill needs {need}")
    crcs = ", ".join(f"rank {r} {v.get('tokens_crc', 0):08x}"
                     for r, v in drill["ranks"].items())
    print(f"[fleet] (c) drill: {drill['world']} replica processes on one card under the "
          f"elastic controller, rank 1 SIGKILLed mid-serve and re-formed ({drill['reforms']} "
          f"re-form, {drill['stop_reason']}); token CRCs equal the uninterrupted in-process "
          f"reference's: {drill['crc_ok']} "
          f"({crcs}); "
          f"restart latency (the failed round's end to the re-formed round's spawn) "
          f"{drill['restart_latency_s']:.3f} s, recovery (to the re-formed round's end) "
          f"{drill['recovery_s']:.3f} s, wall {drill['wall_s']:.2f} s; the reference launched "
          f"kernel 1 {need} times")
    print(f"[fleet] {time.perf_counter() - t_phase:.1f} s")
    return paths


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _ckpt_roundtrip(tag: str, tmp: str, ts, engine, fresh_ts, fresh_engine, tensors) -> None:
    """Save ``ts`` through the sharded store with ``engine``'s placement,
    verify it, restore it into ``fresh_ts`` and require every tensor of
    ``tensors(state)`` bitwise; prints bytes and seconds."""
    import torch

    from tpudml_torch.checkpoint import (
        restore_sharded_checkpoint, save_sharded_checkpoint, verify_sharded_checkpoint,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_sharded_checkpoint(f"{tmp}/{tag}", ts, ts.step, placement=engine.placement)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = verify_sharded_checkpoint(path)
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restore_sharded_checkpoint(path, fresh_ts, placement=fresh_engine.placement)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    a, b = tensors(ts), tensors(fresh_ts)
    check(step == ts.step == fresh_ts.step and len(a) == len(b)
          and all(torch.equal(x, y) for x, y in zip(a, b)),
          f"the {tag} state did not restore bitwise")
    print(f"[zero1] sharded store, {tag} state: {_dir_bytes(path) / 1e6:.1f} MB in "
          f"{len(list(Path(path).iterdir()))} files; save {save_s:.2f} s, verify {verify_s:.2f} "
          f"s, restore (CRCs verified) {restore_s:.2f} s; {len(a)} tensors bitwise")


def zero1_phase() -> dict[str, dict[str, int]]:
    """Main path 12 (module docstring, phase 18). Returns the launch counts of
    the ZeRO-1 flagship runs."""
    import tempfile

    import numpy as np
    import torch

    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import Adam, AdamW
    from tpudml_torch.parallel import DataParallel, GSPMDParallel
    from tpudml_torch.tasks import task2

    t0 = time.perf_counter()
    t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
    batch = synthetic_lm(TRAIN_BATCH, t, v, seed=1)  # the flagship phase's
    paths = {}

    def model(seed=3):
        return TransformerLM(**TRAIN_MODEL, impl="full", fused_ln=True, device="cuda",
                             compute_dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(seed))

    def tensors(state):
        if isinstance(state, dict):
            return [x for k in sorted(state) for x in tensors(state[k])]
        return [state] if isinstance(state, torch.Tensor) else []

    with tempfile.TemporaryDirectory() as tmp, _one_rank_group(tmp) as group:
        def run(accum=1, count=None, **kw):
            m = model()
            dp = DataParallel(m, AdamW(lr=FLAGSHIP_LR), group, fused_xent=True,
                              save_scores=True, flash_attn=True, accum_steps=accum, **kw)
            ts = dp.create_state()
            if count:
                reset_launch_counts()  # ---- the path starts here
            losses, ms = _train_run(ts, dp.make_train_step(), [batch] * FLAGSHIP_STEPS)
            if count:
                paths[count] = {k.name: k.launches for k in KERNELS}  # ---- and ends here
            return losses, ms, dp.gather_params(ts), dp, ts

        a1, a2 = run(), run()
        repeats = a1[0] == a2[0] and _bitwise(a1[2], a2[2])
        z = run(zero1=True, count="zero1")
        d = run(accum=2)
        zo = run(accum=2, zero1=True, zero1_overlap=True, count="zero1_overlap")
        for tag, got, want, per in (("zero1=True", z, a1, 1),
                                    ("zero1_overlap=True, accum_steps=2", zo, d, 2)):
            if repeats:
                check(got[0] == want[0] and _bitwise(got[2], want[2]),
                      f"DataParallel({tag}) at world 1 differs from the step without ZeRO-1")
                agree = "bitwise (losses and every parameter)"
            else:
                lgap = max(abs(x - y) for x, y in zip(a1[0], a2[0]))
                pgap = max((a1[2][n] - a2[2][n]).abs().max().item() for n in a1[2])
                ldiff = max(abs(x - y) for x, y in zip(got[0], want[0]))
                worst = max((got[2][n] - want[2][n]).abs().max().item() for n in want[2])
                check(ldiff <= DP_GAP_MULT * lgap and worst <= DP_GAP_MULT * pgap,
                      f"DataParallel({tag}) disagrees with the step without ZeRO-1")
                agree = f"within {DP_GAP_MULT} x the step's own gap"
            name = "zero1" if per == 1 else "zero1_overlap"
            for k, n in paths[name].items():
                need = FLAGSHIP_STEPS * per * FLAGSHIP_PER_STEP.get(k, 0)
                check(n == need, f"{tag} launched {k} {n} times, need {need}")
            opt_mb = sum(x.numel() * x.element_size() for x in tensors(got[4].opt_state)
                         if x.dim() > 0) / 1e6
            print(f"[zero1] world 1 (one-rank NCCL group), bf16 flagship, "
                  f"DataParallel({tag}): losses {' '.join(f'{x:.6f}' for x in got[0])}; "
                  f"{agree} vs the same step without ZeRO-1 (which repeats itself: "
                  f"{repeats}); {got[1]:.2f} ms/step vs {want[1]:.2f} ms/step; optimizer "
                  f"state {opt_mb:.1f} MB on this rank; launches {paths[name]} = "
                  f"{FLAGSHIP_STEPS} x {per} x {FLAGSHIP_PER_STEP}")
        print(f"[zero1] without ZeRO-1: {a1[1]:.2f}, {a2[1]:.2f} ms/step (accum_steps=1), "
              f"{d[1]:.2f} ms/step (accum_steps=2)")

        # The sharded store: ZeRO-1's state, then a GSPMD state.
        m2 = model(seed=9)
        dp2 = DataParallel(m2, AdamW(lr=FLAGSHIP_LR), group, fused_xent=True, save_scores=True,
                           flash_attn=True, zero1=True)
        ts2 = dp2.create_state()
        _ckpt_roundtrip("ZeRO-1 (AdamW, bf16 flagship)", tmp, z[4], z[3], ts2, dp2,
                        lambda ts: [*ts.model.parameters(), *tensors(ts.opt_state)])
        del z, zo, d, a1, a2, m2, dp2, ts2
        torch.cuda.empty_cache()

        def lm(seed):
            return TransformerLM(**TRAIN_MODEL, impl="full", fused_ln=True, device="cuda",
                                 generator=torch.Generator().manual_seed(seed))

        mp = GSPMDParallel(lm(1), Adam(lr=TRAIN_LR), {"stage": 1}, flash_attn=True)
        ts = mp.create_state()
        ts, _ = mp.make_train_step()(ts, batch[:, :-1], batch[:, 1:])
        mp2 = GSPMDParallel(lm(2), Adam(lr=TRAIN_LR), {"stage": 1}, flash_attn=True)
        _ckpt_roundtrip("GSPMD (stage rule, Adam, f32)", tmp, ts, mp, mp2.create_state(), mp2,
                        lambda s: [*s.model.parameters(), *tensors(s.opt_state)])
        del mp, mp2, ts
        torch.cuda.empty_cache()

        # task2 --zero1 on the IDX files.
        root = Path(tmp) / "mnist"
        root.mkdir()
        _write_mnist_idx(root)
        m, lines = _lab(task2, ["--data_dir", str(root), "--log_dir", f"{tmp}/logs",
                                "--device", "cuda", "--epochs", "1", "--log_every", "0",
                                "--zero1"])
        print(f"[zero1] task2 --zero1 (one epoch): test accuracy {m['test_accuracy']:.4f}, "
              f"{m['steps']} steps in {m['train_time_s']:.2f} s "
              f"({m['train_time_s'] * 1e3 / m['steps']:.3f} ms/step); {lines[-1]}")
        check(m["test_accuracy"] >= LABS_ACC_FLOOR, "task2 --zero1 did not learn")
    check(not torch.distributed.is_initialized(), "the ZeRO-1 group outlived its phase")
    print(f"[zero1] {time.perf_counter() - t0:.1f} s")
    return paths


# ------------------------------------------------------------ phase 27


ANALYSIS_TIMEOUT_S = 300.0
ANALYSIS_TIMED_STEPS = 3  # uncaptured: the first is the warm-up, ms over the rest
ANALYSIS_DECODE_POS = 100  # each slot's position in the decode captures
ANALYSIS_MOE_EXPERTS = 4
ANALYSIS_MARKER_CALLS = 200_000  # calls a timeit run in (e)
ANALYSIS_MARKER_REPEATS = 5
ANALYSIS_MARKER_SHARE = 0.01  # (e): most of a step the markers may cost


def _captured(name, step, args, donation: bool = True, **kw):
    """(capture, findings, launch counter deltas) of one captured step."""
    from tpudml_torch.analysis import analyze_capture, capture
    from tpudml_torch.ops import KERNELS

    before = {k.name: k.launches for k in KERNELS}
    cap = capture(step, args, name=name, **kw)
    deltas = {k.name: k.launches - before[k.name] for k in KERNELS if k.launches > before[k.name]}
    check(cap.error is None, f"the {name} capture raised {cap.error!r}")
    findings = analyze_capture(cap, name, expects_donation=donation)
    return cap, findings, deltas


def _rules(findings) -> list:
    return sorted({f.rule for f in findings})


def analysis_phase() -> dict[str, dict[str, int]]:
    """Main path 21 (module docstring, phase 27). Returns the launch counts
    of the captured steps."""
    import os
    import threading
    import timeit

    import torch

    from tpudml_torch import markers
    from tpudml_torch.analysis import ENTRYPOINTS, analyze_entrypoints
    from tpudml_torch.analysis.entrypoints import entrypoint_group
    from tpudml_torch.data import synthetic_lm
    from tpudml_torch.models import TransformerLM
    from tpudml_torch.ops import KERNELS, reset_launch_counts
    from tpudml_torch.optim import AdamW
    from tpudml_torch.resilience import attach_sentinel
    from tpudml_torch.serve import ServeConfig, ServingEngine
    from tpudml_torch.train import TrainState, make_lm_fused_train_step, make_train_step

    t_phase = time.perf_counter()
    # (a) the strict CLI in a child on the card, then every entrypoint on both devices
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != "TPUDML_DEVICE"}
    proc = subprocess.run([sys.executable, "-m", "tpudml_torch.analysis", "--strict"],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=ANALYSIS_TIMEOUT_S, env=env)
    lines = proc.stdout.strip().splitlines()
    print(f"[analysis] (a) python -m tpudml_torch.analysis --strict on the card: rc "
          f"{proc.returncode}, {lines[-1] if lines else proc.stderr[-300:]!r}, "
          f"{time.perf_counter() - t0:.1f} s")
    check(proc.returncode == 0, f"the strict CLI failed on the card: {proc.stdout[-2000:]}"
                                f"{proc.stderr[-2000:]}")
    check(lines and lines[-1].startswith("0 finding(s)"), "the strict CLI found something")
    check("stale allowlist" not in proc.stdout, "the strict CLI names a stale allowlist entry")
    t0 = time.perf_counter()
    by_device = {}
    for dev in ("cuda", "cpu"):
        with entrypoint_group(dev):
            found = analyze_entrypoints(device=dev)
        by_device[dev] = {n: sorted({f.rule for f in found if f.entrypoint == n})
                          for n in ENTRYPOINTS}
        check(all(f.file and f.line > 0 for f in found), f"a {dev} finding has no file:line")
    same = by_device["cuda"] == by_device["cpu"]
    print(f"[analysis] (a) the 16 entrypoints captured on the card and on the CPU "
          f"({time.perf_counter() - t0:.1f} s): rule sets "
          f"{'equal' if same else 'DIFFER'}: {by_device['cuda']}")
    check(same, f"card and CPU findings differ: {by_device}")

    t, v = TRAIN_MODEL["max_len"], TRAIN_MODEL["vocab_size"]
    batch = torch.from_numpy(synthetic_lm(TRAIN_BATCH, t, v, seed=1)).long().cuda()
    tokens, labels = batch[:, :-1], batch[:, 1:]
    main_thread = threading.get_ident()
    marks = {}  # tag -> (regions, launches, uncaptured ms) of one step, for (e)
    reset_launch_counts()  # ---- main path 21 starts here
    # (b) the bf16 flagship, plain and with the sentinel
    for sentinel in (False, True):
        t0 = time.perf_counter()
        m = TransformerLM(**TRAIN_MODEL, impl="flash", fused_ln=True,
                          compute_dtype=torch.bfloat16, device="cuda",
                          generator=torch.Generator().manual_seed(3))
        opt = AdamW(lr=FLAGSHIP_LR)
        if sentinel:
            opt = attach_sentinel(opt, ())
        step = make_lm_fused_train_step(m, opt, save_scores=True)
        ts, ms = _timed_steps(TrainState.create(m, opt), step, [batch] * ANALYSIS_TIMED_STEPS)
        tag = "flagship_sentinel" if sentinel else "flagship"
        cap, findings, deltas = _captured(tag, step, (ts, tokens, labels))
        off_thread = sum(1 for e in cap.events if e.kind == "launch" and e.thread != main_thread)
        off_ops = sum(1 for e in cap.events if e.kind == "op" and e.thread != main_thread)
        print(f"[analysis] (b) {tag}: captured step {cap.wall_s * 1e3:.1f} ms vs "
              f"{ms:.2f} ms uncaptured (x{cap.wall_s * 1e3 / ms:.1f}); {len(cap.events)} "
              f"events, {len(cap.regions)} regions; launches {dict(cap.launches)} "
              f"({off_thread} launches and {off_ops} ops on autograd's device thread); rules "
              f"{_rules(findings)}; {time.perf_counter() - t0:.1f} s")
        marks[tag] = (len(cap.regions), sum(cap.launches.values()), ms)
        check(dict(cap.launches) == FLAGSHIP_PER_STEP,
              f"the {tag} trace names {dict(cap.launches)}, not {FLAGSHIP_PER_STEP}")
        check(dict(cap.launches) == deltas, f"the {tag} trace disagrees with the counters")
        check(off_thread >= 12 + 6 + 6 and off_ops > 0,
              f"the {tag} backward's launches and ops are not in the trace")
        check(("J111" in _rules(findings)) != sentinel,
              f"J111 {'fired under' if sentinel else 'missed'} the sentinel")
        if not sentinel:
            check(_rules(findings) == by_device["cpu"]["lm_bf16"],
                  f"flagship rules {_rules(findings)} != the CPU lm_bf16's "
                  f"{by_device['cpu']['lm_bf16']}")
        del m, opt, step, ts, cap
        torch.cuda.empty_cache()

    # (c) the dense decode step, unfused and fused
    model = TransformerLM(**SERVE_MODEL, device="cuda", generator=torch.Generator().manual_seed(0))
    slots = SERVE_CFG["slots"]
    tok = torch.zeros(slots, dtype=torch.long, device="cuda")
    pos = torch.full((slots,), ANALYSIS_DECODE_POS, dtype=torch.long, device="cuda")
    for fused in (False, True):
        eng = ServingEngine(model, ServeConfig(**SERVE_CFG, fused_head=fused), device="cuda")
        args = (eng.caches, tok, pos)
        eng._decode(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._decode(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        tag = "decode_fused" if fused else "decode"
        cap, findings, deltas = _captured(tag, eng._decode, args, donation=False,
                                          modules=(model,))
        print(f"[analysis] (c) {tag}: captured step {cap.wall_s * 1e3:.1f} ms vs {ms:.2f} ms "
              f"uncaptured; launches {dict(cap.launches)}; rules {_rules(findings)}")
        marks[tag] = (len(cap.regions), sum(cap.launches.values()), ms)
        check(dict(cap.launches) == ({"fused_decode_head": 1} if fused else {}),
              f"the {tag} trace names {dict(cap.launches)}")
        check(dict(cap.launches) == deltas, f"the {tag} trace disagrees with the counters")
        check(("J119" in _rules(findings)) != fused, f"J119 on {tag}: {_rules(findings)}")
        check("J110" not in _rules(findings), f"J110 fired on {tag}")
        del eng
    del model
    torch.cuda.empty_cache()

    # (d) the bf16 ragged MoE
    t0 = time.perf_counter()
    m = TransformerLM(**MOE_MODEL, moe_experts=ANALYSIS_MOE_EXPERTS, moe_dispatch="ragged",
                      compute_dtype=torch.bfloat16, device="cuda",
                      generator=torch.Generator().manual_seed(6))
    opt = AdamW(lr=MOE_LR)
    step = make_train_step(m, opt)
    ts, ms = _timed_steps(TrainState.create(m, opt), step, [batch] * ANALYSIS_TIMED_STEPS)
    cap, findings, deltas = _captured("moe_ragged_bf16", step, (ts, tokens, labels))
    need = dict(MOE_PER_STEP, grouped_dw_bf16=2 * TRAIN_MODEL["num_layers"])
    print(f"[analysis] (d) ragged MoE E={ANALYSIS_MOE_EXPERTS} bf16: captured step "
          f"{cap.wall_s * 1e3:.1f} ms vs {ms:.2f} ms uncaptured; launches {dict(cap.launches)}; "
          f"rules {_rules(findings)}; {time.perf_counter() - t0:.1f} s")
    check(dict(cap.launches) == need, f"the MoE trace names {dict(cap.launches)}, not {need}")
    check(dict(cap.launches) == deltas, "the MoE trace disagrees with the counters")
    launches = {k.name: k.launches for k in KERNELS}  # ---- and ends here
    del m, opt, step, ts, cap
    torch.cuda.empty_cache()

    # (e) what the markers cost the uncaptured steps of (b) and (c)
    check(markers._capture is None, "a capture outlived its step")

    def bare(x):
        return x

    def best_us(fn, arg) -> float:
        runs = timeit.repeat("fn(arg)", globals={"fn": fn, "arg": arg},
                             number=ANALYSIS_MARKER_CALLS, repeat=ANALYSIS_MARKER_REPEATS)
        return min(runs) / ANALYSIS_MARKER_CALLS * 1e6

    us_bare = best_us(bare, batch)
    us_marked = best_us(markers.marked("probe")(bare), batch) - us_bare
    us_launch = best_us(markers.on_launch, KERNELS[0])
    costs = []
    for tag, (regions, n_launch, ms) in marks.items():
        us = regions * us_marked + n_launch * us_launch
        costs.append(f"{tag} {regions} regions and {n_launch} launches, {us:.1f} us of "
                     f"{ms:.2f} ms ({us / (10 * ms):.4f}%)")
        check(us * 1e-3 <= ANALYSIS_MARKER_SHARE * ms,
              f"the markers cost the {tag} step {us:.1f} us of {ms:.2f} ms")
    print(f"[analysis] (e) with no capture: a marked call {us_marked:.4f} us over a bare "
          f"call ({us_bare:.4f} us), a launch report {us_launch:.4f} us; a step: "
          f"{'; '.join(costs)}")
    print(f"[analysis] phase {time.perf_counter() - t_phase:.1f} s")
    return {"analysis": launches}


def ptxas_usage(log: str) -> dict[str, dict]:
    """{mangled entry function: {registers, spill, stack}} from a ``-Xptxas
    -v`` build log (spill: bytes stored plus bytes loaded; stack: the
    frame's bytes, where arrays the registers do not hold live)."""
    usage: dict[str, dict] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = usage.setdefault(m.group(1), {"registers": None, "spill": None,
                                                  "stack": None})
        elif entry is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                entry["spill"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"(\d+) bytes stack frame", line)
            if m:
                entry["stack"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
    return usage


SASS_OPS = r"\b(HGMMA\.[\w.]+|HMMA\.[\w.]+|FFMA)\b"


def sass_opcodes(lib_path, ops: str = SASS_OPS) -> dict[str, dict[str, int]]:
    """{mangled kernel: {opcode: count}} of the instructions ``ops`` matches
    in a built library, from ``cuobjdump -sass``; by default the
    tensor-core (``HMMA`` from mma.sync, ``HGMMA`` from wgmma, by full
    opcode, so a TF32 product shows as ``...TF32``) and f32 FMA (``FFMA``)
    instructions."""
    from tpudml_torch.ops.cuda_lib import find_nvcc

    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = counts.setdefault(m.group(1), {})
            continue
        m = re.search(ops, line)
        if cur is not None and m:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return counts


# Instances of the redesigned flash kernels: (source, kernel, head-dim widths).
FLASH_INSTANCES = (
    ("flash_fwd.cu", "flash_fwd_bf16_kernel", (32, 64, 128, 256)),
    ("flash_fwd.cu", "flash_fwd_f32_kernel", (32, 64, 128, 256)),
    ("flash_bwd.cu", "flash_dq_bf16_kernel", (32, 64, 128, 256)),
    ("flash_bwd.cu", "flash_dq_f32_kernel", (32, 64, 128, 256)),
    ("flash_dkdv.cu", "flash_dkdv_bf16_kernel", (32, 64, 128, 256)),
    ("flash_dkdv.cu", "flash_dkdv_f32_kernel", (32, 64, 128, 256)),
)
BF16_MMA = "HMMA.16816.F32.BF16"  # mma.sync m16n8k16, bf16 in, f32 sums
# Kernels of xent_lean.cu (the lean head's 14 and 15) and xent_saved.cu (the
# saved-scores 12 and 13), each with its range sum, with whether their bf16
# twin must run on the tensor cores; XENT_TWINS: the twins' template
# arguments in the mangled names.
LEAN_INSTANCES = (
    ("xent_dx_lean_kernel", True),
    ("xent_dw_lean_kernel", True),
    ("xent_dw_range_sum_kernel", False),
)
SAVED_INSTANCES = (
    ("xent_dx_saved_kernel", True),
    ("xent_dw_saved_kernel", True),
    ("xent_dw_range_sum_kernel", False),
)
XENT_TWINS = (("f32", "If"), ("bf16", "I13__nv_bfloat16"))
LEAN_PLAN_WIDTHS = (512, 1024, 2048, 4096, 8192)


# The forward kernels 10, 11 (xent.cu): f32 and bf16, without and with the
# score store (SAVE), for a d that is a multiple of the stage depth and not
# (RAGGED), as (label, mangled template arguments).
FWD_TWINS = tuple((f"{tag}{', save' if save else ''}{', ragged' if ragged else ''}",
                   f"{arg}Lb{save}ELb{ragged}E")
                  for tag, arg in (("f32", "If"), ("bf16", "I13__nv_bfloat16"))
                  for save in (0, 1) for ragged in (0, 1))
# (N, d, V) at which phase 2 holds the forward's cut against ``fwd_plan``:
# the flagship head, the long context, the wide timed head, the grid edge.
FWD_PLAN_SHAPES = ((8192, 512, 32768), (32768, 512, 32768), (4096, 2048, 8192),
                   (8_388_609, 8, 128))


def xent_instances(lib, instances, twins=XENT_TWINS) -> None:
    """Hold every instance of one pair of the fused head's kernels (with
    its range sum) to its design: no spill and no stack frame (its f32
    tiles live in registers), no TF32 instruction, and
    ``HMMA.16816.F32.BF16`` in each bf16 twin of the pair; print registers
    and SASS counts."""
    usage = ptxas_usage(lib.ptxas_log())
    sass = sass_opcodes(lib.target())
    source = lib.source.name
    for kernel, mma_twin in instances:
        for tag, arg in twins:
            names = [n for n in sass if re.search(rf"\d{kernel}{arg}E", n)]
            check(len(names) == 1, f"{source}: no single {kernel}<{tag}> in the SASS")
            ops, use = sass[names[0]], usage.get(names[0])
            check(use is not None, f"no ptxas -v report of {kernel}<{tag}>: the library was "
                  f"built without its log; empty tpudml_torch/_build and rerun")
            mma = ops.get(BF16_MMA, 0)
            tf32 = sum(c for op, c in ops.items() if "TF32" in op)
            print(f"[build] {source} {kernel}<{tag}>: {use.get('registers')} registers, "
                  f"spill {use.get('spill')} B, stack {use.get('stack')} B, {BF16_MMA} {mma}, "
                  f"TF32 {tf32}, FFMA {ops.get('FFMA', 0)}")
            check(use.get("spill") == 0 and use.get("stack") == 0,
                  f"{kernel}<{tag}> spills or keeps a stack frame ({use})")
            check(tf32 == 0, f"{kernel}<{tag}> holds TF32 instructions ({ops})")
            if mma_twin and tag.startswith("bf16"):
                check(mma > 0, f"{kernel}<bf16> runs no bf16 mma on the tensor cores")


def fwd_instances(lib) -> None:
    """The forward kernels 10, 11 (xent.cu) as ``xent_instances`` holds
    them, every instance of FWD_TWINS; then, in f32 and bf16, the cut the
    built kernels make (rows a block, vocabulary slices, blocks) at
    FWD_PLAN_SHAPES against ``fwd_plan``."""
    import torch

    from tpudml_torch.ops import fwd_plan, fwd_plan_built

    xent_instances(lib, (("xent_fwd_kernel", True),), FWD_TWINS)
    for shape in FWD_PLAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = fwd_plan_built(*shape, dtype)
            print(f"[build] forward kernels at N={shape[0]} d={shape[1]} V={shape[2]} "
                  f"{str(dtype)[6:]}: {plan['blocks']} blocks of {plan['rows']} rows, "
                  f"{plan['slices']} slice(s) of {plan['slice_steps']} steps of {plan['cols']} "
                  f"columns, partials {plan['partials']}")
            check(plan == fwd_plan(*shape, dtype),
                  f"fwd_plan{shape} {fwd_plan(*shape, dtype)} is not the kernels' {plan}")


def lean_instances(lib) -> None:
    """The lean kernels 14, 15 (xent_lean.cu) as ``xent_instances`` holds
    them; then the cut of d the built kernels choose (chunk, cluster, S
    passes) against ``lean_plan``."""
    from tpudml_torch.ops import lean_plan, lean_plan_built

    xent_instances(lib, LEAN_INSTANCES)
    for d in LEAN_PLAN_WIDTHS:
        plan = lean_plan_built(d)
        print(f"[build] lean kernels at d={d}: {plan['cluster']} block(s) of {plan['chunk']} "
              f"columns a cluster, scores computed {plan['s_passes']}x a tile")
        check(plan == lean_plan(d), f"lean_plan({d}) {lean_plan(d)} is not the kernels' {plan}")


# (N, d, V) at which phase 2 holds the saved-scores kernels' cut against
# ``saved_plan``: the flagship head, the long-context saved config, the
# wide timed head, and dW's ranges at the grid-edge check.
SAVED_PLAN_SHAPES = ((8192, 512, 32768), (32768, 512, 32768), (4096, 2048, 8192),
                     (8_388_609, 8, 128))


def saved_instances(lib) -> None:
    """The saved-scores kernels 12, 13 (xent_saved.cu) as ``xent_instances``
    holds them; then, in f32 and bf16, the cut the built kernels make
    (rows or columns a block, reads of s, ranges, blocks) at
    SAVED_PLAN_SHAPES against ``saved_plan``."""
    import torch

    from tpudml_torch.ops import saved_plan, saved_plan_built

    xent_instances(lib, SAVED_INSTANCES)
    for shape in SAVED_PLAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = saved_plan_built(*shape, dtype)
            print(f"[build] saved-scores kernels at N={shape[0]} d={shape[1]} V={shape[2]} "
                  f"{str(dtype)[6:]}: dX {plan['dx_blocks']} blocks of {plan['dx_rows']} rows, "
                  f"dW {plan['dw_blocks']} blocks of {plan['dw_cols']} columns "
                  f"({plan['ranges']} range(s) of {plan['range_rows']} rows), s read "
                  f"{plan['s_reads']}x ({plan['chunk']}-column chunks of d)")
            check(plan == saved_plan(*shape, dtype),
                  f"saved_plan{shape} {saved_plan(*shape, dtype)} is not the kernels' {plan}")


# Kernel 16 (grouped_dw.cu): f32 and bf16, with 16-byte row copies (VEC) and
# without (a k or n that is no multiple of 16 bytes), as (label, mangled
# template arguments); (M, k, n, E) at which phase 2 holds its cut against
# ``grouped_dw_plan``: the MoE step's dW1 and dW2 at E = 4 and 8, the card
# tests' multi-chunk, long-chunk and many-expert cases, M = 0, a wide k·n.
GDW_TWINS = tuple((f"{tag}{'' if vec else ', ragged'}", f"{arg}Lb{vec}E")
                  for tag, arg in (("f32", "If"), ("bf16", "I13__nv_bfloat16"))
                  for vec in (1, 0))
GDW_PLAN_SHAPES = ((8192, 512, 2048, 8), (8192, 2048, 512, 8), (8192, 512, 2048, 4),
                   (8192, 2048, 512, 4), (5000, 64, 96, 4), (20000, 512, 1024, 2),
                   (300, 130, 257, 64), (0, 12, 1, 3), (65536, 4096, 4096, 8))


WGMMA_SERIALIZED = "wgmma.mma_async instructions are serialized"  # ptxas's warning


def gdw_instances(lib) -> None:
    """Hold every instance of kernel 16 (grouped_dw.cu, GDW_TWINS) to its
    design: no spill and no stack frame, no TF32 instruction, the bf16
    twins' products on wgmma (``HGMMA.*.F32.BF16`` in their SASS, never
    serialized by ptxas); print registers and SASS counts. Then the cut the
    built kernel makes (R, slots, blocks, workspace) at GDW_PLAN_SHAPES
    against ``grouped_dw_plan``."""
    import torch

    from tpudml_torch.ops import grouped_dw_plan, grouped_dw_plan_built

    log = lib.ptxas_log()
    usage = ptxas_usage(log)
    sass = sass_opcodes(lib.target())
    check(WGMMA_SERIALIZED not in log, f"ptxas serialized kernel 16's wgmma: {log[-2000:]}")
    for tag, arg in GDW_TWINS:
        names = [n for n in sass if re.search(rf"\dgrouped_dw_kernel{arg}E", n)]
        check(len(names) == 1, f"grouped_dw.cu: no single grouped_dw_kernel<{tag}> in the SASS")
        ops, use = sass[names[0]], usage.get(names[0])
        check(use is not None, "no ptxas -v report of grouped_dw.cu: the library was built "
              "without its log; empty tpudml_torch/_build and rerun")
        wgmma = sum(c for op, c in ops.items() if op.startswith("HGMMA") and op.endswith("BF16"))
        tf32 = sum(c for op, c in ops.items() if "TF32" in op)
        print(f"[build] grouped_dw.cu grouped_dw_kernel<{tag}>: {use.get('registers')} "
              f"registers, spill {use.get('spill')} B, stack {use.get('stack')} B, "
              f"{', '.join(f'{op} {c}' for op, c in sorted(ops.items()))}")
        check(use.get("spill") == 0 and use.get("stack") == 0,
              f"grouped_dw_kernel<{tag}> spills or keeps a stack frame ({use})")
        check(tf32 == 0, f"grouped_dw_kernel<{tag}> holds TF32 instructions ({ops})")
        if tag.startswith("bf16"):
            check(wgmma > 0, f"grouped_dw_kernel<{tag}> runs no bf16 wgmma")
    for shape in GDW_PLAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = grouped_dw_plan_built(*shape, dtype)
            print(f"[build] grouped dW at M={shape[0]} k={shape[1]} n={shape[2]} E={shape[3]} "
                  f"{str(dtype)[6:]}: chunks of <= {plan['rows']} rows, {plan['slots']} slots, "
                  f"{plan['blocks']} blocks of {plan['tile']}, {plan['stage_rows']} rows a "
                  f"stage, workspace {plan['workspace_bytes']} B")
            check(plan == grouped_dw_plan(*shape, dtype),
                  f"grouped_dw_plan{shape} {grouped_dw_plan(*shape, dtype)} is not the "
                  f"kernel's {plan}")


# The decode head (decode_head.cu, kernels 4 and 5): f32 and int8 weights,
# with 16-byte loads or one scalar load a column, as (label, mangled template
# arguments); (B, d, V) at which phase 2 holds its cut against ``head_plan``:
# serving, HEAD_WIDE, the card tests' 200 slots, a chunked ragged d and V,
# and one of everything.
HEAD_TWINS = (("f32", "IfLb1E"), ("f32, unaligned", "IfLb0E"), ("int8", "IaLb1E"),
              ("int8, unaligned", "IaLb0E"))
HEAD_PLAN_SHAPES = ((8, 512, 32768), (8, 8192, 32768), (200, 512, 1000), (9, 6401, 32773),
                    (1, 1, 1))
HEAD_OPS = r"\b(HGMMA\.[\w.]+|HMMA\.[\w.]+|FFMA|FMUL|FADD|PRMT|I2F[\w.]*|LDG[\w.]*)\b"


def head_instances(lib) -> None:
    """Hold the decode head's instances (HEAD_TWINS) to no spill, no stack
    frame and no TF32 instruction; print registers and SASS counts (int8:
    PRMT and FADD convert the codes, no I2F). Then the cut the built kernel
    makes at HEAD_PLAN_SHAPES against ``head_plan``."""
    from tpudml_torch.ops import head_plan, head_plan_built

    usage = ptxas_usage(lib.ptxas_log())
    sass = sass_opcodes(lib.target(), HEAD_OPS)
    for tag, arg in HEAD_TWINS:
        names = [n for n in sass if re.search(rf"\dhead_kernel{arg}E", n)]
        check(len(names) == 1, f"decode_head.cu: no single head_kernel<{tag}> in the SASS")
        ops, use = sass[names[0]], usage.get(names[0])
        check(use is not None, "no ptxas -v report of decode_head.cu: the library was built "
              "without its log; empty tpudml_torch/_build and rerun")
        tf32 = sum(c for op, c in ops.items() if "TF32" in op)
        print(f"[build] decode_head.cu head_kernel<{tag}>: {use.get('registers')} registers, "
              f"spill {use.get('spill')} B, stack {use.get('stack')} B, TF32 {tf32}, "
              f"{', '.join(f'{op} {c}' for op, c in sorted(ops.items()))}")
        check(use.get("spill") == 0 and use.get("stack") == 0,
              f"head_kernel<{tag}> spills or keeps a stack frame ({use})")
        check(tf32 == 0, f"head_kernel<{tag}> holds TF32 instructions ({ops})")
    for shape in HEAD_PLAN_SHAPES:
        for int8 in (False, True):
            plan = head_plan_built(*shape, int8)
            print(f"[build] decode head at B={shape[0]} d={shape[1]} V={shape[2]} "
                  f"{'int8' if int8 else 'f32'}: {plan.tiles} blocks of {plan.warps} warps, "
                  f"{'16-byte' if plan.aligned else 'scalar'} loads, {plan.slice} rows of d a "
                  f"warp in chunks of {plan.chunk}, {plan.smem_bytes} B shared, "
                  f"{plan.groups} row group(s), buffer {4 * plan.scratch} B")
            check(plan == head_plan(*shape, int8),
                  f"head_plan{shape} {head_plan(*shape, int8)} is not the kernel's {plan}")


def ln_instances(lib) -> None:
    """Print each LayerNorm kernel instance's registers and spills (ptxas)
    and hold the wide ones (``*_wide_*``, ``*_loop_*``) to no spills."""
    usage = ptxas_usage(lib.ptxas_log())
    check(bool(usage), "no ptxas -v report of add_layernorm.cu: empty tpudml_torch/_build "
          "and rerun")
    for name, use in sorted(usage.items()):
        m = re.search(r"(add_ln_[a-z_]+?_kernel)(I\w+?EE)?(?:Ev|E)", name)
        if not m:
            continue
        args = m.group(2) or ""
        inst = (m.group(1) + "<" + ", ".join(
            a for a in re.findall(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16|If)", args)
            for a in a if a).replace("13__nv_bfloat16", "bf16").replace("If", "f32") + ">")
        print(f"[build] add_layernorm.cu {inst}: {use['registers']} registers, "
              f"spill {use['spill']} B")
        if "_wide_" in name or "_loop_" in name:
            check(use["spill"] == 0, f"{inst} spills ({use})")


def build_phase() -> None:
    """Build every kernel source (one nvcc each, all started together) and
    print what ptxas reports. Hold kernels 1–3 to their design in every
    instance: the bf16 twins on the tensor cores (``HMMA.16816.F32.BF16`` in
    their SASS), no TF32 instruction in any twin, and no spills; the wide
    instances of the LayerNorm kernels 6–9 to no spills; and the
    forward kernels 10, 11, the saved-scores kernels 12, 13 and the lean
    kernels 14, 15 as ``fwd_instances``, ``saved_instances`` and
    ``lean_instances`` say, the grouped dW 16 as ``gdw_instances`` and the
    decode head 4, 5 as ``head_instances``."""
    from tpudml_torch.ops import (
        ADD_LN_FORWARD, DECODE_HEAD, FLASH_DKDV, FLASH_DQ, FLASH_FORWARD, GROUPED_DW,
        KERNELS, XENT_DX, XENT_DX_LEAN, XENT_FORWARD, build_kernels,
    )

    t_build = build_kernels()
    for lib in dict.fromkeys(k.library for k in KERNELS):
        usage = [ln.strip() for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {lib.source.name}: {' | '.join(usage) or 'cached'}")
    print(f"[build] {len(KERNELS)} kernels built in {t_build:.1f} s")

    for lib in (FLASH_FORWARD.library, FLASH_DQ.library, FLASH_DKDV.library):
        usage = ptxas_usage(lib.ptxas_log())
        sass = sass_opcodes(lib.target())
        for source, kernel, widths in FLASH_INSTANCES:
            if source != lib.source.name:
                continue
            for dp in widths:
                pat = re.compile(rf"{kernel}ILi{dp}E")
                names = [n for n in sass if pat.search(n)]
                check(len(names) == 1, f"{source}: no single {kernel}<{dp}> in the SASS")
                ops, use = sass[names[0]], usage.get(names[0])
                check(use is not None, f"no ptxas -v report of {kernel}<{dp}>: the library "
                      f"was built without its log; empty tpudml_torch/_build and rerun")
                mma = ops.get(BF16_MMA, 0)
                tf32 = sum(c for op, c in ops.items() if "TF32" in op)
                print(f"[build] {source} {kernel}<{dp}>: {use.get('registers')} registers, "
                      f"spill {use.get('spill')} B, {BF16_MMA} {mma}, TF32 {tf32}, "
                      f"FFMA {ops.get('FFMA', 0)}")
                check(use.get("spill") == 0, f"{kernel}<{dp}> spills ({use})")
                check(tf32 == 0, f"{kernel}<{dp}> holds TF32 instructions ({ops})")
                if "bf16" in kernel:
                    check(mma > 0, f"{kernel}<{dp}> runs no bf16 mma on the tensor cores")
    ln_instances(ADD_LN_FORWARD.library)
    fwd_instances(XENT_FORWARD.library)
    saved_instances(XENT_DX.library)
    lean_instances(XENT_DX_LEAN.library)
    gdw_instances(GROUPED_DW.library)
    head_instances(DECODE_HEAD.library)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this script runs only on the card", file=sys.stderr)
        return 1
    from tpudml_torch.device import no_tf32
    from tpudml_torch.ops import KERNELS

    no_tf32("cuda")
    smi = nvidia_smi()
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s); "
          f"nvidia-smi: {smi}")

    build_phase()

    gen = torch.Generator().manual_seed(0)
    flash_rows = [flash_phase(gen), *flash_bwd_phase(gen)]
    flash_long_phase(gen, *flash_rows)
    xent_rows = xent_phase(gen)
    rows = [*flash_rows, *head_phase(gen), *add_ln_phase(gen), *flash_bf16_phase(gen),
            *add_ln_bf16_phase(gen), *xent_rows, *xent_lean_phase(gen, xent_rows[0]),
            *ln_phase(gen), *grouped_dw_phase(gen)]
    by_name = {row["name"]: row for row in rows}
    flash_head_dim_phase(gen, by_name)
    ln_wide_phase(gen, by_name)
    xent_wide_phase(gen, by_name)
    head_wide_phase(gen, by_name)
    grid_edge_phase(gen)
    torch.cuda.empty_cache()
    paths = {"serve": serve_phase(gen)}
    torch.cuda.empty_cache()
    paths.update(serve_levers_phase(gen, by_name))
    torch.cuda.empty_cache()
    paths["train"] = train_phase()
    torch.cuda.empty_cache()
    paths["train_wide"] = train_wide_phase()
    torch.cuda.empty_cache()
    paths.update(flagship_phase())
    torch.cuda.empty_cache()
    paths.update(dp_phase())
    torch.cuda.empty_cache()
    paths["long"] = long_phase()
    torch.cuda.empty_cache()
    paths["ln_op"] = ln_op_phase(gen)
    torch.cuda.empty_cache()
    paths["moe"] = moe_phase()
    torch.cuda.empty_cache()
    paths["moe_f32"] = moe_f32_phase()
    torch.cuda.empty_cache()
    paths["resnet"] = resnet_phase()
    torch.cuda.empty_cache()
    paths["ep"] = ep_phase()
    torch.cuda.empty_cache()
    paths["labs"] = labs_phase()
    torch.cuda.empty_cache()
    paths.update(dropout_phase())
    torch.cuda.empty_cache()
    paths.update(host_infra_phase())
    torch.cuda.empty_cache()
    repairs_phase(gen, by_name)
    torch.cuda.empty_cache()
    paths.update(gspmd_phase())
    torch.cuda.empty_cache()
    paths.update(zero1_phase())
    torch.cuda.empty_cache()
    paths.update(fsdp_tp_phase(gen))
    torch.cuda.empty_cache()
    paths.update(pp_phase())
    torch.cuda.empty_cache()
    paths.update(tp_serve_phase(gen))
    torch.cuda.empty_cache()
    paths.update(cp_phase())
    torch.cuda.empty_cache()
    paths.update(plan_phase())
    torch.cuda.empty_cache()
    paths.update(elastic_phase())
    torch.cuda.empty_cache()
    paths.update(mpmd_phase())
    torch.cuda.empty_cache()
    paths.update(fleet_phase())
    torch.cuda.empty_cache()
    paths.update(analysis_phase())
    for row in rows:
        by_path = {path: counts[row["name"]] for path, counts in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        check(row["launches"] > 0, f"{row['name']} never launched on a main path")
    check(len(rows) == len(KERNELS), "a kernel has no row")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    if rc == 0:
        import torch

        torch.cuda.synchronize()
    print(f"[done] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
