// Grouped weight gradient of the dropless MoE expert FFN, f32 and bf16
// operands, for Hopper (sm_90a).
//
// Replaces: tpudml/ops/moe_kernel.py `_grouped_dw_kernel` (launched by
// `_grouped_dw_pallas`, reached through `grouped_dw`), which `ragged_ffn`'s
// backward calls for dW1 and dW2.
//
// Computes, for x [M, k] and g [M, n] (both f32 or both bf16) whose rows are
// sorted by expert, and group_sizes [E] int32 on the device:
//   dW[e] = x[slab e]ᵀ · g[slab e]  (f32 [E, k, n], f32 accumulation),
// where slab e is the rows [off[e], off[e + 1]) with off = [0, cumsum(group
// sizes)], clamped to [0, M]. Rows at or past off[E] belong to no slab and
// are ignored; an empty slab gives dW[e] = 0. Any M, k, n and E.
//
// What bounds it on this card: at the MoE training step's shapes (M = 8192
// rows, k·n = 512·2048, E = 4 or 8) the operations are 2·M·k·n = 17.2 GFLOP
// whatever E, and the bytes are the two operands read once plus the f32
// output (42 MB of bf16 inputs and 33.6 MB of dW at E = 8). On the bf16
// tensor cores (989 TFLOP/s) that is bytes-bound at ~0.02 ms; this version
// runs its products on the CUDA cores in f32 (67 TFLOP/s), so operations
// bound it: mma/wgmma, and a split of long slabs over several blocks, are
// later work.
//
// Design: the TPU kernel walks row tiles once in a static sequential grid
// (MegaBlocks' visit schedule: a tile shared by two experts is visited once
// per expert with complementary row masks, `visits = tiles + E`) and carries
// each expert's sum in VMEM scratch between grid steps. Nothing carries
// between blocks here, and the grid need not be static. So one block owns
// one (expert, k tile, n tile) output tile of 128×128 and loops over its
// expert's slab BK rows at a time, staging x[rows, k tile] and g[rows, n
// tile] (both read along their contiguous axis) into shared memory and
// keeping the f32 accumulators in registers (tile.cuh); it writes its tile
// once. No atomics and a fixed row order: bitwise repeatable. The block reads
// group_sizes from the device and sums the prefix itself (E terms, 64-bit),
// so the host never learns the sizes. All (expert, k tile, n tile) triples
// are folded into grid x (expert slowest, so the blocks of one expert run
// together and share its slab in L2), whose limit is 2³¹ − 1 blocks. x, g
// and dW are indexed with 64-bit offsets. A skewed routing that sends every
// row to one expert leaves that expert's blocks walking all of M while the
// others write zeros: correct, only slower.

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(NT)
grouped_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const int* __restrict__ group_sizes, float* __restrict__ dw,
                  int M, int k, int n, int E) {
  __shared__ float As[BK * LDA];
  __shared__ float Bs[BK * LDB];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int tiles_k = (k + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const int nt = blockIdx.x % tiles_n;
  const int kt = (blockIdx.x / tiles_n) % tiles_k;
  const int e = blockIdx.x / tiles_n / tiles_k;
  const int j0 = kt * BM, c0 = nt * BN;

  long long start = 0;
  for (int i = 0; i < e; ++i) start += group_sizes[i];
  long long end = start + group_sizes[e];
  start = start < 0 ? 0 : (start > M ? M : start);
  end = end < start ? start : (end > M ? M : end);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (long long r0 = start; r0 < end; r0 += BK) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {  // xᵀ[j0 + m][r0 + kk] = x[r0 + kk][j0 + m], m fastest
      const int el = tid + q * NT;
      const int kk = el / BM, m = el % BM;
      const long long row = r0 + kk;
      const int j = j0 + m;
      As[kk * LDA + m] = (row < end && j < k) ? to_f32(x[row * k + j]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {  // g[r0 + kk][c0 + c], c fastest
      const int el = tid + q * NT;
      const int kk = el / BN, c = el % BN;
      const long long row = r0 + kk;
      const int col = c0 + c;
      Bs[kk * LDB + c] = (row < end && col < n) ? to_f32(g[row * n + col]) : 0.f;
    }
    __syncthreads();
    mma_stage(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float* out = dw + static_cast<long long>(e) * k * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int j = j0 + ty + 16 * i;
    if (j >= k) continue;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int col = c0 + tx + 16 * jj;
      if (col < n) out[static_cast<long long>(j) * n + col] = acc[i][jj];
    }
  }
}

template <typename T>
int launch(const void* x, const void* g, const int* group_sizes, float* dw,
           int M, int k, int n, int E, void* stream) {
  if (M < 0 || k < 1 || n < 1 || E < 1) return cudaErrorInvalidValue;
  const long long blocks =
      static_cast<long long>(E) * ((k + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  grouped_dw_kernel<T><<<static_cast<unsigned>(blocks), NT, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), group_sizes, dw, M, k, n, E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, k], g [M, n] contiguous f32; group_sizes [E] int32; dw [E, k, n]
// contiguous f32. All on the device.
int grouped_dw_f32(const void* x, const void* g, const int* group_sizes, float* dw,
                   int M, int k, int n, int E, void* stream) {
  return launch<float>(x, g, group_sizes, dw, M, k, n, E, stream);
}

// As grouped_dw_f32 with x and g in bf16; dw stays f32.
int grouped_dw_bf16(const void* x, const void* g, const int* group_sizes, float* dw,
                    int M, int k, int n, int E, void* stream) {
  return launch<__nv_bfloat16>(x, g, group_sizes, dw, M, k, n, E, stream);
}

const char* grouped_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
