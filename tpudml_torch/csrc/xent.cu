// Fused linear cross-entropy, f32 and bf16 operands, for Hopper (sm_90a): the
// forward, with and without the score store (kernels 10 and 11 of the
// port). The backward kernels are in xent_saved.cu (12, 13: from the saved
// scores) and xent_lean.cu (14, 15: recomputing them).
//
// Replaces: tpudml/ops/xent_kernel.py `_fwd_kernel` (forward, no save) and
// `_fwd_kernel_save` (forward that also stores the f32 scores), launched by
// `_fused_forward`.
//
// For x [N, d], W [d, V], bias [V] (all f32 or all bf16) and int32 labels
// [N], with s = x·W + b in f32 (a bf16 product is exact in f32; only the
// order of the sums differs from the MXU):
//   lse[r] = log Σ_c exp(s[r, c]),
//   picked[r] = s[r, label[r]] if 0 <= label[r] < V, else 0
//   (an out-of-range label contributes loss = lse, no pull-up).
// The saved scores are the unpadded [N, V] f32 buffer (the TPU kernel pads
// it to its tiles; here ragged rows and vocab columns are masked instead).
// Any width d >= 1: a d that is not a multiple of the forward's 8-deep
// contraction stage is masked at that ragged edge (its RAGGED instance; W
// is never padded or copied).
//
// What bounds it on this card: operations. The product is 2·N·d·V FLOP
// (275 GFLOP at N = 8192, d = 512, V = 32768) against the 1 GiB score
// store of kernel 11. This version runs the product on the CUDA cores in
// f32, so its floor is 67 TFLOP/s, not the tensor cores' 989 TFLOP/s in
// bf16: the mma/wgmma redesign is later work.
//
// Design: the register-tiled product of tile.cuh. A block of 256 threads
// owns a 128×128 output tile; each thread keeps 8×8 f32 accumulators (rows
// ty + 16·i, columns tx + 16·j) and walks the contraction axis 8 deep at a
// time through two shared-memory stages, loading each operand in the order
// that keeps its global reads contiguous (rows padded by 4 floats so the
// transposed stores do not collide in a bank). Operands are converted to
// f32 as they are staged.
// The TPU kernel carries (m, l, picked) across a sequential vocab grid
// axis. Here a grid of (vocab tile, row tile) blocks each writes its tile's
// scores (save mode) and per-row partial (max, Σ exp(s − max), picked); a
// second small kernel merges the partials of each row in vocab tile order:
// max, rescaled sum, sum. Enough blocks to fill the SMs and a fixed merge
// order: no atomics, bitwise the same from run to run. The row tiles lie on
// grid y and continue on grid z past 65535 tiles (grid.cuh): grid y alone
// ended launches at 8,388,480 rows.

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"
#include "grid.cuh"
#include "tile.cuh"

namespace {

// Sum / max over the 16 lanes that share a row (tx = 0..15: half a warp).
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Forward tile: block (vocab tile blockIdx.x, row tile grid_y_index()).
// Writes the tile's partials part[0|1|2][tile][row] = (max, Σ exp(s − max),
// picked) and, with SAVE, the tile's scores into s_out [N, V].
template <typename T, bool SAVE, bool RAGGED>
__global__ void __launch_bounds__(NT)
xent_fwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ b, const int* __restrict__ labels,
                     float* __restrict__ s_out, float* __restrict__ part, int N,
                     int d, int V) {
  __shared__ float As[BK * LDA];
  __shared__ float Bs[BK * LDB];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * BN;
  const int r0 = grid_y_index() * BM;  // rows >= N (last z slice) are masked

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // d % BK == 0 unless RAGGED, whose last stage masks k >= d.
  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {  // x[r0 + m][k0 + kk], k fastest
      const int e = tid + q * NT;
      const int kk = e % BK, m = e / BK;
      const int row = r0 + m;
      const bool ok = row < N && (!RAGGED || k0 + kk < d);
      As[kk * LDA + m] = ok ? to_f32(x[static_cast<long long>(row) * d + k0 + kk]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {  // W[k0 + kk][c0 + n], n fastest
      const int e = tid + q * NT;
      const int kk = e / BN, n = e % BN;
      const int col = c0 + n;
      const bool ok = col < V && (!RAGGED || k0 + kk < d);
      Bs[kk * LDB + n] = ok ? to_f32(w[static_cast<long long>(k0 + kk) * V + col]) : 0.f;
    }
    __syncthreads();
    mma_stage(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float bias[TN];
  bool valid[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = c0 + tx + 16 * j;
    valid[j] = col < V;
    bias[j] = valid[j] ? to_f32(b[col]) : 0.f;
  }
  const long long tile_off = static_cast<long long>(blockIdx.x) * N;
  const long long plane = static_cast<long long>(gridDim.x) * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty + 16 * i;
    const bool row_ok = row < N;
    const int label = row_ok ? labels[row] : -1;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = valid[j] ? acc[i][j] + bias[j] : -INFINITY;
      mx = fmaxf(mx, acc[i][j]);
    }
    mx = row_max(mx);  // finite: every vocab tile holds at least one column < V
    float l = 0.f, z = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (valid[j]) {
        l += expf(acc[i][j] - mx);
        if (col == label) z += acc[i][j];
        if (SAVE && row_ok) s_out[static_cast<long long>(row) * V + col] = acc[i][j];
      }
    }
    l = row_sum(l);
    z = row_sum(z);  // one non-zero term at most: exact
    if (tx == 0 && row_ok) {
      part[tile_off + row] = mx;
      part[plane + tile_off + row] = l;
      part[2 * plane + tile_off + row] = z;
    }
  }
}

// One thread per row: merge the vocab tiles' partials in tile order.
__global__ void xent_merge_kernel(const float* __restrict__ part, int N,
                                  int n_tiles, float* __restrict__ lse,
                                  float* __restrict__ picked) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const long long plane = static_cast<long long>(n_tiles) * N;
  float m = -INFINITY;
  for (int t = 0; t < n_tiles; ++t) m = fmaxf(m, part[static_cast<long long>(t) * N + row]);
  float l = 0.f, z = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const long long at = static_cast<long long>(t) * N + row;
    l += part[plane + at] * expf(part[at] - m);
    z += part[2 * plane + at];
  }
  lse[row] = m + logf(l);
  picked[row] = z;
}

int n_vocab_tiles(int V) { return (V + BN - 1) / BN; }

template <typename T, bool SAVE>
cudaError_t launch_fwd(const void* x, const void* w, const void* b,
                       const int* labels, float* s, float* part, float* lse,
                       float* picked, int N, int d, int V, cudaStream_t st) {
  const dim3 grid = grid_xyz(n_vocab_tiles(V), (N + BM - 1) / BM);
  const auto kernel = d % BK ? xent_fwd_tile_kernel<T, SAVE, true>
                             : xent_fwd_tile_kernel<T, SAVE, false>;
  kernel<<<grid, NT, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                              static_cast<const T*>(b), labels, s, part, N, d, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_merge_kernel<<<static_cast<unsigned>((N + 255LL) / 256), 256, 0, st>>>(part, N, n_vocab_tiles(V), lse, picked);
  return cudaGetLastError();
}

bool shape_ok(int N, int d, int V) { return N > 0 && V > 0 && d > 0; }

}  // namespace

extern "C" {

// Vocab columns per forward tile: the caller sizes the partials scratch
// [3, ceil(V / width), N] f32 with it.
int xent_tile_width() { return BN; }

// x [N, d], w [d, V], b [V] contiguous, all f32 (bf16 = 0) or all bf16
// (bf16 = 1); labels [N] int32; part scratch as above; lse, picked [N] f32.
int xent_fwd(const void* x, const void* w, const void* b, const int* labels,
             float* part, float* lse, float* picked, int N, int d, int V,
             int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16, false>(x, w, b, labels, nullptr, part, lse, picked, N, d, V, st)
              : launch_fwd<float, false>(x, w, b, labels, nullptr, part, lse, picked, N, d, V, st);
}

// As xent_fwd, and also the f32 scores s [N, V] (contiguous).
int xent_fwd_save(const void* x, const void* w, const void* b,
                  const int* labels, float* s, float* part, float* lse,
                  float* picked, int N, int d, int V, int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16, true>(x, w, b, labels, s, part, lse, picked, N, d, V, st)
              : launch_fwd<float, true>(x, w, b, labels, s, part, lse, picked, N, d, V, st);
}

const char* xent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
