// Fused linear cross-entropy, f32 and bf16 operands, for Hopper (sm_90a): the
// forward (with and without the score store) and the two backward products
// from the saved scores. (The lean backward, which recomputes the scores,
// is xent_lean.cu.)
//
// Replaces: tpudml/ops/xent_kernel.py `_fwd_kernel` (forward, no save),
// `_fwd_kernel_save` (forward that also stores the f32 scores),
// `_dx_s_kernel` (dX from the saved scores) and `_dw_s_kernel` (dW and db
// from the saved scores), launched by `_fused_forward` and
// `_fused_backward_saved`.
//
// For x [N, d], W [d, V], bias [V] (all f32 or all bf16) and int32 labels
// [N], with s = x·W + b in f32 (a bf16 product is exact in f32; only the
// order of the sums differs from the MXU):
//   forward:  lse[r] = log Σ_c exp(s[r, c]),
//             picked[r] = s[r, label[r]] if 0 <= label[r] < V, else 0
//             (an out-of-range label contributes loss = lse, no pull-up);
//   backward: dlog = (exp(s − lse) − onehot(label)) · inv_n, rounded to the
//             operand dtype before each product (identity in f32),
//             dX = dlog·Wᵀ (stored in x's dtype),
//             dW = xᵀ·dlog (stored in W's dtype), db = Σ_rows dlog (f32,
//             from the unrounded dlog).
// The saved scores are the unpadded [N, V] f32 buffer (the TPU kernel pads
// it to its tiles; here ragged rows and vocab columns are masked in every
// kernel instead). Any width d >= 1: a d that is not a multiple of the
// forward's 8-deep contraction stage is masked at that ragged edge inside
// the forward (its RAGGED instance; W is never padded or copied). The
// saved-scores backward kernels need nothing more: they contract over V
// (dX) and N (dW), both masked already, and d is their output axis, masked
// on load and store; tile.cuh holds no d-sized state.
//
// What bounds it on this card: operations. Each product is 2·N·d·V FLOP
// (275 GFLOP at N = 8192, d = 512, V = 32768) against a few GB of traffic
// (the 1 GiB score buffer written once and read by both saved-scores
// backward kernels). This version runs the products on the CUDA cores in
// f32, so its floor is 67 TFLOP/s, not the tensor cores' 989 TFLOP/s in
// bf16: the mma/wgmma redesign is later work.
//
// Design: one register-tiled product (tile.cuh) shared by all three. A
// block of 256 threads owns a 128×128 output tile; each thread keeps 8×8 f32
// accumulators (rows ty + 16·i, columns tx + 16·j) and walks the
// contraction axis 8 deep at a time through two shared-memory stages,
// loading each operand in the order that keeps its global reads contiguous
// (rows padded by 4 floats so the transposed stores do not collide in a
// bank). Operands are converted to f32 as they are staged, and dlog is
// built (exp, one-hot, 1/N, rounding) while staging, so it never exists in
// device memory.
// - Forward: the TPU kernel carries (m, l, picked) across a sequential vocab
//   grid axis. Here a grid of (vocab tile, row tile) blocks each writes
//   its tile's scores (save mode) and per-row partial (max, Σ exp(s − max),
//   picked); a second small kernel merges the partials of each row in vocab
//   tile order: max, rescaled sum, sum. Enough blocks to fill the SMs and a
//   fixed merge order.
//   The row tiles of the forward and of dX lie on grid y and continue on
//   grid z past 65535 tiles (grid.cuh): grid y alone ended launches at
//   8,388,480 rows.
// - dX: one block per (row tile, d tile) loops over all vocab columns; dW:
//   one block per (d tile, vocab tile) loops over all rows, and the blocks
//   of d tile 0 also reduce db (each thread sums a fixed set of rows, then
//   two threads per column add up in a fixed order). Every output element is
//   written once after a fixed-order loop: no atomics, bitwise the same from
//   run to run.

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

// dlog of one (row, column) from the saved score.
__device__ __forceinline__ float dlog_of(float s, float lse, int col, int label,
                                         float inv_n) {
  return (expf(s - lse) - (col == label ? 1.f : 0.f)) * inv_n;
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

// dX tile: block (d tile blockIdx.x, row tile grid_y_index()), contraction
// over V. SPILL = false, for launches whose row tiles fit grid y, reads the
// row tile from blockIdx.y alone: with the spilled index this kernel ran
// ~4% slower at the flagship's shape, where grid z is 1.
template <typename T, bool SPILL>
__global__ void __launch_bounds__(NT)
xent_dx_kernel(const float* __restrict__ s, const T* __restrict__ w,
               const int* __restrict__ labels, const float* __restrict__ lse,
               T* __restrict__ dx, int N, int d, int V, float inv_n) {
  __shared__ float As[BK * LDA];
  __shared__ float Bs[BK * LDB];
  __shared__ float lse_s[BM];
  __shared__ int lab_s[BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int j0 = blockIdx.x * BN;
  // rows >= N (last z slice) are masked
  const int r0 = (SPILL ? grid_y_index() : blockIdx.y) * BM;
  for (int i = tid; i < BM; i += NT) {
    const int row = r0 + i;
    lse_s[i] = row < N ? lse[row] : 0.f;
    lab_s[i] = row < N ? labels[row] : -1;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int v0 = 0; v0 < V; v0 += BK) {
    __syncthreads();  // lse_s/lab_s written; the previous stage is consumed
#pragma unroll
    for (int q = 0; q < PER; ++q) {  // dlog[r0 + m][v0 + kk], k fastest
      const int e = tid + q * NT;
      const int kk = e % BK, m = e / BK;
      const int row = r0 + m, col = v0 + kk;
      float dl = 0.f;
      if (row < N && col < V)
        dl = dlog_of(s[static_cast<long long>(row) * V + col], lse_s[m], col, lab_s[m], inv_n);
      As[kk * LDA + m] = round_to<T>(dl);
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {  // Wᵀ[v0 + kk][j0 + n] = W[j0 + n][v0 + kk], k fastest
      const int e = tid + q * NT;
      const int kk = e % BK, n = e / BK;
      const int j = j0 + n, col = v0 + kk;
      Bs[kk * LDB + n] = (j < d && col < V) ? to_f32(w[static_cast<long long>(j) * V + col]) : 0.f;
    }
    __syncthreads();
    mma_stage(As, Bs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = j0 + tx + 16 * j;
      if (c < d) dx[static_cast<long long>(row) * d + c] = from_f32<T>(acc[i][j]);
    }
  }
}

// dW tile: block (vocab tile blockIdx.x, d tile blockIdx.y), contraction over
// the rows; the d-tile-0 blocks also write db for their vocab tile.
template <typename T>
__global__ void __launch_bounds__(NT)
xent_dw_kernel(const float* __restrict__ s, const T* __restrict__ x,
               const int* __restrict__ labels, const float* __restrict__ lse,
               T* __restrict__ dw, float* __restrict__ db, int N, int d, int V,
               float inv_n) {
  __shared__ float As[BK * LDA];
  __shared__ float Bs[BK * LDB];
  __shared__ float red[NT];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int v0 = blockIdx.x * BN;
  const int j0 = blockIdx.y * BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float db_acc = 0.f;  // column v0 + tid % BN over rows r0 + tid / BN + 2·q

  for (int r0 = 0; r0 < N; r0 += BK) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {  // xᵀ[j0 + m][r0 + kk] = x[r0 + kk][j0 + m], m fastest
      const int e = tid + q * NT;
      const int kk = e / BM, m = e % BM;
      const int row = r0 + kk, j = j0 + m;
      As[kk * LDA + m] = (row < N && j < d) ? to_f32(x[static_cast<long long>(row) * d + j]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {  // dlog[r0 + kk][v0 + n], n fastest
      const int e = tid + q * NT;
      const int kk = e / BN, n = e % BN;
      const int row = r0 + kk, col = v0 + n;
      float dl = 0.f;
      if (row < N && col < V)
        dl = dlog_of(s[static_cast<long long>(row) * V + col], lse[row], col, labels[row], inv_n);
      db_acc += dl;
      Bs[kk * LDB + n] = round_to<T>(dl);
    }
    __syncthreads();
    mma_stage(As, Bs, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int j = j0 + ty + 16 * i;
    if (j >= d) continue;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int col = v0 + tx + 16 * jj;
      if (col < V) dw[static_cast<long long>(j) * V + col] = from_f32<T>(acc[i][jj]);
    }
  }
  if (blockIdx.y == 0) {
    red[tid] = db_acc;
    __syncthreads();
    if (tid < BN && v0 + tid < V) db[v0 + tid] = red[tid] + red[tid + BN];
  }
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

template <typename T>
cudaError_t launch_dx(const float* s, const void* w, const int* labels,
                      const float* lse, void* dx, int N, int d, int V,
                      float inv_n, cudaStream_t st) {
  const dim3 grid = grid_xyz((d + BN - 1) / BN, (N + BM - 1) / BM);
  const auto kernel = grid.z > 1 ? xent_dx_kernel<T, true> : xent_dx_kernel<T, false>;
  kernel<<<grid, NT, 0, st>>>(s, static_cast<const T*>(w), labels, lse,
                              static_cast<T*>(dx), N, d, V, inv_n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const float* s, const void* x, const int* labels,
                      const float* lse, void* dw, float* db, int N, int d,
                      int V, float inv_n, cudaStream_t st) {
  const dim3 grid(n_vocab_tiles(V), (d + BM - 1) / BM);
  xent_dw_kernel<T><<<grid, NT, 0, st>>>(s, static_cast<const T*>(x), labels,
                                         lse, static_cast<T*>(dw), db, N, d, V,
                                         inv_n);
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

// dx [N, d] in w's dtype from s [N, V] f32, w [d, V], labels [N], lse [N].
int xent_dx_s(const float* s, const void* w, const int* labels,
              const float* lse, void* dx, int N, int d, int V, float inv_n,
              int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dx<__nv_bfloat16>(s, w, labels, lse, dx, N, d, V, inv_n, st)
              : launch_dx<float>(s, w, labels, lse, dx, N, d, V, inv_n, st);
}

// dw [d, V] in x's dtype and db [V] f32 from s, x [N, d], labels, lse.
int xent_dw_s(const float* s, const void* x, const int* labels,
              const float* lse, void* dw, float* db, int N, int d, int V,
              float inv_n, int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dw<__nv_bfloat16>(s, x, labels, lse, dw, db, N, d, V, inv_n, st)
              : launch_dw<float>(s, x, labels, lse, dw, db, N, d, V, inv_n, st);
}

const char* xent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
