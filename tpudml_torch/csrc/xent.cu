// Fused linear cross-entropy, f32 and bf16 operands, for Hopper (sm_90a): the
// forward (with and without the score store), the two backward products from
// the saved scores, and the two lean backward products that recompute them.
//
// Replaces: tpudml/ops/xent_kernel.py `_fwd_kernel` (forward, no save),
// `_fwd_kernel_save` (forward that also stores the f32 scores),
// `_dx_s_kernel` (dX from the saved scores) and `_dw_s_kernel` (dW and db
// from the saved scores), launched by `_fused_forward` and
// `_fused_backward_saved`; and `_dx_kernel` / `_dw_kernel` (the lean
// backward: dX, and dW with db, recomputing the scores tile by tile),
// launched by `_fused_backward`.
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
// on load and store; tile.cuh holds no d-sized state. The lean kernels
// mask k < d in their recompute and keep the fixed operand resident over
// all of d only up to LEAN_RESIDENT_D (168 KB of shared memory at 1024);
// beyond, their STREAM instance stages it LK deep with the other operand,
// in the same order of sums. The lean kernels keep nothing of size N·V: their
// residuals are x, W, b, labels and lse, O(N + parameters).
//
// What bounds it on this card: operations. Each product is 2·N·d·V FLOP
// (275 GFLOP at N = 8192, d = 512, V = 32768) against a few GB of traffic
// (the 1 GiB score buffer written once and read by both saved-scores
// backward kernels; nothing of that size in the lean mode, whose two
// kernels each do two products: the recompute and the gradient). This
// version runs the products on the CUDA cores in f32, so its floor is
// 67 TFLOP/s, not the tensor cores' 989 TFLOP/s in bf16: the mma/wgmma
// redesign is later work.
//
// Design, saved-scores kernels: one register-tiled product (tile.cuh) shared
// by all three. A block of 256 threads owns a 128×128 output tile; each thread
// keeps 8×8 f32 accumulators (rows ty + 16·i, columns tx + 16·j) and walks
// the contraction axis 8 deep at a time through two shared-memory stages,
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
//
// Design, lean kernels: the score tile has to be recomputed (a product over
// all of d) before it feeds the gradient product, so a block that owned
// only one d tile of its output would recompute the same scores once per d
// tile (4× the recompute at d = 512 with 128-wide tiles). Instead a block
// owns its rows (dX) or vocab columns (dW) across a whole d chunk of up to
// 512 and keeps that chunk's accumulators in registers: 32 rows × 512 (dX)
// or 512 × 32 columns (dW) = 64 f32 per thread. Each step recomputes one
// score tile into registers (the operand that stays fixed for the block, x
// rows or W columns, is resident in shared memory over all of d up to
// LEAN_RESIDENT_D, and staged with the other operand beyond), turns it
// into dlog in shared memory, then folds it into the accumulators while the
// other operand streams through 8-deep shared-memory slices. d above 512
// takes more chunks, each recomputing the scores. Still no atomics: a dX
// block owns its output rows and loops over V, a dW block owns its
// (d chunk, vocab tile, row range) and loops over the range's rows (its
// chunk-0 blocks also write db, reduced in a fixed order); rows come in
// ranges of 65536, whose f32 partials a second pass adds up in range order,
// so no accumulator sums more than 65536 rows in one f32 chain (its error
// grew as √N when one chain ran over all N) and results are bitwise
// repeatable. The lean kernels never index anything of size N·V; the
// offsets of x, W, dX and dW are 64-bit, since N·d passes 2³¹ beyond
// 4,194,304 rows at d = 512. Row tiles (dX) and vocab tiles (dW) lie on grid
// x, whose limit is 2³¹ − 1 blocks, so neither N nor V meets the 65535 of
// grid y; the dW row ranges on grid z stay under 32768 for any int N.

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

// ------------------------------------------------------------------ lean

constexpr int LK = 32;       // recompute: contraction depth of one stage
constexpr int LKB = 8;       // gradient product: depth of one stage
constexpr int DJ = 16;       // d columns per lane of a chunk
constexpr int DCH = 32 * DJ; // d chunk of a block: 512 (masked beyond d)
constexpr int XR = 32;       // dX lean: rows per block
constexpr int XV = 64;       // dX lean: vocab columns per step
constexpr int WC = 32;       // dW lean: vocab columns per block
constexpr int WR = 64;       // dW lean: rows per step
constexpr int LR = 65536;    // dW lean: rows of one range (a multiple of WR)
constexpr int LEAN_RESIDENT_D = 1024;  // widest d whose fixed operand stays resident

__host__ __device__ constexpr int lean_dpad(int d) { return (d + LK - 1) / LK * LK; }

// dX lean: block (row tile blockIdx.x, d chunk blockIdx.y) owns dX rows
// [r0, r0 + XR) × columns [j0, j0 + DCH). Per step of XV vocab columns:
// S[XR][XV] = x·W + b recomputed (thread: rows ty, ty + 16; columns
// tx + 16·j), dlog rounded to W's dtype into Ps, then acc += Ps·Wᵀ (thread:
// rows ry + 8·i; columns j0 + lane + 32·jj). STREAM (d past
// LEAN_RESIDENT_D) stages the x rows LK deep beside each W stage instead of
// keeping them resident.
template <typename T, bool STREAM>
__global__ void __launch_bounds__(NT, 2)
xent_dx_lean_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ b, const int* __restrict__ labels,
                    const float* __restrict__ lse, T* __restrict__ dx, int N,
                    int d, int V, float inv_n) {
  extern __shared__ float smem[];
  const int dpad = lean_dpad(d);
  float* Xs = smem;  // xᵀ: [dpad][XR + 1] resident, or the stage [LK][XR + 1]
  float* Ws = Xs + (STREAM ? LK : dpad) * (XR + 1);  // [LK][XV]: W stage of the recompute
  float* Ps = Ws + LK * XV;               // [XR][XV + 1]: dlog tile
  float* Wt = Ps + XR * (XV + 1);         // [LKB][DCH + 4]: Wᵀ stage
  __shared__ float lse_s[XR];
  __shared__ int lab_s[XR];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * XR;
  const int j0 = blockIdx.y * DCH;
  if (!STREAM) {
    for (int e = tid; e < XR * dpad; e += NT) {
      const int m = e / dpad, k = e % dpad;
      const int row = r0 + m;
      Xs[k * (XR + 1) + m] =
          (row < N && k < d) ? to_f32(x[static_cast<long long>(row) * d + k]) : 0.f;
    }
  }
  for (int i = tid; i < XR; i += NT) {
    const int row = r0 + i;
    lse_s[i] = row < N ? lse[row] : 0.f;
    lab_s[i] = row < N ? labels[row] : -1;
  }
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, ry = tid / 32;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;

  for (int v0 = 0; v0 < V; v0 += XV) {
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int k0 = 0; k0 < dpad; k0 += LK) {
      __syncthreads();  // Xs written; the previous stage (or Ps/Wt) consumed
#pragma unroll
      for (int q = 0; q < LK * XV / NT; ++q) {  // W[k0 + kk][v0 + n], n fastest
        const int e = tid + q * NT;
        const int kk = e / XV, n = e % XV;
        const int k = k0 + kk, col = v0 + n;
        Ws[kk * XV + n] =
            (k < d && col < V) ? to_f32(w[static_cast<long long>(k) * V + col]) : 0.f;
      }
      if (STREAM) {
#pragma unroll
        for (int q = 0; q < LK * XR / NT; ++q) {  // x[r0 + m][k0 + kk], k fastest
          const int e = tid + q * NT;
          const int kk = e % LK, m = e / LK;
          const int row = r0 + m, k = k0 + kk;
          Xs[kk * (XR + 1) + m] =
              (row < N && k < d) ? to_f32(x[static_cast<long long>(row) * d + k]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < LK; ++kk) {
        const float a0 = Xs[(STREAM ? kk : k0 + kk) * (XR + 1) + ty];
        const float a1 = Xs[(STREAM ? kk : k0 + kk) * (XR + 1) + ty + 16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bw = Ws[kk * XV + tx + 16 * j];
          s[0][j] = fmaf(a0, bw, s[0][j]);
          s[1][j] = fmaf(a1, bw, s[1][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = v0 + tx + 16 * j;
      const float bias = col < V ? to_f32(b[col]) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = ty + 16 * i;
        float dl = 0.f;
        if (r0 + m < N && col < V)
          dl = (expf(s[i][j] + bias - lse_s[m]) - (col == lab_s[m] ? 1.f : 0.f)) * inv_n;
        Ps[m * (XV + 1) + tx + 16 * j] = round_to<T>(dl);
      }
    }
    for (int cb = 0; cb < XV; cb += LKB) {
      __syncthreads();  // Ps written; the previous Wᵀ slice consumed
#pragma unroll
      for (int q = 0; q < LKB * DCH / NT; ++q) {  // Wᵀ[c][dd] = W[j0 + dd][v0 + cb + c]
        const int e = tid + q * NT;
        const int c = e % LKB, dd = e / LKB;
        const int j = j0 + dd, col = v0 + cb + c;
        Wt[c * (DCH + 4) + dd] =
            (j < d && col < V) ? to_f32(w[static_cast<long long>(j) * V + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < LKB; ++c) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ps[(ry + 8 * i) * (XV + 1) + cb + c];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float wv = Wt[c * (DCH + 4) + lane + 32 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(p[i], wv, acc[i][jj]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ry + 8 * i;
    if (row >= N) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int j = j0 + lane + 32 * jj;
      if (j < d) dx[static_cast<long long>(row) * d + j] = from_f32<T>(acc[i][jj]);
    }
  }
}

// dW lean: block (vocab tile blockIdx.x, d chunk blockIdx.y, row range
// blockIdx.z) owns dW [j0, j0 + DCH) × [v0, v0 + WC) over the rows
// [z·LR, min(N, (z + 1)·LR)), and for d chunk 0 also db[v0, v0 + WC). Per
// step of WR rows: S[WR][WC] recomputed (thread: rows ty + 16·i; columns tx,
// tx + 16), dlog summed into db unrounded and rounded to x's dtype into Ps,
// then acc += xᵀ·Ps (thread: d columns j0 + lane + 32·jj; vocab columns
// wp + 8·i). With one range (N <= LR) the block stores dW in T and db; with
// more, it stores its range's f32 partials into part [ranges, d, V] and
// db_part [ranges, V], which xent_dw_lean_sum_kernel adds up in range order.
// Each accumulator thus sums at most LR rows in one f32 chain: the rounding
// error stays that of LR rows however large N grows. N < 2³¹ keeps the
// ranges (grid z) under 32768. RANGED = false (one range) keeps the loop
// bounds and stores of the single-chain kernel: the ranged body ran ~2%
// slower at N = 32768. STREAM (d past LEAN_RESIDENT_D) stages the W
// columns LK deep beside each x stage instead of keeping them resident.
template <typename T, bool RANGED, bool STREAM>
__global__ void __launch_bounds__(NT, 2)
xent_dw_lean_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ b, const int* __restrict__ labels,
                    const float* __restrict__ lse, T* __restrict__ dw,
                    float* __restrict__ db, float* __restrict__ part,
                    float* __restrict__ db_part, int N, int d, int V, float inv_n) {
  extern __shared__ float smem[];
  const int dpad = lean_dpad(d);
  float* Wr = smem;  // W columns: [dpad][WC + 1] resident, or the stage [LK][WC + 1]
  float* Xs = Wr + (STREAM ? LK : dpad) * (WC + 1);  // [LK][WR + 1]: xᵀ stage of the recompute
  float* Ps = Xs + LK * (WR + 1);         // [WR][WC + 1]: dlog tile
  float* Xr = Ps + WR * (WC + 1);         // [LKB][DCH + 4]: x rows stage
  __shared__ float red[16][WC];
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * WC;
  const int j0 = blockIdx.y * DCH;
  const int n_begin = RANGED ? blockIdx.z * LR : 0;
  const int n_end = RANGED ? n_begin + min(LR, N - n_begin) : N;
  if (!STREAM) {
    for (int e = tid; e < dpad * WC; e += NT) {
      const int k = e / WC, c = e % WC;
      const int col = v0 + c;
      Wr[k * (WC + 1) + c] =
          (k < d && col < V) ? to_f32(w[static_cast<long long>(k) * V + col]) : 0.f;
    }
  }
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, wp = tid / 32;
  float bias[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = v0 + tx + 16 * j;
    bias[j] = col < V ? to_f32(b[col]) : 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  float db_acc[2] = {0.f, 0.f};

  for (int n0 = n_begin; n0 < n_end; n0 += WR) {
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int k0 = 0; k0 < dpad; k0 += LK) {
      __syncthreads();  // Wr written; the previous stage (or Ps/Xr) consumed
#pragma unroll
      for (int q = 0; q < LK * WR / NT; ++q) {  // x[n0 + m][k0 + kk], k fastest
        const int e = tid + q * NT;
        const int kk = e % LK, m = e / LK;
        const int row = n0 + m, k = k0 + kk;
        Xs[kk * (WR + 1) + m] =
            (row < n_end && k < d) ? to_f32(x[static_cast<long long>(row) * d + k]) : 0.f;
      }
      if (STREAM) {
#pragma unroll
        for (int q = 0; q < LK * WC / NT; ++q) {  // W[k0 + kk][v0 + c], c fastest
          const int e = tid + q * NT;
          const int kk = e / WC, c = e % WC;
          const int k = k0 + kk, col = v0 + c;
          Wr[kk * (WC + 1) + c] =
              (k < d && col < V) ? to_f32(w[static_cast<long long>(k) * V + col]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < LK; ++kk) {
        const float b0 = Wr[(STREAM ? kk : k0 + kk) * (WC + 1) + tx];
        const float b1 = Wr[(STREAM ? kk : k0 + kk) * (WC + 1) + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = Xs[kk * (WR + 1) + ty + 16 * i];
          s[i][0] = fmaf(a, b0, s[i][0]);
          s[i][1] = fmaf(a, b1, s[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
      const int row = n0 + m;
      const bool row_ok = row < n_end;
      const float l = row_ok ? lse[row] : 0.f;
      const int label = row_ok ? labels[row] : -1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = v0 + tx + 16 * j;
        float dl = 0.f;
        if (row_ok && col < V)
          dl = (expf(s[i][j] + bias[j] - l) - (col == label ? 1.f : 0.f)) * inv_n;
        db_acc[j] += dl;
        Ps[m * (WC + 1) + tx + 16 * j] = round_to<T>(dl);
      }
    }
    for (int rb = 0; rb < WR; rb += LKB) {
      __syncthreads();  // Ps written; the previous x slice consumed
#pragma unroll
      for (int q = 0; q < LKB * DCH / NT; ++q) {  // x[n0 + rb + r][j0 + dd], dd fastest
        const int e = tid + q * NT;
        const int r = e / DCH, dd = e % DCH;
        const int row = n0 + rb + r, j = j0 + dd;
        Xr[r * (DCH + 4) + dd] =
            (row < n_end && j < d) ? to_f32(x[static_cast<long long>(row) * d + j]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < LKB; ++r) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ps[(rb + r) * (WC + 1) + wp + 8 * i];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float xv = Xr[r * (DCH + 4) + lane + 32 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(xv, p[i], acc[i][jj]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = v0 + wp + 8 * i;
    if (col >= V) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int j = j0 + lane + 32 * jj;
      if (j >= d) continue;
      const long long at = static_cast<long long>(j) * V + col;
      if (RANGED)
        part[static_cast<long long>(blockIdx.z) * d * V + at] = acc[i][jj];
      else
        dw[at] = from_f32<T>(acc[i][jj]);
    }
  }
  if (blockIdx.y == 0) {  // db: the 16 row groups of each column, in order
    red[ty][tx] = db_acc[0];
    red[ty][tx + 16] = db_acc[1];
    __syncthreads();
    if (tid < WC && v0 + tid < V) {
      float t = 0.f;
      for (int g = 0; g < 16; ++g) t += red[g][tid];
      if (RANGED)
        db_part[static_cast<long long>(blockIdx.z) * V + v0 + tid] = t;
      else
        db[v0 + tid] = t;
    }
  }
}

// dW [d, V] in T and db [V] from the ranges' f32 partials, each element
// summed over the ranges in order (one thread per element: bitwise
// repeatable).
template <typename T>
__global__ void xent_dw_lean_sum_kernel(const float* __restrict__ part,
                                        const float* __restrict__ db_part,
                                        T* __restrict__ dw, float* __restrict__ db,
                                        int ranges, int d, int V) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long plane = static_cast<long long>(d) * V;
  if (i < plane) {
    float t = 0.f;
    for (int r = 0; r < ranges; ++r) t += part[r * plane + i];
    dw[i] = from_f32<T>(t);
  }
  if (i < V) {
    float t = 0.f;
    for (int r = 0; r < ranges; ++r) t += db_part[static_cast<long long>(r) * V + i];
    db[i] = t;
  }
}

// Whether the lean kernels stage their fixed operand instead of keeping it
// resident, and their shared memory in bytes.
bool lean_stream(int d) { return d > LEAN_RESIDENT_D; }
size_t dx_lean_smem(int d) {
  const size_t xs = lean_stream(d) ? LK : lean_dpad(d);
  return sizeof(float) * (xs * (XR + 1) + LK * XV + XR * (XV + 1) + LKB * (DCH + 4));
}
size_t dw_lean_smem(int d) {
  const size_t wr = lean_stream(d) ? LK : lean_dpad(d);
  return sizeof(float) * (wr * (WC + 1) + LK * (WR + 1) + WR * (WC + 1) + LKB * (DCH + 4));
}

template <typename T>
cudaError_t launch_dx_lean(const void* x, const void* w, const void* b,
                           const int* labels, const float* lse, void* dx, int N,
                           int d, int V, float inv_n, cudaStream_t st) {
  const size_t smem = dx_lean_smem(d);
  const auto kernel =
      lean_stream(d) ? xent_dx_lean_kernel<T, true> : xent_dx_lean_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + XR - 1) / XR, (d + DCH - 1) / DCH);
  kernel<<<grid, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      labels, lse, static_cast<T*>(dx), N, d, V, inv_n);
  return cudaGetLastError();
}

int lean_ranges(int N) { return static_cast<int>((N + static_cast<long long>(LR) - 1) / LR); }

template <typename T>
cudaError_t launch_dw_lean(const void* x, const void* w, const void* b,
                           const int* labels, const float* lse, void* dw, float* db,
                           float* part, float* db_part, int N, int d, int V,
                           float inv_n, cudaStream_t st) {
  const int ranges = lean_ranges(N);
  if (ranges > 1 && (part == nullptr || db_part == nullptr)) return cudaErrorInvalidValue;
  const bool stream = lean_stream(d);
  const auto kernel = ranges > 1 ? (stream ? xent_dw_lean_kernel<T, true, true>
                                           : xent_dw_lean_kernel<T, true, false>)
                                 : (stream ? xent_dw_lean_kernel<T, false, true>
                                           : xent_dw_lean_kernel<T, false, false>);
  const size_t smem = dw_lean_smem(d);
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((V + WC - 1) / WC, (d + DCH - 1) / DCH, ranges);
  kernel<<<grid, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      labels, lse, static_cast<T*>(dw), db, part, db_part, N, d, V, inv_n);
  err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return err;
  const long long elems = static_cast<long long>(d) * V;
  xent_dw_lean_sum_kernel<T><<<static_cast<unsigned>((elems + 255) / 256), 256, 0, st>>>(
      part, db_part, static_cast<T*>(dw), db, ranges, d, V);
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

// Lean dX [N, d] in x's dtype from x [N, d], w [d, V], b [V] (one dtype),
// labels [N] int32 and lse [N] f32, recomputing the scores.
int xent_dx_lean(const void* x, const void* w, const void* b, const int* labels,
                 const float* lse, void* dx, int N, int d, int V, float inv_n,
                 int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dx_lean<__nv_bfloat16>(x, w, b, labels, lse, dx, N, d, V, inv_n, st)
              : launch_dx_lean<float>(x, w, b, labels, lse, dx, N, d, V, inv_n, st);
}

// Rows of one range of the lean dW: with N above it, the caller passes f32
// scratch part [ceil(N / rows), d, V] and db_part [ceil(N / rows), V].
int xent_dw_lean_range_rows() { return LR; }

// Lean dW [d, V] in W's dtype and db [V] f32, from the same operands; part
// and db_part as above (null when N <= xent_dw_lean_range_rows()).
int xent_dw_lean(const void* x, const void* w, const void* b, const int* labels,
                 const float* lse, void* dw, float* db, float* part, float* db_part,
                 int N, int d, int V, float inv_n, int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dw_lean<__nv_bfloat16>(x, w, b, labels, lse, dw, db, part, db_part, N, d, V, inv_n, st)
              : launch_dw_lean<float>(x, w, b, labels, lse, dw, db, part, db_part, N, d, V, inv_n, st);
}

const char* xent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
