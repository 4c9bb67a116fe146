// Fused residual add + LayerNorm, forward and backward, f32 and bf16 rows,
// for Hopper (sm_90a).
//
// Replaces: tpudml/ops/layernorm_kernel.py `_add_ln_fwd_kernel` (forward)
// and `_add_ln_bwd_kernel` (backward), the junction kernels of
// `fused_add_layernorm` that the LM's fused_ln trunk runs 2L times per
// direction.
//
// Forward, per row of x, r [N, d]: s = x + r, written in the stream dtype
// and read back as f32 (the "post-rounding" rule: bf16 rows round s before
// the statistics, as the unfused bf16 model does; an identity in f32),
// single-pass f32 statistics mean = Σs/d, var = max(Σs²/d − mean², 0),
// rstd = rsqrt(var + eps), y = (s − mean)·rstd·γ + β; mean and rstd [N]
// are kept for the backward.
// Backward, per row, with ŝ = (s − mean)·rstd and g = dy·γ:
//   dx = rstd·(g − mean(g) − ŝ·mean(g·ŝ)) + ds   (dx is also dr),
// and across all rows dγ = Σ dy·ŝ, dβ = Σ dy.
//
// What bounds it on this card: bytes. The forward moves x, r in and s, y
// out (4·N·d floats, 67 MB at N = 8192, d = 512: 0.020 ms at 3.35 TB/s);
// the backward moves s, dy, ds in and dx out (the same 67 MB). The
// arithmetic is a few operations per element.
//
// Design: one warp per row; a row of up to 32·VPT floats stays in
// registers (VPT values per lane, chosen at launch from d), so every
// element is read and written once, coalesced across the warp. The TPU
// kernel accumulates dγ/dβ in VMEM across its sequential grid of row
// tiles; Hopper blocks cannot carry a sum between them, so each block of
// the backward reduces its rows' dγ/dβ to one partial row (its warps
// summed in warp order through shared memory), and a second small kernel
// sums the partials column by column in a fixed order (8 ordered segments
// of blocks, then the segments in order). No atomics: the results are
// bitwise the same from run to run. `ds` may be null (the
// last junction discards s), which merges nothing. The bf16 variant reads
// and writes the rows (x, r, s, y; s, dy, ds, dx) in bf16 and keeps γ, β,
// the statistics and dγ, dβ in f32.

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

constexpr int NWARP = 8;  // warps (rows in flight) per block
constexpr int NTHREAD = NWARP * 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename E, int VPT>
__global__ void __launch_bounds__(NTHREAD)
add_ln_fwd_kernel(const E* __restrict__ x, const E* __restrict__ r,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, E* __restrict__ s,
                  E* __restrict__ y, float* __restrict__ mean,
                  float* __restrict__ rstd, int N, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * NWARP + (threadIdx.x >> 5);
  if (row >= N) return;
  const long long off = row * d;
  float val[VPT];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    val[i] = 0.f;
    if (c < d) {
      const float sv = round_to<E>(to_f32(x[off + c]) + to_f32(r[off + c]));
      s[off + c] = from_f32<E>(sv);
      val[i] = sv;
      sum += sv;
      sq += sv * sv;
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float m = sum / d;
  const float var = fmaxf(sq / d - m * m, 0.f);
  const float rs = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < d) y[off + c] = from_f32<E>((val[i] - m) * rs * gamma[c] + beta[c]);
  }
  if (lane == 0) {
    mean[row] = m;
    rstd[row] = rs;
  }
}

// Rows [blockIdx.x·rows_per_block, +rows_per_block): dx for each row, and
// the block's dγ/dβ partial rows into part[0][blockIdx.x] and
// part[1][blockIdx.x] (part is [2][gridDim.x][d]).
template <typename E, int VPT>
__global__ void __launch_bounds__(NTHREAD)
add_ln_bwd_rows_kernel(const E* __restrict__ s,
                       const float* __restrict__ gamma,
                       const E* __restrict__ dy,
                       const E* __restrict__ ds,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd, E* __restrict__ dx,
                       float* __restrict__ part, int N, int d,
                       int rows_per_block) {
  extern __shared__ float red[];  // [NWARP][d]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float dg[VPT], db[VPT], gam[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    dg[i] = db[i] = 0.f;
    gam[i] = c < d ? gamma[c] : 0.f;
  }
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_block;
  for (int rr = warp; rr < rows_per_block; rr += NWARP) {
    const long long row = first + rr;
    if (row >= N) break;
    const long long off = row * d;
    const float m = mean[row];
    const float rs = rstd[row];
    float xh[VPT], gy[VPT];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      xh[i] = gy[i] = 0.f;
      if (c < d) {
        const float dyv = to_f32(dy[off + c]);
        xh[i] = (to_f32(s[off + c]) - m) * rs;
        gy[i] = dyv * gam[i];
        sg += gy[i];
        sgx += gy[i] * xh[i];
        dg[i] += dyv * xh[i];
        db[i] += dyv;
      }
    }
    const float mg = warp_sum(sg) / d;
    const float mgx = warp_sum(sgx) / d;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < d) {
        float v = rs * (gy[i] - mg - xh[i] * mgx);
        if (ds != nullptr) v += to_f32(ds[off + c]);
        dx[off + c] = from_f32<E>(v);
      }
    }
  }
  // Block partials of dγ then dβ, the warps summed in warp order.
  float* out_g = part + static_cast<long long>(blockIdx.x) * d;
  float* out_b = part + (static_cast<long long>(gridDim.x) + blockIdx.x) * d;
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < d) red[warp * d + c] = which == 0 ? dg[i] : db[i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += NTHREAD) {
      float a = 0.f;
      for (int w = 0; w < NWARP; ++w) a += red[w * d + c];
      (which == 0 ? out_g : out_b)[c] = a;
    }
    __syncthreads();
  }
}

constexpr int COLS = 32;  // column-sum kernel: columns per block
constexpr int SEGS = 8;   // column-sum kernel: ordered row segments

// out[j] for j in [0, 2d): Σ over the row blocks of part[j / d][block]
// [j % d]; out is dγ followed by dβ. Each of SEGS threads of a column sums
// one contiguous range of blocks in order, then the SEGS sums add up in
// segment order: a fixed order, so the result is the same every run.
__global__ void __launch_bounds__(COLS * SEGS)
add_ln_bwd_cols_kernel(const float* __restrict__ part,
                       float* __restrict__ dgamma, float* __restrict__ dbeta,
                       int nblocks, int d) {
  __shared__ float seg_sum[SEGS][COLS];
  const int col = threadIdx.x % COLS;
  const int seg = threadIdx.x / COLS;
  const int j = blockIdx.x * COLS + col;
  const int per = (nblocks + SEGS - 1) / SEGS;
  const int lo = seg * per;
  const int hi = min(lo + per, nblocks);
  float a = 0.f;
  if (j < 2 * d) {
    const int which = j / d, c = j % d;
    const float* p = part + static_cast<long long>(which) * nblocks * d + c;
#pragma unroll 8
    for (int blk = lo; blk < hi; ++blk) a += p[static_cast<long long>(blk) * d];
  }
  seg_sum[seg][col] = a;
  __syncthreads();
  if (seg == 0 && j < 2 * d) {
    float total = 0.f;
    for (int s = 0; s < SEGS; ++s) total += seg_sum[s][col];
    (j < d ? dgamma : dbeta)[j % d] = total;
  }
}

template <typename E, int VPT>
cudaError_t launch_fwd(const E* x, const E* r, const float* gamma,
                       const float* beta, E* s, E* y, float* mean,
                       float* rstd, int N, int d, float eps,
                       cudaStream_t stream) {
  const int grid = (N + NWARP - 1) / NWARP;
  add_ln_fwd_kernel<E, VPT><<<grid, NTHREAD, 0, stream>>>(
      x, r, gamma, beta, s, y, mean, rstd, N, d, eps);
  return cudaGetLastError();
}

template <typename E, int VPT>
cudaError_t launch_bwd(const E* s, const float* gamma, const E* dy,
                       const E* ds, const float* mean, const float* rstd,
                       E* dx, float* dgamma, float* dbeta, float* part,
                       int N, int d, int rows_per_block, cudaStream_t stream) {
  const int nblocks = (N + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * NWARP * d;
  cudaError_t err = cudaFuncSetAttribute(
      add_ln_bwd_rows_kernel<E, VPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  add_ln_bwd_rows_kernel<E, VPT><<<nblocks, NTHREAD, smem, stream>>>(
      s, gamma, dy, ds, mean, rstd, dx, part, N, d, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  add_ln_bwd_cols_kernel<<<(2 * d + COLS - 1) / COLS, COLS * SEGS, 0, stream>>>(
      part, dgamma, dbeta, nblocks, d);
  return cudaGetLastError();
}

template <typename E>
int dispatch_fwd(const E* x, const E* r, const float* gamma, const float* beta,
                 E* s, E* y, float* mean, float* rstd, int N, int d, float eps,
                 cudaStream_t st) {
#define CALL_FWD(V) launch_fwd<E, V>(x, r, gamma, beta, s, y, mean, rstd, N, d, eps, st)
  if (d <= 32) return CALL_FWD(1);
  if (d <= 64) return CALL_FWD(2);
  if (d <= 128) return CALL_FWD(4);
  if (d <= 256) return CALL_FWD(8);
  if (d <= 512) return CALL_FWD(16);
  if (d <= 1024) return CALL_FWD(32);
  return cudaErrorInvalidValue;
#undef CALL_FWD
}

template <typename E>
int dispatch_bwd(const E* s, const float* gamma, const E* dy, const E* ds,
                 const float* mean, const float* rstd, E* dx, float* dgamma,
                 float* dbeta, float* part, int N, int d, int rows_per_block,
                 cudaStream_t st) {
#define CALL_BWD(V) launch_bwd<E, V>(s, gamma, dy, ds, mean, rstd, dx, dgamma, dbeta, part, N, d, rows_per_block, st)
  if (d <= 32) return CALL_BWD(1);
  if (d <= 64) return CALL_BWD(2);
  if (d <= 128) return CALL_BWD(4);
  if (d <= 256) return CALL_BWD(8);
  if (d <= 512) return CALL_BWD(16);
  if (d <= 1024) return CALL_BWD(32);
  return cudaErrorInvalidValue;
#undef CALL_BWD
}

}  // namespace

extern "C" {

// All buffers contiguous: x, r, s, y [N, d] (f32 for _f32, bf16 for
// _bf16); gamma, beta [d] f32; mean, rstd [N] f32. d <= 1024.
int add_ln_fwd_f32(const float* x, const float* r, const float* gamma,
                   const float* beta, float* s, float* y, float* mean,
                   float* rstd, int N, int d, float eps, void* stream) {
  return dispatch_fwd(x, r, gamma, beta, s, y, mean, rstd, N, d, eps,
                      static_cast<cudaStream_t>(stream));
}

int add_ln_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* r,
                    const float* gamma, const float* beta, __nv_bfloat16* s,
                    __nv_bfloat16* y, float* mean, float* rstd, int N, int d,
                    float eps, void* stream) {
  return dispatch_fwd(x, r, gamma, beta, s, y, mean, rstd, N, d, eps,
                      static_cast<cudaStream_t>(stream));
}

// s, dy, ds (or null), dx [N, d] (f32 for _f32, bf16 for _bf16); gamma,
// dgamma, dbeta [d] f32; mean, rstd [N] f32; part is f32 scratch of
// 2·ceil(N / rows_per_block)·d floats.
int add_ln_bwd_f32(const float* s, const float* gamma, const float* dy,
                   const float* ds, const float* mean, const float* rstd,
                   float* dx, float* dgamma, float* dbeta, float* part, int N,
                   int d, int rows_per_block, void* stream) {
  return dispatch_bwd(s, gamma, dy, ds, mean, rstd, dx, dgamma, dbeta, part,
                      N, d, rows_per_block, static_cast<cudaStream_t>(stream));
}

int add_ln_bwd_bf16(const __nv_bfloat16* s, const float* gamma,
                    const __nv_bfloat16* dy, const __nv_bfloat16* ds,
                    const float* mean, const float* rstd, __nv_bfloat16* dx,
                    float* dgamma, float* dbeta, float* part, int N, int d,
                    int rows_per_block, void* stream) {
  return dispatch_bwd(s, gamma, dy, ds, mean, rstd, dx, dgamma, dbeta, part,
                      N, d, rows_per_block, static_cast<cudaStream_t>(stream));
}

const char* add_layernorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
