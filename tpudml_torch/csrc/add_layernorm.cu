// Fused residual add + LayerNorm and plain LayerNorm, forward and backward,
// f32 and bf16 rows, for Hopper (sm_90a).
//
// Replaces: tpudml/ops/layernorm_kernel.py `_add_ln_fwd_kernel` (forward)
// and `_add_ln_bwd_kernel` (backward), the junction kernels of
// `fused_add_layernorm` that the LM's fused_ln trunk runs 2L times per
// direction; and `_fwd_kernel` / `_bwd_kernel`, the plain LayerNorm of
// `fused_layernorm`, which share their bodies with the junction kernels
// (the TPU's `_fwd_body` with no residual, `_bwd_body` with no ds). Here
// the forward is the same template with ADD = false (no r, no s: the
// statistics are those of x), the backward the same kernel with ds null
// (nothing merged into dx).
//
// Forward, per row of x, r [N, d]: s = x + r, rounded to the stream dtype
// before the statistics (the "post-rounding" rule: bf16 rows round s as
// the unfused bf16 model does; an identity in f32), single-pass f32
// statistics mean = Σs/d, var = max(Σs²/d − mean², 0),
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
// Narrow rows (d <= REG_DIM = 1024): one warp per row; the row stays in
// registers (VPT values per lane, chosen at launch from d), so every
// element is read and written once, coalesced across the warp; a block of
// the backward owns 32 rows and reduces their dγ/dβ to one partial row
// (its warps summed in warp order through shared memory).
//
// Wide rows (d > REG_DIM): a block owns whole rows and each thread a fixed
// set of columns, 16 bytes at a time (4 f32 or 8 bf16 values; one value
// at a time, the scalar instance, where d is no multiple of that or a
// pointer is not 16-byte aligned), round-robin over the block. Per row a
// thread loads its columns once into registers, the row's two sums
// (forward Σs, Σs²; backward Σg, Σg·ŝ) go across the block by warp
// shuffles and then shared memory (one __syncthreads a row: two buffers
// alternate), and the outputs are written from the same registers. The
// forward is one row a block of up to 512 threads, WIDE_K = 16 columns a
// thread (32 past d = 8192, so d <= 16384). The backward is persistent: G
// blocks (a small multiple of the SM count, from the wrapper), each owning
// one contiguous range of rows, 16 columns a thread (d <= 8192 at 512
// threads; the scalar instance at most 256 threads, so d <= 4096);
// each thread keeps its columns' γ and its dγ/dβ sums in registers across
// all of the block's rows, and the block writes one partial row of each at
// the end (scratch 2·G·d floats). Past those widths the looped instances
// take the row VEC columns at a time in two passes, staging it in shared
// memory between them where it fits (else reading it again, from L2); the
// backward keeps its dγ/dβ sums in shared memory while 2·d floats fit
// there, else in its partial row in device memory (each column read and
// written by the one thread that owns it). The instance is picked at
// launch from d, the dtype and the pointers (`wide_plan`, mirrored by the
// wrapper's `layernorm_plan`).
//
// The TPU kernel accumulates dγ/dβ in VMEM across its sequential grid of
// row tiles; Hopper blocks cannot carry a sum between them, so each block
// reduces its rows' dγ/dβ to one partial row and a second small kernel
// sums the partials column by column in a fixed order (8 ordered segments
// of blocks, then the segments in order). No atomics: for a given card and
// shape the results are bitwise the same from run to run. `ds` may be null
// (the last junction discards s), which merges nothing. The bf16 variant
// reads and writes the rows (x, r, s, y; s, dy, ds, dx) in bf16 and keeps
// γ, β, the statistics and dγ, dβ in f32.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "dtype.cuh"

namespace {

constexpr int NWARP = 8;  // warps (rows in flight) per block
constexpr int NTHREAD = NWARP * 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename E, int VPT, bool ADD>
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
      const float sv = ADD ? round_to<E>(to_f32(x[off + c]) + to_f32(r[off + c]))
                           : to_f32(x[off + c]);
      if (ADD) s[off + c] = from_f32<E>(sv);
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

// ------------------------------------------------------------ wide rows
// Rows wider than REG_DIM (module note). Thread t's i-th vector of a row
// starts at column (t + i·blockDim.x)·VEC.

constexpr int WIDE_K = 16;               // columns a thread holds in the wide register instances
constexpr int FWD_ROWS_THREADS = 512;    // widest block of the forward's: d <= 16384 (2·WIDE_K a thread past 8192)
constexpr int BWD_ROWS_THREADS = 512;    // and of the backward's: d <= 8192 (scalar: half the threads)
constexpr int LOOP_THREADS = 512;        // block of the looped instances past them
constexpr int SMEM_OPTIN = 232448 - 1024;  // dynamic shared memory a looped block takes at most

// A thread's VEC values of a row as loaded: 16 raw bytes (the pointer
// 16-byte aligned), or one element for VEC = 1.
template <typename E, int VEC>
using raw_t = std::conditional_t<VEC == 1, E, uint4>;

template <typename E, int VEC>
__device__ __forceinline__ raw_t<E, VEC> load_raw(const E* p) {
  return *reinterpret_cast<const raw_t<E, VEC>*>(p);
}

// The VEC values of a raw load, widened to f32.
__device__ __forceinline__ void unpack(float e, float* v) { v[0] = e; }
__device__ __forceinline__ void unpack(__nv_bfloat16 e, float* v) { v[0] = __bfloat162float(e); }

template <typename E>
__device__ __forceinline__ void unpack(const uint4& q, float* v) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(E) == 4) {
      v[j] = __uint_as_float(w[j]);
    } else {  // bf16 to f32: the 16 bits shifted up, exact
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

template <typename E, int VEC>
__device__ __forceinline__ void unpack_raw(const raw_t<E, VEC>& q, float* v) {
  if constexpr (VEC == 1) {
    unpack(q, v);
  } else {
    static_assert(VEC * sizeof(E) == 16, "a vector is 16 bytes");
    unpack<E>(q, v);
  }
}

// VEC values of a row at p widened to f32 (γ and β: VEC/4 loads of 16 bytes).
template <int VEC, typename E>
__device__ __forceinline__ void load_vec(const E* p, float* v) {
  if constexpr (sizeof(E) == 4 && VEC > 4) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) unpack_raw<E, 4>(load_raw<E, 4>(p + j), v + j);
  } else {
    unpack_raw<E, VEC>(load_raw<E, VEC>(p), v);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16;
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 1) {
    *p = __float2bfloat16(v[0]);
  } else {
    static_assert(VEC == 8, "a 16-byte bf16 vector holds 8 values");
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                              bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  }
}

// The block-wide sums of v[0..NS) (blockDim.x a multiple of 32), the same
// in every thread: each warp's butterfly sum, then the warps' sums added in
// warp order through red. One __syncthreads: a caller that sums again
// passes the other of two red buffers, so no warp overwrites sums that
// another is still reading.
template <int NS>
__device__ __forceinline__ void block_sum(float* v, float (*red)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    v[j] = warp_sum(v[j]);
    if (lane == 0) red[j][warp] = v[j];
  }
  __syncthreads();
  const int nwarp = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float a = 0.f;
    for (int w = 0; w < nwarp; ++w) a += red[j][w];
    v[j] = a;
  }
}

// Forward, one row (blockIdx.x) a block, each thread's K columns in
// registers: x (and r) read once, s (post-rounded) and y written once.
template <typename E, int VEC, bool ADD, int K>
__global__ void __launch_bounds__(FWD_ROWS_THREADS, VEC == 1 ? 1 : 2)
add_ln_fwd_wide_kernel(const E* __restrict__ x, const E* __restrict__ r,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       E* __restrict__ s, E* __restrict__ y, float* __restrict__ mean,
                       float* __restrict__ rstd, int d, float eps) {
  constexpr int NV = K / VEC;
  __shared__ float red[2][32];
  const long long off = static_cast<long long>(blockIdx.x) * d;
  float val[NV][VEC];
  float st[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (threadIdx.x + i * blockDim.x) * VEC;
    if (c < d) {
      load_vec<VEC>(x + off + c, val[i]);
      if (ADD) {
        float rv[VEC];
        load_vec<VEC>(r + off + c, rv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) val[i][j] = round_to<E>(val[i][j] + rv[j]);
        store_vec<VEC>(s + off + c, val[i]);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        st[0] += val[i][j];
        st[1] += val[i][j] * val[i][j];
      }
    }
  }
  block_sum<2>(st, red);
  const float m = st[0] / d;
  const float var = fmaxf(st[1] / d - m * m, 0.f);
  const float rs = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (threadIdx.x + i * blockDim.x) * VEC;
    if (c < d) {
      float g[VEC], b[VEC];
      load_vec<VEC>(gamma + c, g);
      load_vec<VEC>(beta + c, b);
#pragma unroll
      for (int j = 0; j < VEC; ++j) val[i][j] = (val[i][j] - m) * rs * g[j] + b[j];
      store_vec<VEC>(y + off + c, val[i]);
    }
  }
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = m;
    rstd[blockIdx.x] = rs;
  }
}

// Forward past the register instance: one row a block in two passes, the
// row (s for ADD, else x) staged in shared memory between them where it
// fits, else read again (x, or this thread's own stores of s).
template <typename E, int VEC, bool ADD>
__global__ void __launch_bounds__(LOOP_THREADS)
add_ln_fwd_loop_kernel(const E* __restrict__ x, const E* __restrict__ r,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       E* __restrict__ s, E* __restrict__ y, float* __restrict__ mean,
                       float* __restrict__ rstd, int d, float eps, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][32];
  E* stage = staged ? reinterpret_cast<E*>(smem) : nullptr;
  const long long off = static_cast<long long>(blockIdx.x) * d;
  const long long step = static_cast<long long>(blockDim.x) * VEC;
  float st[2] = {0.f, 0.f};
#pragma unroll 4
  for (long long c = threadIdx.x * VEC; c < d; c += step) {
    float v[VEC];
    load_vec<VEC>(x + off + c, v);
    if (ADD) {
      float rv[VEC];
      load_vec<VEC>(r + off + c, rv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = round_to<E>(v[j] + rv[j]);
      store_vec<VEC>(s + off + c, v);
    }
    if (stage) store_vec<VEC>(stage + c, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      st[0] += v[j];
      st[1] += v[j] * v[j];
    }
  }
  block_sum<2>(st, red);
  const float m = st[0] / d;
  const float var = fmaxf(st[1] / d - m * m, 0.f);
  const float rs = rsqrtf(var + eps);
  const E* src = stage ? stage : (ADD ? s : x) + off;
#pragma unroll 4
  for (long long c = threadIdx.x * VEC; c < d; c += step) {
    float v[VEC], g[VEC], b[VEC];
    load_vec<VEC>(src + c, v);
    load_vec<VEC>(gamma + c, g);
    load_vec<VEC>(beta + c, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = (v[j] - m) * rs * g[j] + b[j];
    store_vec<VEC>(y + off + c, v);
  }
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = m;
    rstd[blockIdx.x] = rs;
  }
}

// Backward, persistent: block b owns rows [b·rows_per_block, +rows_per_block)
// and takes them one at a time (one __syncthreads a row). Each thread reads
// its WIDE_K columns of s and dy once, as raw 16-byte words that stay in
// registers through both uses (the sums, then dx), starts its ds loads
// before the row's sums cross the block, and writes dx once. γ and the
// dγ/dβ sums stay in registers across the block's rows, and the block
// writes one partial row of each: part[0][b] and part[1][b] (part is
// [2][gridDim.x][d]). The scalar instance holds 16 separate columns, so it
// takes at most half the threads, with twice the registers.
template <typename E, int VEC>
__global__ void __launch_bounds__(VEC == 1 ? BWD_ROWS_THREADS / 2 : BWD_ROWS_THREADS, 1)
add_ln_bwd_wide_kernel(const E* __restrict__ s, const float* __restrict__ gamma,
                       const E* __restrict__ dy, const E* __restrict__ ds,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       E* __restrict__ dx, float* __restrict__ part, int N, int d,
                       int rows_per_block) {
  constexpr int NV = WIDE_K / VEC;
  using R = raw_t<E, VEC>;
  __shared__ float red[2][2][32];
  float gam[NV][VEC], dg[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (threadIdx.x + i * blockDim.x) * VEC;
    if (c < d) load_vec<VEC>(gamma + c, gam[i]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) dg[i][j] = db[i][j] = 0.f;
  }
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long last = min(first + rows_per_block, static_cast<long long>(N));
  R raw_s[NV], raw_dy[NV];  // this row's s and dy as loaded
  float m = 0.f, rs = 0.f;
  auto load_row = [&](long long row, R* qs, R* qdy, float& qm, float& qr) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (threadIdx.x + i * blockDim.x) * VEC;
      if (c < d) {
        qs[i] = load_raw<E, VEC>(s + row * d + c);
        qdy[i] = load_raw<E, VEC>(dy + row * d + c);
      }
    }
    qm = mean[row];
    qr = rstd[row];
  };
  if (first < last) load_row(first, raw_s, raw_dy, m, rs);
  int parity = 0;
  for (long long row = first; row < last; ++row, parity ^= 1) {
    R raw_ds[NV];
    float st[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (threadIdx.x + i * blockDim.x) * VEC;
      if (c < d) {
        if (ds != nullptr) raw_ds[i] = load_raw<E, VEC>(ds + row * d + c);
        float sv[VEC], dyv[VEC];
        unpack_raw<E, VEC>(raw_s[i], sv);
        unpack_raw<E, VEC>(raw_dy[i], dyv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (sv[j] - m) * rs;
          const float gy = dyv[j] * gam[i][j];
          st[0] += gy;
          st[1] += gy * xh;
          dg[i][j] += dyv[j] * xh;
          db[i][j] += dyv[j];
        }
      }
    }
    block_sum<2>(st, red[parity]);
    const float mg = st[0] / d;
    const float mgx = st[1] / d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (threadIdx.x + i * blockDim.x) * VEC;
      if (c < d) {
        float sv[VEC], dyv[VEC], v[VEC];
        unpack_raw<E, VEC>(raw_s[i], sv);
        unpack_raw<E, VEC>(raw_dy[i], dyv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (sv[j] - m) * rs;
          v[j] = rs * (dyv[j] * gam[i][j] - mg - xh * mgx);
        }
        if (ds != nullptr) {
          float dsv[VEC];
          unpack_raw<E, VEC>(raw_ds[i], dsv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[j] += dsv[j];
        }
        store_vec<VEC>(dx + row * d + c, v);
      }
    }
    if (row + 1 < last) load_row(row + 1, raw_s, raw_dy, m, rs);
  }
  float* out_g = part + static_cast<long long>(blockIdx.x) * d;
  float* out_b = part + (static_cast<long long>(gridDim.x) + blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (threadIdx.x + i * blockDim.x) * VEC;
    if (c < d) {
      store_vec<VEC>(out_g + c, dg[i]);
      store_vec<VEC>(out_b + c, db[i]);
    }
  }
}

// Backward past the register instance: persistent like it, each row in two
// passes (sums, then dx), s and dy staged in shared memory between them
// where they fit (`staged`), else read again; the dγ/dβ sums in shared
// memory (`acc_shared`: 2·d floats) or else in the block's partial rows of
// part, read and written by the thread that owns the column.
template <typename E, int VEC>
__global__ void __launch_bounds__(LOOP_THREADS, 1)
add_ln_bwd_loop_kernel(const E* __restrict__ s, const float* __restrict__ gamma,
                       const E* __restrict__ dy, const E* __restrict__ ds,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       E* __restrict__ dx, float* __restrict__ part, int N, int d,
                       int rows_per_block, int acc_shared, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][2][32];
  float* out_g = part + static_cast<long long>(blockIdx.x) * d;
  float* out_b = part + (static_cast<long long>(gridDim.x) + blockIdx.x) * d;
  float* acc_g = acc_shared ? reinterpret_cast<float*>(smem) : out_g;
  float* acc_b = acc_shared ? reinterpret_cast<float*>(smem) + d : out_b;
  E* stage_s = staged ? reinterpret_cast<E*>(reinterpret_cast<float*>(smem) + 2 * d) : nullptr;
  E* stage_dy = staged ? stage_s + d : nullptr;
  const long long step = static_cast<long long>(blockDim.x) * VEC;
  const float zero[VEC] = {};
  for (long long c = threadIdx.x * VEC; c < d; c += step) {
    store_vec<VEC>(acc_g + c, zero);
    store_vec<VEC>(acc_b + c, zero);
  }
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long last = min(first + rows_per_block, static_cast<long long>(N));
  int parity = 0;
  for (long long row = first; row < last; ++row, parity ^= 1) {
    const long long off = row * d;
    const float m = mean[row];
    const float rs = rstd[row];
    float st[2] = {0.f, 0.f};
#pragma unroll 2
    for (long long c = threadIdx.x * VEC; c < d; c += step) {
      float sv[VEC], dyv[VEC], g[VEC], ag[VEC], ab[VEC];
      load_vec<VEC>(s + off + c, sv);
      load_vec<VEC>(dy + off + c, dyv);
      load_vec<VEC>(gamma + c, g);
      load_vec<VEC>(acc_g + c, ag);
      load_vec<VEC>(acc_b + c, ab);
      if (stage_s) {
        store_vec<VEC>(stage_s + c, sv);
        store_vec<VEC>(stage_dy + c, dyv);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (sv[j] - m) * rs;
        const float gy = dyv[j] * g[j];
        st[0] += gy;
        st[1] += gy * xh;
        ag[j] += dyv[j] * xh;
        ab[j] += dyv[j];
      }
      store_vec<VEC>(acc_g + c, ag);
      store_vec<VEC>(acc_b + c, ab);
    }
    block_sum<2>(st, red[parity]);
    const float mg = st[0] / d;
    const float mgx = st[1] / d;
    const E* src_s = stage_s ? stage_s : s + off;
    const E* src_dy = stage_dy ? stage_dy : dy + off;
#pragma unroll 4
    for (long long c = threadIdx.x * VEC; c < d; c += step) {
      float sv[VEC], dyv[VEC], g[VEC], v[VEC];
      load_vec<VEC>(src_s + c, sv);
      load_vec<VEC>(src_dy + c, dyv);
      load_vec<VEC>(gamma + c, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = rs * (dyv[j] * g[j] - mg - (sv[j] - m) * rs * mgx);
      if (ds != nullptr) {
        float dsv[VEC];
        load_vec<VEC>(ds + off + c, dsv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] += dsv[j];
      }
      store_vec<VEC>(dx + off + c, v);
    }
  }
  if (acc_shared) {
    for (long long c = threadIdx.x * VEC; c < d; c += step) {
      float a[VEC];
      load_vec<VEC>(acc_g + c, a);
      store_vec<VEC>(out_g + c, a);
      load_vec<VEC>(acc_b + c, a);
      store_vec<VEC>(out_b + c, a);
    }
  }
}

// ------------------------------------------------------------ launches

template <typename E, int VPT, bool ADD>
cudaError_t launch_fwd(const E* x, const E* r, const float* gamma,
                       const float* beta, E* s, E* y, float* mean,
                       float* rstd, int N, int d, float eps,
                       cudaStream_t stream) {
  const int grid = (N + NWARP - 1) / NWARP;
  add_ln_fwd_kernel<E, VPT, ADD><<<grid, NTHREAD, 0, stream>>>(
      x, r, gamma, beta, s, y, mean, rstd, N, d, eps);
  return cudaGetLastError();
}

constexpr int REG_DIM = 1024;  // widest row the register instances hold

// The wide instance of a launch (mirrored by the wrapper's layernorm_plan).
enum WideKind { WIDE_REGISTERS = 1, WIDE_STAGED = 2, WIDE_SHARED = 3, WIDE_DEVICE = 4 };
struct WidePlan {
  int kind;     // registers: the row (and dγ/dβ) in registers; staged: the row
                // (and dγ/dβ) in shared memory; shared: dγ/dβ only; device: neither
  int threads;  // a block
  int smem;     // dynamic shared memory, bytes
};

inline WidePlan wide_plan(bool backward, int d, int esize, bool vec) {
  const int k = !backward && d > FWD_ROWS_THREADS * WIDE_K ? 2 * WIDE_K : WIDE_K;
  const long long t = ((d + k - 1LL) / k + 31) / 32 * 32;
  if (t <= (backward ? BWD_ROWS_THREADS / (vec ? 1 : 2) : FWD_ROWS_THREADS))
    return {WIDE_REGISTERS, static_cast<int>(t), 0};
  const long long acc = backward ? 8LL * d : 0;  // dγ, dβ in f32
  const long long row = static_cast<long long>(esize) * d * (backward ? 2 : 1);  // s, dy / x or s
  if (acc + row <= SMEM_OPTIN) return {WIDE_STAGED, LOOP_THREADS, static_cast<int>(acc + row)};
  if (backward && acc <= SMEM_OPTIN) return {WIDE_SHARED, LOOP_THREADS, static_cast<int>(acc)};
  return {WIDE_DEVICE, LOOP_THREADS, 0};
}

// 16-byte vectors take every width that is a multiple of one and pointers
// (null or) 16-byte aligned.
template <typename E>
bool vector_ok(int d, std::initializer_list<const void*> ptrs) {
  if (d % (16 / sizeof(E)) != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename E, bool ADD>
cudaError_t launch_fwd_wide(const E* x, const E* r, const float* gamma,
                            const float* beta, E* s, E* y, float* mean, float* rstd,
                            int N, int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(E);
  const bool vec = vector_ok<E>(d, {x, r, gamma, beta, s, y});
  const WidePlan p = wide_plan(false, d, sizeof(E), vec);
  if (p.kind == WIDE_REGISTERS) {
    const bool k2 = d > FWD_ROWS_THREADS * WIDE_K;
    auto kernel = vec ? (k2 ? add_ln_fwd_wide_kernel<E, V, ADD, 2 * WIDE_K>
                            : add_ln_fwd_wide_kernel<E, V, ADD, WIDE_K>)
                      : (k2 ? add_ln_fwd_wide_kernel<E, 1, ADD, 2 * WIDE_K>
                            : add_ln_fwd_wide_kernel<E, 1, ADD, WIDE_K>);
    kernel<<<N, p.threads, 0, stream>>>(x, r, gamma, beta, s, y, mean, rstd, d, eps);
    return cudaGetLastError();
  }
  auto kernel = vec ? add_ln_fwd_loop_kernel<E, V, ADD> : add_ln_fwd_loop_kernel<E, 1, ADD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<N, p.threads, p.smem, stream>>>(x, r, gamma, beta, s, y, mean, rstd, d, eps,
                                           p.kind == WIDE_STAGED);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_bwd_wide(const E* s, const float* gamma, const E* dy, const E* ds,
                            const float* mean, const float* rstd, E* dx, float* dgamma,
                            float* dbeta, float* part, int N, int d, int rows_per_block,
                            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(E);
  const int nblocks = (N + rows_per_block - 1) / rows_per_block;
  const bool vec = vector_ok<E>(d, {s, gamma, dy, ds, dx, part});
  const WidePlan p = wide_plan(true, d, sizeof(E), vec);
  if (p.kind == WIDE_REGISTERS) {
    auto kernel = vec ? add_ln_bwd_wide_kernel<E, V> : add_ln_bwd_wide_kernel<E, 1>;
    kernel<<<nblocks, p.threads, 0, stream>>>(s, gamma, dy, ds, mean, rstd, dx, part, N, d,
                                              rows_per_block);
  } else {
    auto kernel = vec ? add_ln_bwd_loop_kernel<E, V> : add_ln_bwd_loop_kernel<E, 1>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<nblocks, p.threads, p.smem, stream>>>(s, gamma, dy, ds, mean, rstd, dx, part, N,
                                                   d, rows_per_block, p.kind != WIDE_DEVICE,
                                                   p.kind == WIDE_STAGED);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  add_ln_bwd_cols_kernel<<<(2 * d + COLS - 1) / COLS, COLS * SEGS, 0, stream>>>(
      part, dgamma, dbeta, nblocks, d);
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

template <typename E, bool ADD>
int dispatch_fwd(const E* x, const E* r, const float* gamma, const float* beta,
                 E* s, E* y, float* mean, float* rstd, int N, int d, float eps,
                 cudaStream_t st) {
#define CALL_FWD(V) launch_fwd<E, V, ADD>(x, r, gamma, beta, s, y, mean, rstd, N, d, eps, st)
  if (d <= 32) return CALL_FWD(1);
  if (d <= 64) return CALL_FWD(2);
  if (d <= 128) return CALL_FWD(4);
  if (d <= 256) return CALL_FWD(8);
  if (d <= 512) return CALL_FWD(16);
  if (d <= REG_DIM) return CALL_FWD(32);
  if (d >= 1) return launch_fwd_wide<E, ADD>(x, r, gamma, beta, s, y, mean, rstd, N, d, eps, st);
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
  if (d <= REG_DIM) return CALL_BWD(32);
  if (d >= 1)
    return launch_bwd_wide(s, gamma, dy, ds, mean, rstd, dx, dgamma, dbeta, part, N, d,
                           rows_per_block, st);
  return cudaErrorInvalidValue;
#undef CALL_BWD
}

}  // namespace

extern "C" {

// All buffers contiguous: x, r, s, y [N, d] (f32 for _f32, bf16 for
// _bf16); gamma, beta [d] f32; mean, rstd [N] f32; any d >= 1.
int add_ln_fwd_f32(const float* x, const float* r, const float* gamma,
                   const float* beta, float* s, float* y, float* mean,
                   float* rstd, int N, int d, float eps, void* stream) {
  return dispatch_fwd<float, true>(x, r, gamma, beta, s, y, mean, rstd, N, d, eps,
                                   static_cast<cudaStream_t>(stream));
}

int add_ln_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* r,
                    const float* gamma, const float* beta, __nv_bfloat16* s,
                    __nv_bfloat16* y, float* mean, float* rstd, int N, int d,
                    float eps, void* stream) {
  return dispatch_fwd<__nv_bfloat16, true>(x, r, gamma, beta, s, y, mean, rstd, N, d,
                                           eps, static_cast<cudaStream_t>(stream));
}

// Plain LayerNorm forward: x, y [N, d]; gamma, beta [d] f32; mean, rstd [N]
// f32.
int ln_fwd_f32(const float* x, const float* gamma, const float* beta, float* y,
               float* mean, float* rstd, int N, int d, float eps, void* stream) {
  return dispatch_fwd<float, false>(x, nullptr, gamma, beta, nullptr, y, mean, rstd,
                                    N, d, eps, static_cast<cudaStream_t>(stream));
}

int ln_fwd_bf16(const __nv_bfloat16* x, const float* gamma, const float* beta,
                __nv_bfloat16* y, float* mean, float* rstd, int N, int d,
                float eps, void* stream) {
  return dispatch_fwd<__nv_bfloat16, false>(x, nullptr, gamma, beta, nullptr, y, mean,
                                            rstd, N, d, eps,
                                            static_cast<cudaStream_t>(stream));
}

// s, dy, ds (or null), dx [N, d] (f32 for _f32, bf16 for _bf16); gamma,
// dgamma, dbeta [d] f32; mean, rstd [N] f32; part is f32 scratch of
// 2·P·d floats, P = ceil(N / rows_per_block) partial rows (one a block; the
// wrapper sets rows_per_block to 32 up to REG_DIM, past it to fill G
// persistent blocks). The plain LayerNorm backward is these entries with
// ds null and x in place of s.
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

// The wide instance (WideKind: 1 registers, 2 staged, 3 shared, 4 device)
// that a launch of width d > REG_DIM takes with rows of esize bytes, in 16-
// byte vectors (vec) or not, and its block size in *threads: what the
// wrapper's layernorm_plan mirrors.
int add_ln_wide_plan(int backward, int d, int esize, int vec, int* threads) {
  const WidePlan p = wide_plan(backward != 0, d, esize, vec != 0);
  *threads = p.threads;
  return p.kind;
}

const char* add_layernorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
