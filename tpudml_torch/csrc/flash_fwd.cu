// Flash-attention forward with the row log-sum-exp, f32 and bf16, for Hopper
// (sm_90a).
//
// Replaces: tpudml/ops/attention_kernel.py `_fwd_kernel` (launched by
// `_flash_forward`, reached through `flash_forward_lse`), the TPU kernel the
// chunked-prefill window attention (`_chunk_flash_window`) runs per block.
//
// Computes, for q, k, v [B, T, H, D] (same T), out = softmax(q·kᵀ·scale)·v and
// lse = log Σ exp(q·kᵀ·scale) per (b, h, query row), with an optional causal
// mask `q_pos >= k_pos + k_shift` on local positions. A row that sees no key
// at all (possible only with k_shift > 0) gets out = 0 and lse = -1e30, so
// it carries zero weight in any log-sum-exp merge. The bf16 variant widens
// q, k, v to f32 as it stages them, rounds each tile's probabilities to bf16
// before the P·V product (as the TPU kernel's `p.astype(v.dtype)`; the
// normalizer sums the unrounded p) and stores out in bf16; lse stays f32.
//
// What bounds it on this card: at the serving shapes (T = C = 128, D = 64)
// the work is tiny (a few MFLOP per head) and the call is bound by launch
// latency and by the serial dependency of the online softmax; at long T it
// would be bound by the f32 FMA rate of the CUDA cores (no tensor cores in
// f32 here). Its inputs are read once per Q tile, so bytes never bound it.
//
// Design: the TPU kernel's sequential K-tile grid axis does not carry over,
// because blocks run in parallel and nothing survives between them. So one
// block owns one (b·h, 64-row Q tile) and walks the K tiles in a loop INSIDE
// the block, keeping the running max m, normalizer l and the output
// accumulator in registers (8 warps, 8 query rows per warp; each lane holds
// D/32 output columns of each of its rows). Q, the current K and V tiles and
// the tile's probabilities live in shared memory (K rows padded by one float
// so the 32 lanes of a warp read 32 different banks). K tiles entirely above
// the shifted diagonal are skipped by ending the loop; keys past T are never
// loaded and Q rows past T are never written. [B, T, H, D] is indexed through
// the caller's strides: no folding or padding copies.

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per K tile
constexpr int NWARP = 8;        // warps per block
constexpr int RPW = BQ / NWARP; // query rows per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * BK);
}

template <typename E, int D>
__global__ void __launch_bounds__(NWARP * 32)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, E* __restrict__ o,
                 float* __restrict__ lse, int T, int H,
                 long long qsb, long long qst, long long qsh,
                 long long ksb, long long kst, long long ksh,
                 long long vsb, long long vst, long long vsh,
                 int causal, int k_shift, float scale) {
  constexpr int NC = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][D]
  float* ks = qs + BQ * D;          // [BK][D + 1]
  float* vs = ks + BK * (D + 1);    // [BK][D]
  float* ps = vs + BK * D;          // [BQ][BK]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const E* qp = q + b * qsb + h * qsh;
  const E* kp = k + b * ksb + h * ksh;
  const E* vp = v + b * vsb + h * vsh;

  for (int i = tid; i < BQ * D; i += NWARP * 32) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    qs[i] = t < T ? to_f32(qp[t * qst + c]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][NC];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[rr][cc] = 0.f;
  }

  const int q_last = min(q0 + BQ, T) - 1;
  const int n_tiles = (T + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    // Tile skip: no row of this Q tile can see any key of this or a later
    // K tile once the tile's first key is past the last row's diagonal.
    if (causal && k0 + k_shift > q_last) break;
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int i = tid; i < BK * D; i += NWARP * 32) {
      const int j = i / D, c = i % D;
      const int t = k0 + j;
      ks[j * (D + 1) + c] = t < T ? to_f32(kp[t * kst + c]) : 0.f;
      vs[j * D + c] = t < T ? to_f32(vp[t * vst + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int q_pos = q0 + r;
      float s[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        const int k_pos = k0 + j;
        float dot = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) dot += qs[r * D + c] * ks[j * (D + 1) + c];
        const bool visible = k_pos < T && (!causal || q_pos >= k_pos + k_shift);
        s[jj] = visible ? dot * scale : -INFINITY;
      }
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(s[0], s[1])));
      // m_new == -inf: nothing visible yet in this row; keep the zero state.
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[rr] - m_new);
      const float p0 = s[0] == -INFINITY ? 0.f : expf(s[0] - m_new);
      const float p1 = s[1] == -INFINITY ? 0.f : expf(s[1] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p0 + p1);
      m[rr] = m_new;
      ps[r * BK + lane] = round_to<E>(p0);
      ps[r * BK + lane + 32] = round_to<E>(p1);
      __syncwarp();
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = lane + 32 * cc;
        float a = acc[rr][cc] * alpha;
#pragma unroll 16
        for (int j = 0; j < BK; ++j) a += ps[r * BK + j] * vs[j * D + c];
        acc[rr][cc] = a;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int t = q0 + warp * RPW + rr;
    if (t >= T) continue;
    const bool seen = l[rr] > 0.f;
    E* orow = o + ((static_cast<long long>(b) * T + t) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
      orow[lane + 32 * cc] = from_f32<E>(seen ? acc[rr][cc] / l[rr] : 0.f);
    if (lane == 0)
      lse[(static_cast<long long>(b) * H + h) * T + t] =
          seen ? m[rr] + logf(l[rr]) : NEG_INF;
  }
}

template <typename E, int D>
cudaError_t launch(const E* q, const E* k, const E* v, E* o, float* lse, int B,
                   int T, int H, const long long* qs, const long long* ks, const long long* vs, int causal,
                   int k_shift, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<E, D><<<grid, NWARP * 32, smem, stream>>>(
      q, k, v, o, lse, T, H, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], causal, k_shift, scale);
  return cudaGetLastError();
}

template <typename E>
int dispatch(const E* q, const E* k, const E* v, E* o, float* lse, int B,
             int T, int H, int D, const long long* qs, const long long* ks,
             const long long* vs, int causal, int k_shift, float scale,
             cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<E, 32>(q, k, v, o, lse, B, T, H, qs, ks, vs, causal, k_shift, scale, s);
    case 64:
      return launch<E, 64>(q, k, v, o, lse, B, T, H, qs, ks, vs, causal, k_shift, scale, s);
    case 128:
      return launch<E, 128>(q, k, v, o, lse, B, T, H, qs, ks, vs, causal, k_shift, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/k/v strides are (batch, time, head) in elements; the head-dim stride is
// 1. out is a contiguous [B, T, H, D] buffer of q's dtype, lse a contiguous
// [B, H, T] f32 one.
int flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                  float* lse, int B, int T, int H, int D, long long qsb,
                  long long qst, long long qsh, long long ksb, long long kst,
                  long long ksh, long long vsb, long long vst, long long vsh,
                  int causal, int k_shift, float scale, void* stream) {
  const long long qs[3] = {qsb, qst, qsh};
  const long long ks[3] = {ksb, kst, ksh};
  const long long vs[3] = {vsb, vst, vsh};
  return dispatch(q, k, v, o, lse, B, T, H, D, qs, ks, vs, causal, k_shift,
                  scale, static_cast<cudaStream_t>(stream));
}

int flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int B,
                   int T, int H, int D, long long qsb, long long qst,
                   long long qsh, long long ksb, long long kst, long long ksh,
                   long long vsb, long long vst, long long vsh, int causal,
                   int k_shift, float scale, void* stream) {
  const long long qs[3] = {qsb, qst, qsh};
  const long long ks[3] = {ksb, kst, ksh};
  const long long vs[3] = {vsb, vst, vsh};
  return dispatch(q, k, v, o, lse, B, T, H, D, qs, ks, vs, causal, k_shift,
                  scale, static_cast<cudaStream_t>(stream));
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
