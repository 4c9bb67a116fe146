// Flash-attention backward dQ, f32 and bf16, for Hopper (sm_90a): kernel 2
// of the port. (Kernel 3, dK/dV, is flash_dkdv.cu.)
//
// Replaces: tpudml/ops/attention_kernel.py:177 `_dq_kernel` (K innermost),
// launched by `_backward_calls` from the flash custom-vjp backward and from
// `flash_block_grads`.
//
// Computes, for q, k, v, dO [B, T, H, D] (D in {32, 64, 128}; the wrapper
// zero-pads any other D up to 128 and slices dQ back) and the row
// statistics lse, Δ [B, H, T] (Δ = rowsum(dO ⊙ O), taken outside the
// kernel), with s = q·kᵀ·scale masked causally (`q_pos >= k_pos +
// k_shift`, local positions) and p = exp(s − lse) on visible entries, 0
// elsewhere:
//   dp = dO·Vᵀ,  ds = p ⊙ (dp − Δ),  dQ = scale · ds·K.
// The bf16 variant widens q, k, v, dO to f32 as it stages them, rounds ds to
// bf16 before the product it feeds (the TPU kernel's `ds.astype(k.dtype)`)
// and stores dQ in bf16; lse and Δ stay f32.
//
// What bounds it on this card: f32 FMAs on the CUDA cores. Per visible
// (q, k) pair dQ does 3·D FMAs (q·k, dO·v, ds·k); at the training shape
// (B=8, T=1024, H=4, D=128, causal) that is ~13 GFLOP against ~100 MB of
// traffic. This simple version feeds every FMA from shared memory, so
// shared-memory bandwidth, not the FMA rate, is its real limit (its
// redesign on the tensor cores is ROADMAP queue 2's next item).
//
// Design: the TPU's sequential grid axis becomes a loop inside the block,
// as in flash_fwd.cu: one block per (b·h, 64-row Q tile), walking the K
// tiles up to the causal diagonal; the dQ tile accumulates in registers
// (8 warps × 8 rows; each lane D/32 columns). Every output element is
// written by exactly one thread after a fixed-order loop: no atomics, so
// the results are bitwise the same from run to run. The operand whose rows
// the 32 lanes read in parallel is padded by one float per row (no bank
// conflicts); the other is read as a broadcast. Keys past T are masked and
// rows past T are never written, so any T works. q/k/v/dO are indexed
// through their (batch, time, head) strides; outputs are contiguous. B·H
// lies on grid y and continues on grid z past 65535 (grid.cuh).

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"
#include "grid.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NWARP = 8;        // warps per block
constexpr int NTHREAD = NWARP * 32;
constexpr int RPW = BQ / NWARP; // query rows per warp

struct Strides {
  long long b, t, h;
};

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO [BQ][D]; K, V [BK][D+1]; ds [BQ][BK]; lse, delta [BQ]
  return sizeof(float) * (2 * BQ * D + 2 * BK * (D + 1) + BQ * BK + 2 * BQ);
}

template <typename E, int D>
__global__ void __launch_bounds__(NTHREAD)
flash_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, const E* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                E* __restrict__ dq, int BH, int T, int H, Strides qs, Strides ks,
                Strides vs, Strides dos, int causal, int k_shift, float scale) {
  constexpr int NC = D / 32;  // output columns per lane
  constexpr int KP = D + 1;   // padded K/V row
  extern __shared__ float smem[];
  float* q_s = smem;               // [BQ][D]
  float* do_s = q_s + BQ * D;      // [BQ][D]
  float* k_s = do_s + BQ * D;      // [BK][D+1]
  float* v_s = k_s + BK * KP;      // [BK][D+1]
  float* ds_s = v_s + BK * KP;     // [BQ][BK]
  float* lse_s = ds_s + BQ * BK;   // [BQ]
  float* del_s = lse_s + BQ;       // [BQ]

  const int bh = grid_y_index();
  if (bh >= BH) return;  // past B·H in the last z slice
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const E* qp = q + b * qs.b + h * qs.h;
  const E* kp = k + b * ks.b + h * ks.h;
  const E* vp = v + b * vs.b + h * vs.h;
  const E* dop = dout + b * dos.b + h * dos.h;
  const long long row0 = static_cast<long long>(bh) * T;  // [B, H, T] rows

  for (int i = tid; i < BQ * D; i += NTHREAD) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    q_s[i] = t < T ? to_f32(qp[t * qs.t + c]) : 0.f;
    do_s[i] = t < T ? to_f32(dop[t * dos.t + c]) : 0.f;
  }
  for (int i = tid; i < BQ; i += NTHREAD) {
    const int t = q0 + i;
    lse_s[i] = t < T ? lse[row0 + t] : 0.f;
    del_s[i] = t < T ? delta[row0 + t] : 0.f;
  }

  float acc[RPW][NC];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[rr][cc] = 0.f;

  const int q_last = min(q0 + BQ, T) - 1;
  const int n_tiles = (T + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    // Causal tile skip: no row of this Q tile sees this or a later K tile.
    if (causal && k0 + k_shift > q_last) break;
    __syncthreads();  // the previous tile's k_s/v_s/ds_s are no longer read
    for (int i = tid; i < BK * D; i += NTHREAD) {
      const int j = i / D, c = i % D;
      const int t = k0 + j;
      k_s[j * KP + c] = t < T ? to_f32(kp[t * ks.t + c]) : 0.f;
      v_s[j * KP + c] = t < T ? to_f32(vp[t * vs.t + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int q_pos = q0 + r;
#pragma unroll
      for (int jj = 0; jj < BK / 32; ++jj) {
        const int j = lane + 32 * jj;
        const int k_pos = k0 + j;
        float sdot = 0.f, pdot = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) {
          sdot += q_s[r * D + c] * k_s[j * KP + c];
          pdot += do_s[r * D + c] * v_s[j * KP + c];
        }
        const bool visible = q_pos < T && k_pos < T &&
                             (!causal || q_pos >= k_pos + k_shift);
        const float p = visible ? expf(sdot * scale - lse_s[r]) : 0.f;
        ds_s[r * BK + j] = round_to<E>(p * (pdot - del_s[r]));
      }
      __syncwarp();
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = lane + 32 * cc;
        float a = acc[rr][cc];
#pragma unroll 16
        for (int j = 0; j < BK; ++j) a += ds_s[r * BK + j] * k_s[j * KP + c];
        acc[rr][cc] = a;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int t = q0 + warp * RPW + rr;
    if (t >= T) continue;
    E* row = dq + ((static_cast<long long>(b) * T + t) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) row[lane + 32 * cc] = from_f32<E>(acc[rr][cc] * scale);
  }
}

template <typename E, int D>
cudaError_t launch_dq(const E* q, const E* k, const E* v, const E* dout,
                      const float* lse, const float* delta, E* dq, int B,
                      int T, int H, Strides qs, Strides ks, Strides vs,
                      Strides dos, int causal, int k_shift, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_xyz((T + BQ - 1) / BQ, static_cast<long long>(B) * H);
  flash_dq_kernel<E, D><<<grid, NTHREAD, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, B * H, T, H, qs, ks, vs, dos, causal, k_shift,
      scale);
  return cudaGetLastError();
}

template <typename E>
int dispatch_dq(const E* q, const E* k, const E* v, const E* dout,
                const float* lse, const float* delta, E* dq, int B, int T,
                int H, int D, Strides qs, Strides ks, Strides vs, Strides dos,
                int causal, int k_shift, float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dq<E, 32>(q, k, v, dout, lse, delta, dq, B, T, H, qs, ks, vs, dos, causal, k_shift, scale, s);
    case 64:
      return launch_dq<E, 64>(q, k, v, dout, lse, delta, dq, B, T, H, qs, ks, vs, dos, causal, k_shift, scale, s);
    case 128:
      return launch_dq<E, 128>(q, k, v, dout, lse, delta, dq, B, T, H, qs, ks, vs, dos, causal, k_shift, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/k/v/dO strides are (batch, time, head) in elements; the head-dim
// stride is 1. lse and delta are contiguous [B, H, T] f32; dq is a
// contiguous [B, T, H, D] buffer of q's dtype. The _f32 entry point takes
// f32 q/k/v/dO, the _bf16 one bf16.
#define DQ_ENTRY(NAME, E)                                                      \
  int NAME(const E* q, const E* k, const E* v, const E* dout,                  \
           const float* lse, const float* delta, E* dq, int B, int T, int H,   \
           int D, long long qsb, long long qst, long long qsh, long long ksb,  \
           long long kst, long long ksh, long long vsb, long long vst,         \
           long long vsh, long long dsb, long long dst, long long dsh,         \
           int causal, int k_shift, float scale, void* stream) {               \
    return dispatch_dq(q, k, v, dout, lse, delta, dq, B, T, H, D,             \
                       Strides{qsb, qst, qsh}, Strides{ksb, kst, ksh},         \
                       Strides{vsb, vst, vsh}, Strides{dsb, dst, dsh}, causal, \
                       k_shift, scale, static_cast<cudaStream_t>(stream));     \
  }
DQ_ENTRY(flash_dq_f32, float)
DQ_ENTRY(flash_dq_bf16, __nv_bfloat16)

#undef DQ_ENTRY

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
