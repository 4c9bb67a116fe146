// Flash-attention backward, f32 and bf16, for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: tpudml/ops/attention_kernel.py `_dq_kernel` (dQ, K innermost)
// and `_dkdv_kernel` (dK/dV, Q innermost), launched by `_backward_calls`
// from the flash custom-vjp backward and from `flash_block_grads`.
//
// Computes, for q, k, v, dO [B, T, H, D] and the row statistics lse, Δ
// [B, H, T] (Δ = rowsum(dO ⊙ O), taken outside the kernels), with
// s = q·kᵀ·scale masked causally (`q_pos >= k_pos + k_shift`, local
// positions) and p = exp(s − lse) on visible entries, 0 elsewhere:
//   dp = dO·Vᵀ,  ds = p ⊙ (dp − Δ),
//   dQ = scale · ds·K,  dK = scale · dsᵀ·Q,  dV = pᵀ·dO.
// The bf16 variant widens q, k, v, dO to f32 as it stages them, rounds p and
// ds to bf16 before the products they feed (the TPU kernel's
// `p.astype(do.dtype)`, `ds.astype(k.dtype)`, `ds.astype(q.dtype)`) and
// stores dQ, dK, dV in bf16; lse and Δ stay f32.
//
// What bounds it on this card: f32 FMAs on the CUDA cores. Per visible
// (q, k) pair dQ does 3·D FMAs (q·k, dO·v, ds·k) and dK/dV 4·D (q·k, dO·v,
// p·dO, ds·q); at the training shape (B=8, T=1024, H=4, D=128, causal)
// that is ~13 and ~17 GFLOP against ~100 MB of traffic. This simple
// version feeds every FMA from shared memory, so shared-memory bandwidth,
// not the FMA rate, is its real limit.
//
// Design: the TPU's sequential grid axis becomes a loop inside the block,
// as in flash_fwd.cu. dQ: one block per (b·h, 64-row Q tile), walking the
// K tiles up to the causal diagonal; the dQ tile accumulates in registers
// (8 warps × 8 rows; each lane D/32 columns). dK/dV: one block per
// (b·h, 64-key K tile), walking the Q tiles from the diagonal down; dK and
// dV accumulate in registers (8 warps × 8 keys). Every output element is
// written by exactly one thread after a fixed-order loop: no atomics, so
// the results are bitwise the same from run to run. The operand whose rows
// the 32 lanes read in parallel is padded by one float per row (no bank
// conflicts); the other is read as a broadcast. Keys past T are masked and
// rows past T are never written, so any T works. q/k/v/dO are indexed
// through their (batch, time, head) strides; outputs are contiguous.

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NWARP = 8;        // warps per block
constexpr int NTHREAD = NWARP * 32;
constexpr int RPW = BQ / NWARP; // dQ: query rows per warp
constexpr int KPW = BK / NWARP; // dK/dV: keys per warp

struct Strides {
  long long b, t, h;
};

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO [BQ][D]; K, V [BK][D+1]; ds [BQ][BK]; lse, delta [BQ]
  return sizeof(float) * (2 * BQ * D + 2 * BK * (D + 1) + BQ * BK + 2 * BQ);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K, V [BK][D]; q, dO [BQ][D+1]; p, ds [BK][BQ]; lse, delta [BQ]
  return sizeof(float) * (2 * BK * D + 2 * BQ * (D + 1) + 2 * BK * BQ + 2 * BQ);
}

template <typename E, int D>
__global__ void __launch_bounds__(NTHREAD)
flash_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, const E* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                E* __restrict__ dq, int T, int H, Strides qs, Strides ks,
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

  const int bh = blockIdx.y;
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
__global__ void __launch_bounds__(NTHREAD)
flash_dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                  const E* __restrict__ v, const E* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  E* __restrict__ dk, E* __restrict__ dv, int T, int H,
                  Strides qs, Strides ks, Strides vs, Strides dos, int causal,
                  int k_shift, float scale) {
  constexpr int NC = D / 32;  // output columns per lane
  constexpr int QP = D + 1;   // padded q/dO row
  extern __shared__ float smem[];
  float* k_s = smem;               // [BK][D]
  float* v_s = k_s + BK * D;       // [BK][D]
  float* q_s = v_s + BK * D;       // [BQ][D+1]
  float* do_s = q_s + BQ * QP;     // [BQ][D+1]
  float* p_s = do_s + BQ * QP;     // [BK][BQ]
  float* ds_s = p_s + BK * BQ;     // [BK][BQ]
  float* lse_s = ds_s + BK * BQ;   // [BQ]
  float* del_s = lse_s + BQ;       // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const E* qp = q + b * qs.b + h * qs.h;
  const E* kp = k + b * ks.b + h * ks.h;
  const E* vp = v + b * vs.b + h * vs.h;
  const E* dop = dout + b * dos.b + h * dos.h;
  const long long row0 = static_cast<long long>(bh) * T;

  for (int i = tid; i < BK * D; i += NTHREAD) {
    const int j = i / D, c = i % D;
    const int t = k0 + j;
    k_s[i] = t < T ? to_f32(kp[t * ks.t + c]) : 0.f;
    v_s[i] = t < T ? to_f32(vp[t * vs.t + c]) : 0.f;
  }

  float dk_acc[KPW][NC], dv_acc[KPW][NC];
#pragma unroll
  for (int jj = 0; jj < KPW; ++jj)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dk_acc[jj][cc] = dv_acc[jj][cc] = 0.f;

  const int n_tiles = (T + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    // Causal tile skip: the tile's last row cannot see this K tile's
    // first key (the same test as the dQ kernel, from the other side).
    if (causal && q0 + BQ - 1 < k0 + k_shift) continue;
    __syncthreads();  // the previous tile's q_s/do_s/p_s/ds_s are no longer read
    for (int i = tid; i < BQ * D; i += NTHREAD) {
      const int r = i / D, c = i % D;
      const int t = q0 + r;
      q_s[r * QP + c] = t < T ? to_f32(qp[t * qs.t + c]) : 0.f;
      do_s[r * QP + c] = t < T ? to_f32(dop[t * dos.t + c]) : 0.f;
    }
    for (int i = tid; i < BQ; i += NTHREAD) {
      const int t = q0 + i;
      lse_s[i] = t < T ? lse[row0 + t] : 0.f;
      del_s[i] = t < T ? delta[row0 + t] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < KPW; ++jj) {
      const int j = warp * KPW + jj;
      const int k_pos = k0 + j;
#pragma unroll
      for (int ii = 0; ii < BQ / 32; ++ii) {
        const int i = lane + 32 * ii;
        const int q_pos = q0 + i;
        float sdot = 0.f, pdot = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) {
          sdot += q_s[i * QP + c] * k_s[j * D + c];
          pdot += do_s[i * QP + c] * v_s[j * D + c];
        }
        const bool visible = q_pos < T && k_pos < T &&
                             (!causal || q_pos >= k_pos + k_shift);
        const float p = visible ? expf(sdot * scale - lse_s[i]) : 0.f;
        p_s[j * BQ + i] = round_to<E>(p);
        ds_s[j * BQ + i] = round_to<E>(p * (pdot - del_s[i]));
      }
    }
    __syncwarp();  // each warp reads back only the p/ds rows it wrote

#pragma unroll
    for (int jj = 0; jj < KPW; ++jj) {
      const int j = warp * KPW + jj;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = lane + 32 * cc;
        float a = dv_acc[jj][cc];
        float g = dk_acc[jj][cc];
#pragma unroll 16
        for (int i = 0; i < BQ; ++i) {
          a += p_s[j * BQ + i] * do_s[i * QP + c];
          g += ds_s[j * BQ + i] * q_s[i * QP + c];
        }
        dv_acc[jj][cc] = a;
        dk_acc[jj][cc] = g;
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < KPW; ++jj) {
    const int t = k0 + warp * KPW + jj;
    if (t >= T) continue;
    const long long off = ((static_cast<long long>(b) * T + t) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      dk[off + lane + 32 * cc] = from_f32<E>(dk_acc[jj][cc] * scale);
      dv[off + lane + 32 * cc] = from_f32<E>(dv_acc[jj][cc]);
    }
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
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_dq_kernel<E, D><<<grid, NTHREAD, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, T, H, qs, ks, vs, dos, causal, k_shift,
      scale);
  return cudaGetLastError();
}

template <typename E, int D>
cudaError_t launch_dkdv(const E* q, const E* k, const E* v, const E* dout,
                        const float* lse, const float* delta, E* dk, E* dv,
                        int B, int T, int H, Strides qs, Strides ks,
                        Strides vs, Strides dos,
                        int causal, int k_shift, float scale,
                        cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkdv_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((T + BK - 1) / BK, B * H);
  flash_dkdv_kernel<E, D><<<grid, NTHREAD, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, T, H, qs, ks, vs, dos, causal,
      k_shift, scale);
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

template <typename E>
int dispatch_dkdv(const E* q, const E* k, const E* v, const E* dout,
                  const float* lse, const float* delta, E* dk, E* dv, int B,
                  int T, int H, int D, Strides qs, Strides ks, Strides vs,
                  Strides dos, int causal, int k_shift, float scale,
                  cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dkdv<E, 32>(q, k, v, dout, lse, delta, dk, dv, B, T, H, qs, ks, vs, dos, causal, k_shift, scale, s);
    case 64:
      return launch_dkdv<E, 64>(q, k, v, dout, lse, delta, dk, dv, B, T, H, qs, ks, vs, dos, causal, k_shift, scale, s);
    case 128:
      return launch_dkdv<E, 128>(q, k, v, dout, lse, delta, dk, dv, B, T, H, qs, ks, vs, dos, causal, k_shift, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/k/v/dO strides are (batch, time, head) in elements; the head-dim
// stride is 1. lse and delta are contiguous [B, H, T] f32; dq (dk, dv) are
// contiguous [B, T, H, D] buffers of q's dtype. The _f32 entry points take
// f32 q/k/v/dO, the _bf16 ones bf16.
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
#define DKDV_ENTRY(NAME, E)                                                    \
  int NAME(const E* q, const E* k, const E* v, const E* dout,                  \
           const float* lse, const float* delta, E* dk, E* dv, int B, int T,   \
           int H, int D, long long qsb, long long qst, long long qsh,          \
           long long ksb, long long kst, long long ksh, long long vsb,         \
           long long vst, long long vsh, long long dsb, long long dst,         \
           long long dsh, int causal, int k_shift, float scale,                \
           void* stream) {                                                     \
    return dispatch_dkdv(q, k, v, dout, lse, delta, dk, dv, B, T, H, D,       \
                         Strides{qsb, qst, qsh}, Strides{ksb, kst, ksh},       \
                         Strides{vsb, vst, vsh}, Strides{dsb, dst, dsh},       \
                         causal, k_shift, scale,                               \
                         static_cast<cudaStream_t>(stream));                   \
  }

DQ_ENTRY(flash_dq_f32, float)
DQ_ENTRY(flash_dq_bf16, __nv_bfloat16)
DKDV_ENTRY(flash_dkdv_f32, float)
DKDV_ENTRY(flash_dkdv_bf16, __nv_bfloat16)

#undef DQ_ENTRY
#undef DKDV_ENTRY

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
