// Flash-attention backward dQ, f32 and bf16, for Hopper (sm_90a): kernel 2
// of the port. (Kernel 3, dK/dV, is flash_dkdv.cu.)
//
// Replaces: tpudml/ops/attention_kernel.py:177 `_dq_kernel` (K innermost),
// launched by `_backward_calls` from the flash custom-vjp backward and from
// `flash_block_grads`.
//
// Computes, for q, k, v, dO [B, T, H, D] (any D from 1 to 256) and the row
// statistics lse, Δ [B, H, T] (Δ = rowsum(dO ⊙ O), taken outside the
// kernel), with s = q·kᵀ·scale masked causally (`q_pos >= k_pos +
// k_shift`, local positions) and p = exp(s − lse) on visible entries, 0
// elsewhere whatever the lse:
//   dp = dO·Vᵀ,  ds = p ⊙ (dp − Δ),  dQ = scale · ds·K.
// The bf16 twin forms ds from the unrounded f32 p, rounds it to bf16 before
// the product it feeds (the TPU kernel's `ds.astype(k.dtype)`) and stores
// dQ in bf16. All sums are f32; lse and Δ are f32; the scale (1/√D of the
// true D, times log2 e for exp2f) multiplies the f32 score.
//
// What bounds it on this card: operations. Per visible (q, k) pair dQ does
// 3 products of D terms (q·k, dO·v, ds·k), 6·D flops: ~13 GFLOP at the
// training shape (B=8, T=1024, H=4, D=128, causal) against ~20-40 MB of
// traffic, far above the card's balance point in either dtype. The bf16
// twin is bound by the tensor cores' rate and by the chain S, dP → dS → dQ
// between its products; the f32 twin by the f32 FMA rate of the CUDA cores
// (no TF32: the f32 contract is rtol 1e-5). The design before this one fed
// every FMA from two shared-memory loads, widened bf16 to f32 (the tensor
// cores idle) and ran 6-8 TFLOP/s in both dtypes.
//
// Design. The TPU's sequential K-tile grid axis becomes a loop inside one
// block per (b·h, 64-row Q tile), as in the forward (flash_fwd.cu): Q tiles
// run in reverse order on grid x, so the causal triangle's longest blocks
// start first; K tiles wholly past the diagonal end the loop, and only
// tiles that cross the diagonal or the end of T are masked elementwise. Q,
// dO and the rows' lse and Δ stay for the whole walk; K and V tiles stream
// through a two-stage cp.async ring (tile j+1 loads while tile j computes);
// the dQ tile accumulates in registers and is written once, after a
// fixed-order loop: no atomics, so a repeat call is bitwise equal. Columns
// past D run in the next larger instance (32/64/128/256), zero-filled on
// load and never stored; rows past T are zero-filled, masked and never
// stored. A Q tile whose rows see no key (k_shift > 0) stores zeros.
//   bf16: 4 warps, each owning 16 query rows. S = Q·Kᵀ and dP = dO·Vᵀ run
//   as mma.sync m16n8k16 into f32 fragments, the Q and dO A fragments read
//   by ldmatrix from swizzled shared memory at each k-step (not held in
//   registers: the dQ accumulators take D/2 registers a thread). P and dS
//   are formed in registers; dS is packed to bf16 and is directly the A
//   fragment of dQ += dS·K, with K read by ldmatrix.trans. The K tile is 64
//   keys, 32 at D = 256, where the accumulators alone take 128 registers.
//   f32: 256 threads as 16×16; each thread owns 4 rows × BK/16 keys of S and
//   dP (rows 4·ty.., keys tx + 16·j) and a 4 × D/16 micro-tile of dQ,
//   reading its operands as float4 from row-padded tiles (conflict-free), so
//   each value loaded feeds 4 FMAs. dS passes through shared memory within a
//   half-warp (the 16 lanes of one row). At D = 256 the K tile is 32 keys
//   and the K/V ring one stage deep, which keeps Q, dO, K and V in 227 KB.
// Copies are 16-byte cp.async where the base pointers and the (batch, time,
// head) strides allow it, and scalar loads into the same tiles otherwise.
// B·H lies on grid y and continues on grid z past 65535 (grid.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "grid.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per block, both twins

// lse and Δ of this thread's query rows t (zeros past T), kept in registers
// for the whole walk.
__device__ __forceinline__ void row_stats(const Args& a, const float* lp, const float* dp,
                                          int t, float& l, float& dl) {
  l = t < a.T ? lp[t] : 0.f;
  dl = t < a.T ? dp[t] : 0.f;
}

// ------------------------------------------------------------------ bf16

template <int DP>
struct Bf16Cfg {
  static constexpr int BK = DP == 256 ? 32 : 64;  // keys per K tile
  static constexpr size_t smem = sizeof(bf16) * (2 * BQ * DP + 2 * 2 * BK * DP);
};

template <int DP>
__global__ void __launch_bounds__(128)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, Args a) {
  constexpr int BK = Bf16Cfg<DP>::BK;
  constexpr int NCH = DP / 8;  // 16-byte chunks a row
  constexpr int KD = DP / 16;  // k-steps of S, dP (over D)
  constexpr int NS = BK / 8;   // n-tiles of S, dP (over keys)
  constexpr int KK = BK / 16;  // k-steps of dQ (over keys)
  constexpr int NO = DP / 8;   // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BQ][DP]
  bf16* do_s = q_s + BQ * DP;                     // [BQ][DP]
  bf16* k_s = do_s + BQ * DP;                     // [2][BK][DP]
  bf16* v_s = k_s + 2 * BK * DP;                  // [2][BK][DP]

  const int bh = grid_y_index();
  if (bh >= a.BH) return;  // past B·H in the last z slice
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest Q tiles first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const bool vec = a.vec;

  const bf16* qp = q + b * a.qs.b + h * a.qs.h;
  const bf16* kp = k + b * a.ks.b + h * a.ks.h;
  const bf16* vp = v + b * a.vs.b + h * a.vs.h;
  const bf16* dop = dout + b * a.dos.b + h * a.dos.h;
  const float* lp = lse + static_cast<long long>(bh) * a.T;
  const float* dp = delta + static_cast<long long>(bh) * a.T;
  const int n_kt = visited_k_tiles(a, q0, BQ, BK);

  load_tile<DP, BQ, 128>(q_s, qp, a.qs.t, q0, a.T, a.D, vec);
  load_tile<DP, BQ, 128>(do_s, dop, a.dos.t, q0, a.T, a.D, vec);
  if (n_kt > 0) {
    load_tile<DP, BK, 128>(k_s, kp, a.ks.t, 0, a.T, a.D, vec);
    load_tile<DP, BK, 128>(v_s, vp, a.vs.t, 0, a.T, a.D, vec);
  }
  cp_async_commit();

  // ldmatrix row/chunk of this lane: A (Q, dO rows of this warp), B (K, V
  // rows), B transposed (K rows as the k axis).
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, a_ch = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_ch = (lane >> 3) & 1;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_ch = lane >> 4;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float l2[2], dl[2];  // lse·log2 e and Δ of the two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_stats(a, lp, dp, row0 + 8 * i, l2[i], dl[i]);
    l2[i] *= LOG2E;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_kt) {
      load_tile<DP, BK, 128>(k_s + (cur ^ 1) * BK * DP, kp, a.ks.t, (j + 1) * BK, a.T, a.D, vec);
      load_tile<DP, BK, 128>(v_s + (cur ^ 1) * BK * DP, vp, a.vs.t, (j + 1) * BK, a.T, a.D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ (16 rows × BK keys a warp).
    const bf16* kt = k_s + cur * BK * DP;
    const bf16* vt = v_s + cur * BK * DP;
    float s[NS][4], pd[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = pd[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, q_s + swz<NCH>(a_row, 2 * kk + a_ch));
      ldmatrix_x4(da, do_s + swz<NCH>(a_row, 2 * kk + a_ch));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, kt + swz<NCH>(np * 16 + b_row, 2 * kk + b_ch));
        ldmatrix_x4(vb, vt + swz<NCH>(np * 16 + b_row, 2 * kk + b_ch));
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        mma_bf16(pd[2 * np], da, vb[0], vb[1]);
        mma_bf16(pd[2 * np + 1], da, vb[2], vb[3]);
      }
    }

    // dS = P ⊙ (dP − Δ) in pd, from the unrounded f32 P.
    const int k0 = j * BK;
    const bool mask = needs_mask(a, q0, BQ, k0, BK);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(s[n][e] * a.scale_log2 - l2[i]);
        if (mask && !visible(a, row0 + 8 * i, k0 + n * 8 + 2 * c + (e & 1))) p = 0.f;
        pd[n][e] = p * (pd[n][e] - dl[i]);
      }

    // dQ += dS·K, dS rounded to bf16 in registers as the A fragment.
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t sa[4] = {pack_bf16(pd[2 * kk][0], pd[2 * kk][1]),
                              pack_bf16(pd[2 * kk][2], pd[2 * kk][3]),
                              pack_bf16(pd[2 * kk + 1][0], pd[2 * kk + 1][1]),
                              pack_bf16(pd[2 * kk + 1][2], pd[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, kt + swz<NCH>(kk * 16 + t_row, 2 * np + t_ch));
        mma_bf16(acc[2 * np], sa, kb[0], kb[1]);
        mma_bf16(acc[2 * np + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // tile `cur` is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + i * 8;
    if (t >= a.T) continue;
    bf16* row = dq + ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * c;
      const float x = acc[n][2 * i] * a.scale, y = acc[n][2 * i + 1] * a.scale;
      if (col + 1 < a.D && (a.D & 1) == 0) {
        store_pair(row + col, x, y);
      } else {
        if (col < a.D) row[col] = __float2bfloat16(x);
        if (col + 1 < a.D) row[col + 1] = __float2bfloat16(y);
      }
    }
  }
}

// ------------------------------------------------------------------- f32

template <int DP>
struct F32Cfg {
  static constexpr int BK = DP == 256 ? 32 : 64;    // keys per K tile
  static constexpr int NJ = BK / 16;                // S, dP keys a thread
  static constexpr int STAGES = DP == 256 ? 1 : 2;  // K/V ring depth
  static constexpr int LD = DP + 4;                 // padded tile row
  static constexpr int LDP = BK + 4;                // padded dS row
  static constexpr int VW = DP >= 64 ? 4 : 2;       // dQ column vector width
  static constexpr int NCG = DP / (16 * VW);        // dQ column groups a thread
  static constexpr size_t smem =
      sizeof(float) * ((2 * BQ + 2 * STAGES * BK) * LD + BQ * LDP);
};

template <int DP>
__global__ void __launch_bounds__(256)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, Args a) {
  using C = F32Cfg<DP>;
  constexpr int BK = C::BK, NJ = C::NJ, STAGES = C::STAGES, LD = C::LD, LDP = C::LDP;
  constexpr int VW = C::VW, NCG = C::NCG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [BQ][LD]
  float* do_s = q_s + BQ * LD;                       // [BQ][LD]
  float* k_s = do_s + BQ * LD;                       // [STAGES][BK][LD]
  float* v_s = k_s + STAGES * BK * LD;               // [STAGES][BK][LD]
  float* ds_s = v_s + STAGES * BK * LD;              // [BQ][LDP]

  const int bh = grid_y_index();
  if (bh >= a.BH) return;  // past B·H in the last z slice
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest Q tiles first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool vec = a.vec;

  const float* qp = q + b * a.qs.b + h * a.qs.h;
  const float* kp = k + b * a.ks.b + h * a.ks.h;
  const float* vp = v + b * a.vs.b + h * a.vs.h;
  const float* dop = dout + b * a.dos.b + h * a.dos.h;
  const float* lp = lse + static_cast<long long>(bh) * a.T;
  const float* dp = delta + static_cast<long long>(bh) * a.T;
  const int n_kt = visited_k_tiles(a, q0, BQ, BK);

  load_tile<DP, BQ, 256>(q_s, qp, a.qs.t, q0, a.T, a.D, vec);
  load_tile<DP, BQ, 256>(do_s, dop, a.dos.t, q0, a.T, a.D, vec);
  if (n_kt > 0) {
    load_tile<DP, BK, 256>(k_s, kp, a.ks.t, 0, a.T, a.D, vec);
    load_tile<DP, BK, 256>(v_s, vp, a.vs.t, 0, a.T, a.D, vec);
  }
  cp_async_commit();

  // Rows 4·ty + i; S, dP keys tx + 16·jj; dQ columns 16·VW·cg + VW·tx + w.
  float l2[4], dl[4];  // lse·log2 e and Δ of the four rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_stats(a, lp, dp, q0 + 4 * ty + i, l2[i], dl[i]);
    l2[i] *= LOG2E;
  }
  float acc[4][NCG * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NCG * VW; ++n) acc[i][n] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int cur = STAGES == 2 ? (j & 1) : 0;
    if (STAGES == 2) {
      if (j + 1 < n_kt) {
        load_tile<DP, BK, 256>(k_s + (cur ^ 1) * BK * LD, kp, a.ks.t, (j + 1) * BK, a.T, a.D, vec);
        load_tile<DP, BK, 256>(v_s + (cur ^ 1) * BK * LD, vp, a.vs.t, (j + 1) * BK, a.T, a.D, vec);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ on the 4 × NJ micro-tile.
    const float* kt = k_s + cur * BK * LD;
    const float* vt = v_s + cur * BK * LD;
    float s[4][NJ], pd[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) s[i][jj] = pd[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float xv[4][4], yv[NJ][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec(xv[i], q_s + (4 * ty + i) * LD + d);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) load_vec(yv[jj], kt + (tx + 16 * jj) * LD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) s[i][jj] = fmaf(xv[i][e], yv[jj][e], s[i][jj]);
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec(xv[i], do_s + (4 * ty + i) * LD + d);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) load_vec(yv[jj], vt + (tx + 16 * jj) * LD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) pd[i][jj] = fmaf(xv[i][e], yv[jj][e], pd[i][jj]);
    }

    // dS = P ⊙ (dP − Δ) into shared memory.
    const int k0 = j * BK;
    const bool mask = needs_mask(a, q0, BQ, k0, BK);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        float p = exp2f(s[i][jj] * a.scale_log2 - l2[i]);
        if (mask && !visible(a, q0 + 4 * ty + i, k0 + tx + 16 * jj)) p = 0.f;
        ds_s[(4 * ty + i) * LDP + tx + 16 * jj] = p * (pd[i][jj] - dl[i]);
      }
    __syncwarp();  // a row's dS is written and read by the 16 lanes of one half-warp

    // dQ += dS·K on the 4 × D/16 micro-tile.
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float sv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec(sv[i], ds_s + (4 * ty + i) * LDP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cg = 0; cg < NCG; ++cg) {
          float kv[VW];
          load_vec(kv, kt + (kk + e) * LD + cg * 16 * VW + tx * VW);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[i][cg * VW + w] = fmaf(sv[i][e], kv[w], acc[i][cg * VW + w]);
        }
      }
    }
    __syncthreads();  // tile `cur` and dS are refilled next iteration
    if (STAGES == 1 && j + 1 < n_kt) {
      load_tile<DP, BK, 256>(k_s, kp, a.ks.t, (j + 1) * BK, a.T, a.D, vec);
      load_tile<DP, BK, 256>(v_s, vp, a.vs.t, (j + 1) * BK, a.T, a.D, vec);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= a.T) continue;
    float* row = dq + ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg) {
      const int col = cg * 16 * VW + tx * VW;
      float x[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) x[w] = acc[i][cg * VW + w] * a.scale;
      if (col + VW <= a.D && a.D % VW == 0) {
        if constexpr (VW == 4)
          *reinterpret_cast<float4*>(row + col) = make_float4(x[0], x[1], x[2], x[3]);
        else
          *reinterpret_cast<float2*>(row + col) = make_float2(x[0], x[1]);
      } else {
#pragma unroll
        for (int w = 0; w < VW; ++w)
          if (col + w < a.D) row[col + w] = x[w];
      }
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename E, int DP>
cudaError_t launch(const E* q, const E* k, const E* v, const E* dout, const float* lse,
                   const float* delta, E* dq, int B, const Args& a, cudaStream_t stream) {
  const dim3 grid = grid_xyz((a.T + BQ - 1) / BQ, static_cast<long long>(B) * a.H);
  if constexpr (sizeof(E) == 2) {
    constexpr size_t smem = Bf16Cfg<DP>::smem;
    cudaError_t err = set_smem_once<flash_dq_bf16_kernel<DP>>(static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_dq_bf16_kernel<DP><<<grid, 128, smem, stream>>>(q, k, v, dout, lse, delta, dq, a);
  } else {
    constexpr size_t smem = F32Cfg<DP>::smem;
    cudaError_t err = set_smem_once<flash_dq_f32_kernel<DP>>(static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_dq_f32_kernel<DP><<<grid, 256, smem, stream>>>(q, k, v, dout, lse, delta, dq, a);
  }
  return cudaGetLastError();
}

template <typename E>
int dispatch(const E* q, const E* k, const E* v, const E* dout, const float* lse,
             const float* delta, E* dq, int B, int T, int H, int D, Strides qs,
             Strides ks, Strides vs, Strides dos, int causal, int k_shift, float scale,
             cudaStream_t s) {
  const bool vec = vec_ok<E>(D, {q, k, v, dout}, {qs, ks, vs, dos});
  const Args a{B * H, T, H, D, causal, k_shift, vec ? 1 : 0, scale, scale * LOG2E,
               qs, ks, vs, dos};
  return by_head_dim<256>(D, [&](auto dp) {
    return launch<E, decltype(dp)::value>(q, k, v, dout, lse, delta, dq, B, a, s);
  });
}

}  // namespace

extern "C" {

// q/k/v/dO strides are (batch, time, head) in elements; the head-dim
// stride is 1. lse and delta are contiguous [B, H, T] f32; dq is a
// contiguous [B, T, H, D] buffer of q's dtype; scale is 1/√D. The _f32
// entry point takes f32 q/k/v/dO, the _bf16 one bf16.
#define DQ_ENTRY(NAME, E)                                                      \
  int NAME(const E* q, const E* k, const E* v, const E* dout,                  \
           const float* lse, const float* delta, E* dq, int B, int T, int H,   \
           int D, long long qsb, long long qst, long long qsh, long long ksb,  \
           long long kst, long long ksh, long long vsb, long long vst,         \
           long long vsh, long long dsb, long long dst, long long dsh,         \
           int causal, int k_shift, float scale, void* stream) {               \
    return dispatch(q, k, v, dout, lse, delta, dq, B, T, H, D,                \
                    Strides{qsb, qst, qsh}, Strides{ksb, kst, ksh},            \
                    Strides{vsb, vst, vsh}, Strides{dsb, dst, dsh}, causal,    \
                    k_shift, scale, static_cast<cudaStream_t>(stream));        \
  }
DQ_ENTRY(flash_dq_f32, float)
DQ_ENTRY(flash_dq_bf16, __nv_bfloat16)

#undef DQ_ENTRY

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
