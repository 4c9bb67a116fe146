// Flash-attention backward dK/dV, f32 and bf16, for Hopper (sm_90a): kernel 3
// of the port.
//
// Replaces: tpudml/ops/attention_kernel.py:217 `_dkdv_kernel` (Q innermost),
// launched by `_backward_calls` from the flash custom-vjp backward and from
// `flash_block_grads`.
//
// Computes, for q, k, v, dO [B, T, H, D] (any D from 1 to 256) and the row
// statistics lse, Δ [B, H, T] (Δ = rowsum(dO ⊙ O), taken outside the
// kernel), with s = q·kᵀ·scale masked causally (`q_pos >= k_pos + k_shift`,
// local positions) and p = exp(s − lse) on visible entries, 0 elsewhere:
//   dp = dO·Vᵀ,  ds = p ⊙ (dp − Δ),  dK = scale · dsᵀ·Q,  dV = pᵀ·dO.
// The bf16 twin rounds p to bf16 before dV = pᵀ·dO (the TPU kernel's
// `p.astype(do.dtype)`), forms ds from the unrounded p and rounds it to bf16
// before dK = scale·dsᵀ·Q (`ds.astype(q.dtype)`), and stores dK, dV in bf16.
// All sums are f32; lse and Δ are f32; the scale (1/√D of the true D, times
// log2 e for exp2f) multiplies the f32 score.
//
// What bounds it on this card: operations. Per visible (q, k) pair it does
// 4 products of D terms (q·k, dO·v, p·dO, ds·q), 8·D flops: ~18 GFLOP at the
// training shape (B=8, T=1024, H=4, D=128, causal) against ~25-50 MB of
// traffic. The bf16 twin is bound by the tensor cores' rate and by the chain
// S → P → dS between its four products; the f32 twin by the f32 FMA rate of
// the CUDA cores (no TF32: the f32 contract is rtol 1e-5).
//
// Design. One block per (b·h, 64-key tile) walks the Q tiles from the first
// one that sees its keys to the end of T (key tile 0, the longest, is
// launched first); the dK and dV tiles stay in registers. K and V stay in
// shared memory for the whole walk; the Q and dO tiles with their lse and Δ
// stream through a two-stage cp.async ring (tile i+1 loads while tile i
// computes). Only Q tiles that cross the diagonal or the end of T are masked
// elementwise. Columns past D run in the next larger instance
// (32/64/128/256), zero-filled on load and never stored; rows past T are
// zero-filled, masked (queries) and never stored (keys). At D = 256 the dK
// and dV columns are split between two blocks (neighbours on grid x), each
// recomputing Sᵀ and dPᵀ over the full D and accumulating only its 128
// columns: that keeps the accumulators at the D = 128 instance's count (the
// whole row would need 256 registers a thread in bf16, and the f32 tiles
// ~300 KB of shared memory), for twice the Sᵀ/dPᵀ work of one block. The
// f32 twin there also takes its Q/dO tiles one stage deep.
//   bf16: 4 warps, each owning 16 keys. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ run as
//   mma.sync m16n8k16 into f32 fragments, K and V read by ldmatrix from
//   swizzled shared memory at every step (not held in registers: the dK and
//   dV accumulators alone take 128 registers a thread at D = 128). Pᵀ and
//   dSᵀ are formed in registers, packed to bf16 and used directly as the A
//   fragments of dV += Pᵀ·dO and dK += dSᵀ·Q, with dO and Q read by
//   ldmatrix.trans. The Q tile is 32 rows from D = 128 and 64 below, which keeps
//   the thread under 255 registers without spills.
//   f32: 256 threads as 16×16; each thread owns 4 keys × 2 queries of Sᵀ and
//   dPᵀ (keys 4·ty.., queries tx, tx + 16) and 4 keys × D/16 columns of dK
//   and dV, reading operands as float4 from row-padded tiles; Pᵀ and dSᵀ pass
//   through shared memory within a half-warp (the 16 lanes of one key row).
// Copies are 16-byte cp.async where the base pointers and strides allow it,
// scalar loads otherwise. B·H lies on grid y and continues on grid z past
// 65535 (grid.cuh). Every output element is written by one thread after a
// fixed-order loop: no atomics, so a repeat call is bitwise equal.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "grid.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;  // keys per block

// The first Q tile of width bq that holds a query seeing key k0 (0 unless
// causal).
__device__ __forceinline__ int first_q_tile(const Args& a, int k0, int bq) {
  return a.causal ? (k0 + a.k_shift) / bq : 0;
}

// lse and Δ of bq queries from row t0 (contiguous [B, H, T] f32), zeros past T.
template <int NT>
__device__ __forceinline__ void load_stats(float* l_s, float* d_s, const float* lse,
                                           const float* delta, int t0, int bq, int T) {
  for (int i = threadIdx.x; i < bq; i += NT) {
    const bool ok = t0 + i < T;
    cp_async_4(l_s + i, ok ? lse + t0 + i : lse, ok);
    cp_async_4(d_s + i, ok ? delta + t0 + i : delta, ok);
  }
}

// ------------------------------------------------------------------ bf16

// dK/dV columns a block accumulates (all of them up to D = 128, half at
// 256) and the blocks that share a key tile.
template <int DP>
struct Split {
  static constexpr int OC = DP > 128 ? 128 : DP;
  static constexpr int N = DP / OC;
};

template <int DP>
struct Bf16Cfg {
  static constexpr int BQ = DP >= 128 ? 32 : 64;  // Q tile rows
  static constexpr size_t smem =
      sizeof(bf16) * (2 * BK * DP + 2 * 2 * BQ * DP) + sizeof(float) * 2 * 2 * BQ;
};

template <int DP>
__global__ void __launch_bounds__(128)
flash_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, Args a) {
  constexpr int BQ = Bf16Cfg<DP>::BQ;
  constexpr int NCH = DP / 8;  // 16-byte chunks a row
  constexpr int KD = DP / 16;  // k-steps of Sᵀ, dPᵀ (over D)
  constexpr int NS = BQ / 8;   // n-tiles of Sᵀ, dPᵀ (over queries)
  constexpr int KQ = BQ / 16;  // k-steps of dV, dK (over queries)
  constexpr int NSPLIT = Split<DP>::N;
  constexpr int NO = Split<DP>::OC / 8;  // n-tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [BK][DP]
  bf16* v_s = k_s + BK * DP;                      // [BK][DP]
  bf16* q_s = v_s + BK * DP;                      // [2][BQ][DP]
  bf16* do_s = q_s + 2 * BQ * DP;                 // [2][BQ][DP]
  float* l_s = reinterpret_cast<float*>(do_s + 2 * BQ * DP);  // [2][BQ]
  float* d_s = l_s + 2 * BQ;                                  // [2][BQ]

  const int bh = grid_y_index();
  if (bh >= a.BH) return;  // past B·H in the last z slice
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = (blockIdx.x / NSPLIT) * BK;
  const int col0 = (blockIdx.x % NSPLIT) * Split<DP>::OC;  // first dK/dV column
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const bool vec = a.vec;

  const bf16* qp = q + b * a.qs.b + h * a.qs.h;
  const bf16* kp = k + b * a.ks.b + h * a.ks.h;
  const bf16* vp = v + b * a.vs.b + h * a.vs.h;
  const bf16* dop = dout + b * a.dos.b + h * a.dos.h;
  const float* lp = lse + static_cast<long long>(bh) * a.T;
  const float* dp = delta + static_cast<long long>(bh) * a.T;
  const int n_qt = (a.T + BQ - 1) / BQ;
  const int qt0 = first_q_tile(a, k0, BQ);

  load_tile<DP, BK, 128>(k_s, kp, a.ks.t, k0, a.T, a.D, vec);
  load_tile<DP, BK, 128>(v_s, vp, a.vs.t, k0, a.T, a.D, vec);
  if (qt0 < n_qt) {
    load_tile<DP, BQ, 128>(q_s, qp, a.qs.t, qt0 * BQ, a.T, a.D, vec);
    load_tile<DP, BQ, 128>(do_s, dop, a.dos.t, qt0 * BQ, a.T, a.D, vec);
    load_stats<128>(l_s, d_s, lp, dp, qt0 * BQ, BQ, a.T);
  }
  cp_async_commit();

  // ldmatrix row/chunk of this lane: A (K, V rows of this warp), B (Q, dO
  // rows), B transposed (Q, dO rows as the k axis).
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, a_ch = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_ch = (lane >> 3) & 1;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_ch = lane >> 4;
  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = qt0; it < n_qt; ++it) {
    const int cur = (it - qt0) & 1, nxt = cur ^ 1;
    if (it + 1 < n_qt) {
      const int t1 = (it + 1) * BQ;
      load_tile<DP, BQ, 128>(q_s + nxt * BQ * DP, qp, a.qs.t, t1, a.T, a.D, vec);
      load_tile<DP, BQ, 128>(do_s + nxt * BQ * DP, dop, a.dos.t, t1, a.T, a.D, vec);
      load_stats<128>(l_s + nxt * BQ, d_s + nxt * BQ, lp, dp, t1, BQ, a.T);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* qt = q_s + cur * BQ * DP;
    const bf16* dt = do_s + cur * BQ * DP;
    const float* lt = l_s + cur * BQ;
    const float* dlt = d_s + cur * BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (16 keys × BQ queries a warp).
    float s[NS][4], pd[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = pd[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, k_s + swz<NCH>(a_row, 2 * kk + a_ch));
      ldmatrix_x4(va, v_s + swz<NCH>(a_row, 2 * kk + a_ch));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t qb[4], db[4];
        ldmatrix_x4(qb, qt + swz<NCH>(np * 16 + b_row, 2 * kk + b_ch));
        ldmatrix_x4(db, dt + swz<NCH>(np * 16 + b_row, 2 * kk + b_ch));
        mma_bf16(s[2 * np], ka, qb[0], qb[1]);
        mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
        mma_bf16(pd[2 * np], va, db[0], db[1]);
        mma_bf16(pd[2 * np + 1], va, db[2], db[3]);
      }
    }

    // Pᵀ (in s) and dSᵀ (in pd), unrounded f32.
    const int q0 = it * BQ;
    const bool mask = needs_mask(a, q0, BQ, k0, BK);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * c + (e & 1);
        float p = exp2f(s[n][e] * a.scale_log2 - lt[qi] * LOG2E);
        if (mask && !visible(a, q0 + qi, key0 + (e >> 1) * 8)) p = 0.f;
        s[n][e] = p;
        pd[n][e] = p * (pd[n][e] - dlt[qi]);
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q, Pᵀ and dSᵀ rounded to bf16 in registers.
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kq][0], s[2 * kq][1]),
                              pack_bf16(s[2 * kq][2], s[2 * kq][3]),
                              pack_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1]),
                              pack_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3])};
      const uint32_t sa[4] = {pack_bf16(pd[2 * kq][0], pd[2 * kq][1]),
                              pack_bf16(pd[2 * kq][2], pd[2 * kq][3]),
                              pack_bf16(pd[2 * kq + 1][0], pd[2 * kq + 1][1]),
                              pack_bf16(pd[2 * kq + 1][2], pd[2 * kq + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t db[4], qb[4];
        ldmatrix_x4_trans(db, dt + swz<NCH>(kq * 16 + t_row, col0 / 8 + 2 * np + t_ch));
        ldmatrix_x4_trans(qb, qt + swz<NCH>(kq * 16 + t_row, col0 / 8 + 2 * np + t_ch));
        mma_bf16(dv_acc[2 * np], pa, db[0], db[1]);
        mma_bf16(dv_acc[2 * np + 1], pa, db[2], db[3]);
        mma_bf16(dk_acc[2 * np], sa, qb[0], qb[1]);
        mma_bf16(dk_acc[2 * np + 1], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // stage `cur` is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = key0 + i * 8;
    if (t >= a.T) continue;
    const long long off = ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = col0 + n * 8 + 2 * c;
      const float gk0 = dk_acc[n][2 * i] * a.scale, gk1 = dk_acc[n][2 * i + 1] * a.scale;
      const float gv0 = dv_acc[n][2 * i], gv1 = dv_acc[n][2 * i + 1];
      if (col + 1 < a.D && (a.D & 1) == 0) {
        store_pair(dk + off + col, gk0, gk1);
        store_pair(dv + off + col, gv0, gv1);
      } else {
        if (col < a.D) dk[off + col] = __float2bfloat16(gk0), dv[off + col] = __float2bfloat16(gv0);
        if (col + 1 < a.D)
          dk[off + col + 1] = __float2bfloat16(gk1), dv[off + col + 1] = __float2bfloat16(gv1);
      }
    }
  }
}

// ------------------------------------------------------------------- f32

constexpr int F32_BQ = 32;  // Q tile rows

template <int DP>
struct F32Cfg {
  static constexpr int LD = DP + 4;                 // padded tile row
  static constexpr int LDP = F32_BQ + 4;            // padded Pᵀ / dSᵀ row
  static constexpr int STAGES = DP <= 128 ? 2 : 1;  // Q/dO ring depth
  static constexpr int OC = Split<DP>::OC;          // dK/dV columns a block
  static constexpr int VW = OC >= 64 ? 4 : 2;       // dK/dV column vector width
  static constexpr int NCG = OC / (16 * VW);        // column groups a thread
  static constexpr size_t smem = sizeof(float) *
      ((2 * BK + 2 * STAGES * F32_BQ) * LD + 2 * BK * LDP + 2 * STAGES * F32_BQ);
};

template <int DP>
__global__ void __launch_bounds__(256)
flash_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, Args a) {
  using C = F32Cfg<DP>;
  constexpr int BQ = F32_BQ, LD = C::LD, LDP = C::LDP, VW = C::VW, NCG = C::NCG;
  constexpr int STAGES = C::STAGES, NSPLIT = Split<DP>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // [BK][LD]
  float* v_s = k_s + BK * LD;                        // [BK][LD]
  float* q_s = v_s + BK * LD;                        // [STAGES][BQ][LD]
  float* do_s = q_s + STAGES * BQ * LD;              // [STAGES][BQ][LD]
  float* p_s = do_s + STAGES * BQ * LD;              // Pᵀ [BK][LDP]
  float* ds_s = p_s + BK * LDP;                      // dSᵀ [BK][LDP]
  float* l_s = ds_s + BK * LDP;                      // [STAGES][BQ]
  float* d_s = l_s + STAGES * BQ;                    // [STAGES][BQ]

  const int bh = grid_y_index();
  if (bh >= a.BH) return;  // past B·H in the last z slice
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = (blockIdx.x / NSPLIT) * BK;
  const int col0 = (blockIdx.x % NSPLIT) * C::OC;  // first dK/dV column
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool vec = a.vec;

  const float* qp = q + b * a.qs.b + h * a.qs.h;
  const float* kp = k + b * a.ks.b + h * a.ks.h;
  const float* vp = v + b * a.vs.b + h * a.vs.h;
  const float* dop = dout + b * a.dos.b + h * a.dos.h;
  const float* lp = lse + static_cast<long long>(bh) * a.T;
  const float* dp = delta + static_cast<long long>(bh) * a.T;
  const int n_qt = (a.T + BQ - 1) / BQ;
  const int qt0 = first_q_tile(a, k0, BQ);

  load_tile<DP, BK, 256>(k_s, kp, a.ks.t, k0, a.T, a.D, vec);
  load_tile<DP, BK, 256>(v_s, vp, a.vs.t, k0, a.T, a.D, vec);
  if (qt0 < n_qt) {
    load_tile<DP, BQ, 256>(q_s, qp, a.qs.t, qt0 * BQ, a.T, a.D, vec);
    load_tile<DP, BQ, 256>(do_s, dop, a.dos.t, qt0 * BQ, a.T, a.D, vec);
    load_stats<256>(l_s, d_s, lp, dp, qt0 * BQ, BQ, a.T);
  }
  cp_async_commit();

  // Keys 4·ty + i; Sᵀ queries tx + 16·jj; dK/dV columns 16·VW·cg + VW·tx + w.
  float dk_acc[4][NCG * VW], dv_acc[4][NCG * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NCG * VW; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.f;

  for (int it = qt0; it < n_qt; ++it) {
    const int cur = STAGES == 2 ? (it - qt0) & 1 : 0, nxt = cur ^ 1;
    if (STAGES == 2) {
      if (it + 1 < n_qt) {
        const int t1 = (it + 1) * BQ;
        load_tile<DP, BQ, 256>(q_s + nxt * BQ * LD, qp, a.qs.t, t1, a.T, a.D, vec);
        load_tile<DP, BQ, 256>(do_s + nxt * BQ * LD, dop, a.dos.t, t1, a.T, a.D, vec);
        load_stats<256>(l_s + nxt * BQ, d_s + nxt * BQ, lp, dp, t1, BQ, a.T);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* qt = q_s + cur * BQ * LD;
    const float* dt = do_s + cur * BQ * LD;
    const float* lt = l_s + cur * BQ;
    const float* dlt = d_s + cur * BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ on the 4×2 micro-tile.
    float s[4][2], pd[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = pd[i][0] = pd[i][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float kv[4][4], vv[4][4], qv[2][4], dv4[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        load_vec(kv[i], k_s + (4 * ty + i) * LD + d);
        load_vec(vv[i], v_s + (4 * ty + i) * LD + d);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        load_vec(qv[jj], qt + (tx + 16 * jj) * LD + d);
        load_vec(dv4[jj], dt + (tx + 16 * jj) * LD + d);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            s[i][jj] = fmaf(kv[i][e], qv[jj][e], s[i][jj]);
            pd[i][jj] = fmaf(vv[i][e], dv4[jj][e], pd[i][jj]);
          }
    }

    const int q0 = it * BQ;
    const bool mask = needs_mask(a, q0, BQ, k0, BK);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int qi = tx + 16 * jj;
        float p = exp2f(s[i][jj] * a.scale_log2 - lt[qi] * LOG2E);
        if (mask && !visible(a, q0 + qi, k0 + 4 * ty + i)) p = 0.f;
        p_s[(4 * ty + i) * LDP + qi] = p;
        ds_s[(4 * ty + i) * LDP + qi] = p * (pd[i][jj] - dlt[qi]);
      }
    __syncwarp();  // a key row's Pᵀ, dSᵀ are written and read by one half-warp

    // dV += Pᵀ·dO and dK += dSᵀ·Q on the 4 × D/16 micro-tile.
#pragma unroll 2
    for (int qq = 0; qq < BQ; qq += 4) {
      float pv[4][4], sv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        load_vec(pv[i], p_s + (4 * ty + i) * LDP + qq);
        load_vec(sv[i], ds_s + (4 * ty + i) * LDP + qq);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cg = 0; cg < NCG; ++cg) {
          float ov[VW], xv[VW];
          load_vec(ov, dt + (qq + e) * LD + col0 + cg * 16 * VW + tx * VW);
          load_vec(xv, qt + (qq + e) * LD + col0 + cg * 16 * VW + tx * VW);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int w = 0; w < VW; ++w) {
              dv_acc[i][cg * VW + w] = fmaf(pv[i][e], ov[w], dv_acc[i][cg * VW + w]);
              dk_acc[i][cg * VW + w] = fmaf(sv[i][e], xv[w], dk_acc[i][cg * VW + w]);
            }
        }
      }
    }
    __syncthreads();  // stage `cur`, Pᵀ and dSᵀ are refilled next iteration
    if (STAGES == 1 && it + 1 < n_qt) {
      const int t1 = (it + 1) * BQ;
      load_tile<DP, BQ, 256>(q_s, qp, a.qs.t, t1, a.T, a.D, vec);
      load_tile<DP, BQ, 256>(do_s, dop, a.dos.t, t1, a.T, a.D, vec);
      load_stats<256>(l_s, d_s, lp, dp, t1, BQ, a.T);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + 4 * ty + i;
    if (t >= a.T) continue;
    const long long off = ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg) {
      const int col = col0 + cg * 16 * VW + tx * VW;
#pragma unroll
      for (int w = 0; w < VW; ++w) {
        if (col + w < a.D) {
          dk[off + col + w] = dk_acc[i][cg * VW + w] * a.scale;
          dv[off + col + w] = dv_acc[i][cg * VW + w];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename E, int DP>
cudaError_t launch(const E* q, const E* k, const E* v, const E* dout, const float* lse,
                   const float* delta, E* dk, E* dv, int B, const Args& a,
                   cudaStream_t stream) {
  const dim3 grid = grid_xyz((a.T + BK - 1) / BK * Split<DP>::N,
                             static_cast<long long>(B) * a.H);
  if constexpr (sizeof(E) == 2) {
    constexpr size_t smem = Bf16Cfg<DP>::smem;
    cudaError_t err = set_smem_once<flash_dkdv_bf16_kernel<DP>>(static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_dkdv_bf16_kernel<DP><<<grid, 128, smem, stream>>>(q, k, v, dout, lse, delta,
                                                            dk, dv, a);
  } else {
    constexpr size_t smem = F32Cfg<DP>::smem;
    cudaError_t err = set_smem_once<flash_dkdv_f32_kernel<DP>>(static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_dkdv_f32_kernel<DP><<<grid, 256, smem, stream>>>(q, k, v, dout, lse, delta,
                                                           dk, dv, a);
  }
  return cudaGetLastError();
}

template <typename E>
int dispatch(const E* q, const E* k, const E* v, const E* dout, const float* lse,
             const float* delta, E* dk, E* dv, int B, int T, int H, int D,
             Strides qs, Strides ks, Strides vs, Strides dos, int causal,
             int k_shift, float scale, cudaStream_t s) {
  const bool vec = vec_ok<E>(D, {q, k, v, dout}, {qs, ks, vs, dos});
  const Args a{B * H, T, H, D, causal, k_shift, vec ? 1 : 0, scale, scale * LOG2E,
               qs, ks, vs, dos};
  return by_head_dim<256>(D, [&](auto dp) {
    return launch<E, decltype(dp)::value>(q, k, v, dout, lse, delta, dk, dv, B, a, s);
  });
}

}  // namespace

extern "C" {

// q/k/v/dO strides are (batch, time, head) in elements; the head-dim stride
// is 1. lse and delta are contiguous [B, H, T] f32; dk, dv are contiguous
// [B, T, H, D] buffers of q's dtype; scale is 1/√D.
#define DKDV_ENTRY(NAME, E)                                                    \
  int NAME(const E* q, const E* k, const E* v, const E* dout,                  \
           const float* lse, const float* delta, E* dk, E* dv, int B, int T,   \
           int H, int D, long long qsb, long long qst, long long qsh,          \
           long long ksb, long long kst, long long ksh, long long vsb,         \
           long long vst, long long vsh, long long dsb, long long dst,         \
           long long dsh, int causal, int k_shift, float scale,                \
           void* stream) {                                                     \
    return dispatch(q, k, v, dout, lse, delta, dk, dv, B, T, H, D,            \
                    Strides{qsb, qst, qsh}, Strides{ksb, kst, ksh},            \
                    Strides{vsb, vst, vsh}, Strides{dsb, dst, dsh}, causal,    \
                    k_shift, scale, static_cast<cudaStream_t>(stream));        \
  }

DKDV_ENTRY(flash_dkdv_f32, float)
DKDV_ENTRY(flash_dkdv_bf16, __nv_bfloat16)

#undef DKDV_ENTRY

const char* flash_dkdv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
