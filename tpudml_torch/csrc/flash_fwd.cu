// Flash-attention forward with the row log-sum-exp, f32 and bf16, for Hopper
// (sm_90a): kernel 1 of the port.
//
// Replaces: tpudml/ops/attention_kernel.py:93 `_fwd_kernel` (launched by
// `_flash_forward`, reached through `flash_forward_lse`), the TPU kernel the
// chunked-prefill window attention (`_chunk_flash_window`) and the training
// forward run per block.
//
// Computes, for q, k, v [B, T, H, D] (same T, any D from 1 to 256),
// out = softmax(q·kᵀ·scale)·v and lse = log Σ exp(q·kᵀ·scale) per (b, h,
// query row), with an optional causal mask `q_pos >= k_pos + k_shift` on
// local positions. A row that sees no key at all (possible only with
// k_shift > 0) gets out = 0 and lse = -1e30, so it carries zero weight in
// any log-sum-exp merge. The bf16 twin rounds each tile's probabilities to
// bf16 before the P·V product (the TPU kernel's `p.astype(v.dtype)`; the
// normalizer sums the unrounded p) and stores out in bf16. Sums, lse and the
// softmax state are f32 in both twins; the scale (1/√D of the true D, times
// log2 e so that exp2f serves) multiplies the f32 score.
//
// What bounds it on this card: operations. At the training shape (B=8,
// T=1024, H=4, D=128, causal) the kernel does 4·D flops per visible (q, k)
// pair, ~9 GFLOP, against ~17 MB (bf16) to 34 MB (f32) of traffic: 500+
// flops a byte, above the card's balance point in either dtype. The bf16
// twin is bound by the tensor cores' rate and by the serial softmax chain
// between its two products; the f32 twin by the CUDA cores' f32 FMA rate
// (no tensor cores: the f32 contract with the reference is rtol 1e-5, which
// TF32 cannot hold).
//
// Design. The TPU kernel's sequential K-tile grid axis becomes a loop inside
// one block per (b·h, Q tile: 128 rows in bf16, 64 in f32); the running max
// m, normalizer l and the output tile stay in registers. Q tiles run in reverse order on grid x, so
// the causal triangle's longest blocks start first; K tiles wholly past the
// diagonal end the loop, and only tiles that cross the diagonal or the end of
// T are masked elementwise. K/V tiles are double-buffered: tile j+1 is copied
// with cp.async while tile j computes. Columns past D (a D between two
// instances runs the next larger one, 32/64/128/256) are zero-filled on load
// and never stored; rows past T are zero-filled and never stored.
//   bf16: 8 warps (a 128-row Q tile), each owning 16 query rows. S = Q·Kᵀ and O += P·V run as
//   mma.sync m16n8k16 (f32 sums) on operands read by ldmatrix (V
//   transposed) from XOR-swizzled tiles (mma.cuh). The softmax is reduced
//   across the 4 lanes that share a row; P is packed to bf16 in registers and
//   is directly the A fragment of P·V, so it never touches shared memory.
//   Q fragments stay in registers up to D = 128.
//   f32: 256 threads as 16×16; each thread owns a 4×4 micro-tile of S (rows
//   4·ty.., keys tx + 16·j) and a 4 × D/16 micro-tile of O, reading its
//   operands as float4 from row-padded tiles (conflict-free), so each value
//   loaded feeds 4 FMAs. Row reductions run over the 16 lanes of a row; P
//   passes through shared memory within a half-warp.
// Copies are 16-byte cp.async where the base pointers and the (batch, time,
// head) strides allow it, and scalar loads into the same tiles otherwise.
// B·H lies on grid y and continues on grid z past 65535 (grid.cuh). Every
// output element is written by one thread after a fixed-order loop: a repeat
// call is bitwise equal.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "grid.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NWARP_BF16 = 8;  // bf16 warps, 16 query rows each (8 timed faster than 4)
constexpr int BQ_BF16 = 16 * NWARP_BF16;  // query rows per bf16 block
constexpr int BQ = 64;  // query rows per f32 block
constexpr int BK = 64;  // keys per K tile
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// max(a, b) that keeps NaN, as the TPU kernel's jnp.maximum does (fmaxf
// returns the other operand): a NaN score makes the row's max, and so its
// p, l and O, NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Whether a row saw a key: its normalizer is not 0. A NaN normalizer counts
// as seen, so the row stores NaN rather than the no-key row's 0 and -1e30.
__device__ __forceinline__ bool saw_a_key(float l) { return !(l == 0.f); }

// ------------------------------------------------------------------ bf16

template <int DP>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * (BQ_BF16 * DP + 2 * 2 * BK * DP);  // Q; K, V × 2 stages
}

template <int DP>
__global__ void __launch_bounds__(NWARP_BF16 * 32)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, Args a) {
  constexpr int NCH = DP / 8;       // 16-byte chunks a row
  constexpr int KD = DP / 16;       // k-steps of S = Q·Kᵀ
  constexpr int NS = BK / 8;        // n-tiles of S
  constexpr int NO = DP / 8;        // n-tiles of O
  constexpr bool Q_REGS = DP <= 128;
  constexpr int BQ = BQ_BF16, NT = NWARP_BF16 * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BQ][DP]
  bf16* k_s = q_s + BQ * DP;                      // [2][BK][DP]
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
  const int n_kt = visited_k_tiles(a, q0, BQ, BK);

  load_tile<DP, BQ, NT>(q_s, qp, a.qs.t, q0, a.T, a.D, vec);
  if (n_kt > 0) {
    load_tile<DP, BK, NT>(k_s, kp, a.ks.t, 0, a.T, a.D, vec);
    load_tile<DP, BK, NT>(v_s, vp, a.vs.t, 0, a.T, a.D, vec);
  }
  cp_async_commit();

  // ldmatrix row/chunk of this lane: A (Q rows), B (K rows), B transposed (V rows).
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, a_ch = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_ch = (lane >> 3) & 1;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_ch = lane >> 4;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  uint32_t qf[Q_REGS ? KD : 1][4];

  for (int j = 0; j < n_kt; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_kt) {
      load_tile<DP, BK, NT>(k_s + (cur ^ 1) * BK * DP, kp, a.ks.t, (j + 1) * BK, a.T, a.D, vec);
      load_tile<DP, BK, NT>(v_s + (cur ^ 1) * BK * DP, vp, a.vs.t, (j + 1) * BK, a.T, a.D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (Q_REGS && j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[Q_REGS ? kk : 0], q_s + swz<NCH>(a_row, 2 * kk + a_ch));
    }

    // S = Q·Kᵀ
    const bf16* kt = k_s + cur * BK * DP;
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t af[4];
      if (Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[Q_REGS ? kk : 0][e];
      } else {
        ldmatrix_x4(af, q_s + swz<NCH>(a_row, 2 * kk + a_ch));
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, kt + swz<NCH>(np * 16 + b_row, 2 * kk + b_ch));
        mma_bf16(s[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }

    // Scale, mask, online softmax (rows row0 and row0 + 8).
    const int k0 = j * BK;
    const bool mask = needs_mask(a, q0, BQ, k0, BK);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale_log2;
        if (mask && !visible(a, row0 + (e >> 1) * 8, k0 + n * 8 + 2 * c + (e & 1)))
          x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = max_nan(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = max_nan(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = max_nan(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = max_nan(m[i], mx[i]);
      // m_new == -inf: nothing visible yet in this row; keep the zero state.
      alpha[i] = m_new == -INFINITY ? 1.f : exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] == -INFINITY ? 0.f : exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P·V, P rounded to bf16 in registers as the A fragment.
    const bf16* vt = v_s + cur * BK * DP;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, vt + swz<NCH>(kk * 16 + v_row, 2 * np + v_ch));
        mma_bf16(acc[2 * np], pf, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], pf, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // tile `cur` is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = row0 + i * 8;
    if (t >= a.T) continue;
    const bool seen = saw_a_key(l[i]);
    bf16* orow = o + ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * c;
      const float x = seen ? acc[n][2 * i] / l[i] : 0.f;
      const float y = seen ? acc[n][2 * i + 1] / l[i] : 0.f;
      if (col + 1 < a.D && (a.D & 1) == 0) {
        store_pair(orow + col, x, y);
      } else {
        if (col < a.D) orow[col] = __float2bfloat16(x);
        if (col + 1 < a.D) orow[col + 1] = __float2bfloat16(y);
      }
    }
    if (c == 0)
      lse[(static_cast<long long>(b) * a.H + h) * a.T + t] =
          seen ? m[i] * LN2 + logf(l[i]) : NEG_INF;
  }
}

// ------------------------------------------------------------------- f32

template <int DP>
struct F32Cfg {
  static constexpr int LD = DP + 4;                  // padded tile row
  static constexpr int LDP = BK + 4;                 // padded P row
  static constexpr int STAGES = DP <= 128 ? 2 : 1;   // K/V ring depth
  static constexpr int VW = DP >= 64 ? 4 : 2;        // O column vector width
  static constexpr int NCG = DP / (16 * VW);         // O column groups a thread
  static constexpr int NC = NCG * VW;                // O columns a thread
  static constexpr size_t smem =
      sizeof(float) * ((BQ + 2 * STAGES * BK) * LD + BQ * LDP);
};

template <int DP>
__global__ void __launch_bounds__(256)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Args a) {
  using C = F32Cfg<DP>;
  constexpr int LD = C::LD, LDP = C::LDP, STAGES = C::STAGES, VW = C::VW, NCG = C::NCG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [BQ][LD]
  float* k_s = q_s + BQ * LD;                        // [STAGES][BK][LD]
  float* v_s = k_s + STAGES * BK * LD;               // [STAGES][BK][LD]
  float* p_s = v_s + STAGES * BK * LD;               // [BQ][LDP]

  const int bh = grid_y_index();
  if (bh >= a.BH) return;  // past B·H in the last z slice
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest Q tiles first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool vec = a.vec;

  const float* qp = q + b * a.qs.b + h * a.qs.h;
  const float* kp = k + b * a.ks.b + h * a.ks.h;
  const float* vp = v + b * a.vs.b + h * a.vs.h;
  const int n_kt = visited_k_tiles(a, q0, BQ, BK);

  load_tile<DP, BQ, 256>(q_s, qp, a.qs.t, q0, a.T, a.D, vec);
  if (n_kt > 0) {
    load_tile<DP, BK, 256>(k_s, kp, a.ks.t, 0, a.T, a.D, vec);
    load_tile<DP, BK, 256>(v_s, vp, a.vs.t, 0, a.T, a.D, vec);
  }
  cp_async_commit();

  // Rows 4·ty + i; S keys tx + 16·jj; O columns 16·VW·cg + VW·tx + w.
  float acc[4][NCG * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NCG * VW; ++n) acc[i][n] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

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

    // S = Q·Kᵀ on the 4×4 micro-tile.
    const float* kt = k_s + cur * BK * LD;
    const float* vt = v_s + cur * BK * LD;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float qv[4][4], kv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec(qv[i], q_s + (4 * ty + i) * LD + d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) load_vec(kv[jj], kt + (tx + 16 * jj) * LD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i][e], kv[jj][e], s[i][jj]);
    }

    const int k0 = j * BK;
    const bool mask = needs_mask(a, q0, BQ, k0, BK);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = s[i][jj] * a.scale_log2;
        if (mask && !visible(a, row, k0 + tx + 16 * jj)) x = -INFINITY;
        s[i][jj] = x;
        mx = max_nan(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = max_nan(m[i], mx);
      const float alpha = m_new == -INFINITY ? 1.f : exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < NCG * VW; ++n) acc[i][n] *= alpha;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = s[i][jj] == -INFINITY ? 0.f : exp2f(s[i][jj] - m_new);
        l[i] += p;
        p_s[(4 * ty + i) * LDP + tx + 16 * jj] = p;
      }
    }
    __syncwarp();  // a row's P is written and read by the 16 lanes of one half-warp

    // O += P·V on the 4 × NC micro-tile.
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec(pv[i], p_s + (4 * ty + i) * LDP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cg = 0; cg < NCG; ++cg) {
          float vv[VW];
          load_vec(vv, vt + (kk + e) * LD + cg * 16 * VW + tx * VW);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[i][cg * VW + w] = fmaf(pv[i][e], vv[w], acc[i][cg * VW + w]);
        }
      }
    }
    __syncthreads();  // tile `cur` and P are refilled next iteration
    if (STAGES == 1 && j + 1 < n_kt) {
      load_tile<DP, BK, 256>(k_s, kp, a.ks.t, (j + 1) * BK, a.T, a.D, vec);
      load_tile<DP, BK, 256>(v_s, vp, a.vs.t, (j + 1) * BK, a.T, a.D, vec);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int t = q0 + 4 * ty + i;
    if (t >= a.T) continue;
    const bool seen = saw_a_key(l[i]);
    float* orow = o + ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg) {
      const int col = cg * 16 * VW + tx * VW;
      float x[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) x[w] = seen ? acc[i][cg * VW + w] / l[i] : 0.f;
      if (col + VW <= a.D && a.D % VW == 0) {
        if constexpr (VW == 4)
          *reinterpret_cast<float4*>(orow + col) = make_float4(x[0], x[1], x[2], x[3]);
        else
          *reinterpret_cast<float2*>(orow + col) = make_float2(x[0], x[1]);
      } else {
#pragma unroll
        for (int w = 0; w < VW; ++w)
          if (col + w < a.D) orow[col + w] = x[w];
      }
    }
    if (tx == 0)
      lse[(static_cast<long long>(b) * a.H + h) * a.T + t] =
          seen ? m[i] * LN2 + logf(l[i]) : NEG_INF;
  }
}

// ---------------------------------------------------------------- launch

template <typename E, int DP>
cudaError_t launch(const E* q, const E* k, const E* v, E* o, float* lse, int B,
                   const Args& a, cudaStream_t stream) {
  const int bq = sizeof(E) == 2 ? BQ_BF16 : BQ;
  const dim3 grid = grid_xyz((a.T + bq - 1) / bq, static_cast<long long>(B) * a.H);
  if constexpr (sizeof(E) == 2) {
    constexpr size_t smem = bf16_smem_bytes<DP>();
    cudaError_t err = set_smem_once<flash_fwd_bf16_kernel<DP>>(static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<DP><<<grid, NWARP_BF16 * 32, smem, stream>>>(q, k, v, o, lse, a);
  } else {
    constexpr size_t smem = F32Cfg<DP>::smem;
    cudaError_t err = set_smem_once<flash_fwd_f32_kernel<DP>>(static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_fwd_f32_kernel<DP><<<grid, 256, smem, stream>>>(q, k, v, o, lse, a);
  }
  return cudaGetLastError();
}

template <typename E>
int dispatch(const E* q, const E* k, const E* v, E* o, float* lse, int B, int T,
             int H, int D, Strides qs, Strides ks, Strides vs, int causal,
             int k_shift, float scale, cudaStream_t s) {
  const Args a{B * H, T, H, D, causal, k_shift, vec_ok<E>(D, {q, k, v}, {qs, ks, vs}) ? 1 : 0,
               scale, scale * LOG2E, qs, ks, vs, Strides{}};
  return by_head_dim<256>(D, [&](auto dp) {
    return launch<E, decltype(dp)::value>(q, k, v, o, lse, B, a, s);
  });
}

}  // namespace

extern "C" {

// q/k/v strides are (batch, time, head) in elements; the head-dim stride is
// 1. out is a contiguous [B, T, H, D] buffer of q's dtype, lse a contiguous
// [B, H, T] f32 one; scale is 1/√D.
#define FWD_ENTRY(NAME, E)                                                       \
  int NAME(const E* q, const E* k, const E* v, E* o, float* lse, int B, int T,   \
           int H, int D, long long qsb, long long qst, long long qsh,           \
           long long ksb, long long kst, long long ksh, long long vsb,          \
           long long vst, long long vsh, int causal, int k_shift, float scale,  \
           void* stream) {                                                      \
    return dispatch(q, k, v, o, lse, B, T, H, D, Strides{qsb, qst, qsh},        \
                    Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh}, causal,     \
                    k_shift, scale, static_cast<cudaStream_t>(stream));         \
  }

FWD_ENTRY(flash_fwd_f32, float)
FWD_ENTRY(flash_fwd_bf16, __nv_bfloat16)

#undef FWD_ENTRY

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
