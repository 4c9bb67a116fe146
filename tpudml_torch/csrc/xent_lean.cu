// The lean backward of the fused linear cross-entropy, f32 and bf16, for
// Hopper (sm_90a): kernels 14 (dX) and 15 (dW, db) of the port, which
// recompute the scores instead of reading them.
//
// Replaces: tpudml/ops/xent_kernel.py:327 `_dx_kernel` and :356 `_dw_kernel`
// (launched by `_fused_backward`, the lean mode of `linear_cross_entropy`).
//
// For x [N, d], W [d, V], b [V] (all f32 or all bf16), int32 labels [N] and
// the forward's lse [N] f32, with s = x·W + b summed in f32 from operands in
// their storage dtype:
//   dlog = (exp(s − lse) − onehot(label)) · inv_n   (a label outside [0, V)
//          gives no one-hot), rounded to the operand dtype just before the
//          gradient product (the identity in f32);
//   dX = dlog·Wᵀ (stored in x's dtype),
//   dW = xᵀ·dlog (stored in W's dtype), db = Σ_rows dlog (f32, from the
//   unrounded dlog).
// Nothing of size N·V exists: the residuals are x, W, b, labels and lse.
//
// What bounds it on this card: operations. Each kernel does two products of
// 2·N·d·V flops, the score recompute and the gradient: 2.2 TFLOP at the
// long-context head (N = 32768, d = 512, V = 32768), 32.9 ms at the f32
// rate of the CUDA cores (67 TFLOP/s; the f32 twin uses no TF32: its
// contract is rtol 1e-5) and 2.2 ms at the dense bf16 rate of the tensor
// cores (0.56 ms at the flagship's N = 8192). The bytes are below that: each dX block streams all of W once (64
// MiB f32 at that shape), each dW block all of its row range of x (64 MiB);
// the 1024 blocks of either kernel read 64 GiB through L2 in all, which the
// ring overlaps with the products. L2 is expected to absorb most of it,
// since the 132 resident blocks walk W (dX) or x (dW) from its start at
// about the same pace: at one pass over the operand a wave, device memory
// serves ~0.5 GiB (0.15 ms); were no tile shared, 64 GiB (20 ms at 3.35
// TB/s), still under the products' 32.9 ms.
//
// Design. The lean pair is the flash backward's shape (flash_bwd.cu,
// flash_dkdv.cu) with x as Q and Wᵀ as both K and V: lse is known, so there
// is no online softmax, and dlog plays dS. A block owns an output tile
// across a whole 512-column chunk of d, and S is computed once per block
// and step, in f32, then turned into dlog and fed to the gradient product:
// - dX: a block owns BR rows × one d chunk of dX and walks the vocabulary
//   BV columns at a time. Its x rows stay resident in shared memory; the W
//   tile [chunk][BV] streams through a two-stage cp.async ring and serves
//   both products: S = x·W (over the chunk's k) and dX += dlog·Wᵀ.
// - dW: a block owns BC vocabulary columns × one d chunk of dW (and db)
//   over a range of rows, and walks the rows BR at a time. Its W columns
//   stay resident; the x tile [BR][chunk] streams through the ring and
//   serves both products: S = x·W and dW += xᵀ·dlog.
// - The chunks of a wide d (past 512) are the blocks of one thread-block
//   cluster (up to 8: d <= 4096), each holding its chunk's operands. Each
//   block sums S over its own chunk of k, the blocks exchange these
//   partial sums through distributed shared memory and add them in rank
//   order, so every block of the cluster holds the same S over all of d,
//   computed once: S is computed once per output for d = 512, 1024, 2048
//   and 4096.
//   Past 4096 a cluster of 8 owns 8 chunks of the output, so the S of a
//   row (dX) or vocabulary (dW) tile is computed once per 4096 columns of
//   d; each block then adds up its share of k over the chunks q, q + 8,
//   ... (its own last), reloading the resident operand for each: a slow
//   path that keeps every d correct.
// - Inside a block, S is split by k (S alone would give each thread too
//   few outputs to reuse its loads), and the gradient product splits each
//   S row tile over the warps by output columns (a warp that owned a row
//   tile's whole chunk would need 256 accumulator registers a thread), so
//   S cannot stay in the registers that made it: each S element becomes
//   dlog once, stored in the operand dtype in shared memory (P), from
//   where every warp's gradient product reads it.
// - f32, CUDA cores: S on 4×8 tiles a thread, each over one of 8 k groups
//   held by the 8 lanes of a quarter warp, which a shuffle butterfly adds
//   up so that each lane ends with 4 elements of S, turns them into dlog in
//   registers and stores them to P; the gradient on an 8×8 tile a thread
//   (64 accumulators). All operands are read as float4, conflict-free (x
//   row-padded, W swizzled); each float4 loaded feeds 16 FMAs in the
//   gradient and 10.7 in S. (An 8×8 S tile would hold 64 sums beside the
//   64 accumulators: past a thread's 255 registers.)
// - bf16, tensor cores: both products are mma.sync m16n8k16 with f32 sums,
//   S split by k over 4 (dX) or 2 (dW) warps whose partial sums meet in
//   shared memory, the operands read by ldmatrix (plain or transposed) from
//   swizzled tiles: the W tile is the B operand of S through ldmatrix.trans and of
//   dX through ldmatrix; the x tile is the A operand of S and, transposed,
//   of dW; dlog, rounded to bf16 in shared memory, is the A operand of dX
//   and, transposed, the B operand of dW.
// - Fill: at 1 block an SM (each takes 204-218 KiB of shared memory), dX at
//   the long-context N = 32768 is 1024 blocks (32 rows each; 7.8 waves on
//   132 SMs) and 256 at the flagship's N = 8192 (1.9 waves); dW at V =
//   32768 is 1024 blocks (32 columns each). Fewer rows or columns a block
//   would cost more L2 traffic and syncs; more would not fit.
// - Copies are 16-byte cp.async where the row stride and base allow it (d
//   and V multiples of 16 bytes), and scalar loads otherwise (load_tile).
//   A ragged d, N or V is zero-filled on load and masked on store; x, W
//   and the outputs are never padded or copied.
// - dW's rows come in ranges of LR = 65536 (grid y): with more than one,
//   each range's f32 partials go to scratch (part, db_part) that
//   xent_dw_lean_sum_kernel adds in range order, so no accumulator sums
//   more than LR rows in one f32 chain. No atomics anywhere: every output
//   is written once after a fixed-order loop, and a block's rows, columns,
//   chunk and range come from (N, d, V, dtype) alone, so a repeat is
//   bitwise equal. Offsets are 64-bit; dX row tiles and dW vocabulary tiles
//   lie on grid x (2³¹ − 1 blocks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace cgrp = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;     // threads a block
constexpr int CW = 512;     // d columns a block owns (a chunk)
constexpr int CMAX = 8;     // blocks a cluster (portable): chunks one S pass covers
constexpr int LR = 65536;   // dW: rows of one range

// How a width d is cut: nch chunks of CW, C blocks a cluster, G clusters
// (S passes) for the chunks of one row (dX) or vocabulary (dW) tile.
struct Chunks {
  int nch, C, G;
};
__host__ __device__ inline Chunks lean_chunks(int d) {
  const int nch = (d + CW - 1) / CW;
  const int C = nch < CMAX ? nch : CMAX;
  return {nch, C, (nch + C - 1) / C};
}

// A block's share of k: the chunks q, q + C, ... (nk of them), with its own
// output chunk (home = s·C + q, if it exists) visited last.
struct Share {
  int q, s, C, nk, home;
  bool has_home;
  __device__ int chunk(int i) const {
    int idx = i;
    if (has_home) idx = i == nk - 1 ? s : (i < s ? i : i + 1);
    return q + C * idx;
  }
};
__device__ inline Share share_of(int q, int s, const Chunks& c) {
  Share sh;
  sh.q = q, sh.s = s, sh.C = c.C;
  sh.nk = (c.nch - q + c.C - 1) / c.C;
  sh.home = s * c.C + q;
  sh.has_home = s < sh.nk;
  return sh;
}

// Valid width of chunk m.
__device__ __forceinline__ int chunk_width(int d, int m) {
  const int w = d - m * CW;
  return w < CW ? w : CW;
}

// ---------------------------------------------------------------- configs

// Tile sizes of one kernel and dtype. Shared memory: the resident operand
// (RES elements of T), the two ring stages (STAGE each), then f32: the KG
// partial sums of S [KG][BR][LDS] (bf16 only), the cluster's block sums
// [2][BR][LDS] (by step parity), and P, dlog in T.
template <typename T, bool DX>
struct Cfg;

// f32: dX 32 rows × 32 vocabulary columns a step; dW 32 columns × 32 rows a
// step. x tiles row-padded [rows][CW + 4], W tiles swizzled [CW][32]; S is
// reduced across lanes (KG = 0), P is [BR][LDS] f32.
template <bool DX>
struct Cfg<float, DX> {
  static constexpr int BR = 32, BV = 32, KG = 0, LDS = BV + 4;
  static constexpr int RES = DX ? BR * (CW + 4) : CW * BV;
  static constexpr int STAGE = DX ? CW * BV : BR * (CW + 4);
  static constexpr int P_OFF = (KG + 2) * BR * LDS;  // floats past the partials
  static constexpr size_t smem = sizeof(float) * (RES + 2 * STAGE + P_OFF + BR * LDS);
};

// bf16: dX 32 rows × 64 vocabulary columns a step; dW 32 columns × 64 rows
// a step; all tiles swizzled, P [BR][BV] bf16.
template <>
struct Cfg<bf16, true> {
  static constexpr int BR = 32, BV = 64, KG = 4, LDS = BV + 8;
  static constexpr int RES = BR * CW, STAGE = CW * BV;
  static constexpr int P_OFF = (KG + 2) * BR * LDS;
  static constexpr size_t smem =
      sizeof(bf16) * (RES + 2 * STAGE + BR * BV) + sizeof(float) * P_OFF;
};
template <>
struct Cfg<bf16, false> {
  static constexpr int BR = 64, BV = 32, KG = 2, LDS = BV + 8;
  static constexpr int RES = CW * BV, STAGE = BR * CW;
  static constexpr int P_OFF = (KG + 2) * BR * LDS;
  static constexpr size_t smem =
      sizeof(bf16) * (RES + 2 * STAGE + BR * BV) + sizeof(float) * P_OFF;
};

// The f32 W tile [CW][32]: the 16-byte chunk c of row k lies at chunk
// c ^ ((k >> 2) & 7), so that 8 lanes reading rows 4 apart (the score
// product) or 8 rows that differ in (k >> 2) & 7 (the dX gradient) at one
// chunk hit 8 different bank groups. Zeros past the valid rows and columns.
__device__ __forceinline__ int wsw(int k, int c) { return k * 32 + 4 * (c ^ ((k >> 2) & 7)); }

__device__ __forceinline__ void load_w_f32(float* s, const float* g, long long st,
                                           int rows, int cols, bool vec) {
  for (int i = threadIdx.x; i < CW * 8; i += NT) {
    const int r = i >> 3, c = i & 7;
    float* dst = s + wsw(r, c);
    const bool row_ok = r < rows;
    const float* src = g + (row_ok ? r * st : 0) + 4 * c;
    if (vec) {
      const bool ok = row_ok && 4 * c < cols;
      cp_async_16(dst, ok ? src : g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = row_ok && 4 * c + e < cols ? src[e] : 0.f;
    }
  }
}

// Staging (zero-filled past the valid rows and columns): the x rows
// [BR][CW] of chunk m from row r0 (load_tile, mma.cuh: f32 row-padded,
// bf16 swizzled), and the W tile [CW][COLS] of chunk m from column v0.
template <typename T, int BR>
__device__ __forceinline__ void stage_x(T* s, const T* x, int r0, int rows, int d, int m,
                                        bool vec) {
  load_tile<CW, BR, NT>(s, x + m * CW, d, r0, rows, d - m * CW, vec);
}
template <typename T, int COLS>
__device__ __forceinline__ void stage_w(T* s, const T* w, int v0, int d, int V, int m,
                                        bool vec) {
  const T* g = w + static_cast<long long>(m) * CW * V + v0;
  if constexpr (sizeof(T) == 4)
    load_w_f32(s, g, V, d - m * CW, V - v0, vec);
  else
    load_tile<COLS, CW, NT>(s, g, V, 0, d - m * CW, V - v0, vec);
}

// ------------------------------------------------------------- f32 products

constexpr int F_LDX = CW + 4;  // x tile row

// This lane's place in the f32 score product: k group kg (lane % 8) of
// the 4×8 S tile (rows 4·tr.., columns 8·tc..), four tiles a warp.
struct ScoreLane {
  int kg, tr, tc;
  __device__ ScoreLane() {
    const int lane = threadIdx.x & 31, tile = 4 * (threadIdx.x >> 5) + (lane >> 3);
    kg = lane & 7, tr = tile >> 2, tc = tile & 3;
  }
};

// S over this lane's k group of one chunk: s[8i + j] += Σ_k x[4tr + i][k]·
// W[k][8tc + j] over the 4-wide slices k = 4·kg + 32·t below kd (the
// chunk's width rounded up to 4; the tiles are zero past it). Each lane
// reads 12 float4 for 128 FMAs; the 8 lanes of a quarter warp read 8
// consecutive x chunks and 8 W rows 4 apart (one bank group each). (An 8×8
// tile, with twice the FMAs a load, would hold 64 sums beside the 64
// accumulators of the gradient: more than a thread's 255 registers.)
__device__ __forceinline__ void score_f32(const float* xs, const float* ws, int kd,
                                          float (&s)[32]) {
  const ScoreLane sl;
#pragma unroll 2
  for (int k = 4 * sl.kg; k < kd; k += 32) {
    float xv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec(xv[i], xs + (4 * sl.tr + i) * F_LDX + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float wv[2][4];
      load_vec(wv[0], ws + wsw(k + e, 2 * sl.tc));
      load_vec(wv[1], ws + wsw(k + e, 2 * sl.tc + 1));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[8 * i + j] = fmaf(xv[i][e], wv[j >> 2][j & 3], s[8 * i + j]);
    }
  }
}

// One butterfly round over lane bit LM: a lane keeps the lower or upper
// H of its 2·H values and adds the partner's copy of them.
template <int H, int LM>
__device__ __forceinline__ void butterfly(float (&s)[32]) {
  const bool up = threadIdx.x & LM;
#pragma unroll
  for (int a = 0; a < H; ++a) {
    const float lo = s[a], hi = s[a + H];
    const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, LM);
    s[a] = (up ? hi : lo) + got;
  }
}

// The 8 k groups' sums, by a butterfly over lane bits 2..0 that halves the
// values a lane keeps each round (28 shuffles): s[0..3] become S at tile
// row kg >> 1, columns 4·(kg & 1) + 0..3 (Dlog<float>'s place).
__device__ __forceinline__ void reduce_k8(float (&s)[32]) {
  butterfly<16, 4>(s);
  butterfly<8, 2>(s);
  butterfly<4, 1>(s);
}

// dX += P·Wᵀ on the 8×8 tile a thread: rows rg + 4i, chunk columns
// 64·warp + 4·cg + (jj & 3) + 32·(jj >> 2) (lane = 8·rg + cg), so that the
// 8 lanes of a quarter warp read W rows that differ in (j >> 2) & 7. Warps
// past the chunk's width hw idle.
__device__ __forceinline__ int dx_col(int warp, int cg, int jj) {
  return 64 * warp + 4 * cg + (jj & 3) + 32 * (jj >> 2);
}
__device__ __forceinline__ void grad_dx_f32(const float* p, const float* ws, int hw,
                                            float (&acc)[64]) {
  constexpr int LDS = Cfg<float, true>::LDS, BV = Cfg<float, true>::BV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;
  if (warp * 64 >= hw) return;
#pragma unroll 2
  for (int c = 0; c < BV; c += 4) {
    float pv[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) load_vec(pv[i], p + (rg + 4 * i) * LDS + c);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float wv[4];
      load_vec(wv, ws + wsw(dx_col(warp, cg, jj), c >> 2));
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[8 * i + jj] = fmaf(pv[i][e], wv[e], acc[8 * i + jj]);
    }
  }
}

// dW += xᵀ·P on the 8×8 tile a thread: chunk rows 4jg + e + 256h (acc row
// 4h + e), vocabulary columns 4cg + f + 16g (acc column 4g + f); tid =
// 4jg + cg. Rows past the chunk's width hw are skipped.
__device__ __forceinline__ void grad_dw_f32(const float* p, const float* xs, int hw,
                                            float (&acc)[64]) {
  constexpr int LDS = Cfg<float, false>::LDS, BR = Cfg<float, false>::BR;
  const int cg = threadIdx.x & 3, jg = threadIdx.x >> 2;
  const bool hi = 256 + 4 * jg < hw;
  if (4 * jg >= hw) return;
#pragma unroll 4
  for (int r = 0; r < BR; ++r) {
    float xv[2][4], pv[2][4];
    load_vec(xv[0], xs + r * F_LDX + 4 * jg);
    load_vec(pv[0], p + r * LDS + 4 * cg);
    load_vec(pv[1], p + r * LDS + 16 + 4 * cg);
    if (hi) {
      load_vec(xv[1], xs + r * F_LDX + 256 + 4 * jg);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[1][e] = 0.f;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[8 * a + c] = fmaf(xv[a >> 2][a & 3], pv[c >> 2][c & 3], acc[8 * a + c]);
  }
}

// ------------------------------------------------------------ bf16 products

// ldmatrix row/chunk of this lane: A (rows of a row-major M×K tile), B (rows
// of an N×K tile), B transposed (rows of a K×N tile); A transposed (rows of
// a K×M tile) uses the B pattern.
struct Lanes {
  int a_row, a_ch, b_row, b_ch, t_row, t_ch, g, c;
  __device__ Lanes() {
    const int lane = threadIdx.x & 31;
    a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_ch = lane >> 4;
    b_row = (lane & 7) + (lane >> 4) * 8, b_ch = (lane >> 3) & 1;
    t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_ch = lane >> 4;
    g = lane >> 2, c = lane & 3;
  }
};

// Partial S of a warp: rows 16·rg.. of the x tile [BR][CW] (A), all NB·8
// columns of the W tile [CW][NB·8] (B through ldmatrix.trans), over the
// k-steps kg, kg + KG, ... below ks (16 deep; the tiles are zero past d).
template <int NB, int KG>
__device__ __forceinline__ void score_bf16(const bf16* xs, const bf16* ws, int ks, int rg,
                                           int kg, const Lanes& l, float (&s)[NB][4]) {
#pragma unroll 2
  for (int kk = kg; kk < ks; kk += KG) {
    uint32_t a[4];
    ldmatrix_x4(a, xs + swz<CW / 8>(16 * rg + l.a_row, 2 * kk + l.a_ch));
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, ws + swz<NB>(16 * kk + l.t_row, 2 * np + l.t_ch));
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// A warp's partial S fragments into sx[kg][BR][LDS] (rows 16·rg + g, + 8).
template <int NB, int BR, int LDS>
__device__ __forceinline__ void write_partial_bf16(const float (&s)[NB][4], float* sx,
                                                   int rg, int kg, const Lanes& l) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_pair(sx + (kg * BR + 16 * rg + l.g + 8 * h) * LDS + 8 * n + 2 * l.c,
                 s[n][2 * h], s[n][2 * h + 1]);
}

// -------------------------------------------------------------------- dlog

// Where a thread forms dlog: RP rows row(i) of the step's tile, 4 columns
// col()..col() + 3; slot() numbers the NSLOT threads that share a column
// (dW sums db over them in slot order); put() stores its dlog into P.
// bf16: thread t takes columns 4·(t % (BV/4)) of rows t / (BV/4) + RS·i,
// from the partial sums in shared memory.
template <typename T, bool DX>
struct Dlog {
  using C_ = Cfg<T, DX>;
  static constexpr int BR = C_::BR, BV = C_::BV, LDS = C_::LDS;
  static constexpr int CPR = BV / 4, RS = NT / CPR, RP = BR / RS, NSLOT = RS;
  static __device__ int col() { return 4 * (threadIdx.x % CPR); }
  static __device__ int row(int i) { return threadIdx.x / CPR + RS * i; }
  static __device__ int slot() { return threadIdx.x / CPR; }
  static __device__ void put(T* p, int r, const float (&v)[4]) {
    const int c = col();
    *reinterpret_cast<uint2*>(p + swz<BV / 8>(r, c / 8) + c % 8) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
  // S of this thread's (row pass i) four elements: the KG partials in order.
  static __device__ void block_sum(const float* sx, int i, float (&v)[4]) {
    v[0] = v[1] = v[2] = v[3] = 0.f;
#pragma unroll
    for (int kg = 0; kg < C_::KG; ++kg) {
      float t[4];
      load_vec(t, sx + (kg * BR + row(i)) * LDS + col());
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += t[e];
    }
  }
};
// f32: the lane's place after reduce_k8, one row.
template <bool DX>
struct Dlog<float, DX> {
  static constexpr int BR = 32, BV = 32, LDS = Cfg<float, DX>::LDS, RP = 1, NSLOT = 32;
  static __device__ int col() {
    const ScoreLane sl;
    return 8 * sl.tc + 4 * (sl.kg & 1);
  }
  static __device__ int row(int) {
    const ScoreLane sl;
    return 4 * sl.tr + (sl.kg >> 1);
  }
  static __device__ int slot() { return row(0); }
  static __device__ void put(float* p, int r, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p + r * LDS + col()) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// In a cluster (C > 1): the block's S values go to sb (this step's parity)
// and, after the cluster barrier, every block adds all blocks' values in
// rank order, so all hold the same S.
template <int RP, int LDS>
__device__ __forceinline__ void cluster_sum(float (&v)[RP][4], float* sb, const int (&row)[RP],
                                            int col, int C) {
#pragma unroll
  for (int i = 0; i < RP; ++i)
    *reinterpret_cast<float4*>(sb + row[i] * LDS + col) =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
  cgrp::cluster_group cl = cgrp::this_cluster();
  cl.sync();
#pragma unroll
  for (int i = 0; i < RP; ++i) v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
  for (int rk = 0; rk < C; ++rk) {
    const float* src = cl.map_shared_rank(sb, rk);
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      float t[4];
      load_vec(t, src + row[i] * LDS + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][e] += t[e];
    }
  }
}

// The step's S for this thread's dlog elements, from the score product's
// registers s: f32 through the lane butterfly; bf16 through the partial
// sums in sx (barrier inside); then the cluster's sum.
template <typename T, bool DX, int NS>
__device__ __forceinline__ void step_scores(float (&s)[NS], float* sx, float* sb, int C,
                                            const Lanes& l, float (&v)[Dlog<T, DX>::RP][4]) {
  using D = Dlog<T, DX>;
  int rows[D::RP];
#pragma unroll
  for (int i = 0; i < D::RP; ++i) rows[i] = D::row(i);
  if constexpr (sizeof(T) == 4) {
    reduce_k8(s);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[0][e] = s[e];
  } else {
    using C_ = Cfg<T, DX>;
    const int warp = threadIdx.x >> 5;
    constexpr int RG = C_::BR / 16;  // row groups (warps a k group)
    write_partial_bf16<NS / 4, C_::BR, C_::LDS>(*reinterpret_cast<float(*)[NS / 4][4]>(s), sx,
                                                warp % RG, warp / RG, l);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < D::RP; ++i) D::block_sum(sx, i, v[i]);
  }
  if (C > 1) cluster_sum<D::RP, D::LDS>(v, sb, rows, D::col(), C);
}

__device__ __forceinline__ float dlog_of(float s, float lse, int col, int label, float inv_n) {
  return (expf(s - lse) - (col == label ? 1.f : 0.f)) * inv_n;
}

// ---------------------------------------------------------------- kernel 14

// dX lean: block (row tile, S pass s, cluster rank q) = blockIdx.x, rank
// fastest. It sums S over its share of k and, for its home chunk, owns
// dX[r0 .. r0 + BR) × [home·CW, +CW).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
xent_dx_lean_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ b, const int* __restrict__ labels,
                    const float* __restrict__ lse, T* __restrict__ dx, int N, int d,
                    int V, float inv_n, int vx, int vw) {
  using C_ = Cfg<T, true>;
  using D = Dlog<T, true>;
  constexpr int BR = C_::BR, BV = C_::BV, LDS = C_::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [BR][CW] x rows of the chunk
  T* ws = xs + C_::RES;                    // [2][CW][BV] W tiles
  float* sx = reinterpret_cast<float*>(ws + 2 * C_::STAGE);  // [KG][BR][LDS]
  float* sb = sx + C_::KG * BR * LDS;                        // [2][BR][LDS]
  T* p = reinterpret_cast<T*>(sx + C_::P_OFF);               // dlog

  const Chunks ch = lean_chunks(d);
  const int q = blockIdx.x % ch.C, rest = blockIdx.x / ch.C;
  const Share sh = share_of(q, rest % ch.G, ch);
  const int r0 = (rest / ch.G) * BR;
  const int steps = (V + BV - 1) / BV, total = steps * sh.nk;
  const int hw = sh.has_home ? chunk_width(d, sh.home) : 0;

  float lse_r[D::RP];
  int lab_r[D::RP];
#pragma unroll
  for (int i = 0; i < D::RP; ++i) {
    const int row = r0 + D::row(i);
    lse_r[i] = row < N ? lse[row] : 0.f;
    lab_r[i] = row < N ? labels[row] : -1;
  }

  if (sh.nk == 1) stage_x<T, BR>(xs, x, r0, N, d, sh.chunk(0), vx);
  stage_w<T, BV>(ws, w, 0, d, V, sh.chunk(0), vw);
  cp_async_commit();

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  constexpr int NS = 32;
  float s[NS], bias[4];
  const Lanes l;
  const int warp = threadIdx.x >> 5;

  for (int pr = 0; pr < total; ++pr) {
    const int step = pr / sh.nk, i = pr % sh.nk, m = sh.chunk(i);
    const int v0 = step * BV;
    const T* wt = ws + (pr & 1) * C_::STAGE;
    cp_async_wait<0>();
    __syncthreads();  // W tile pr landed; pair pr − 1 is done with the other stage, xs, P
    if (sh.nk > 1) {
      stage_x<T, BR>(xs, x, r0, N, d, m, vx);
      cp_async_commit();
    }
    if (pr + 1 < total)
      stage_w<T, BV>(ws + ((pr + 1) & 1) * C_::STAGE, w, ((pr + 1) / sh.nk) * BV, d, V,
                     sh.chunk((pr + 1) % sh.nk), vw);
    cp_async_commit();
    if (sh.nk > 1) {
      cp_async_wait<1>();
      __syncthreads();
    }
    if (i == 0) {
#pragma unroll
      for (int e = 0; e < NS; ++e) s[e] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // read now, used after the score product
        const int col = v0 + D::col() + e;
        bias[e] = col < V ? to_f32(b[col]) : 0.f;
      }
    }
    const int wm = chunk_width(d, m);
    if constexpr (sizeof(T) == 4) {
      score_f32(xs, wt, (wm + 3) & ~3, s);
    } else {
      score_bf16<8, 4>(xs, wt, (wm + 15) / 16, warp & 1, warp >> 1, l,
                       *reinterpret_cast<float(*)[8][4]>(s));
    }
    if (i != sh.nk - 1) continue;

    // The step's S, dlog into P.
    float v[D::RP][4];
    step_scores<T, true>(s, sx, sb + (step & 1) * BR * LDS, sh.C, l, v);
#pragma unroll
    for (int r = 0; r < D::RP; ++r) {
      const bool row_ok = r0 + D::row(r) < N;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + D::col() + e;
        v[r][e] = row_ok && col < V ? dlog_of(v[r][e] + bias[e], lse_r[r], col, lab_r[r], inv_n)
                                    : 0.f;
      }
      D::put(p, D::row(r), v[r]);
    }
    __syncthreads();
    if (!sh.has_home) continue;
    if constexpr (sizeof(T) == 4) {
      grad_dx_f32(p, wt, hw, acc);
    } else {
      // acc as 16 n-tiles × 4: rows 16·rg + g (+8), chunk columns 128·cg + 8n + 2c.
      const int rg = warp & 1, j0 = (warp >> 1) * 128;
      if (j0 < hw) {
        float(&a4)[16][4] = *reinterpret_cast<float(*)[16][4]>(acc);
#pragma unroll
        for (int kk = 0; kk < BV / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, p + swz<BV / 8>(16 * rg + l.a_row, 2 * kk + l.a_ch));
#pragma unroll
          for (int np = 0; np < 8; ++np) {
            uint32_t bm[4];
            ldmatrix_x4(bm, wt + swz<BV / 8>(j0 + 16 * np + l.b_row, 2 * kk + l.b_ch));
            mma_bf16(a4[2 * np], a, bm[0], bm[1]);
            mma_bf16(a4[2 * np + 1], a, bm[2], bm[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (sh.C > 1) cgrp::this_cluster().sync();  // no block leaves while others read its sums
  if (!sh.has_home) return;

  const long long c0 = static_cast<long long>(sh.home) * CW;
  if constexpr (sizeof(T) == 4) {
    const int lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + rg + 4 * i;
      if (row >= N) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = dx_col(warp, cg, jj);
        if (j < hw) dx[static_cast<long long>(row) * d + c0 + j] = acc[8 * i + jj];
      }
    }
  } else {
    const int rg = warp & 1, j0 = (warp >> 1) * 128;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * rg + l.g + 8 * h;
      if (row >= N) continue;
      T* out = dx + static_cast<long long>(row) * d + c0;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int j = j0 + 8 * n + 2 * l.c;
        const float e0 = acc[4 * n + 2 * h], e1 = acc[4 * n + 2 * h + 1];
        if (j + 1 < hw && (d & 1) == 0) {
          store_pair(out + j, e0, e1);
        } else {
          if (j < hw) out[j] = from_f32<T>(e0);
          if (j + 1 < hw) out[j + 1] = from_f32<T>(e1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- kernel 15

// dW lean: block (vocabulary tile, S pass s, cluster rank q) = blockIdx.x,
// rank fastest; row range blockIdx.y. It sums S over its share of k and,
// for its home chunk, owns dW[home·CW, +CW) × [v0, v0 + BV) over the
// range's rows, and (home chunk 0) db[v0, v0 + BV). With one range it
// stores dW in T and db; with more, the range's f32 partials into part
// [ranges, d, V] and db_part [ranges, V].
template <typename T>
__global__ void __launch_bounds__(NT, 1)
xent_dw_lean_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ b, const int* __restrict__ labels,
                    const float* __restrict__ lse, T* __restrict__ dw,
                    float* __restrict__ db, float* __restrict__ part,
                    float* __restrict__ db_part, int N, int d, int V, float inv_n, int vx,
                    int vw) {
  using C_ = Cfg<T, false>;
  using D = Dlog<T, false>;
  constexpr int BR = C_::BR, BV = C_::BV, LDS = C_::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wr = reinterpret_cast<T*>(smem_raw);  // [CW][BV] W columns of the chunk
  T* xs = wr + C_::RES;                    // [2][BR][CW] x tiles
  float* sx = reinterpret_cast<float*>(xs + 2 * C_::STAGE);
  float* sb = sx + C_::KG * BR * LDS;
  T* p = reinterpret_cast<T*>(sx + C_::P_OFF);

  const Chunks ch = lean_chunks(d);
  const int q = blockIdx.x % ch.C, rest = blockIdx.x / ch.C;
  const Share sh = share_of(q, rest % ch.G, ch);
  const int v0 = (rest / ch.G) * BV;
  const bool ranged = gridDim.y > 1;
  const int n_begin = blockIdx.y * LR;
  const int n_end = n_begin + min(LR, N - n_begin);
  const int steps = (n_end - n_begin + BR - 1) / BR, total = steps * sh.nk;
  const int hw = sh.has_home ? chunk_width(d, sh.home) : 0;

  float bias[4], db_r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = v0 + D::col() + e;
    bias[e] = col < V ? to_f32(b[col]) : 0.f;
    db_r[e] = 0.f;
  }

  if (sh.nk == 1) stage_w<T, BV>(wr, w, v0, d, V, sh.chunk(0), vw);
  stage_x<T, BR>(xs, x, n_begin, n_end, d, sh.chunk(0), vx);
  cp_async_commit();

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  constexpr int NS = sizeof(T) == 4 ? 32 : 16;
  float s[NS], lse_r[D::RP];
  int lab_r[D::RP];
  const Lanes l;
  const int warp = threadIdx.x >> 5;

  for (int pr = 0; pr < total; ++pr) {
    const int step = pr / sh.nk, i = pr % sh.nk, m = sh.chunk(i);
    const int n0 = n_begin + step * BR;
    const T* xt = xs + (pr & 1) * C_::STAGE;
    cp_async_wait<0>();
    __syncthreads();  // x tile pr landed; pair pr − 1 is done with the other stage, wr, P
    if (sh.nk > 1) {
      stage_w<T, BV>(wr, w, v0, d, V, m, vw);
      cp_async_commit();
    }
    if (pr + 1 < total)
      stage_x<T, BR>(xs + ((pr + 1) & 1) * C_::STAGE, x, n_begin + ((pr + 1) / sh.nk) * BR,
                     n_end, d, sh.chunk((pr + 1) % sh.nk), vx);
    cp_async_commit();
    if (sh.nk > 1) {
      cp_async_wait<1>();
      __syncthreads();
    }
    if (i == 0) {
#pragma unroll
      for (int e = 0; e < NS; ++e) s[e] = 0.f;
#pragma unroll
      for (int r = 0; r < D::RP; ++r) {  // read now, used after the score product
        const int row = n0 + D::row(r);
        lse_r[r] = row < n_end ? lse[row] : 0.f;
        lab_r[r] = row < n_end ? labels[row] : -1;
      }
    }
    const int wm = chunk_width(d, m);
    if constexpr (sizeof(T) == 4) {
      score_f32(xt, wr, (wm + 3) & ~3, s);
    } else {
      score_bf16<4, 2>(xt, wr, (wm + 15) / 16, warp & 3, warp >> 2, l,
                       *reinterpret_cast<float(*)[4][4]>(s));
    }
    if (i != sh.nk - 1) continue;

    float v[D::RP][4];
    step_scores<T, false>(s, sx, sb + (step & 1) * BR * LDS, sh.C, l, v);
#pragma unroll
    for (int r = 0; r < D::RP; ++r) {
      const bool row_ok = n0 + D::row(r) < n_end;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + D::col() + e;
        v[r][e] = row_ok && col < V
                      ? dlog_of(v[r][e] + bias[e], lse_r[r], col, lab_r[r], inv_n)
                      : 0.f;
        db_r[e] += v[r][e];
      }
      D::put(p, D::row(r), v[r]);
    }
    __syncthreads();
    if (!sh.has_home) continue;
    if constexpr (sizeof(T) == 4) {
      grad_dw_f32(p, xt, hw, acc);
    } else {
      // acc as 4 m-tiles (chunk rows 64·warp + 16mt + g, + 8) × 4 n-tiles
      // (columns 8nt + 2c) × 4.
      const int j0 = warp * 64;
      if (j0 < hw) {
#pragma unroll
        for (int kk = 0; kk < BR / 16; ++kk) {
          uint32_t pb[4][2];
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t t4[4];
            ldmatrix_x4_trans(t4, p + swz<BV / 8>(16 * kk + l.t_row, 2 * np + l.t_ch));
            pb[2 * np][0] = t4[0], pb[2 * np][1] = t4[1];
            pb[2 * np + 1][0] = t4[2], pb[2 * np + 1][1] = t4[3];
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, xt + swz<CW / 8>(16 * kk + l.b_row, (j0 + 16 * mt) / 8 + l.b_ch));
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 16 * mt + 4 * nt), a, pb[nt][0],
                       pb[nt][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (sh.C > 1) cgrp::this_cluster().sync();  // no block leaves while others read its sums

  // db: the slots of each column, in order (home chunk 0 only; every block
  // of the cluster holds the same dlog).
  if (sh.has_home && sh.home == 0) {
    __syncthreads();  // sb is free
    float* red = sb;  // [NSLOT][BV]
#pragma unroll
    for (int e = 0; e < 4; ++e) red[D::slot() * BV + D::col() + e] = db_r[e];
    __syncthreads();
    if (threadIdx.x < BV && v0 + static_cast<int>(threadIdx.x) < V) {
      float t = 0.f;
      for (int g = 0; g < D::NSLOT; ++g) t += red[g * BV + threadIdx.x];
      if (ranged)
        db_part[static_cast<long long>(blockIdx.y) * V + v0 + threadIdx.x] = t;
      else
        db[v0 + threadIdx.x] = t;
    }
  }
  if (!sh.has_home) return;

  const long long plane = static_cast<long long>(d) * V;
  float* pz = part + (ranged ? static_cast<long long>(blockIdx.y) * plane : 0);
  const long long j_base = static_cast<long long>(sh.home) * CW;
  if constexpr (sizeof(T) == 4) {
    const int cg = threadIdx.x & 3, jg = threadIdx.x >> 2;
    const bool vec = vw && (V & 3) == 0;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int j = 4 * jg + (a & 3) + 256 * (a >> 2);
      if (j >= hw) continue;
      const long long row = (j_base + j) * V;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int col = v0 + 4 * cg + 16 * g;
        const float* src = acc + 8 * a + 4 * g;
        float* dst = ranged ? pz + row + col : dw + row + col;
        if (vec && col < V) {
          *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
        } else {
#pragma unroll
          for (int f = 0; f < 4; ++f)
            if (col + f < V) dst[f] = src[f];
        }
      }
    }
  } else {
    const int j0 = warp * 64;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + 16 * mt + l.g + 8 * h;
        if (j >= hw) continue;
        const long long row = (j_base + j) * V;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = v0 + 8 * nt + 2 * l.c;
          const float e0 = acc[16 * mt + 4 * nt + 2 * h], e1 = acc[16 * mt + 4 * nt + 2 * h + 1];
          const bool pair = col + 1 < V && (V & 1) == 0;
          if (ranged) {
            if (pair) {
              store_pair(pz + row + col, e0, e1);
            } else {
              if (col < V) pz[row + col] = e0;
              if (col + 1 < V) pz[row + col + 1] = e1;
            }
          } else if (pair) {
            store_pair(dw + row + col, e0, e1);
          } else {
            if (col < V) dw[row + col] = from_f32<T>(e0);
            if (col + 1 < V) dw[row + col + 1] = from_f32<T>(e1);
          }
        }
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

// ------------------------------------------------------------------ launch

// A launch of `grid` blocks of NT threads in clusters of C along x.
template <typename... K, typename... A>
cudaError_t launch_clustered(void (*kernel)(K...), dim3 grid, int C, size_t smem,
                             cudaStream_t st, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<K>(args)...);
}

template <typename T>
bool vec_rows(const void* p, long long stride) {
  return aligned16(p) && stride % (16 / sizeof(T)) == 0;
}

template <typename T>
cudaError_t launch_dx_lean(const void* x, const void* w, const void* b, const int* labels,
                           const float* lse, void* dx, int N, int d, int V, float inv_n,
                           cudaStream_t st) {
  constexpr size_t smem = Cfg<T, true>::smem;
  cudaError_t err = set_smem_once<xent_dx_lean_kernel<T>>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const Chunks ch = lean_chunks(d);
  const long long tiles = (N + Cfg<T, true>::BR - 1LL) / Cfg<T, true>::BR;
  const dim3 grid(static_cast<unsigned>(tiles * ch.G * ch.C));
  return launch_clustered(xent_dx_lean_kernel<T>, grid, ch.C, smem, st, static_cast<const T*>(x),
                          static_cast<const T*>(w), static_cast<const T*>(b), labels, lse,
                          static_cast<T*>(dx), N, d, V, inv_n, int(vec_rows<T>(x, d)),
                          int(vec_rows<T>(w, V)));
}

int lean_ranges(int N) { return static_cast<int>((N + static_cast<long long>(LR) - 1) / LR); }

template <typename T>
cudaError_t launch_dw_lean(const void* x, const void* w, const void* b, const int* labels,
                           const float* lse, void* dw, float* db, float* part,
                           float* db_part, int N, int d, int V, float inv_n, cudaStream_t st) {
  const int ranges = lean_ranges(N);
  if (ranges > 1 && (part == nullptr || db_part == nullptr)) return cudaErrorInvalidValue;
  constexpr size_t smem = Cfg<T, false>::smem;
  cudaError_t err = set_smem_once<xent_dw_lean_kernel<T>>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const Chunks ch = lean_chunks(d);
  const long long tiles = (V + Cfg<T, false>::BV - 1LL) / Cfg<T, false>::BV;
  const dim3 grid(static_cast<unsigned>(tiles * ch.G * ch.C), ranges);
  err = launch_clustered(xent_dw_lean_kernel<T>, grid, ch.C, smem, st, static_cast<const T*>(x),
                         static_cast<const T*>(w), static_cast<const T*>(b), labels, lse,
                         static_cast<T*>(dw), db, part, db_part, N, d, V, inv_n,
                         int(vec_rows<T>(x, d)), int(vec_rows<T>(w, V)));
  if (err != cudaSuccess || ranges == 1) return err;
  const long long elems = static_cast<long long>(d) * V;
  xent_dw_lean_sum_kernel<T><<<static_cast<unsigned>((elems + 255) / 256), 256, 0, st>>>(
      part, db_part, static_cast<T*>(dw), db, ranges, d, V);
  return cudaGetLastError();
}

bool shape_ok(int N, int d, int V) { return N > 0 && V > 0 && d > 0; }

}  // namespace

extern "C" {

// Lean dX [N, d] in x's dtype from x [N, d], w [d, V], b [V] (one dtype,
// contiguous), labels [N] int32 and lse [N] f32, recomputing the scores.
int xent_dx_lean(const void* x, const void* w, const void* b, const int* labels,
                 const float* lse, void* dx, int N, int d, int V, float inv_n, int bf16,
                 void* stream) {
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
                 const float* lse, void* dw, float* db, float* part, float* db_part, int N,
                 int d, int V, float inv_n, int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dw_lean<__nv_bfloat16>(x, w, b, labels, lse, dw, db, part, db_part, N,
                                              d, V, inv_n, st)
              : launch_dw_lean<float>(x, w, b, labels, lse, dw, db, part, db_part, N, d, V,
                                      inv_n, st);
}

// How both kernels cut a width d: out = (columns a chunk, blocks a
// cluster, S passes a tile) (ops/xent_kernel.py `lean_plan` mirrors it).
int xent_lean_plan(int d, int* out) {
  if (d < 1) return cudaErrorInvalidValue;
  const Chunks ch = lean_chunks(d);
  out[0] = CW, out[1] = ch.C, out[2] = ch.G;
  return cudaSuccess;
}

const char* xent_lean_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
