// The saved-scores backward of the fused linear cross-entropy, f32 and
// bf16, for Hopper (sm_90a): kernels 12 (dX) and 13 (dW, db) of the port,
// which read the forward's f32 scores instead of recomputing them.
//
// Replaces: tpudml/ops/xent_kernel.py:175 `_dx_s_kernel` and :199
// `_dw_s_kernel` (launched by `_fused_backward_saved`, the saved-scores
// mode of `linear_cross_entropy`).
//
// For the saved scores s [N, V] f32 (unpadded, contiguous), W [d, V] or
// x [N, d] (f32 or bf16), int32 labels [N] and the forward's lse [N] f32:
//   dlog = (exp(s − lse) − onehot(label)) · inv_n   (a label outside [0, V)
//          gives no one-hot), rounded to the operand dtype just before the
//          product (the identity in f32);
//   dX = dlog·Wᵀ (stored in W's dtype),
//   dW = xᵀ·dlog (stored in x's dtype), db = Σ_rows dlog (f32, from the
//   unrounded dlog).
//
// What bounds it on this card. Each kernel does one product of 2·N·d·V
// flops and reads the 4·N·V bytes of s. At the flagship head (N = 8192,
// d = 512, V = 32768: 275 GFLOP, 1 GiB of s) the bf16 twins are bound by
// the bytes (s once, 0.32 ms at 3.35 TB/s; the product alone 0.28 ms at the
// tensor cores' dense 989 TFLOP/s), the f32 twins by the operations (4.1 ms
// at the CUDA cores' 67 TFLOP/s; no TF32: the f32 contract is rtol 1e-5).
// Besides s, every block streams its operand once through L2: all of W for
// dX (32 MiB in bf16, 64 MiB in f32 at that shape), its row range of x for
// dW (8 / 16 MiB). That is 4 GiB of L2 reads a kernel in bf16 (128 dX
// blocks × 32 MiB, 512 dW blocks × 8 MiB) and 16 GiB in f32 (256 × 64,
// 1024 × 16), which the blocks share in L2 since they walk the operand from
// its start at about the same pace: device memory serves s once and the
// operand about once a wave.
//
// Design. The saved pair is the lean pair (xent_lean.cu) without the score
// product: a block owns an output tile across a whole 512-column chunk of
// d, so each element of s it reads becomes dlog once, in f32, and feeds the
// whole chunk's product:
// - dX: a block owns BR rows × one chunk of dX and walks the vocabulary BV
//   columns a step; dW: a block owns BV vocabulary columns × one chunk of dW
//   (and db) over a range of rows, and walks the rows BR a step.
// - A step's tiles come through a cp.async ring (S stages: 2 in bf16, 3 in
//   f32; Saved): the operand tile (W [CW][BV] for dX, x [BR][CW] for dW)
//   and the s tile [BR][BV], plus, for dW, the step's lse and labels (dX
//   stages its rows' lse and labels once, in registers). Each thread turns
//   the s elements it copied itself (16-byte chunks, 4 a chunk) into dlog
//   and stores them once, in the operand dtype, into P, from where every
//   warp's product reads them.
// - f32, CUDA cores: BR = BV = 32, the lean kernels' products (grad_dx_f32,
//   grad_dw_f32, xent_grad.cuh): an 8×8 tile a thread, float4 operands,
//   conflict-free (x row-padded, W swizzled), no spill.
// - bf16, tensor cores: BR = BV = 64, mma.sync m16n8k16 with f32 sums. Warp
//   w owns 64 columns of the chunk (dX: all 64 rows, P the A operand by
//   ldmatrix, the W tile the B operand by ldmatrix) or 64 rows of it (dW:
//   all 64 vocabulary columns, the x tile the A operand by ldmatrix.trans, P
//   the B operand by ldmatrix.trans): 32 products a k-step from 8 ldmatrix,
//   each tile read by one warp (the operand) or by all (P, an eighth of the
//   bytes a step), 128 accumulators a thread.
// - Fill, one block an SM (168 KiB of shared memory in bf16, 209–211 KiB in
//   f32). dX at the flagship's N = 8192: 128 blocks of 64 rows in bf16, one
//   wave on 132 SMs (32 rows would be 256 blocks and twice W's L2 reads for
//   the same 97% of a second wave); 256 of 32 in f32 (1.94 waves; 64 rows
//   would put 128 f32 sums beside the operands in each thread). At the long
//   context's N = 32768: 512 and 1024 blocks. dW at V = 32768: 512 blocks
//   of 64 columns in bf16 (3.9 waves), 1024 of 32 in f32 (7.8 waves).
// - Wide d: the chunks of a width past 512 are blocks of their own, next to
//   each other in the grid (chunk fastest), each reading the s tile of its
//   rows (dX) or columns (dW) again: s is read through L2 once per chunk,
//   2, 4 and 8 times at d = 1024, 2048 and 4096, and from device memory
//   about once, since the chunks of a tile run at the same time. There is
//   no product to share between them, so no cluster.
// - Copies are 16-byte cp.async where rows and bases allow it (V % 4 == 0
//   for s; d or V a multiple of 16 bytes for x or W), and scalar loads
//   otherwise. dX's W tile is staged only as far as the chunk's width
//   reaches (a narrow d stages a few W rows, not 512). A ragged N, d or V
//   is otherwise zero-filled on load and masked on store; dlog is zero past
//   N and V. Nothing is padded or copied.
// - dW's rows come in ranges of LR = 65536 (grid y): with more than one,
//   each range's f32 partials of dW and db go to scratch (part [ranges, d,
//   V], db_part [ranges, V]) that xent_dw_range_sum_kernel adds in range
//   order, so no accumulator sums more than LR rows in one f32 chain. db is
//   summed by the block of chunk 0 of every vocabulary tile, each thread
//   over its own rows in step order, then over the threads in a fixed order.
// - No atomics: every output is written once after a fixed-order loop, and
//   a block's rows, columns, chunk and range come from (N, d, V, dtype)
//   alone, so a repeat is bitwise equal. Offsets are 64-bit; dX row tiles
//   and dW vocabulary tiles lie on grid x (2³¹ − 1 blocks).

#include "xent_grad.cuh"

namespace {

// ---------------------------------------------------------------- configs

// Tiles of one kernel (DX: dX, else dW) and dtype: BR rows × BV vocabulary
// columns of s and dlog a step; S stages of the cp.async ring; OP elements
// of T an operand stage (W [CW][BV] for dX, x [BR][CW or F_LDX] for dW); P
// [BR][LDP] in T; ACC accumulators a thread (the f32 8×8 tile, or 4
// m-tiles × 8 n-tiles of 4 in bf16). Timed on the H100 at the flagship
// head: a third f32 stage made dW a few percent faster and left dX as it
// was; in bf16, steps of 32 with 4 or 5 stages were slower than steps of 64
// with 2 (the deepest ring that fits at 64), and one barrier a step (dlog
// built a step ahead into a second P) gained too little to keep.
template <typename T, bool DX>
struct Saved;

template <bool DX>
struct Saved<float, DX> {
  static constexpr int BR = F_BR, BV = F_BV, LDP = F_LDS, ACC = 64, S = 3;
  static constexpr int OP = DX ? CW * BV : BR * F_LDX;
};
template <bool DX>
struct Saved<bf16, DX> {
  static constexpr int BR = 64, BV = 64, LDP = BV, ACC = 128, S = 2;
  static constexpr int OP = DX ? CW * BV : BR * CW;
};

// Shared memory: [S][OP] T, [S][BR][BV] f32 s tiles, (dW) [S][BR] f32 lse
// and [S][BR] int labels, then P.
template <typename T, bool DX>
constexpr size_t saved_smem() {
  using C_ = Saved<T, DX>;
  return sizeof(T) * (C_::S * C_::OP + C_::BR * C_::LDP) +
         sizeof(float) * C_::S * C_::BR * C_::BV + (DX ? 0 : C_::S * 2 * C_::BR * 4);
}

// Where a thread forms dlog: the 16-byte chunks i·NT + tid of the s tile,
// i < RP: RP rows row(i), the 4 columns col()..col() + 3; the RS threads
// that share a column are numbered by slot() (dW sums db over them in slot
// order). These are the chunks stage_s has the thread copy.
template <typename T, bool DX>
struct Elems {
  using C_ = Saved<T, DX>;
  static constexpr int CPR = C_::BV / 4, RS = NT / CPR, RP = C_::BR / RS;
  static __device__ int col() { return 4 * (threadIdx.x % CPR); }
  static __device__ int row(int i) { return threadIdx.x / CPR + RS * i; }
  static __device__ int slot() { return threadIdx.x / CPR; }
  static __device__ void put(T* p, int r, const float (&v)[4]) {
    const int c = col();
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p + r * C_::LDP + c) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<uint2*>(p + swz<C_::BV / 8>(r, c / 8) + c % 8) =
          make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    }
  }
};

// ---------------------------------------------------------------- staging

// The s tile [BR][BV] of rows r0.. (valid below `rows`) and columns v0..,
// in 16-byte chunks (cp.async with `vec`, scalar loads otherwise), zeros
// past the valid rows and columns.
template <int BR, int BV>
__device__ __forceinline__ void stage_s(float* dst, const float* s, int r0, int rows, int v0,
                                        int V, bool vec) {
  constexpr int CPR = BV / 4;
  for (int i = threadIdx.x; i < BR * CPR; i += NT) {
    const int r = i / CPR, c = 4 * (i % CPR);
    const int row = r0 + r, col = v0 + c;
    float* to = dst + r * BV + c;
    const bool row_ok = row < rows;
    const float* src = s + (row_ok ? static_cast<long long>(row) * V + col : 0);
    if (vec) {
      const bool ok = row_ok && col < V;
      cp_async_16(to, ok ? src : s, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) to[e] = row_ok && col + e < V ? src[e] : 0.f;
    }
  }
}

// lse and labels of rows r0 .. r0 + BR (zeros past `rows`).
template <int BR>
__device__ __forceinline__ void stage_rows(float* ls, int* lb, const float* lse,
                                           const int* labels, int r0, int rows) {
  for (int i = threadIdx.x; i < BR; i += NT) {
    const int row = r0 + i;
    const bool ok = row < rows;
    cp_async_4(ls + i, ok ? lse + row : lse, ok);
    cp_async_4(lb + i, ok ? labels + row : labels, ok);
  }
}

// dX's W tile [CW][BV] of chunk m only as far as the chunk's width hw
// reaches: the W rows below hw (8 chunks of 16 bytes a row: f32 swizzled by
// wsw, bf16 by swz), zeros past V. What lies past hw in shared memory is
// left as it was: the product reads it only into dX columns past hw, which
// are never stored. (A narrow d would otherwise stage 512 rows, zeros
// mostly, every step; on the H100 this also took a few percent off dX at
// d = 512. The same for dW's x columns made dW slower at every width.)
template <typename T>
__device__ __forceinline__ void stage_w_to(T* s, const T* w, int v0, int V, int m, int hw,
                                           bool vec) {
  constexpr int E = 16 / sizeof(T);
  const T* g = w + static_cast<long long>(m) * CW * V + v0;
  const int cols = V - v0;
  for (int i = threadIdx.x; i < hw * 8; i += NT) {
    const int r = i >> 3, c = i & 7;
    T* dst = s + (sizeof(T) == 4 ? wsw(r, c) : swz<8>(r, c));
    const T* src = g + static_cast<long long>(r) * V + c * E;
    if (vec) {
      const bool ok = c * E < cols;
      cp_async_16(dst, ok ? src : g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) dst[e] = c * E + e < cols ? src[e] : from_f32<T>(0.f);
    }
  }
}
// ------------------------------------------------------------ bf16 products

// dX += P·Wᵀ: warp w owns chunk columns [64w, 64w + 64) of all BR rows, as
// BR/16 m-tiles × 8 n-tiles (rows 16·mt + g (+8), columns 64w + 8n + 2c);
// P [BR][BV] is the A operand, the W tile [CW][BV] (rows = n) the B operand.
// Warps past the chunk's width hw idle.
template <int BR, int BV>
__device__ __forceinline__ void grad_dx_bf16(const bf16* p, const bf16* wt, int hw,
                                             float (&acc)[128]) {
  constexpr int MT = BR / 16;
  static_assert(MT * 8 * 4 == 128, "dX bf16 tile");
  const int j0 = 64 * (threadIdx.x >> 5);
  if (j0 >= hw) return;
  const Lanes l;
  float(&a4)[MT][8][4] = *reinterpret_cast<float(*)[MT][8][4]>(acc);
#pragma unroll
  for (int kk = 0; kk < BV / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[mt], p + swz<BV / 8>(16 * mt + l.a_row, 2 * kk + l.a_ch));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bm[4];
      ldmatrix_x4(bm, wt + swz<BV / 8>(j0 + 16 * np + l.b_row, 2 * kk + l.b_ch));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(a4[mt][2 * np], a[mt], bm[0], bm[1]);
        mma_bf16(a4[mt][2 * np + 1], a[mt], bm[2], bm[3]);
      }
    }
  }
}

// dW += xᵀ·P: warp w owns chunk rows [64w, 64w + 64) of d and all BV
// columns, as 4 m-tiles × BV/8 n-tiles (rows 64w + 16·mt + g (+8), columns
// 8·nt + 2c); xᵀ is the A operand (ldmatrix.trans of the x tile [BR][CW]),
// P [BR][BV] the B operand (ldmatrix.trans). Warps past hw idle.
template <int BR, int BV>
__device__ __forceinline__ void grad_dw_bf16(const bf16* p, const bf16* xt, int hw,
                                             float (&acc)[128]) {
  constexpr int NB = BV / 8;
  static_assert(4 * NB * 4 == 128, "dW bf16 tile");
  const int j0 = 64 * (threadIdx.x >> 5);
  if (j0 >= hw) return;
  const Lanes l;
  float(&a4)[4][NB][4] = *reinterpret_cast<float(*)[4][NB][4]>(acc);
#pragma unroll
  for (int kk = 0; kk < BR / 16; ++kk) {
    uint32_t pb[NB][2];
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
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
      for (int nt = 0; nt < NB; ++nt) mma_bf16(a4[mt][nt], a, pb[nt][0], pb[nt][1]);
    }
  }
}

// ---------------------------------------------------------------- kernel 12

// dX from the saved scores: block (row tile, chunk m) = blockIdx.x, chunk
// fastest; it owns dX[r0 .. r0 + BR) × [m·CW, +CW).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
xent_dx_saved_kernel(const float* __restrict__ s, const T* __restrict__ w,
                     const int* __restrict__ labels, const float* __restrict__ lse,
                     T* __restrict__ dx, int N, int d, int V, float inv_n, int vs, int vw) {
  using C_ = Saved<T, true>;
  using E = Elems<T, true>;
  constexpr int BR = C_::BR, BV = C_::BV, S = C_::S;
  static_assert(BV * sizeof(T) == 128, "stage_w_to stages 8 chunks of 16 bytes a W row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);                 // [2][CW][BV] W tiles
  float* ss = reinterpret_cast<float*>(ws + S * C_::OP);  // [S][BR][BV] s tiles
  T* p = reinterpret_cast<T*>(ss + S * BR * BV);          // dlog [BR][LDP]

  const int nch = (d + CW - 1) / CW;
  const int m = blockIdx.x % nch;
  const int r0 = (blockIdx.x / nch) * BR;
  const int hw = chunk_width(d, m);
  const int steps = (V + BV - 1) / BV;

  float lse_r[E::RP];
  int lab_r[E::RP];
#pragma unroll
  for (int i = 0; i < E::RP; ++i) {
    const int row = r0 + E::row(i);
    lse_r[i] = row < N ? lse[row] : 0.f;
    lab_r[i] = row < N ? labels[row] : -1;
  }

  for (int i = 0; i < S - 1; ++i) {  // the ring's first S − 1 steps
    if (i < steps) {
      stage_w_to<T>(ws + i * C_::OP, w, i * BV, V, m, hw, vw);
      stage_s<BR, BV>(ss + i * BR * BV, s, r0, N, i * BV, V, vs);
    }
    cp_async_commit();
  }

  float acc[C_::ACC];
#pragma unroll
  for (int e = 0; e < C_::ACC; ++e) acc[e] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int v0 = step * BV, stg = step % S, ahead = step + S - 1;
    cp_async_wait<S - 2>();
    __syncthreads();  // the step's tiles landed; step − 1 is done with its stage and P
    if (ahead < steps) {
      stage_w_to<T>(ws + (ahead % S) * C_::OP, w, ahead * BV, V, m, hw, vw);
      stage_s<BR, BV>(ss + (ahead % S) * BR * BV, s, r0, N, ahead * BV, V, vs);
    }
    cp_async_commit();
    const float* st = ss + stg * BR * BV;
#pragma unroll
    for (int i = 0; i < E::RP; ++i) {
      const bool row_ok = r0 + E::row(i) < N;
      float v[4];
      load_vec(v, st + E::row(i) * BV + E::col());
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + E::col() + e;
        v[e] = row_ok && col < V ? dlog_of(v[e], lse_r[i], col, lab_r[i], inv_n) : 0.f;
      }
      E::put(p, E::row(i), v);
    }
    __syncthreads();  // P is whole
    const T* wt = ws + stg * C_::OP;
    if constexpr (sizeof(T) == 4)
      grad_dx_f32(p, wt, hw, acc);
    else
      grad_dx_bf16<BR, BV>(p, wt, hw, acc);
  }
  cp_async_wait<0>();

  const long long c0 = static_cast<long long>(m) * CW;
  const int warp = threadIdx.x >> 5;
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
    constexpr int MT = BR / 16;
    const float(&a4)[MT][8][4] = *reinterpret_cast<const float(*)[MT][8][4]>(acc);
    const Lanes l;
    const int j0 = 64 * warp;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * mt + l.g + 8 * h;
        if (row >= N) continue;
        T* out = dx + static_cast<long long>(row) * d + c0;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int j = j0 + 8 * n + 2 * l.c;
          const float e0 = a4[mt][n][2 * h], e1 = a4[mt][n][2 * h + 1];
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

// ---------------------------------------------------------------- kernel 13

// dW from the saved scores: block (vocabulary tile, chunk m) = blockIdx.x,
// chunk fastest; row range blockIdx.y. It owns dW[m·CW, +CW) × [v0, v0 +
// BV) over the range's rows and (chunk 0) db[v0, v0 + BV). With one range
// it stores dW in T and db; with more, the range's f32 partials into part
// [ranges, d, V] and db_part [ranges, V].
template <typename T>
__global__ void __launch_bounds__(NT, 1)
xent_dw_saved_kernel(const float* __restrict__ s, const T* __restrict__ x,
                     const int* __restrict__ labels, const float* __restrict__ lse,
                     T* __restrict__ dw, float* __restrict__ db, float* __restrict__ part,
                     float* __restrict__ db_part, int N, int d, int V, float inv_n, int vs,
                     int vx) {
  using C_ = Saved<T, false>;
  using E = Elems<T, false>;
  constexpr int BR = C_::BR, BV = C_::BV, S = C_::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);                 // [2][BR][CW] x tiles
  float* ss = reinterpret_cast<float*>(xs + S * C_::OP);  // [S][BR][BV] s tiles
  float* ls = ss + S * BR * BV;                           // [S][BR] lse
  int* lb = reinterpret_cast<int*>(ls + S * BR);          // [S][BR] labels
  T* p = reinterpret_cast<T*>(lb + S * BR);               // dlog [BR][LDP]

  const int nch = (d + CW - 1) / CW;
  const int m = blockIdx.x % nch;
  const int v0 = (blockIdx.x / nch) * BV;
  const int hw = chunk_width(d, m);
  const bool ranged = gridDim.y > 1;
  const int n_begin = blockIdx.y * LR;
  const int n_end = n_begin + min(LR, N - n_begin);
  const int steps = (n_end - n_begin + BR - 1) / BR;

  for (int i = 0; i < S - 1; ++i) {  // the ring's first S − 1 steps
    if (i < steps) {
      const int n0 = n_begin + i * BR;
      stage_x<T, BR>(xs + i * C_::OP, x, n0, n_end, d, m, vx);
      stage_s<BR, BV>(ss + i * BR * BV, s, n0, n_end, v0, V, vs);
      stage_rows<BR>(ls + i * BR, lb + i * BR, lse, labels, n0, n_end);
    }
    cp_async_commit();
  }

  float acc[C_::ACC], db_r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < C_::ACC; ++e) acc[e] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int n0 = n_begin + step * BR, stg = step % S, ahead = step + S - 1;
    cp_async_wait<S - 2>();
    __syncthreads();  // the step's tiles landed; step − 1 is done with its stage and P
    if (ahead < steps) {
      const int o = ahead % S, na = n_begin + ahead * BR;
      stage_x<T, BR>(xs + o * C_::OP, x, na, n_end, d, m, vx);
      stage_s<BR, BV>(ss + o * BR * BV, s, na, n_end, v0, V, vs);
      stage_rows<BR>(ls + o * BR, lb + o * BR, lse, labels, na, n_end);
    }
    cp_async_commit();
    const float* st = ss + stg * BR * BV;
    const float* lst = ls + stg * BR;
    const int* lbt = lb + stg * BR;
#pragma unroll
    for (int i = 0; i < E::RP; ++i) {
      const int r = E::row(i);
      const bool row_ok = n0 + r < n_end;
      float v[4];
      load_vec(v, st + r * BV + E::col());
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + E::col() + e;
        v[e] = row_ok && col < V ? dlog_of(v[e], lst[r], col, lbt[r], inv_n) : 0.f;
        db_r[e] += v[e];
      }
      E::put(p, r, v);
    }
    __syncthreads();  // P is whole
    const T* xt = xs + stg * C_::OP;
    if constexpr (sizeof(T) == 4)
      grad_dw_f32(p, xt, hw, acc);
    else
      grad_dw_bf16<BR, BV>(p, xt, hw, acc);
  }
  cp_async_wait<0>();

  // db: the slots of each column, in order (chunk 0; every chunk's block
  // holds the same dlog).
  if (m == 0) {
    __syncthreads();  // the s tiles are free
    float* red = ss;  // [RS][BV]
#pragma unroll
    for (int e = 0; e < 4; ++e) red[E::slot() * BV + E::col() + e] = db_r[e];
    __syncthreads();
    if (threadIdx.x < BV && v0 + static_cast<int>(threadIdx.x) < V) {
      float t = 0.f;
      for (int g = 0; g < E::RS; ++g) t += red[g * BV + threadIdx.x];
      if (ranged)
        db_part[static_cast<long long>(blockIdx.y) * V + v0 + threadIdx.x] = t;
      else
        db[v0 + threadIdx.x] = t;
    }
  }

  const long long plane = static_cast<long long>(d) * V;
  float* pz = part + (ranged ? static_cast<long long>(blockIdx.y) * plane : 0);
  const long long j_base = static_cast<long long>(m) * CW;
  if constexpr (sizeof(T) == 4) {
    const int cg = threadIdx.x & 3, jg = threadIdx.x >> 2;
    const bool vec = (V & 3) == 0;
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
    constexpr int NB = BV / 8;
    const float(&a4)[4][NB][4] = *reinterpret_cast<const float(*)[4][NB][4]>(acc);
    const Lanes l;
    const int j0 = 64 * (threadIdx.x >> 5);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + 16 * mt + l.g + 8 * h;
        if (j >= hw) continue;
        const long long row = (j_base + j) * V;
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          const int col = v0 + 8 * nt + 2 * l.c;
          const float e0 = a4[mt][nt][2 * h], e1 = a4[mt][nt][2 * h + 1];
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

// ------------------------------------------------------------------ launch

int n_chunks(int d) { return (d + CW - 1) / CW; }

template <typename T>
cudaError_t launch_dx_saved(const float* s, const void* w, const int* labels, const float* lse,
                            void* dx, int N, int d, int V, float inv_n, cudaStream_t st) {
  constexpr size_t smem = saved_smem<T, true>();
  cudaError_t err = set_smem_once<xent_dx_saved_kernel<T>>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (N + Saved<T, true>::BR - 1LL) / Saved<T, true>::BR;
  const dim3 grid(static_cast<unsigned>(tiles * n_chunks(d)));
  xent_dx_saved_kernel<T><<<grid, NT, smem, st>>>(
      s, static_cast<const T*>(w), labels, lse, static_cast<T*>(dx), N, d, V, inv_n,
      int(vec_rows<float>(s, V)), int(vec_rows<T>(w, V)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw_saved(const float* s, const void* x, const int* labels, const float* lse,
                            void* dw, float* db, float* part, float* db_part, int N, int d,
                            int V, float inv_n, cudaStream_t st) {
  const int ranges = n_ranges(N);
  if (ranges > 1 && (part == nullptr || db_part == nullptr)) return cudaErrorInvalidValue;
  constexpr size_t smem = saved_smem<T, false>();
  cudaError_t err = set_smem_once<xent_dw_saved_kernel<T>>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (V + Saved<T, false>::BV - 1LL) / Saved<T, false>::BV;
  const dim3 grid(static_cast<unsigned>(tiles * n_chunks(d)), ranges);
  xent_dw_saved_kernel<T><<<grid, NT, smem, st>>>(
      s, static_cast<const T*>(x), labels, lse, static_cast<T*>(dw), db, part, db_part, N, d,
      V, inv_n, int(vec_rows<float>(s, V)), int(vec_rows<T>(x, d)));
  err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return err;
  return launch_range_sum<T>(part, db_part, dw, db, ranges, d, V, st);
}

}  // namespace

extern "C" {

// dx [N, d] in w's dtype from s [N, V] f32, w [d, V] (f32 or bf16),
// labels [N] int32 and lse [N] f32, all contiguous.
int xent_dx_s(const float* s, const void* w, const int* labels, const float* lse, void* dx,
              int N, int d, int V, float inv_n, int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dx_saved<__nv_bfloat16>(s, w, labels, lse, dx, N, d, V, inv_n, st)
              : launch_dx_saved<float>(s, w, labels, lse, dx, N, d, V, inv_n, st);
}

// dw [d, V] in x's dtype and db [V] f32 from s, x [N, d], labels, lse;
// with more than one row range (xent_saved_plan), f32 scratch part
// [ranges, d, V] and db_part [ranges, V], else null.
int xent_dw_s(const float* s, const void* x, const int* labels, const float* lse, void* dw,
              float* db, float* part, float* db_part, int N, int d, int V, float inv_n,
              int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dw_saved<__nv_bfloat16>(s, x, labels, lse, dw, db, part, db_part, N, d,
                                               V, inv_n, st)
              : launch_dw_saved<float>(s, x, labels, lse, dw, db, part, db_part, N, d, V,
                                       inv_n, st);
}

// How both kernels cut (N, d, V) in one dtype (ops/xent_kernel.py
// `saved_plan` mirrors it): out = (rows a dX block, vocabulary columns a
// dW block, columns of d a block, chunks of d (reads of s), rows a dW
// range, ranges, dX blocks, dW blocks).
int xent_saved_plan(int N, int d, int V, int is_bf16, long long* out) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  const int br = is_bf16 ? Saved<__nv_bfloat16, true>::BR : Saved<float, true>::BR;
  const int bv = is_bf16 ? Saved<__nv_bfloat16, false>::BV : Saved<float, false>::BV;
  const long long nch = n_chunks(d), ranges = n_ranges(N);
  out[0] = br, out[1] = bv, out[2] = CW, out[3] = nch, out[4] = LR, out[5] = ranges;
  out[6] = (N + br - 1LL) / br * nch;
  out[7] = (V + bv - 1LL) / bv * nch * ranges;
  return cudaSuccess;
}

const char* xent_saved_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
