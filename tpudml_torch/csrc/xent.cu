// Fused linear cross-entropy, f32 and bf16 operands, for Hopper (sm_90a): the
// forward, with and without the score store (kernels 10 and 11 of the
// port). The backward kernels are in xent_saved.cu (12, 13: from the saved
// scores) and xent_lean.cu (14, 15: recomputing them).
//
// Replaces: tpudml/ops/xent_kernel.py `_fwd_kernel` (forward, no save) and
// `_fwd_kernel_save` (forward that also stores the f32 scores), launched by
// `_fused_forward`.
//
// For x [N, d], W [d, V], bias [V] (all f32 or all bf16) and int32 labels
// [N], with s = x·W + b summed in f32 (a bf16 product is exact in f32; only
// the order of the sums differs from the MXU):
//   lse[r] = log Σ_c exp(s[r, c]),
//   picked[r] = s[r, label[r]] if 0 <= label[r] < V, else 0
//   (an out-of-range label contributes loss = lse, no pull-up).
// The saved scores are the unpadded [N, V] f32 buffer (the TPU kernel pads
// it to its tiles; here ragged rows and vocabulary columns are masked
// instead). Any width d >= 1: the contraction stage past d is zero-filled
// on load, and a d that is no multiple of the stage depth runs the RAGGED
// instance, whose last stage stops at d (W is never padded or copied).
//
// What bounds it on this card: operations. The product is 2·N·d·V flops
// (275 GFLOP at N = 8192, d = 512, V = 32768: 0.28 ms on the tensor cores'
// dense 989 TFLOP/s in bf16, 4.1 ms on the CUDA cores' 67 TFLOP/s in f32,
// which uses no TF32: its contract is rtol 1e-5), against the 1 GiB score
// store of kernel 11 (0.32 ms at 3.35 TB/s).
//
// Design. The flash forward without its second product (flash_fwd.cu): x
// plays Q, W plays Kᵀ, and a block keeps the online (max, Σ exp) state and
// the label pick of its rows instead of an output tile.
// - A block owns BR = 128 rows and walks a slice of the vocabulary BV
//   columns a step; each step contracts the whole of d through a cp.async
//   ring of S stages, each stage an x tile [BR][BK] and a W tile [BK][BV],
//   zeros past N, d and V. The ring runs on across steps, so the next
//   step's tiles load while a step ends.
// - bf16, tensor cores: BV = 256, BK = 64, 3 stages (144 KiB). Warp w owns
//   rows 64·(w / 4).. and columns 64·(w % 4).. of the step, 4 m-tiles × 8
//   n-tiles of mma.sync m16n8k16 with f32 sums (128 accumulators a thread),
//   x the A operand by ldmatrix and W the B operand by ldmatrix.trans, both
//   from XOR-swizzled tiles (mma.cuh): 8 ldmatrix for 32 products a k-step.
//   Each mma sums its k-step from zero, and a rounded FADD adds it to the
//   f32 sum: chained through the tensor cores, whose f32 accumulation
//   truncates, the sums drifted past the scores' tolerance at d = 2048.
// - f32, CUDA cores: BV = 128, BK = 64, 3 stages (201 KiB). Warp w owns rows
//   32·(w / 2).. and columns 64·(w % 2)..; lane 8·rg + cg an 8×8 tile, rows
//   rg + 4i and columns 4·cg + 32·h + e. Each k group of 4 reads 8 float4
//   of x (row-padded tile: the 4 rows of a warp's load hit 4 different bank
//   groups, its 8 lanes of a row one address) and 8 float4 of W (8 lanes
//   read 128 contiguous bytes, the same for the 4 row groups) for 256 FMAs.
// - A step's accumulators start from the bias. At the step's end each
//   thread masks columns past V (last step only), stores the scores (SAVE)
//   and folds its own columns of each row into its running (max, Σ exp):
//   no shuffle and no barrier. That state, the labels and the picked
//   scores wait in shared memory, not in registers, which the bf16 product
//   fills: the one thread whose columns hold a row's label writes its
//   score. The score store writes 16 bytes a
//   lane, each 32-byte sector whole, where V % 4 == 0 (f32: a thread's 4
//   neighbouring columns; bf16: lanes c and c ^ 1 trade a row half of each
//   fragment so that each holds 4 columns of one row), with streaming
//   stores (the scores do not stay in L2); narrower stores only at a ragged
//   V. The store leaves the register tile as it is and waits on nothing.
// - At the block's end the lanes and then the warps that share a row merge
//   their (max, Σ exp) in a fixed order, and the block writes one partial (max,
//   Σ exp(s − max), picked) per (row, slice); xent_merge_kernel combines a
//   row's partials in slice order.
// - Slices (fwd_plan): the vocabulary steps are cut into equal slices so
//   that the grid fills FILL_SMS = 132 SMs (one block an SM): at N = 8192
//   there are only 64 row tiles, so the cut over V fills the card (2 slices:
//   128 blocks); at N = 32768, 256 row tiles and 1 slice.
// - No atomics, fixed merge orders, and a cut that comes from (N, V, dtype)
//   alone: bitwise the same from run to run. Row tiles lie on grid y and
//   continue on grid z past 65535 (grid.cuh); offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>

#include "grid.cuh"
#include "xent_grad.cuh"

namespace {

constexpr int BR = 128;        // rows a block
constexpr int FILL_SMS = 132;  // the H100's SMs: the slice count fills them
constexpr int MAX_SLICES = 1024;
constexpr float LOG2E = 1.4426950408889634f;

// Tiles of one dtype: BV vocabulary columns a step, BK deep stages, S of
// them in the ring; X and W elements of T a stage's x and W tile; a thread's
// R rows × CN columns of the step, WC warps across the columns (LX: the
// lane bits of the threads that share a row).
template <typename T>
struct Fwd;
template <>
struct Fwd<bf16> {
  static constexpr int BV = 256, BK = 64, S = 3, R = 8, CN = 16, WC = 4, LX = 2;
  static constexpr int X = BR * BK, W = BK * BV;
};
template <>
struct Fwd<float> {
  static constexpr int BV = 128, BK = 64, S = 3, R = 8, CN = 8, WC = 2, LX = 3;
  static constexpr int LDX = BK + 4, LDW = BV + 4;  // load_tile's padded rows
  static constexpr int X = BR * LDX, W = BK * LDW;
};

// Shared memory: the ring [S][X + W] of T, the rows' labels and picked
// scores [BR] each, and each thread's running (max, Σ exp) of its R rows
// [R][NT] (in registers they would stay live across the product, and the
// bf16 product needs them all).
template <typename T>
constexpr size_t fwd_smem() {
  return sizeof(T) * Fwd<T>::S * (Fwd<T>::X + Fwd<T>::W) + 2 * sizeof(float) * BR +
         sizeof(float2) * Fwd<T>::R * NT;
}

// Where this thread's accumulators lie in the block's step tile: row i
// (0..R) and column j (0..CN), both from the block's origin.
template <typename T>
struct Place;
template <>
struct Place<bf16> {  // acc[2mt + h][2n + e] = fragment n of m-tile mt, element 2h + e
  static __device__ int row(int i) {
    const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
    return 64 * (w >> 2) + 16 * (i >> 1) + g + 8 * (i & 1);
  }
  static __device__ int col(int j) {
    const int w = threadIdx.x >> 5, c = threadIdx.x & 3;
    return 64 * (w & 3) + 8 * (j >> 1) + 2 * c + (j & 1);
  }
  static __device__ int col0() { return 64 * ((threadIdx.x >> 5) & 3); }  // the warp's
};
template <>
struct Place<float> {
  static __device__ int row(int i) {
    const int w = threadIdx.x >> 5, rg = (threadIdx.x & 31) >> 3;
    return 32 * (w >> 1) + rg + 4 * i;
  }
  static __device__ int col(int j) {
    const int w = threadIdx.x >> 5, cg = threadIdx.x & 7;
    return 64 * (w & 1) + 4 * cg + 32 * (j >> 2) + (j & 3);
  }
  static __device__ int col0() { return 64 * ((threadIdx.x >> 5) & 1); }
};

// ------------------------------------------------------------------ staging

// The x tile [BR][BK] of rows r0.. at k0 and the W tile [BK][BV] of rows
// k0.. at column v0 into one ring stage (load_tile: bf16 swizzled, f32
// row-padded; zeros past N, d and V).
template <typename T>
__device__ __forceinline__ void stage_fwd(T* st, const T* x, const T* w, int r0, int N, int d,
                                          int V, int k0, int v0, bool vx, bool vw) {
  using C = Fwd<T>;
  load_tile<C::BK, BR, NT>(st, x + k0, d, r0, N, d - k0, vx);
  load_tile<C::BV, C::BK, NT>(st + C::X, w + v0, V, k0, d, V - v0, vw);
}

// ----------------------------------------------------------------- products

// d = a·b, a 16×16 bf16, b 16×8 bf16, d 16×8 f32 from zero: mma_bf16
// (mma.cuh) with C = 0 in one register.
__device__ __forceinline__ void mma_bf16_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// One k-step of 16 of the bf16 product: the warp's 4 × 8 fragments. Each
// mma sums its 16 products from zero and the result is added to the
// running f32 sum by a rounded FADD: the tensor cores' own f32 accumulation
// truncates, and chained over d / 16 k-steps it drifted by more than the
// scores' rtol 1e-5 (at d = 2048: 3.1e-5 on elements near 0).
__device__ __forceinline__ void k_step(const bf16* st, int kk, float (&acc)[8][16]) {
  using C = Fwd<bf16>;
  const Lanes l;
  const int w = threadIdx.x >> 5, rw = 64 * (w >> 2), cw = 8 * (w & 3);  // cw in chunks
  const bf16* ws = st + C::X;
  uint32_t a[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
    ldmatrix_x4(a[mt], st + swz<C::BK / 8>(rw + 16 * mt + l.a_row, 2 * kk + l.a_ch));
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, ws + swz<C::BV / 8>(16 * kk + l.t_row, cw + 2 * np + l.t_ch));
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = 2 * np + q;
        float f[4];  // this k-step's 16 terms alone (see above)
        mma_bf16_fresh(f, a[mt], b[2 * q], b[2 * q + 1]);
        acc[2 * mt][2 * n] += f[0], acc[2 * mt][2 * n + 1] += f[1];
        acc[2 * mt + 1][2 * n] += f[2], acc[2 * mt + 1][2 * n + 1] += f[3];
      }
  }
}

// acc += x tile · W tile over the first kd (<= BK) rows of k of one stage
// (past d the tiles hold zeros: only the ragged last stage has kd < BK,
// and only a RAGGED instance, d % BK != 0, holds the loop that stops at
// kd: the branch cost the full stages a few percent in the others).
template <bool RAGGED>
__device__ __forceinline__ void stage_product(const bf16* st, int kd, float (&acc)[8][16]) {
  using C = Fwd<bf16>;
  if (!RAGGED || kd == C::BK) {  // not unrolled: unrolled, the k-steps' fragments and
#pragma unroll 1                 // fresh sums overlap and spill the bf16 registers
    for (int kk = 0; kk < C::BK / 16; ++kk) k_step(st, kk, acc);
  } else {  // the ragged last stage: only the k-steps below d
#pragma unroll 1
    for (int kk = 0; kk < (kd + 15) / 16; ++kk) k_step(st, kk, acc);
  }
}

// One k group of 4 of the f32 product (xp, wp: the thread's x row and W
// column in the stage).
__device__ __forceinline__ void k_group(const float* xp, const float* wp, int k,
                                        float (&acc)[8][8]) {
  using C = Fwd<float>;
  float xv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) load_vec(xv[i], xp + 4 * i * C::LDX + k);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float wv[2][4];
    load_vec(wv[0], wp + (k + e) * C::LDW);
    load_vec(wv[1], wp + (k + e) * C::LDW + 32);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i][e], wv[j >> 2][j & 3], acc[i][j]);
  }
}

// The same in f32, k groups of 4.
template <bool RAGGED>
__device__ __forceinline__ void stage_product(const float* st, int kd, float (&acc)[8][8]) {
  using C = Fwd<float>;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xp = st + (32 * (w >> 1) + (lane >> 3)) * C::LDX;
  const float* wp = st + C::X + 64 * (w & 1) + 4 * (lane & 7);
  if (!RAGGED || kd == C::BK) {
#pragma unroll
    for (int k = 0; k < C::BK; k += 4) k_group(xp, wp, k, acc);
  } else {  // the ragged last stage: only the groups below d
#pragma unroll 1
    for (int k = 0; k < kd; k += 4) k_group(xp, wp, k, acc);
  }
}

// ------------------------------------------------------------- score store

// This thread's scores of one step (columns from v0) into s [N, V]: 16
// bytes a lane where vec (V % 4 == 0), scalars otherwise.
__device__ __forceinline__ void store_scores(float* s, const float (&acc)[8][8], int r0, int v0,
                                             int N, int V, bool vec) {
  using P = Place<float>;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + P::row(i);
    if (row >= N) continue;
    float* out = s + static_cast<long long>(row) * V + v0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = P::col(4 * h);
      if (vec) {
        if (v0 + col < V)
          __stcs(reinterpret_cast<float4*>(out + col),
                 make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                             acc[i][4 * h + 3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (v0 + col + e < V) __stcs(out + col + e, acc[i][4 * h + e]);
      }
    }
  }
}

// bf16 fragments: with vec, lanes c and c ^ 1 trade half of each fragment
// (the even lane keeps row g and takes its partner's columns of it, the odd
// one row g + 8), so each stores 4 neighbouring columns of one row.
__device__ __forceinline__ void store_scores(float* s, const float (&acc)[8][16], int r0,
                                             int v0, int N, int V, bool vec) {
  using P = Place<bf16>;
  const bool odd = threadIdx.x & 1;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (vec) {
        const float g0 = acc[2 * mt][2 * n], g1 = acc[2 * mt][2 * n + 1];  // row g
        const float h0 = acc[2 * mt + 1][2 * n], h1 = acc[2 * mt + 1][2 * n + 1];  // g + 8
        const float k0 = odd ? h0 : g0, k1 = odd ? h1 : g1;
        const float t0 = __shfl_xor_sync(0xffffffffu, odd ? g0 : h0, 1);
        const float t1 = __shfl_xor_sync(0xffffffffu, odd ? g1 : h1, 1);
        const int row = r0 + P::row(2 * mt + odd);
        const int col = P::col(2 * n) - 2 * odd;
        if (row < N && v0 + col < V)
          __stcs(reinterpret_cast<float4*>(s + static_cast<long long>(row) * V + v0 + col),
                 odd ? make_float4(t0, t1, k0, k1) : make_float4(k0, k1, t0, t1));
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + P::row(2 * mt + h);
          if (row >= N) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = v0 + P::col(2 * n + e);
            if (col < V)
              __stcs(s + static_cast<long long>(row) * V + col, acc[2 * mt + h][2 * n + e]);
          }
        }
      }
    }
}

// -------------------------------------------------------------- the state

// (m, l) merged with (mo, lo): the larger max, the sums rescaled to it.
__device__ __forceinline__ void merge_state(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;  // both empty
  l = l * exp2f((m - mn) * LOG2E) + lo * exp2f((mo - mn) * LOG2E);
  m = mn;
}

// ------------------------------------------------------------ kernels 10, 11

// Block (vocabulary slice blockIdx.x, row tile grid_y_index()): rows r0 ..
// r0 + BR over the slice's `per` steps (fewer in the last slice). Writes
// the partials part[0|1|2][slice][row] = (max, Σ exp(s − max), picked)
// and, with SAVE, the slice's scores into s_out [N, V]. RAGGED: d is no
// multiple of BK.
template <typename T, bool SAVE, bool RAGGED>
__global__ void __launch_bounds__(NT, 1)
xent_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                const int* __restrict__ labels, float* __restrict__ s_out,
                float* __restrict__ part, int N, int d, int V, int per, int vx, int vw,
                int vs) {
  using C = Fwd<T>;
  using P = Place<T>;
  constexpr int S = C::S, STAGE = C::X + C::W, R = C::R, CN = C::CN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);           // [S][STAGE]
  int* labs = reinterpret_cast<int*>(ring + S * STAGE);  // [BR]: -1 past N or V
  float* picks = reinterpret_cast<float*>(labs + BR);    // [BR]
  float2* state = reinterpret_cast<float2*>(picks + BR);  // [R][NT]: (max, Σ exp)

  const int r0 = grid_y_index() * BR;
  if (r0 >= N) return;  // past the row tiles in the last z slice
  const int step0 = blockIdx.x * per;
  const int steps = min(per, (V + C::BV - 1) / C::BV - step0);
  const int kt_n = (d + C::BK - 1) / C::BK;
  const int total = steps * kt_n;  // ring stages: (step, k stage), k fastest

  for (int i = 0; i < S - 1; ++i) {  // the ring's first S − 1 stages
    if (i < total)
      stage_fwd<T>(ring + i * STAGE, x, w, r0, N, d, V, (i % kt_n) * C::BK,
                   (step0 + i / kt_n) * C::BV, vx, vw);
    cp_async_commit();
  }

  // A row's label column lies in one step of one slice and there in one
  // thread's columns: that thread alone writes the row's picked score.
  if (threadIdx.x < BR) {
    const int row = r0 + threadIdx.x;
    const int y = row < N ? labels[row] : -1;
    labs[threadIdx.x] = y < V ? y : -1;  // a label past V picks no (masked) column
    picks[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) state[i * NT + threadIdx.x] = make_float2(-INFINITY, 0.f);

  float acc[R][CN];
  int kt = 0, v0 = step0 * C::BV;
  int ka = (S - 1) % kt_n, va = (step0 + (S - 1) / kt_n) * C::BV;  // the stage ahead
  for (int it = 0; it < total; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage `it` landed; stage it − 1 is free
    if (it + S - 1 < total)
      stage_fwd<T>(ring + ((it + S - 1) % S) * STAGE, x, w, r0, N, d, V, ka * C::BK, va, vx,
                   vw);
    cp_async_commit();
    if (++ka == kt_n) ka = 0, va += C::BV;

    if (kt == 0) {  // the step's accumulators start from the bias
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = v0 + P::col(j);
        const float bj = col < V ? to_f32(b[col]) : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = bj;
      }
    }
    stage_product<RAGGED>(ring + (it % S) * STAGE, min(C::BK, d - kt * C::BK), acc);
    if (++kt < kt_n) continue;

    // The step's end: mask, store, fold into the running state.
    kt = 0;
    if (v0 + C::BV > V) {
#pragma unroll
      for (int j = 0; j < CN; ++j)
        if (v0 + P::col(j) >= V) {
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][j] = -INFINITY;
        }
    }
    if (SAVE) store_scores(s_out, acc, r0, v0, N, V, vs);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = acc[i][0];
#pragma unroll
      for (int j = 1; j < CN; ++j) mx = fmaxf(mx, acc[i][j]);
      const float2 ml = state[i * NT + threadIdx.x];
      const float mn = fmaxf(ml.x, mx);
      const float off = (mn == -INFINITY ? 0.f : mn) * LOG2E;  // a row with no column yet
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) sum += exp2f(fmaf(acc[i][j], LOG2E, -off));
      const float scale = exp2f(fmaf(ml.x, LOG2E, -off));  // the old sum to the new max
      state[i * NT + threadIdx.x] = make_float2(mn, fmaf(ml.y, scale, sum));
      const int at = labs[P::row(i)] - v0 - P::col0();  // its column in the warp's 64
      if (at >= 0 && at < 64) {
#pragma unroll
        for (int j = 0; j < CN; ++j)
          if (P::col(j) - P::col0() == at) picks[P::row(i)] = acc[i][j];
      }
    }
    v0 += C::BV;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' merged states now

  // Lanes that share a row, then the warps that do, in a fixed order.
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float2 ml = state[i * NT + threadIdx.x];
    m[i] = ml.x, l[i] = ml.y;
#pragma unroll
    for (int o = 0; o < C::LX; ++o) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], 1 << o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], 1 << o);
      merge_state(m[i], l[i], mo, lo);
    }
  }
  float* red = reinterpret_cast<float*>(smem_raw);  // [WC][2][BR]
  const int wc = P::col0() / 64;
  if ((threadIdx.x & ((1 << C::LX) - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float* at = red + wc * 2 * BR + P::row(i);
      at[0] = m[i], at[BR] = l[i];
    }
  }
  __syncthreads();
  const int t = threadIdx.x, row = r0 + t;
  if (t < BR && row < N) {
    float mm = red[t], ll = red[BR + t];
    for (int c = 1; c < C::WC; ++c)
      merge_state(mm, ll, red[c * 2 * BR + t], red[(c * 2 + 1) * BR + t]);
    const long long plane = static_cast<long long>(gridDim.x) * N;
    const long long off = static_cast<long long>(blockIdx.x) * N + row;
    part[off] = mm;
    part[plane + off] = ll;
    part[2 * plane + off] = picks[t];
  }
}

// One thread per row: merge the vocab tiles' partials in tile order.
__global__ void xent_merge_kernel(const float* __restrict__ part, int N,
                                  int n_tiles, float* __restrict__ lse,
                                  float* __restrict__ picked) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const long long plane = static_cast<long long>(n_tiles) * N;
  float m = -INFINITY;
  for (int t = 0; t < n_tiles; ++t) m = fmaxf(m, part[static_cast<long long>(t) * N + row]);
  float l = 0.f, z = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const long long at = static_cast<long long>(t) * N + row;
    l += part[plane + at] * expf(part[at] - m);
    z += part[2 * plane + at];
  }
  lse[row] = m + logf(l);
  picked[row] = z;
}

// ------------------------------------------------------------------ launch

// How (N, V) is cut in one dtype (ops/xent_kernel.py `fwd_plan` mirrors
// it): the vocabulary steps in `slices` equal slices of `per` steps (the
// last may be shorter), the count that takes the fewest step times over
// the grid's waves on FILL_SMS SMs, one block an SM, a step added for each
// block's ring fill and merge; the fewest slices among equals.
struct Plan {
  long long row_tiles, steps, slices, per;
};

template <typename T>
Plan plan_fwd(int N, int V) {
  Plan p{(N + BR - 1LL) / BR, (V + Fwd<T>::BV - 1LL) / Fwd<T>::BV, 1, 0};
  p.per = p.steps;
  long long best = -1;
  for (long long s = 1; s <= p.steps && s <= MAX_SLICES; ++s) {
    const long long per = (p.steps + s - 1) / s;
    if ((p.steps + per - 1) / per != s) continue;  // no equal cut into s slices
    const long long cost = (p.row_tiles * s + FILL_SMS - 1) / FILL_SMS * (per + 1);
    if (best < 0 || cost < best) best = cost, p.slices = s, p.per = per;
  }
  return p;
}

template <typename T, bool SAVE, bool RAGGED>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, const int* labels, float* s,
                       float* part, float* lse, float* picked, int N, int d, int V,
                       cudaStream_t st) {
  constexpr size_t smem = fwd_smem<T>();
  cudaError_t err = set_smem_once<xent_fwd_kernel<T, SAVE, RAGGED>>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const Plan p = plan_fwd<T>(N, V);
  const dim3 grid = grid_xyz(static_cast<unsigned>(p.slices), p.row_tiles);
  xent_fwd_kernel<T, SAVE, RAGGED><<<grid, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), labels, s,
      part, N, d, V, static_cast<int>(p.per), int(vec_rows<T>(x, d)), int(vec_rows<T>(w, V)),
      int(SAVE && vec_rows<float>(s, V)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_merge_kernel<<<static_cast<unsigned>((N + 255LL) / 256), 256, 0, st>>>(
      part, N, static_cast<int>(p.slices), lse, picked);
  return cudaGetLastError();
}

template <typename T, bool SAVE>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, const int* labels, float* s,
                       float* part, float* lse, float* picked, int N, int d, int V,
                       cudaStream_t st) {
  const auto launch = d % Fwd<T>::BK ? launch_fwd<T, SAVE, true> : launch_fwd<T, SAVE, false>;
  return launch(x, w, b, labels, s, part, lse, picked, N, d, V, st);
}

}  // namespace

extern "C" {

// How the forward cuts (N, d, V) in one dtype (ops/xent_kernel.py
// `fwd_plan` mirrors it): out = (rows a block, vocabulary columns a step,
// vocabulary steps, slices, steps a slice, blocks). The caller sizes the
// partials scratch [3, slices, N] f32 with it.
int xent_fwd_plan(int N, int d, int V, int is_bf16, long long* out) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  const Plan p = is_bf16 ? plan_fwd<bf16>(N, V) : plan_fwd<float>(N, V);
  out[0] = BR, out[1] = is_bf16 ? Fwd<bf16>::BV : Fwd<float>::BV, out[2] = p.steps;
  out[3] = p.slices, out[4] = p.per, out[5] = p.row_tiles * p.slices;
  return cudaSuccess;
}

// x [N, d], w [d, V], b [V] contiguous, all f32 (bf16 = 0) or all bf16
// (bf16 = 1); labels [N] int32; part scratch as above; lse, picked [N] f32.
int xent_fwd(const void* x, const void* w, const void* b, const int* labels,
             float* part, float* lse, float* picked, int N, int d, int V,
             int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16, false>(x, w, b, labels, nullptr, part, lse, picked, N, d, V, st)
              : launch_fwd<float, false>(x, w, b, labels, nullptr, part, lse, picked, N, d, V, st);
}

// As xent_fwd, and also the f32 scores s [N, V] (contiguous).
int xent_fwd_save(const void* x, const void* w, const void* b,
                  const int* labels, float* s, float* part, float* lse,
                  float* picked, int N, int d, int V, int bf16, void* stream) {
  if (!shape_ok(N, d, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16, true>(x, w, b, labels, s, part, lse, picked, N, d, V, st)
              : launch_fwd<float, true>(x, w, b, labels, s, part, lse, picked, N, d, V, st);
}

const char* xent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
