// Device code shared by the two backward pairs of the fused linear
// cross-entropy on Hopper (sm_90a): the lean kernels 14, 15 (xent_lean.cu),
// which recompute the scores, and the saved-scores kernels 12, 13
// (xent_saved.cu), which read them; the forward (xent.cu) takes its block
// size, Lanes and the host checks from here. Both pairs contract dlog with
// W (dX) or x (dW) over a 512-column chunk of d a block:
// - the shared-memory layouts of the chunk's operand tiles (f32 x
//   row-padded to F_LDX, f32 W swizzled by wsw, bf16 both by swz) and the
//   staging of the x rows (stage_x);
// - the f32 gradient products on the CUDA cores, 8×8 outputs a thread from
//   a dlog tile P [F_BR][F_LDS] (grad_dx_f32, grad_dw_f32);
// - the lanes' places in bf16 mma.sync fragments read by ldmatrix (Lanes);
// - dlog of one element, and the sum of dW's row ranges in range order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;     // threads a block
constexpr int CW = 512;     // d columns a block owns (a chunk)
constexpr int LR = 65536;   // dW: rows of one range

// Valid width of chunk m.
__device__ __forceinline__ int chunk_width(int d, int m) {
  const int w = d - m * CW;
  return w < CW ? w : CW;
}

// The f32 tiles of both pairs: F_BR rows × F_BV vocabulary columns of dlog
// a step, P row-padded to F_LDS; x tiles [rows][F_LDX].
constexpr int F_BR = 32, F_BV = 32, F_LDS = F_BV + 4;
constexpr int F_LDX = CW + 4;

// The f32 W tile [CW][32]: the 16-byte chunk c of row k lies at chunk
// c ^ ((k >> 2) & 7), so that 8 lanes reading rows 4 apart (the score
// product) or 8 rows that differ in (k >> 2) & 7 (the dX gradient) at one
// chunk hit 8 different bank groups.
__device__ __forceinline__ int wsw(int k, int c) { return k * 32 + 4 * (c ^ ((k >> 2) & 7)); }

// Staging of the x rows [BR][CW] of chunk m from row r0 (load_tile,
// mma.cuh: f32 row-padded, bf16 swizzled; zeros past the valid rows and
// columns).
template <typename T, int BR>
__device__ __forceinline__ void stage_x(T* s, const T* x, int r0, int rows, int d, int m,
                                        bool vec) {
  load_tile<CW, BR, NT>(s, x + m * CW, d, r0, rows, d - m * CW, vec);
}

// ------------------------------------------------------------- f32 products

// dX += P·Wᵀ on the 8×8 tile a thread: rows rg + 4i, chunk columns
// 64·warp + 4·cg + (jj & 3) + 32·(jj >> 2) (lane = 8·rg + cg), so that the
// 8 lanes of a quarter warp read W rows that differ in (j >> 2) & 7. Warps
// past the chunk's width hw idle.
__device__ __forceinline__ int dx_col(int warp, int cg, int jj) {
  return 64 * warp + 4 * cg + (jj & 3) + 32 * (jj >> 2);
}
__device__ __forceinline__ void grad_dx_f32(const float* p, const float* ws, int hw,
                                            float (&acc)[64]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;
  if (warp * 64 >= hw) return;
#pragma unroll 2
  for (int c = 0; c < F_BV; c += 4) {
    float pv[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) load_vec(pv[i], p + (rg + 4 * i) * F_LDS + c);
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
  const int cg = threadIdx.x & 3, jg = threadIdx.x >> 2;
  const bool hi = 256 + 4 * jg < hw;
  if (4 * jg >= hw) return;
#pragma unroll 4
  for (int r = 0; r < F_BR; ++r) {
    float xv[2][4], pv[2][4];
    load_vec(xv[0], xs + r * F_LDX + 4 * jg);
    load_vec(pv[0], p + r * F_LDS + 4 * cg);
    load_vec(pv[1], p + r * F_LDS + 16 + 4 * cg);
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

// -------------------------------------------------------------------- dlog

__device__ __forceinline__ float dlog_of(float s, float lse, int col, int label, float inv_n) {
  return (expf(s - lse) - (col == label ? 1.f : 0.f)) * inv_n;
}

// ------------------------------------------------------------- range sum

// dW [d, V] in T and db [V] from the ranges' f32 partials, each element
// summed over the ranges in order (one thread per element: bitwise
// repeatable).
template <typename T>
__global__ void xent_dw_range_sum_kernel(const float* __restrict__ part,
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

// ------------------------------------------------------------------- host

// Launch the range sum of `ranges` partial planes into dw and db.
template <typename T>
cudaError_t launch_range_sum(const float* part, const float* db_part, void* dw, float* db,
                             int ranges, int d, int V, cudaStream_t st) {
  const long long elems = static_cast<long long>(d) * V;
  xent_dw_range_sum_kernel<T><<<static_cast<unsigned>((elems + 255) / 256), 256, 0, st>>>(
      part, db_part, static_cast<T*>(dw), db, ranges, d, V);
  return cudaGetLastError();
}

int n_ranges(int N) { return static_cast<int>((N + static_cast<long long>(LR) - 1) / LR); }

template <typename T>
bool vec_rows(const void* p, long long stride) {
  return aligned16(p) && stride % (16 / sizeof(T)) == 0;
}

bool shape_ok(int N, int d, int V) { return N > 0 && V > 0 && d > 0; }

}  // namespace
