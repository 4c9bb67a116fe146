// PTX wrappers for the port's tensor-core and async-copy kernels on Hopper
// (sm_90a): warp-level bf16 products (`mma.sync` m16n8k16, f32 sums),
// operand loads from shared memory (`ldmatrix`, plain and transposed), and
// 16- or 4-byte global-to-shared copies (`cp.async`) that zero-fill what
// lies past an edge, plus the XOR swizzle that keeps `ldmatrix` free of
// bank conflicts on row-major bf16 tiles.
//
// Fragment layouts of m16n8k16 (g = lane / 4, c = lane % 4):
//   A 16×16 row-major, 4 regs of bf16x2: (g, 2c..2c+1), (g+8, 2c..),
//     (g, 2c+8..), (g+8, 2c+8..);
//   B 16×8 (k × n), 2 regs: (k = 2c..2c+1, n = g), (k = 2c+8.., n = g);
//   C/D 16×8 f32, 4 floats: (g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1).
// Two neighbouring C tiles (columns 8j.. and 8j+8..) packed to bf16 are the
// A fragment of a k-step of 16 over those columns, so a product's result
// feeds the next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8×8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and r[i] receives this lane's pair of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The same, each matrix transposed on the way into registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a·b, a 16×16 bf16, b 16×8 bf16, d 16×8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even) in one register, `lo` in the
// low half (the lower column of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, or zero when !valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of 16-byte chunk `c` of row `r` in a row-major bf16 tile of
// NCH chunks a row (NCH = width / 8), the chunk index XOR-swizzled so that
// the 8 row addresses of one `ldmatrix` matrix fall in 8 different 16-byte
// bank groups: with NCH >= 8 by r % 8; with NCH = 4 (two rows a 128-byte
// line) by (r / 2) % 4.
template <int NCH>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(NCH == 4 || NCH % 8 == 0, "tile width must be 32 or a multiple of 64");
  const int x = NCH >= 8 ? (r & 7) : ((r >> 1) & 3);
  return (r * NCH + (c ^ x)) * 8;
}

// Two neighbouring outputs of a row, stored at once (p 8- or 4-byte aligned).
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Raise KERNEL's dynamic shared-memory limit to `bytes` once per device
// (the runtime call costs more than a small launch).
template <auto KERNEL>
cudaError_t set_smem_once(int bytes) {
  static unsigned long long done = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// Whether 16-byte copies may start at p.
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Staging of attention operands: ROWS rows of a [*, D] operand (row stride
// st elements, unit stride along D) from row t0 into a shared tile of DP
// columns, by NT threads; zeros past T and past D. With `vec` (base and
// strides 16-byte aligned, D a multiple of 16 bytes) each 16-byte chunk is
// one cp.async (the caller commits and waits); otherwise scalar loads and
// stores. bf16 tiles are [ROWS][DP], swizzled for ldmatrix (swz).
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          long long st, int t0, int T, int D, bool vec) {
  constexpr int NCH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * NCH; i += NT) {
    const int r = i / NCH, c = i % NCH;
    const int t = t0 + r;
    __nv_bfloat16* dst = s + swz<NCH>(r, c);
    const bool row_ok = t < T;
    const __nv_bfloat16* src = g + (row_ok ? t * st : 0) + c * 8;
    if (vec) {
      const bool ok = row_ok && c * 8 < D;
      cp_async_16(dst, ok ? src : g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = row_ok && c * 8 + e < D ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// f32 tiles are row-major [ROWS][DP + 4]: rows padded by 16 bytes, so float4
// reads of 8 consecutive rows at one column hit 8 different bank groups.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* s, const float* g, long long st,
                                          int t0, int T, int D, bool vec) {
  constexpr int NCH = DP / 4, LD = DP + 4;
  for (int i = threadIdx.x; i < ROWS * NCH; i += NT) {
    const int r = i / NCH, c = i % NCH;
    const int t = t0 + r;
    float* dst = s + r * LD + c * 4;
    const bool row_ok = t < T;
    const float* src = g + (row_ok ? t * st : 0) + c * 4;
    if (vec) {
      const bool ok = row_ok && c * 4 < D;
      cp_async_16(dst, ok ? src : g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = row_ok && c * 4 + e < D ? src[e] : 0.f;
    }
  }
}

// x[0..N) = p[0..N) as one float4 (N = 4) or float2 (N = 2) shared-memory load.
template <int N>
__device__ __forceinline__ void load_vec(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  }
}
