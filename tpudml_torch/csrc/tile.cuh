// The register-tiled product on the CUDA cores of the grouped dW
// (grouped_dw.cu, kernel 16): a block of 256 threads owns a 128×128 f32
// output tile; each thread keeps 8×8 accumulators (rows ty + 16·i, columns
// tx + 16·j, tx = tid % 16, ty = tid / 16) and the contraction axis is
// walked BK deep at a time through shared-memory stages As [BK][LDA] and Bs
// [BK][LDB] (rows padded by 4 floats so transposed stores do not collide in
// a bank).

#pragma once

constexpr int BM = 128;       // output tile rows
constexpr int BN = 128;       // output tile columns (the forward's vocab tile)
constexpr int BK = 8;         // contraction depth of one shared-memory stage
constexpr int TM = 8;         // accumulator rows per thread
constexpr int TN = 8;         // accumulator columns per thread
constexpr int NT = 256;       // threads per block: 16 × 16
constexpr int LDA = BM + 4;   // padded stage rows
constexpr int LDB = BN + 4;
constexpr int PER = BK * BM / NT;  // staged elements per thread and operand

// acc[i][j] += Σ_kk As[kk][ty + 16·i] · Bs[kk][tx + 16·j]
__device__ __forceinline__ void mma_stage(const float* __restrict__ As,
                                          const float* __restrict__ Bs, int ty,
                                          int tx, float (&acc)[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk * LDA + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk * LDB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}
