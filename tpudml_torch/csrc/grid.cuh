// Grid y holds at most 65535 blocks. The kernels that lay row tiles (or the
// (batch, head) pairs) on grid y continue past that count on grid z, y
// fastest: a launch that fits grid y is the same 2-D grid as before (z = 1,
// same block order), and one that does not still launches. The last z slice
// may hold indices past the count, which the kernel skips or masks.

#pragma once

#include <cuda_runtime.h>

constexpr long long GRID_Y_MAX = 65535;

// A grid of x blocks by `count` y indices, spilled over grid z.
inline dim3 grid_xyz(unsigned x, long long count) {
  const long long y = count < GRID_Y_MAX ? count : GRID_Y_MAX;
  return dim3(x, static_cast<unsigned>(y),
              static_cast<unsigned>((count + GRID_Y_MAX - 1) / GRID_Y_MAX));
}

// The block's index along the spilled y axis, in 32 bits (< 2³¹ for any
// int count).
__device__ __forceinline__ int grid_y_index() {
  return static_cast<int>(blockIdx.y + 65535u * blockIdx.z);
}
