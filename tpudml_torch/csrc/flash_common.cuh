// What the flash forward (flash_fwd.cu, kernel 1), dQ (flash_bwd.cu,
// kernel 2) and dK/dV (flash_dkdv.cu, kernel 3) share: their launch
// arguments, the causal mask and tile walk, the test for 16-byte copies,
// and the ladder of head-dim instances.

#pragma once

#include <cuda_runtime.h>

#include <initializer_list>
#include <type_traits>

#include "mma.cuh"

constexpr float LOG2E = 1.4426950408889634f;

// (batch, time, head) strides of a [B, T, H, D] operand, in elements; the
// head-dim stride is 1.
struct Strides {
  long long b, t, h;
};

struct Args {
  int BH, T, H, D, causal, k_shift, vec;
  float scale;       // 1/√D of the true D
  float scale_log2;  // 1/√D · log2 e
  Strides qs, ks, vs, dos;  // dos: dO's, in the backward
};

// Whether 16-byte copies may stage every operand: D a whole number of
// 16-byte chunks, and each base pointer and stride 16-byte aligned.
template <typename E>
inline bool vec_ok(int D, std::initializer_list<const E*> ptrs,
                   std::initializer_list<Strides> strides) {
  constexpr int CH = 16 / sizeof(E);  // elements a 16-byte copy
  bool ok = D % CH == 0;
  for (const E* p : ptrs) ok = ok && aligned16(p);
  for (const Strides& st : strides) ok = ok && st.b % CH == 0 && st.t % CH == 0 && st.h % CH == 0;
  return ok;
}

// Whether query q_pos sees key k_pos: both lie inside T and, when causal,
// q_pos >= k_pos + k_shift (local positions).
__device__ __forceinline__ bool visible(const Args& a, int q_pos, int k_pos) {
  return q_pos < a.T && k_pos < a.T && (!a.causal || q_pos >= k_pos + a.k_shift);
}

// Whether the tile of queries [q0, q0 + bq) × keys [k0, k0 + bk) needs the
// elementwise mask: it reaches past T on either axis, or its first query
// does not see its last key.
__device__ __forceinline__ bool needs_mask(const Args& a, int q0, int bq, int k0, int bk) {
  return q0 + bq > a.T || k0 + bk > a.T || (a.causal && k0 + bk - 1 + a.k_shift > q0);
}

// K tiles of width bk that the Q tile [q0, q0 + bq) visits: all of them, or
// up to the one that holds the last key its last row sees (none if that
// row sees no key).
__device__ __forceinline__ int visited_k_tiles(const Args& a, int q0, int bq, int bk) {
  const int n = (a.T + bk - 1) / bk;
  if (!a.causal) return n;
  const int last_key = min(q0 + bq, a.T) - 1 - a.k_shift;
  return last_key < 0 ? 0 : min(n, last_key / bk + 1);
}

// launch(std::integral_constant<int, DP>) for the instance width DP (32, 64,
// 128, 256) that holds head dim D, the least that is >= D; a D outside
// [1, MAX_DP] is refused.
template <int MAX_DP, typename F>
cudaError_t by_head_dim(int D, F&& launch) {
  static_assert(MAX_DP == 128 || MAX_DP == 256, "instances are 32, 64, 128[, 256]");
  if (D < 1 || D > MAX_DP) return cudaErrorInvalidValue;
  if (D <= 32) return launch(std::integral_constant<int, 32>{});
  if (D <= 64) return launch(std::integral_constant<int, 64>{});
  if (D <= 128) return launch(std::integral_constant<int, 128>{});
  if constexpr (MAX_DP == 256) return launch(std::integral_constant<int, 256>{});
  return cudaErrorInvalidValue;
}
