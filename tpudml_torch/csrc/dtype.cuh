// Storage-type helpers shared by the port's kernels: every kernel computes in
// f32 and stores either f32 or bf16. A bf16 operand is widened on load (exact),
// a value that the TPU kernel rounds to the operand dtype before a product is
// rounded with round_to<E> (round to nearest even), and a result is narrowed
// once on store.

#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to E's precision, as f32 (the identity for E = float).
template <typename E>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<E>(v)); }
