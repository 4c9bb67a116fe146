// Fused greedy decode head, f32 and int8 weights, for Hopper (sm_90a).
//
// Replaces: tpudml/ops/decode_head.py `_head_kernel` (f32 weights) and
// `_head_kernel_int8` (int8 codes + per-column f32 scales), both launched by
// `_head_call`. For x [B, d], W [d, V] and bias [V] it returns, per row, the
// greedy token argmax(x·W + b) (first occurrence on ties), the max logit and
// the log-sum-exp, without writing the [B, V] logits to device memory. The
// int8 twin dequantizes each weight as `float(q) * scale[col]`, the op order
// of serve/fleet/quant.py `_dequant_kernel`.
//
// What bounds it on this card: reading W. At the serving shape (B = 8,
// d = 512, V = 32768) W is 64 MiB in f32 (16 MiB in int8) against 2·B·d·V =
// 268 MFLOP, about 4 FLOP per byte, far below the card's f32 balance point,
// so the floor is W's bytes over the memory rate.
//
// Design: the TPU kernel walks vocab tiles in order on one core and carries
// the running (max, normalizer, argmax) from tile to tile. Here vocab tiles
// run in parallel and nothing carries between blocks, so the work is split
// into two passes:
//   pass 1: one block per 256-column vocab tile, one column per thread,
//           handling ALL B rows (in register groups of 8) so that W is read
//           once per group, coalesced along V. It writes each tile's max,
//           first-occurrence column of that max, and Σ exp(s − max).
//   pass 2: one thread per row merges the tiles IN TILE ORDER with a strict
//           `>`, which reproduces jnp.argmax's first-occurrence rule exactly
//           (an equal later tile never steals the pick), then
//           lse = M + log Σ_j l_j·exp(m_j − M).
// x sits in shared memory (rows padded with zeros to the group size). Where
// one 8-row group does not fit the X_STAGE_BYTES stage (d > 6400), the
// CHUNKED instance stages each group XC columns of d at a time and keeps the
// group's dot products in registers across the chunks: the same products
// summed in the same order, so the same result; the caller then passes the
// whole batch in one launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TV = 256;          // vocab columns per block (one per thread)
constexpr int NWARP = TV / 32;
constexpr int GROUP = 8;         // rows accumulated in registers per pass over W
constexpr int X_STAGE_BYTES = 200 * 1024;  // x's shared-memory stage
constexpr int XC = 1024;         // CHUNKED: columns of d staged at a time

struct ArgMax {
  float v;
  int i;
};

// Larger value wins; on equal values the smaller column wins (first
// occurrence). -inf entries (columns past V) never beat a finite one.
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ ArgMax warp_argmax(ArgMax a) {
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(0xffffffffu, a.v, o), __shfl_xor_sync(0xffffffffu, a.i, o)};
    a = better(a, b);
  }
  return a;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename W>
__device__ __forceinline__ float load_w(const W* w, long long idx, float scale);

template <>
__device__ __forceinline__ float load_w<float>(const float* w, long long idx, float) {
  return w[idx];
}

template <>
__device__ __forceinline__ float load_w<int8_t>(const int8_t* w, long long idx, float scale) {
  return static_cast<float>(w[idx]) * scale;
}

template <typename W, bool CHUNKED>
__global__ void __launch_bounds__(TV)
head_tile_kernel(const float* __restrict__ x, const W* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 int B, int d, int V, float* __restrict__ tile_max,
                 int* __restrict__ tile_idx, float* __restrict__ tile_sum) {
  extern __shared__ float xs[];  // [round_up(B, GROUP)][d], CHUNKED [GROUP][XC]
  __shared__ float red_v[NWARP];
  __shared__ int red_i[NWARP];
  __shared__ float red_s[NWARP];
  __shared__ float tile_m;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (!CHUNKED) {
    const int b_pad = (B + GROUP - 1) / GROUP * GROUP;
    for (int i = tid; i < b_pad * d; i += TV) xs[i] = i < B * d ? x[i] : 0.f;
    __syncthreads();
  }

  const int col = blockIdx.x * TV + tid;
  const bool valid = col < V;
  const float sc = (scale != nullptr && valid) ? scale[col] : 1.f;
  const float bc = valid ? bias[col] : 0.f;

  for (int b0 = 0; b0 < B; b0 += GROUP) {
    float acc[GROUP];
#pragma unroll
    for (int r = 0; r < GROUP; ++r) acc[r] = 0.f;
    if (CHUNKED) {
      for (int k0 = 0; k0 < d; k0 += XC) {
        const int n = min(XC, d - k0);
        __syncthreads();  // the previous chunk is consumed
        for (int i = tid; i < GROUP * XC; i += TV) {
          const int r = i / XC, kk = i % XC;
          xs[i] = b0 + r < B && kk < n
                      ? x[static_cast<long long>(b0 + r) * d + k0 + kk] : 0.f;
        }
        __syncthreads();
        if (valid) {
#pragma unroll 4
          for (int kk = 0; kk < n; ++kk) {
            const float wv = load_w<W>(w, static_cast<long long>(k0 + kk) * V + col, sc);
#pragma unroll
            for (int r = 0; r < GROUP; ++r) acc[r] += xs[r * XC + kk] * wv;
          }
        }
      }
    } else if (valid) {
      const float* xg = xs + b0 * d;
#pragma unroll 4
      for (int kk = 0; kk < d; ++kk) {
        const float wv = load_w<W>(w, static_cast<long long>(kk) * V + col, sc);
#pragma unroll
        for (int r = 0; r < GROUP; ++r) acc[r] += xg[r * d + kk] * wv;
      }
    }
    for (int r = 0; r < GROUP && b0 + r < B; ++r) {
      const float s = valid ? acc[r] + bc : -INFINITY;
      ArgMax a = warp_argmax(ArgMax{s, valid ? col : 0x7fffffff});
      if (lane == 0) {
        red_v[warp] = a.v;
        red_i[warp] = a.i;
      }
      __syncthreads();
      if (tid == 0) {
        ArgMax t{red_v[0], red_i[0]};
        for (int k = 1; k < NWARP; ++k) t = better(t, ArgMax{red_v[k], red_i[k]});
        tile_m = t.v;
        tile_max[static_cast<long long>(blockIdx.x) * B + b0 + r] = t.v;
        tile_idx[static_cast<long long>(blockIdx.x) * B + b0 + r] = t.i;
      }
      __syncthreads();
      const float e = valid ? expf(s - tile_m) : 0.f;
      const float ws = warp_sum(e);
      if (lane == 0) red_s[warp] = ws;
      __syncthreads();
      if (tid == 0) {
        float t = 0.f;
        for (int k = 0; k < NWARP; ++k) t += red_s[k];
        tile_sum[static_cast<long long>(blockIdx.x) * B + b0 + r] = t;
      }
      __syncthreads();
    }
  }
}

__global__ void head_merge_kernel(const float* __restrict__ tile_max,
                                  const int* __restrict__ tile_idx,
                                  const float* __restrict__ tile_sum, int B,
                                  int n_tiles, int* __restrict__ tok,
                                  float* __restrict__ max_logit,
                                  float* __restrict__ lse) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float m = -INFINITY;
  int idx = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const float mj = tile_max[static_cast<long long>(j) * B + b];
    if (mj > m) {  // strictly greater: an equal later tile keeps the earlier pick
      m = mj;
      idx = tile_idx[static_cast<long long>(j) * B + b];
    }
  }
  float l = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const long long at = static_cast<long long>(j) * B + b;
    l += tile_sum[at] * expf(tile_max[at] - m);
  }
  tok[b] = idx;
  max_logit[b] = m;
  lse[b] = m + logf(l);
}

size_t x_smem_bytes(int B, int d) {
  return sizeof(float) * static_cast<size_t>((B + GROUP - 1) / GROUP * GROUP) * d;
}

// Whether one 8-row group of x misses the stage, so that the CHUNKED
// instance walks d.
bool chunked(int d) { return x_smem_bytes(GROUP, d) > X_STAGE_BYTES; }

template <typename W>
cudaError_t launch(const float* x, const W* w, const float* scale,
                   const float* bias, int B, int d, int V, float* tile_max,
                   int* tile_idx, float* tile_sum, int* tok, float* max_logit,
                   float* lse, cudaStream_t stream) {
  const bool chunk = chunked(d);
  if (!chunk && x_smem_bytes(B, d) > X_STAGE_BYTES) return cudaErrorInvalidValue;
  const size_t smem = chunk ? sizeof(float) * GROUP * XC : x_smem_bytes(B, d);
  const auto kernel = chunk ? head_tile_kernel<W, true> : head_tile_kernel<W, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + TV - 1) / TV;
  kernel<<<n_tiles, TV, smem, stream>>>(
      x, w, scale, bias, B, d, V, tile_max, tile_idx, tile_sum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head_merge_kernel<<<(B + 31) / 32, 32, 0, stream>>>(
      tile_max, tile_idx, tile_sum, B, n_tiles, tok, max_logit, lse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns per pass-1 tile: the caller sizes the [n_tiles, B] scratch with it.
int decode_head_tile_width() { return TV; }

// x [B, d], w [d, V], bias [V]; scratch tile_* [ceil(V / TV), B]; outputs
// tok, max_logit, lse [B]. All contiguous, all on the current device. Up to
// d = 6400 the B rows must fit the x stage (round_up(B, 8)·d·4 bytes <=
// 200 KiB; the caller splits a larger batch); beyond, any B.
int decode_head_f32(const float* x, const float* w, const float* bias, int B,
                    int d, int V, float* tile_max, int* tile_idx,
                    float* tile_sum, int* tok, float* max_logit, float* lse,
                    void* stream) {
  return launch<float>(x, w, nullptr, bias, B, d, V, tile_max, tile_idx,
                       tile_sum, tok, max_logit, lse,
                       static_cast<cudaStream_t>(stream));
}

// As decode_head_f32 with int8 codes wq [d, V] and f32 per-column scale [V].
int decode_head_int8(const float* x, const int8_t* wq, const float* scale,
                     const float* bias, int B, int d, int V, float* tile_max,
                     int* tile_idx, float* tile_sum, int* tok,
                     float* max_logit, float* lse, void* stream) {
  return launch<int8_t>(x, wq, scale, bias, B, d, V, tile_max, tile_idx,
                        tile_sum, tok, max_logit, lse,
                        static_cast<cudaStream_t>(stream));
}

const char* decode_head_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
