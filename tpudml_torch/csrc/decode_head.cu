// Fused greedy decode head, f32 and int8 weights, for Hopper (sm_90a).
//
// Replaces: tpudml/ops/decode_head.py `_head_kernel` (f32 weights) and
// `_head_kernel_int8` (int8 codes + per-column f32 scales), both launched by
// `_head_call`. For x [B, d], W [d, V] and bias [V] it returns, per row, the
// greedy token argmax(x·W + b) (first occurrence on ties), the max logit and
// lse = m + log Σ exp(s − m), without writing the [B, V] logits to device
// memory.
//
// What bounds it on this card. f32: W's bytes. At the serving shape (B = 8,
// d = 512, V = 32768) W is 64 MiB against 2·B·d·V = 268 MFLOP, 4 FLOP a byte,
// so the floor is 67 MB / 3.35 TB/s = 20 µs. int8: W's bytes (16.8 MB, 5 µs
// from HBM) and, as much, the FP32 pipe. Each weight byte costs a
// conversion, one FMUL by its column's scale and 8 FFMAs (one per row of the
// group): 10 FP32 operations a byte, plus one PRMT. At HBM's rate an SM takes
// 3.35 TB/s / 132 / 1.755 GHz = 14.5 bytes a clock, ~145 FP32 operations a
// clock against the SM's 128; with the 16.8 MB warm in the 50 MB L2
// (serving's back-to-back steps) the FP32 pipe alone sets the pace. So the
// codes spend no I2F (16 a clock an SM, a second limit): q becomes a float
// by one PRMT and one FADD, `__byte_perm` of (q ^ 0x80) into the low byte of
// 2²³'s bit pattern, minus 2²³ + 128: exact for every code.
//
// The int8 op order is the oracle's (serve/fleet/quant.py `_dequant_kernel`,
// tpudml/ops/decode_head.py:103-106): w = float(q) · scale[col], rounded to
// f32, then acc = fma(x, w, acc). Factoring the scale out of the sum,
// (Σ x·q)·scale, would save the FMUL but round differently, and the
// dequantized-weights path (and serving's stream comparisons) would no longer
// agree with this one to the last bit of the weights.
//
// Design. A block owns TV = 128 vocab columns; a lane copies 16 bytes of a W
// row at a time: 4 neighbouring f32 columns (32 lanes cover a 512-byte row
// segment) or 16 int8 columns (8 lanes cover the 128-byte segment, so a warp
// copies 4 rows of W at once), and owns those columns for all 8 rows of x.
// d is split across the block's warps: warp w takes the contiguous rows
// [w·S, (w+1)·S) of d, S = ⌈d / NW⌉. V = 32768 gives 256 blocks; two fit an
// SM (f32: 8 warps of ≤ 128 registers, int8: 4 warps of ≤ 255 with their
// 16·8 sums; 96 or 64 KB of shared memory), so the grid is one wave over the
// 132 SMs. x is staged, per warp, in shared memory transposed, [k][8] for
// the 8-row group: one k needs two broadcast 16-byte reads for all 8 rows,
// feeding 32 (f32) or 128 (int8) FFMAs. A warp walks its slice in chunks of
// at most XW_MAX rows of d (128 f32, 256 int8), re-staging x with
// __syncwarp only, so any d fits. B past 8 loops over 8-row groups inside
// the kernel (W read once a group).
//
// Bytes in flight (Little's law): 3.35 TB/s × ~1 µs ≈ 3.4 MB across the
// card, ~25 KB an SM. W reaches the registers through a ring in shared
// memory that each thread fills with its own 16-byte `cp.async` copies
// (NS = 4 steps of U = 4 copies; the thread reads back only what it copied,
// so no barrier guards the ring) and x through 4-byte copies: NS − 1 steps,
// 192 B a thread, stay in flight, 512 threads × 192 B = 96 KB an SM (f32),
// 256 × 192 B = 48 KB (int8), while the thread works on the oldest step.
//
// The sums: each thread accumulates its columns over its warp's slice in
// order; int8 lanes reduce across the warp's 4 row lanes by a two-step
// reduce-scatter of shuffles; the warps' partials meet in shared memory
// (over the ring, once every warp is done with it) and are summed in warp
// order, then + bias. All in a fixed order: results are bitwise repeatable.
// Each block writes, per row, its tile's (max, first column of the max,
// Σ exp(s − max)) to the scratch; columns past V score −inf and never win.
//
// The merge, in the same launch: after its stats, each block bumps an
// arrival counter (the ticket is the only atomic; no value is summed by
// atomics). The block that draws the last ticket merges every row, lanes
// over tiles: (value, column) pairs by "larger value, then smaller column".
// That rule is associative and commutative, so the pick is the first
// occurrence whatever the merge order — as jnp.argmax and the TPU kernel's
// strict `>` across tiles decide. Then lse = M + log Σ_j l_j·exp(m_j − M),
// each lane summing its tiles in order, then a fixed shuffle tree. The last
// block resets the counter to 0, so the next launch on the stream finds it
// so.
//
// Alignment: a W row starts at k·V·4 (f32) or k·V (int8) bytes, so a V that
// is no multiple of 4 (f32) or 16 (int8), or a W that does not start on 16
// bytes, takes the unaligned instance: the same layout with one guarded
// scalar load a column into the ring, never past the end of a row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int TV = 128;      // vocab columns a block
constexpr int GROUP = 8;     // batch rows a pass over W serves
constexpr int U = 4;         // 16-byte copies a thread a step
constexpr int NS = 4;        // steps in a thread's ring (NS - 1 in flight)

// How a block's lanes cover W. A 16-byte copy holds VEC columns, and COLG
// lanes cover a row's TV columns; each lane owns its VEC columns for all 8
// rows of x (4·8 f32 or 16·8 int8 sums in registers). f32: 8 warps of ≤ 128
// registers; int8: 4 warps of ≤ 255, each copying 4 rows of W at once. Two
// blocks an SM either way. XW_MAX: rows of d a warp stages at a time.
template <typename W>
struct Layout {
  static constexpr bool INT8 = sizeof(W) == 1;
  static constexpr int VEC = 16 / sizeof(W);      // 4 or 16
  static constexpr int NW = INT8 ? 4 : 8;
  static constexpr int XW_MAX = INT8 ? 256 : 128;
  static constexpr int THREADS = NW * 32;
  static constexpr int COLG = TV / VEC;          // lanes on one W row: 32 or 8
  static constexpr int RPW = 32 / COLG;          // W rows a warp copies at once: 1 or 4
  static constexpr int STEP = RPW * U;           // rows of d a warp walks a step
  static constexpr int RING = NS * U * THREADS;  // uint4 slots, all the threads' rings
  static constexpr int MOST_SMEM = 16 * RING + 4 * NW * GROUP * XW_MAX;
  static_assert(RING * 16 >= NW * GROUP * TV * 4, "the partial sums live over the ring");
};

// How (B, d, V) is cut (ops/decode_head.py `head_plan` mirrors it).
struct Plan {
  int tiles;   // blocks: vocab tiles of TV columns
  int slice;   // rows of d a warp owns, S = ⌈d / NW⌉
  int chunk;   // rows of d a warp stages at a time (XW)
  int smem;    // dynamic shared memory a block, bytes
  int groups;  // 8-row groups of x the block walks
  int scratch; // int32 words of the call's buffer: tok, max, lse, then stats [3][B][tiles]
};

template <typename W>
Plan plan_of(int B, int d, int V) {
  using L = Layout<W>;
  Plan p;
  p.tiles = (V + TV - 1) / TV;
  p.slice = (d + L::NW - 1) / L::NW;
  const int rounded = (p.slice + L::STEP - 1) / L::STEP * L::STEP;
  p.chunk = rounded < L::XW_MAX ? rounded : L::XW_MAX;
  p.smem = 16 * L::RING + static_cast<int>(sizeof(float)) * L::NW * GROUP * p.chunk;
  p.groups = (B + GROUP - 1) / GROUP;
  p.scratch = 3 * B * (p.tiles + 1);
  return p;
}

struct ArgMax {
  float v;
  int i;
};

// Larger value wins; on equal values the smaller column wins (first
// occurrence). Associative and commutative: any merge order picks the same.
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// Reductions over groups of WIDTH neighbouring lanes (a fixed butterfly:
// every lane of a group ends with the same bits).
template <int WIDTH = 32>
__device__ __forceinline__ ArgMax warp_argmax(ArgMax a) {
  for (int o = WIDTH / 2; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(0xffffffffu, a.v, o), __shfl_xor_sync(0xffffffffu, a.i, o)};
    a = better(a, b);
  }
  return a;
}

template <int WIDTH = 32>
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = WIDTH / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One thread's 16 bytes of W row k at columns [col, col + VEC) into its ring
// slot: zero where k >= kend or col >= V. ALIGNED: one 16-byte cp.async (V a
// multiple of VEC, so the VEC columns are all in the row or all past it);
// else one guarded scalar load a column, stored when it arrives.
template <typename W, bool ALIGNED>
__device__ __forceinline__ void fetch_w(uint4* slot, const W* __restrict__ w, int k, int kend,
                                        int col, int V) {
  const bool valid = k < kend && col < V;
  const W* p = w + static_cast<long long>(k) * V + col;
  if constexpr (ALIGNED) {
    cp_async_16(slot, valid ? p : w, valid);
  } else {
    W* dst = reinterpret_cast<W*>(slot);
#pragma unroll
    for (int j = 0; j < Layout<W>::VEC; ++j)
      dst[j] = valid && col + j < V ? __ldg(p + j) : W(0);
  }
}

// float(q) for byte b of `word` without I2F: (q ^ 0x80) is q + 128 as an
// unsigned byte; as the low byte of 2²³'s bit pattern it reads 2²³ + q + 128,
// and subtracting 2²³ + 128 leaves q exactly.
__device__ __forceinline__ float code(uint32_t word, int b) {
  return __fsub_rn(__uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7540u + b)),
                   8388736.f);
}

// acc[r][j] += x[r] · w_j over one copy of W row k (xk: x's 8 rows at k),
// all VEC weights first, then row by row (each x[r] read into the FFMAs of
// consecutive instructions). int8: w_j = float(q_j) · scale_j, the oracle's
// order.
template <typename W>
__device__ __forceinline__ void fma_copy(float (&acc)[GROUP][Layout<W>::VEC], uint4 raw,
                                         const float* xk, const float (&sc)[Layout<W>::VEC]) {
  constexpr int VEC = Layout<W>::VEC;
  const uint32_t word[4] = {raw.x, raw.y, raw.z, raw.w};
  float wv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if constexpr (sizeof(W) == 4) wv[j] = __uint_as_float(word[j]);
    else wv[j] = __fmul_rn(code(word[j / 4], j % 4), sc[j]);
  }
  const float4 x0 = reinterpret_cast<const float4*>(xk)[0];
  const float4 x1 = reinterpret_cast<const float4*>(xk)[1];
  const float xr[GROUP] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
  for (int r = 0; r < GROUP; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = __fmaf_rn(xr[r], wv[j], acc[r][j]);
}

template <typename W, bool ALIGNED>
__global__ void __launch_bounds__(Layout<W>::THREADS, 2)
head_kernel(const float* __restrict__ x, const W* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias, int B,
            int d, int V, int S, int XW, int* __restrict__ out,
            unsigned* __restrict__ counter) {
  using L = Layout<W>;
  constexpr int VEC = L::VEC, NW = L::NW, THREADS = L::THREADS;
  extern __shared__ uint4 smem4[];
  uint4* ring = smem4;  // [NS][U][THREADS] each thread's W copies
  float* red = reinterpret_cast<float*>(smem4);  // [NW][GROUP][TV] partial sums, after the ring
  float* xs = reinterpret_cast<float*>(smem4 + L::RING);  // [NW][XW][GROUP] x chunks
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = gridDim.x, tile = blockIdx.x;
  const int sub = lane / L::COLG;  // which of the warp's RPW rows this lane copies
  const int col = tile * TV + (lane % L::COLG) * VEC;
  float sc[VEC];  // int8: the scales of this lane's columns
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    sc[j] = sizeof(W) == 1 && col + j < V ? __ldg(scale + col + j) : 1.f;
  float bv[4];  // the bias of the 4 columns this lane scores
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tile * TV + 4 * lane + j;
    bv[j] = c < V ? __ldg(bias + c) : 0.f;
  }
  const int lo = min(warp * S, d), hi = min(lo + S, d);
  float* xw = xs + warp * XW * GROUP;
  int* tok = out;
  float* max_logit = reinterpret_cast<float*>(out + B);
  float* lse = max_logit + B;
  float* st_m = lse + B;  // [B][tiles] each tile's max
  int* st_i = reinterpret_cast<int*>(st_m + static_cast<long long>(B) * tiles);  // its column
  float* st_l = reinterpret_cast<float*>(st_i + static_cast<long long>(B) * tiles);  // Σ exp

  for (int g0 = 0; g0 < B; g0 += GROUP) {
    const int rows = min(GROUP, B - g0);
    float acc[GROUP][VEC];
#pragma unroll
    for (int r = 0; r < GROUP; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;

    for (int c0 = lo; c0 < hi; c0 += XW) {
      const int n = min(XW, hi - c0), kend = c0 + n;
      // The step starting at row k0 into ring slot s (one commit group).
      auto fetch = [&](int k0, int s) {
        if (k0 < kend) {
#pragma unroll
          for (int u = 0; u < U; ++u)
            fetch_w<W, ALIGNED>(ring + (s * U + u) * THREADS + tid, w, k0 + u * L::RPW + sub,
                                kend, col, V);
        }
        cp_async_commit();
      };
      __syncwarp();  // the previous chunk's x is consumed
#pragma unroll
      for (int r = 0; r < GROUP; ++r) {
        const float* xr = x + static_cast<long long>(g0 + r) * d + c0;
        for (int kk = lane; kk < XW; kk += 32) {
          const bool ok = r < rows && kk < n;
          cp_async_4(xw + kk * GROUP + r, ok ? xr + kk : x, ok);
        }
      }
      cp_async_commit();
#pragma unroll
      for (int s = 0; s < NS - 1; ++s) fetch(c0 + s * L::STEP, s);
      cp_async_wait<NS - 1>();  // x has landed
      __syncwarp();
      for (int i = 0, k0 = c0; k0 < kend; ++i, k0 += L::STEP) {
        cp_async_wait<NS - 2>();  // step i has landed
        fetch(k0 + (NS - 1) * L::STEP, (i + NS - 1) % NS);
        const uint4* slot = ring + (i % NS) * U * THREADS + tid;
#pragma unroll
        for (int u = 0; u < U; ++u)
          fma_copy<W>(acc, slot[u * THREADS], xw + (k0 - c0 + u * L::RPW + sub) * GROUP, sc);
      }
      cp_async_wait<0>();  // no copy past the chunk is left to land
    }

    // int8: the warp's 4 row lanes hold partials of the same columns; a
    // reduce-scatter leaves each lane 2 rows summed over the 4 (xor 16 pairs
    // lanes 0-7 with 16-23 and 8-15 with 24-31 and keeps rows 0-3 or 4-7,
    // xor 8 then keeps 2 of those 4).
    int r_lo = 0;
    if constexpr (L::RPW == 4) {
      const bool hi4 = sub & 2, hi2 = sub & 1;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float mine = hi4 ? acc[r + 4][j] : acc[r][j];
          const float give = hi4 ? acc[r][j] : acc[r + 4][j];
          acc[r][j] = mine + __shfl_xor_sync(0xffffffffu, give, 16);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float mine = hi2 ? acc[r + 2][j] : acc[r][j];
          const float give = hi2 ? acc[r][j] : acc[r + 2][j];
          acc[r][j] = mine + __shfl_xor_sync(0xffffffffu, give, 8);
        }
      r_lo = (hi4 ? 4 : 0) + (hi2 ? 2 : 0);
    }
    constexpr int KEEP = L::RPW == 4 ? 2 : GROUP;
    const int c_in = (lane % L::COLG) * VEC;
    __syncthreads();  // every warp is done with the ring, which red overlays
#pragma unroll
    for (int r = 0; r < KEEP; ++r)
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(red + (warp * GROUP + r_lo + r) * TV + c_in + j) =
            make_float4(acc[r][j], acc[r][j + 1], acc[r][j + 2], acc[r][j + 3]);
    __syncthreads();

    // A warp a row: lane owns columns 4·lane..+3 of the tile; the warps'
    // partials summed in warp order, then + bias.
    for (int r = warp; r < rows; r += NW) {
      float s[4];
      float4 p = *reinterpret_cast<const float4*>(red + r * TV + 4 * lane);
      s[0] = p.x, s[1] = p.y, s[2] = p.z, s[3] = p.w;
#pragma unroll
      for (int v = 1; v < NW; ++v) {
        p = *reinterpret_cast<const float4*>(red + (v * GROUP + r) * TV + 4 * lane);
        s[0] += p.x, s[1] += p.y, s[2] += p.z, s[3] += p.w;
      }
      ArgMax a{-INFINITY, 0x7fffffff};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tile * TV + 4 * lane + j;
        s[j] = c < V ? s[j] + bv[j] : -INFINITY;
        a = better(a, ArgMax{s[j], c < V ? c : 0x7fffffff});
      }
      a = warp_argmax(a);
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += tile * TV + 4 * lane + j < V ? expf(s[j] - a.v) : 0.f;
      e = warp_sum(e);
      if (lane == 0) {
        const long long at = static_cast<long long>(g0 + r) * tiles + tile;
        st_m[at] = a.v;
        st_i[at] = a.i;
        st_l[at] = e;
      }
    }
    __syncthreads();  // the ring and red are rewritten by the next group
  }

  // The last block to arrive merges every row: 8 / NW rows a warp at once,
  // each on 32 · NW / 8 lanes. A lane takes its tiles in order: first the
  // (max, column) pick, reduced over the row's lanes, then
  // Σ l_j·exp(m_j − M), summed the same way.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1u) == static_cast<unsigned>(tiles - 1);
  __syncthreads();
  if (!last) return;
  constexpr int WIDTH = 32 * NW / GROUP;  // lanes a row
  for (int b0 = warp * (32 / WIDTH); b0 < B; b0 += GROUP) {
    const int b = b0 + lane / WIDTH;
    const long long at = static_cast<long long>(b < B ? b : 0) * tiles;
    const int j0 = b < B ? lane % WIDTH : tiles;
    ArgMax a{-INFINITY, 0x7fffffff};
#pragma unroll 4
    for (int j = j0; j < tiles; j += WIDTH)
      a = better(a, ArgMax{__ldcg(st_m + at + j), __ldcg(st_i + at + j)});
    a = warp_argmax<WIDTH>(a);
    float sum = 0.f;
#pragma unroll 4
    for (int j = j0; j < tiles; j += WIDTH)
      sum += __ldcg(st_l + at + j) * expf(__ldcg(st_m + at + j) - a.v);
    sum = warp_sum<WIDTH>(sum);
    if (b < B && lane % WIDTH == 0) {
      tok[b] = a.i;
      max_logit[b] = a.v;
      lse[b] = a.v + logf(sum);
    }
  }
  if (tid == 0) *counter = 0u;
}

template <typename W>
cudaError_t launch(const float* x, const W* w, const float* scale, const float* bias,
                   int B, int d, int V, int* out, unsigned* counter, cudaStream_t stream) {
  using L = Layout<W>;
  if (B < 1 || d < 1 || V < 1) return cudaErrorInvalidValue;
  const Plan p = plan_of<W>(B, d, V);
  const bool aligned = V % L::VEC == 0 && aligned16(w);
  const auto kernel = aligned ? head_kernel<W, true> : head_kernel<W, false>;
  cudaError_t err = aligned ? set_smem_once<head_kernel<W, true>>(L::MOST_SMEM)
                            : set_smem_once<head_kernel<W, false>>(L::MOST_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<p.tiles, L::THREADS, p.smem, stream>>>(x, w, scale, bias, B, d, V, p.slice, p.chunk,
                                                  out, counter);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, d] f32, w [d, V] f32, bias [V]; out: the call's int32 buffer of
// plan.scratch words, tok [B] then max [B] and lse [B] (f32 bits), then the
// tiles' stats; counter: one uint32 that is 0 between launches on this
// stream (each launch leaves it 0). All contiguous, on the current device.
// Any B, d, V >= 1.
int decode_head_f32(const float* x, const float* w, const float* bias, int B, int d, int V,
                    int* out, unsigned* counter, void* stream) {
  return launch<float>(x, w, nullptr, bias, B, d, V, out, counter,
                       static_cast<cudaStream_t>(stream));
}

// As decode_head_f32 with int8 codes wq [d, V] and f32 per-column scale [V].
int decode_head_int8(const float* x, const int8_t* wq, const float* scale,
                     const float* bias, int B, int d, int V, int* out, unsigned* counter,
                     void* stream) {
  return launch<int8_t>(x, wq, scale, bias, B, d, V, out, counter,
                        static_cast<cudaStream_t>(stream));
}

// How (B, d, V) is cut for f32 (is_int8 0) or int8 weights
// (ops/decode_head.py `head_plan` mirrors it): out = (tiles, aligned for a W
// that starts on 16 bytes, warps, slice, chunk, smem bytes, groups, scratch
// words).
int decode_head_plan(int B, int d, int V, int is_int8, int* out) {
  const Plan p = is_int8 ? plan_of<int8_t>(B, d, V) : plan_of<float>(B, d, V);
  const int vec = is_int8 ? Layout<int8_t>::VEC : Layout<float>::VEC;
  const int nw = is_int8 ? Layout<int8_t>::NW : Layout<float>::NW;
  const int v[8] = {p.tiles, V % vec == 0, nw, p.slice, p.chunk, p.smem, p.groups, p.scratch};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

const char* decode_head_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
