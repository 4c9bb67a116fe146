// Grouped weight gradient of the dropless MoE expert FFN, f32 and bf16
// operands, for Hopper (sm_90a): kernel 16 of the port.
//
// Replaces: tpudml/ops/moe_kernel.py `_grouped_dw_kernel` (launched by
// `_grouped_dw_pallas`, reached through `grouped_dw`), which `ragged_ffn`'s
// backward calls for dW1 and dW2.
//
// Computes, for x [M, k] and g [M, n] (both f32 or both bf16) whose rows are
// sorted by expert, and group_sizes [E] int32 on the device:
//   dW[e] = x[slab e]ᵀ · g[slab e]  (f32 [E, k, n], f32 sums),
// where slab e is the rows [off[e], off[e + 1]) with off = [0, cumsum(group
// sizes)], clamped to [0, M]. Rows at or past off[E] belong to no slab and
// are ignored; an empty slab gives dW[e] = 0. Any M >= 0, k, n, E >= 1,
// with 64-bit offsets. The host never learns the sizes.
//
// What bounds it on this card. At the MoE training step's shapes (M = 8192
// with 8000 routed rows, k·n = 512·2048, E = 4 or 8) the operations are
// 2·Σsizes·k·n = 16.8 GFLOP whatever E, and the bytes are the routed rows of
// both operands read once plus the f32 dW written once (41 MB of bf16 rows
// and 33.6 MB of dW at E = 8). In bf16 the tensor cores (989 TFLOP/s) would
// take 0.017 ms and the bytes 0.022 ms: bytes bound it. In f32 (no TF32:
// the CUDA cores' 67 TFLOP/s) operations do, at 0.25 ms. What bounds a
// block-tiled kernel in bf16 is another traffic: every block reads its
// chunk's rows of x and g from L2, so the L2-to-SM bytes are the rows times
// (tile rows + tile columns) per tile, 262 MB at E = 8 with 128×128 tiles;
// in a probe of a 128×128 mma.sync design, the loads alone took longer
// than the products alone. Hence the widest tile the register file holds,
// 128×256 f32 sums (−25% of those bytes), and the products on wgmma, which
// leaves the issue slots to the loads.
//
// Design. The TPU kernel walks row tiles once in a sequential grid
// (MegaBlocks' visit schedule, `visits = tiles + E`) and carries each
// expert's sum in VMEM between grid steps. Here blocks run in parallel and
// in no order, so:
// - Work unit = (chunk, tile of dW[e]). A chunk is at most R rows of one
//   slab: expert e's slab of len rows is cut into ⌈len / R⌉ equal chunks
//   (one empty chunk for an empty slab, which writes the zeros). Since
//   Σ(⌊len / R⌋ + 1) <= ⌊M / R⌋ + E for disjoint slabs, the chunk list fits
//   `slots` = ⌊M / R⌋ + E slots, and the grid, slots × tiles, follows from
//   (M, k, n, E) alone (plan_gdw). Each block walks the sizes on the device
//   to find its chunk; a block past the list exits at once. R makes one
//   slab of all M rows about FILL_ELEMS of dW work (4 waves of 128×128
//   tiles on 132 SMs), at least MIN_ROWS and in bf16 at most MAX_ROWS
//   (below): 1024 at the MoE shapes, so that a skewed or collapsed routing
//   fills the card while a balanced E = 8 slab (~1000 rows) stays whole.
//   Negative sizes make slabs overlap; R then doubles on the device until
//   the list fits (never for sizes >= 0).
// - A block streams its chunk's rows through a cp.async ring of S stages,
//   BK = 64 rows a stage: x[rows, k tile] and g[rows, n tile], both read
//   along their contiguous axis in 16-byte copies (zero-filled past the
//   chunk and past k, n). A k or n that is no multiple of 16 bytes takes
//   the !VEC instance (element loads and stores); the full instances hold
//   no edge loop.
// - bf16: a 128 (k) × 256 (n) tile, 2 warpgroups, 4 stages (192 KiB, one
//   block an SM). Warpgroup w owns rows 64·w.. and all 256 columns: 4
//   wgmma m64n256k16 a stage (128 f32 sums a thread; 4 warpgroups of
//   m64n128 ran slower in a probe), both operands from shared memory in
//   their MN-major form (the tiles as loaded, row = contraction index),
//   stored as 64-column atoms of 8-row, 128-byte-swizzled blocks (the
//   canonical layout). The next stages' loads are issued while a stage's
//   wgmma run. The tensor cores' f32 accumulation truncates, so one chain
//   of wgmma may not sum too many rows: over 500 k-steps (R = 8000) the
//   error came near the 1e-5 tolerance in a probe. A bf16 chunk holds at
//   most MAX_ROWS = 2048 rows (128 k-steps; `chip_smoke.py` phase 3 prints
//   the error at that cap). Folding each 1024-row chain into the chunk's
//   slot instead spilled and serialized the wgmma (ptxas C7515: non-wgmma
//   writes to the accumulators inside the pipeline).
// - f32: a 128×128 tile, 3 stages (198 KiB, one block an SM). Warp w owns
//   rows 32·(w / 2).. and columns 64·(w % 2)..; lane 8·jg + cg an 8×8 tile,
//   rows 4·jg + 16·h + e, columns 4·cg + 32·h + f: per row of the chunk 2
//   float4 of x (8 lanes share each) and 2 float4 of g (128 contiguous
//   bytes) for 64 FMAs.
// - An expert of one chunk writes its tile of dW directly, once, in 8-
//   (bf16 layout) or 16-byte (f32) stores. Of a longer slab, chunk 0 writes
//   its partial into dW and chunk i >= 1 into its slot of the workspace;
//   then each counts its arrival on a counter of (expert, tile), and the
//   block that arrives last sums the expert's partials in chunk order
//   (chunk 0 from dW, the rest from their slots) and writes dW. No atomics
//   on dW and a sum order that does not depend on which block is last:
//   bitwise repeatable. The workspace holds a partial tile for every list
//   slot and tile (FILL_ELEMS + E·k·n floats at most, rounded to tiles,
//   until MAX_ROWS caps R; past that M·k·n / MAX_ROWS) and E × tiles
//   counters, which the launch zeroes.

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr long long FILL_ELEMS = 4LL * 132 * 128 * 128;  // dW elements of one slab of all M rows
constexpr long long MIN_ROWS = 256;                      // the shortest chunk limit R
constexpr long long ROW_UNIT = 64;                       // R is a multiple of it

// Tiles of one dtype: NT threads a block, BJ × BC of dW a block (ACC f32
// sums a thread), BK rows a stage, S stages in the ring, STAGE elements a
// stage (the x tile, X elements, then the g tile); V neighbouring columns
// of one row a thread holds (and stores at once); MAX_ROWS: the most rows
// a chunk may hold (0: no limit).
template <typename T>
struct Gdw;
template <>
struct Gdw<bf16> {  // 2 warpgroups
  static constexpr int NT = 256, BJ = 128, BC = 256, BK = 64, S = 4, V = 2, MAX_ROWS = 2048;
  static constexpr int X = BK * BJ, STAGE = BK * (BJ + BC);  // atoms of [BK][64]
  static constexpr int TILE = BJ * BC, ACC = TILE / NT;
};
template <>
struct Gdw<float> {  // 8 warps
  static constexpr int NT = 256, BJ = 128, BC = 128, BK = 64, S = 3, V = 4, MAX_ROWS = 0;
  static constexpr int LD = BJ + 4;  // load_tile's padded rows
  static constexpr int X = BK * LD, STAGE = 2 * BK * LD;
  static constexpr int TILE = BJ * BC, ACC = TILE / NT;
};

// Dynamic shared memory: the ring, aligned to 1024 bytes in the kernel (the
// swizzle repeat of the bf16 atoms), then the last-arrival flag and the
// chunk's (expert, index, count).
template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * Gdw<T>::S * Gdw<T>::STAGE + 1024 + 16;
}

// Where this thread's accumulators lie in the tile: acc[V·q .. V·q + V) are
// V neighbouring columns of one row (group q): row row(h_of(q)) (R rows a
// thread), columns col0() + dc(q).
template <typename T>
struct Place;
template <>
struct Place<bf16> {  // warpgroup w: rows 64·w..; acc[4·j + i]: wgmma fragment j, element i
  static constexpr int R = 2;
  static __device__ int row(int h) {
    const int lane = threadIdx.x & 31;
    return 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2) + 8 * h;
  }
  static __device__ int col0() { return 2 * (threadIdx.x & 3); }
  static __host__ __device__ constexpr int h_of(int q) { return q & 1; }
  static __host__ __device__ constexpr int dc(int q) { return 8 * (q >> 1); }
};
template <>
struct Place<float> {  // acc[8·a + b]: row a, column b of the thread's 8×8
  static constexpr int R = 8;
  static __device__ int row(int a) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return 32 * (w >> 1) + 16 * (a >> 2) + 4 * (lane >> 3) + (a & 3);
  }
  static __device__ int col0() { return 64 * ((threadIdx.x >> 5) & 1) + 4 * (threadIdx.x & 7); }
  static __host__ __device__ constexpr int h_of(int q) { return q >> 1; }
  static __host__ __device__ constexpr int dc(int q) { return 32 * (q & 1); }
};

// ------------------------------------------------------------ the chunks

// Rows [lo, hi) of expert e's slab: the i-th of its `count` chunks (e < 0:
// past the chunk list).
struct Chunk {
  long long lo, hi;
  int e, i, count;
};

__device__ __forceinline__ long long clamp_ll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Chunks of a slab of len rows, at most `rows` each; an empty slab has one.
__device__ __forceinline__ long long chunks_of(long long len, long long rows) {
  return len > 0 ? (len + rows - 1) / rows : 1;
}

// The chunk in list slot `slot`: the experts' chunks in expert order.
__device__ Chunk find_chunk(const int* __restrict__ sizes, int M, int E, long long rows,
                            long long slots, long long slot) {
  for (;;) {  // overlapping slabs (negative sizes) may need longer chunks
    long long count = 0, start = 0;
#pragma unroll 4
    for (int e = 0; e < E; ++e) {
      const long long end = start + sizes[e];
      const long long lo = clamp_ll(start, 0, M);
      count += chunks_of(clamp_ll(end, lo, M) - lo, rows);
      start = end;
    }
    if (count <= slots) break;
    rows *= 2;
  }
  long long start = 0, first = 0;
  for (int e = 0; e < E; ++e) {
    const long long end = start + sizes[e];
    const long long lo = clamp_ll(start, 0, M), len = clamp_ll(end, lo, M) - lo;
    const long long count = chunks_of(len, rows);
    if (slot < first + count) {
      const long long i = slot - first;
      return {lo + i * len / count, lo + (i + 1) * len / count, e, static_cast<int>(i),
              static_cast<int>(count)};
    }
    first += count;
    start = end;
  }
  return {0, 0, -1, 0, 0};
}

// ------------------------------------------------------------ staging

// BK rows from row r0 (zeros at or past `end`) of COLS bf16 columns (zeros
// past D) of a row-major operand (row stride st) into atoms [COLS / 64][BK]
// [64]: 16-byte chunk c of row r at chunk c ^ (r % 8) of its 128-byte row
// (wgmma's 128-byte swizzle; the atoms start 1024-byte aligned).
template <int COLS>
__device__ __forceinline__ void load_atoms(bf16* s, const bf16* src, long long st, int r0,
                                           int end, int D, bool vec) {
  constexpr int BK = Gdw<bf16>::BK, NCH = COLS / 8;
  for (int i = threadIdx.x; i < BK * NCH; i += Gdw<bf16>::NT) {
    const int r = i / NCH, c = i % NCH;
    const int t = r0 + r;
    bf16* dst = s + (c >> 3) * (BK * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3);
    const bool row_ok = t < end;
    const bf16* p = src + (row_ok ? t * st : 0) + c * 8;
    if (vec) {
      const bool ok = row_ok && c * 8 < D;
      cp_async_16(dst, ok ? p : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = row_ok && c * 8 + e < D ? p[e] : __float2bfloat16(0.f);
    }
  }
}

// Rows r0 .. r0 + BK (zeros at or past `end`) of the x tile (xt: x's
// first column of the tile; dx valid columns, zeros past them) and the g
// tile (gt, dg) into one ring stage: bf16 in swizzled atoms, f32
// row-padded (load_tile).
template <bool VEC>
__device__ __forceinline__ void stage(bf16* st, const bf16* xt, const bf16* gt, int r0, int end,
                                      int k, int n, int dx, int dg) {
  using C = Gdw<bf16>;
  load_atoms<C::BJ>(st, xt, k, r0, end, dx, VEC);
  load_atoms<C::BC>(st + C::X, gt, n, r0, end, dg, VEC);
}
template <bool VEC>
__device__ __forceinline__ void stage(float* st, const float* xt, const float* gt, int r0,
                                      int end, int k, int n, int dx, int dg) {
  using C = Gdw<float>;
  load_tile<C::BJ, C::BK, C::NT>(st, xt, k, r0, end, dx, VEC);
  load_tile<C::BC, C::BK, C::NT>(st + C::X, gt, n, r0, end, dg, VEC);
}

// ------------------------------------------------------------ products

// wgmma's view of a 128-byte-swizzled MN-major operand at p: 8-row blocks
// 1024 bytes apart along the contraction (SBO), 64-column atoms `lbo`
// bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup run.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Order this thread's generic-proxy shared-memory writes (cp.async, stores)
// before the async proxy's reads (wgmma).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += a·b over one k-step of 16: a the 64×16 A tile (MN-major), b the 16×256 B
// tile (MN-major), both 128-byte-swizzled in shared memory, d 64×256 f32 over
// the warpgroup (fragment (j, i) of a thread: row 16·warp + lane / 4 + 8·(i / 2),
// column 8·j + 2·(lane % 4) + i % 2, at d[4·j + i]).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// acc += xᵀ·g over one bf16 stage: warpgroup w's 64 rows (atom w of the x
// tile) by the g tile's 256 columns, 4 k-steps of 16, issued and committed
// as one group (the caller waits).
__device__ __forceinline__ void stage_product(const bf16* st, float (&acc)[Gdw<bf16>::ACC]) {
  using C = Gdw<bf16>;
  const bf16* xs = st + (threadIdx.x >> 7) * (C::BK * 64);
  const bf16* gs = st + C::X;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < C::BK / 16; ++ks)
    wgmma_m64n256k16(acc, wgmma_desc(xs + ks * 16 * 64, C::BK * 128),
                     wgmma_desc(gs + ks * 16 * 64, C::BK * 128));
  wgmma_commit();
}

// acc += xᵀ·g over one f32 stage on the CUDA cores, a row at a time.
__device__ __forceinline__ void stage_product(const float* st, float (&acc)[Gdw<float>::ACC]) {
  using C = Gdw<float>;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xp = st + 32 * (w >> 1) + 4 * (lane >> 3);
  const float* gp = st + C::X + 64 * (w & 1) + 4 * (lane & 7);
#pragma unroll 8
  for (int r = 0; r < C::BK; ++r) {
    float xv[2][4], gv[2][4];
    load_vec(xv[0], xp + r * C::LD);
    load_vec(xv[1], xp + r * C::LD + 16);
    load_vec(gv[0], gp + r * C::LD);
    load_vec(gv[1], gp + r * C::LD + 32);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b)
        acc[8 * a + b] = fmaf(xv[a >> 2][a & 3], gv[b >> 2][b & 3], acc[8 * a + b]);
  }
}

// ------------------------------------------------------------ epilogue

// V neighbouring floats at p: stored from v, loaded into v (from L2: other
// blocks wrote them), or added to v.
enum Io { STORE, LOAD, ADD };

template <int V, Io IO>
__device__ __forceinline__ void vec_io(float* p, float* v) {
  if constexpr (IO == STORE) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (V == 2) {
      store_pair(p, v[0], v[1]);
    } else {
      *p = v[0];
    }
  } else {
    float t[4];
    if constexpr (V == 4) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
      t[0] = q.x, t[1] = q.y, t[2] = q.z, t[3] = q.w;
    } else if constexpr (V == 2) {
      const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
      t[0] = q.x, t[1] = q.y;
    } else {
      t[0] = __ldcg(p);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = IO == ADD ? v[e] + t[e] : t[e];
  }
}

// This thread's elements of the tile (j0, c0) of out [k, n], elements past
// k or n skipped. VEC (n a multiple of 16 bytes of T): a group as a vector.
// One pointer a row and immediate column offsets: addresses of every group
// computed apart held the registers of the bf16 sums.
template <typename T, bool VEC, Io IO>
__device__ __forceinline__ void tile_io(float* out, float (&acc)[Gdw<T>::ACC], int j0, int c0,
                                        int k, int n) {
  using P = Place<T>;
  constexpr int V = Gdw<T>::V;
  float* rp[P::R];
  bool rv[P::R];
#pragma unroll
  for (int h = 0; h < P::R; ++h) {
    const int j = j0 + P::row(h);
    rv[h] = j < k;
    rp[h] = out + static_cast<long long>(j) * n + c0 + P::col0();
  }
  const int rem = n - c0 - P::col0();  // columns left from this thread's first
#pragma unroll
  for (int q = 0; q < Gdw<T>::ACC / V; ++q) {
    const int h = P::h_of(q), dc = P::dc(q);
    if (!rv[h] || dc >= rem) continue;
    float* v = acc + V * q;
    if (VEC) {
      vec_io<V, IO>(rp[h] + dc, v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (dc + e < rem) vec_io<1, IO>(rp[h] + dc + e, v + e);
    }
  }
}

// A tile's partial in a workspace slot: group q of thread t at float (q·NT
// + t)·V, so that a warp's accesses are contiguous.
template <typename T, Io IO>
__device__ __forceinline__ void slot_io(float* slot, float (&acc)[Gdw<T>::ACC]) {
  constexpr int V = Gdw<T>::V;
#pragma unroll
  for (int q = 0; q < Gdw<T>::ACC / V; ++q)
    vec_io<V, IO>(slot + (q * Gdw<T>::NT + threadIdx.x) * V, acc + V * q);
}


// ------------------------------------------------------------ kernel 16

// Block (list slot, tile) = (blockIdx.x / tiles, blockIdx.x % tiles), tile
// (k tile, n tile) with n fastest: the chunk's xᵀ·g over one tile of its
// expert's dW. `part`: the partial slots [⌊M / R⌋][tiles][TILE];
// `arrivals`: zeroed counters [E][tiles].
template <typename T, bool VEC>
__global__ void __launch_bounds__(Gdw<T>::NT, 1)
grouped_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, const int* __restrict__ sizes,
                  float* __restrict__ dw, float* __restrict__ part, int* __restrict__ arrivals,
                  int M, int k, int n, int E, long long rows, long long slots) {
  using C = Gdw<T>;
  constexpr bool MMA = sizeof(T) == 2;  // bf16: wgmma
  constexpr int S = C::S, BK = C::BK, STAGE = C::STAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* ring = reinterpret_cast<T*>(base);                    // [S][STAGE]
  int* last = reinterpret_cast<int*>(ring + S * STAGE);

  int* meta = last + 1;  // the chunk's expert, index and count, for the end
  const int tiles_n = (n + C::BC - 1) / C::BC;
  const int tiles = ((k + C::BJ - 1) / C::BJ) * tiles_n;
  int lo, hi;
  {
    const Chunk ch = find_chunk(sizes, M, E, rows, slots, blockIdx.x / tiles);
    if (ch.e < 0) return;  // past the chunk list
    if (threadIdx.x == 0) meta[0] = ch.e, meta[1] = ch.i, meta[2] = ch.count;
    lo = static_cast<int>(ch.lo), hi = static_cast<int>(ch.hi);
  }
  const int stages = (hi - lo + BK - 1) / BK;
  // The tile (k tile, n tile), n fastest; the loop keeps only the operand
  // pointers, the end recomputes the rest.
  const int dx = k - (blockIdx.x % tiles / tiles_n) * C::BJ;  // valid columns of the tiles
  const int dg = n - (blockIdx.x % tiles % tiles_n) * C::BC;
  const T* xt = x + (k - dx);
  const T* gt = g + (n - dg);
  // The ring runs D stages ahead. bf16: a buffer is refilled two stages
  // after its wgmma were issued, once both warpgroups waited for them.
  constexpr int D = MMA ? S - 2 : S - 1;
  for (int i = 0; i < D; ++i) {
    if (i < stages) stage<VEC>(ring + i * STAGE, xt, gt, lo + i * BK, hi, k, n, dx, dg);
    cp_async_commit();
  }
  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;
  for (int it = 0; it < stages; ++it) {
    if constexpr (MMA) wgmma_wait<1>();  // this warpgroup's products of stage it − 2 are done
    cp_async_wait<D - 1>();
    if constexpr (MMA) fence_async_shared();
    __syncthreads();  // stage `it` landed; the buffer of stage it + D is free
    T* cur = ring + (it % S) * STAGE;
    if constexpr (MMA) stage_product(cur, acc);  // issued, not waited for
    if (it + D < stages)
      stage<VEC>(ring + ((it + D) % S) * STAGE, xt, gt, lo + (it + D) * BK, hi, k, n, dx, dg);
    cp_async_commit();
    if constexpr (!MMA) stage_product(cur, acc);
  }
  if constexpr (MMA) wgmma_wait<0>();
  cp_async_wait<0>();

  __syncthreads();  // meta
  const int e = meta[0], ci = meta[1], count = meta[2];
  const int t = blockIdx.x % tiles;
  const int j0 = (t / tiles_n) * C::BJ, c0 = (t % tiles_n) * C::BC;
  float* out = dw + static_cast<long long>(e) * k * n;
  if (count == 1) {
    tile_io<T, VEC, STORE>(out, acc, j0, c0, k, n);
    return;
  }
  // A slab of several chunks: chunk 0 leaves its partial in dW, chunk i
  // >= 1 in its workspace slot, that of (list slot, tile) = blockIdx.x;
  // the last to arrive sums them in chunk order (chunk i's slot: tiles
  // blocks after chunk i − 1's).
  float* mine = part + static_cast<long long>(blockIdx.x) * C::TILE;
  if (ci == 0) {
    tile_io<T, VEC, STORE>(out, acc, j0, c0, k, n);
  } else {
    slot_io<T, STORE>(mine, acc);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(arrivals + static_cast<long long>(e) * tiles + t, 1) == count - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  tile_io<T, VEC, LOAD>(out, acc, j0, c0, k, n);  // chunk 0's partial
  for (int i = 1; i < count; ++i)
    slot_io<T, ADD>(mine + static_cast<long long>(i - ci) * tiles * C::TILE, acc);
  tile_io<T, VEC, STORE>(out, acc, j0, c0, k, n);
}

// ------------------------------------------------------------------ launch

// How (M, k, n, E) is cut in one dtype (ops/moe_kernel.py `grouped_dw_plan`
// mirrors it): R = `rows`, the list's `slots`, the tiles of one dW[e], the
// grid.
struct Plan {
  long long rows, slots, tiles, blocks;
};

template <typename T>
Plan plan_gdw(int M, int k, int n, int E) {
  using C = Gdw<T>;
  Plan p;
  p.tiles = ((k + C::BJ - 1LL) / C::BJ) * ((n + C::BC - 1LL) / C::BC);
  const long long fill = (M * p.tiles * C::TILE + FILL_ELEMS - 1) / FILL_ELEMS;
  const long long r = (fill + ROW_UNIT - 1) / ROW_UNIT * ROW_UNIT;
  p.rows = r > MIN_ROWS ? r : MIN_ROWS;
  if (C::MAX_ROWS > 0 && p.rows > C::MAX_ROWS) p.rows = C::MAX_ROWS;
  p.slots = M / p.rows + E;
  p.blocks = p.slots * p.tiles;
  return p;
}

// The workspace: a partial tile for each list slot and tile, then the
// counters.
template <typename T>
long long partial_floats(const Plan& p) {
  return p.slots * p.tiles * Gdw<T>::TILE;
}
template <typename T>
long long workspace_bytes(const Plan& p, int E) {
  return sizeof(float) * partial_floats<T>(p) + sizeof(int) * E * p.tiles;
}

template <typename T>
bool vec_rows(const void* p, long long stride) {
  return aligned16(p) && stride % (16 / sizeof(T)) == 0;
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* g, const int* sizes, float* dw, void* ws, int M,
                   int k, int n, int E, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = set_smem_once<grouped_dw_kernel<T, VEC>>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const Plan p = plan_gdw<T>(M, k, n, E);
  if (p.blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  float* part = static_cast<float*>(ws);
  int* arrivals = reinterpret_cast<int*>(part + partial_floats<T>(p));
  if (p.slots > E) {  // a slab may span several chunks
    err = cudaMemsetAsync(arrivals, 0, sizeof(int) * E * p.tiles, st);
    if (err != cudaSuccess) return err;
  }
  grouped_dw_kernel<T, VEC><<<static_cast<unsigned>(p.blocks), Gdw<T>::NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), sizes, dw, part, arrivals, M, k, n, E,
      p.rows, p.slots);
  return cudaGetLastError();
}

template <typename T>
int launch_any(const void* x, const void* g, const int* sizes, float* dw, void* ws, int M, int k,
               int n, int E, void* stream) {
  if (M < 0 || k < 1 || n < 1 || E < 1) return cudaErrorInvalidValue;
  const bool vec = vec_rows<T>(x, k) && vec_rows<T>(g, n) && aligned16(dw) && aligned16(ws);
  const auto run = vec ? launch<T, true> : launch<T, false>;
  return run(x, g, sizes, dw, ws, M, k, n, E, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// How the kernel cuts (M, k, n, E) in one dtype (ops/moe_kernel.py
// `grouped_dw_plan` mirrors it): out = (R: rows a chunk at most, tile rows,
// tile columns, rows a ring stage, list slots, blocks, workspace bytes).
int grouped_dw_plan(int M, int k, int n, int E, int is_bf16, long long* out) {
  if (M < 0 || k < 1 || n < 1 || E < 1) return cudaErrorInvalidValue;
  const Plan p = is_bf16 ? plan_gdw<bf16>(M, k, n, E) : plan_gdw<float>(M, k, n, E);
  out[0] = p.rows;
  out[1] = is_bf16 ? Gdw<bf16>::BJ : Gdw<float>::BJ;
  out[2] = is_bf16 ? Gdw<bf16>::BC : Gdw<float>::BC;
  out[3] = is_bf16 ? Gdw<bf16>::BK : Gdw<float>::BK;
  out[4] = p.slots, out[5] = p.blocks;
  out[6] = is_bf16 ? workspace_bytes<bf16>(p, E) : workspace_bytes<float>(p, E);
  return cudaSuccess;
}

// x [M, k], g [M, n] contiguous f32; group_sizes [E] int32; dw [E, k, n]
// contiguous f32; ws: the plan's workspace bytes. All on the device.
int grouped_dw_f32(const void* x, const void* g, const int* group_sizes, float* dw, void* ws,
                   int M, int k, int n, int E, void* stream) {
  return launch_any<float>(x, g, group_sizes, dw, ws, M, k, n, E, stream);
}

// As grouped_dw_f32 with x and g in bf16; dw stays f32.
int grouped_dw_bf16(const void* x, const void* g, const int* group_sizes, float* dw, void* ws,
                    int M, int k, int n, int E, void* stream) {
  return launch_any<__nv_bfloat16>(x, g, group_sizes, dw, ws, M, k, n, E, stream);
}

const char* grouped_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
