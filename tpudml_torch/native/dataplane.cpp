// Host data-plane kernels of tpudml_torch (its copy of the JAX package's
// data plane, under its own symbol names).
//
// The reference's host data path lives inside torchvision/DataLoader C++
// internals (SURVEY.md §2.4: its only native code is vendored library
// internals). This is our equivalent: the per-step batch materialization —
// row gather + dequantize-normalize — done in one pass in C++, invoked via
// ctypes (a plain C interface, no pybind11). The fused u8 path lets datasets stay
// resident in memory at 1/4 the bytes of float32 and turns per-batch
// normalization into a single streaming loop.
//
// Build: g++ -O3 -shared -fPIC (see tpudml_torch/native/__init__.py; rebuilt
// automatically when this source is newer than the cached .so).

#include <cstdint>
#include <cstring>

extern "C" {

// out[i, :] = src[idx[i], :]  (row-major, rows of `row` float32 elements)
void tpudml_torch_gather_rows_f32(const float* src, const int64_t* idx, int64_t n,
                            int64_t row, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * row, src + idx[i] * row,
                static_cast<size_t>(row) * sizeof(float));
  }
}

// out[i, :] = src[idx[i], :]  (uint8 rows, no conversion)
void tpudml_torch_gather_rows_u8(const uint8_t* src, const int64_t* idx, int64_t n,
                           int64_t row, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * row, src + idx[i] * row, static_cast<size_t>(row));
  }
}

// out[i, j] = src[idx[i], j] * scale + bias  — fused gather + dequantize
// (the ToTensor /255 normalization of the reference pipeline,
// codes/task1/pytorch/model.py:93-95, done at batch time instead of load
// time so the resident dataset stays uint8).
void tpudml_torch_gather_normalize_u8(const uint8_t* src, const int64_t* idx,
                                int64_t n, int64_t row, float scale,
                                float bias, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = src + idx[i] * row;
    float* o = out + i * row;
    for (int64_t j = 0; j < row; ++j) {
      o[j] = static_cast<float>(s[j]) * scale + bias;
    }
  }
}

// out[i] = src[idx[i]]  (label gather)
void tpudml_torch_gather_i32(const int32_t* src, const int64_t* idx, int64_t n,
                       int32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = src[idx[i]];
}

// In-place endian swap of n elements of `width` bytes (IDX files are
// big-endian; payloads wider than 1 byte need swapping on little-endian
// hosts). width ∈ {2, 4, 8}. Returns 0 on success, -1 on bad width.
int tpudml_torch_byteswap(void* data, int64_t n, int32_t width) {
  if (width == 2) {
    uint16_t* p = static_cast<uint16_t*>(data);
    for (int64_t i = 0; i < n; ++i) p[i] = __builtin_bswap16(p[i]);
  } else if (width == 4) {
    uint32_t* p = static_cast<uint32_t*>(data);
    for (int64_t i = 0; i < n; ++i) p[i] = __builtin_bswap32(p[i]);
  } else if (width == 8) {
    uint64_t* p = static_cast<uint64_t*>(data);
    for (int64_t i = 0; i < n; ++i) p[i] = __builtin_bswap64(p[i]);
  } else {
    return -1;
  }
  return 0;
}

}  // extern "C"
