// Shared pieces of the segment-sum kernels (pair_walk.cuh, which
// live_partials.cu, live_partials_pair.cu and live_partials_slab.cu build
// on, and live_partials_weighted.cu): 16-byte row vectors of f32 or bf16
// values widened to f32 and the store of a finished run; and
// live_partials_weighted.cu's launch grid, one block per (tile, column
// chunk).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16 bytes of input per thread per row: 4 f32 or 8 bf16 values.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float* x) {
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32 word
  // (element 2i is the low half of 32-bit word i, little-endian).
  __device__ static void unpack(const Raw& r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// acc += the row vector r, in f32.
template <typename T>
__device__ __forceinline__ void add_row(const typename Vec<T>::Raw& r,
                                        float* acc) {
  float x[Vec<T>::N];
  Vec<T>::unpack(r, x);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) acc[i] += x[i];
}

// Store the N sums of one run as row `row` of out [*, D] and clear them.
template <int N>
__device__ __forceinline__ void flush(float* __restrict__ out, int64_t row,
                                      int col, int D, float* acc) {
  float4* dst = reinterpret_cast<float4*>(out + row * D + col);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                         acc[4 * i + 3]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// One block per (tile, column chunk): its threads take adjacent 16-byte
// column vectors of a row.
inline void row_grid(int n_tiles, int vecs, dim3* grid, int* threads) {
  *threads = vecs >= 128 ? 128 : ((vecs + 31) / 32) * 32;
  *grid = dim3(n_tiles, (vecs + *threads - 1) / *threads);
}

}  // namespace
