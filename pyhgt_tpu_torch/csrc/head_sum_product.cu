// head_sum_product — per-head lane sums of a * b, the product never stored.
//
// Replaces the TPU kernel pyhgt_tpu/ops/pallas_seg.py:head_sum_product
// (_headsum_prod_call / _headsum_prod_kernel). Contract, for a, b [E, D]
// (both f32 or both bf16) and D = H*dk:
//
//     out[e, h] = sum_{c in head h} float(a[e, c]) * float(b[e, c])
//
// out is [E, H] f32 and is written in full (no zero-fill needed).
//
// Design. The TPU kernel multiplies in VMEM and sums each head's lanes with a
// hi/lo-split 0/1 matmul. Here each thread takes one 16-byte vector of a row
// of a and the same of b (8 bf16 or 4 f32 values, widened to f32 exactly),
// sums their products in a register, and the dk/N threads that share a head
// (neighbouring lanes of one warp: the wrapper requires dk/N to be a power of
// two up to 32) add their sums with warp shuffles; the first of them writes
// out[e, h]. Consecutive threads walk consecutive vectors of the flattened
// [E*D] arrays, so loads are coalesced, and each thread has kItems vector
// pairs in flight.
//
// Bound. Memory: a and b read once, out written once. At the bench shapes
// (2 x 226,560 x 512 bf16 in, 226,560 x 8 f32 out) that is ~471 MB, ~0.14 ms
// at 3.35 TB/s; one multiply-add per value pair is far below the f32 rate.

#include "seg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // vector pairs per thread

template <typename T>
__global__ void head_sum_product_kernel(const T* __restrict__ a,
                                        const T* __restrict__ b,
                                        float* __restrict__ out,
                                        int64_t n_vecs, int group) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const typename V::Raw* pa = reinterpret_cast<const typename V::Raw*>(a);
  const typename V::Raw* pb = reinterpret_cast<const typename V::Raw*>(b);
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kItems * kThreads + threadIdx.x;

  typename V::Raw ra[kItems], rb[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int64_t i = first + static_cast<int64_t>(u) * kThreads;
    if (i < n_vecs) {
      ra[u] = __ldcs(pa + i);
      rb[u] = __ldcs(pb + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int64_t i = first + static_cast<int64_t>(u) * kThreads;
    float s = 0.f;
    if (i < n_vecs) {
      float x[N], y[N];
      V::unpack(ra[u], x);
      V::unpack(rb[u], y);
#pragma unroll
      for (int j = 0; j < N; ++j) s = fmaf(x[j], y[j], s);
    }
    // the `group` lanes of one head are aligned neighbours in the warp; every
    // lane takes part (a lane past the end holds 0 and belongs to no group
    // that writes)
    for (int d = group >> 1; d > 0; d >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, d);
    }
    if (i < n_vecs && i % group == 0) out[i / group] = s;
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, float* out, int64_t E, int D,
                   int dk, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const int64_t n_vecs = E * (D / N);
  const int group = dk / N;  // threads per head
  const int64_t per_block = static_cast<int64_t>(kItems) * kThreads;
  const unsigned blocks =
      static_cast<unsigned>((n_vecs + per_block - 1) / per_block);
  if (blocks == 0) return cudaSuccess;
  head_sum_product_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out, n_vecs, group);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. out is [E, D/dk] f32. Returns the
// cudaError_t of the launch.
extern "C" int head_sum_product_launch(const void* a, const void* b, int dtype,
                                       float* out, long long E, int D, int dk,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch<__nv_bfloat16>(a, b, out, E, D, dk, s)
                               : launch<float>(a, b, out, E, D, dk, s);
  return static_cast<int>(err);
}
