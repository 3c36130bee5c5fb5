// live_partials_weighted — live_partials of head_expand(w) * v, the product
// formed in the kernel.
//
// Replaces the TPU kernel pyhgt_tpu/ops/pallas_seg.py:live_partials_weighted
// (_live_partials_weighted_call / _seg_kernel_weighted). Contract, for
// w [n_tiles*K, H] f32, v [n_tiles*K, D] (f32 or bf16) with D = H*dk,
// loc [n_tiles, K] int32 and blk [>= n_tiles] int32:
//
//     out[blk[t]*W + loc[t, k], c] += w[t*K + k, c / dk] * v[t*K + k, c]
//
// in f32. out is [NB*W, D] f32, zero-filled by the caller. The aux is a runs
// aux (loc sorted within a tile, each (tile, rank) owns its row), checked on
// the host by the wrapper; in an aux marked dead_rows a negative loc is a dead
// row that the walk skips (kDead, compiled in only for such an aux, as in
// live_partials.cu).
//
// Design. The register walk of live_partials.cu: one block per (tile, column
// chunk), each thread owns a 16-byte column vector, sums the current run of
// equal loc in f32 registers and stores it when loc changes. The wrapper
// requires dk to be a multiple of the vector's lanes (8 bf16, 4 f32), so a
// thread's columns lie inside one head and it reads one w[e, h] per row (the
// threads of a head read the same word: one broadcast load, served from L1).
// The [E, D] message tensor is never written. The TPU kernel expands w with a
// 0/1 matmul and, for bf16 v, rounds the product to bf16 before its one-hot
// matmul; here product and sum stay f32, which is closer to the exact sum.
// Any W >= V works (no carry between blocks).
//
// Bound. Memory: v read once, w once, loc once, the output written once. At
// the bench shapes (226,560 x 512 bf16, w 226,560 x 8 f32, 14,016 x 512 f32
// out) that is ~269 MB, ~80 us at 3.35 TB/s; one multiply-add per value is
// far below the card's f32 rate.

#include "seg_common.cuh"

namespace {

constexpr int kUnroll = 8;  // rows loaded ahead per thread

template <typename T, bool kDead>
__global__ void live_partials_weighted_kernel(
    const float* __restrict__ w, const T* __restrict__ v,
    const int* __restrict__ loc, const int* __restrict__ blk,
    float* __restrict__ out, int K, int D, int H, int dk, int W) {
  using V = Vec<T>;
  constexpr int N = V::N;
  extern __shared__ int sloc[];
  const int t = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    sloc[k] = loc[static_cast<int64_t>(t) * K + k];
  }
  __syncthreads();
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * N;
  if (col >= D) return;

  const int64_t base = static_cast<int64_t>(blk[t]) * W;
  const int64_t row0 = static_cast<int64_t>(t) * K;
  const typename V::Raw* src =
      reinterpret_cast<const typename V::Raw*>(v + row0 * D + col);
  const float* wsrc = w + row0 * H + col / dk;  // this thread's head
  const int64_t stride = D / N;  // Raw vectors per row
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  int cur = sloc[0];

  for (int k0 = 0; k0 < K; k0 += kUnroll) {
    typename V::Raw raw[kUnroll];
    float wt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < K) {
        raw[u] = __ldcs(src + (k0 + u) * stride);
        wt[u] = __ldg(wsrc + static_cast<int64_t>(k0 + u) * H);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < K) {
        const int l = sloc[k0 + u];
        if (l != cur) {
          if (!kDead || cur >= 0) flush<N>(out, base + cur, col, D, acc);
          cur = l;
        }
        if (!kDead || l >= 0) {
          float x[N];
          V::unpack(raw[u], x);
#pragma unroll
          for (int i = 0; i < N; ++i) acc[i] = fmaf(wt[u], x[i], acc[i]);
        }
      }
    }
  }
  if (!kDead || cur >= 0) flush<N>(out, base + cur, col, D, acc);
}

template <typename T>
cudaError_t launch(const float* w, const void* v, const int* loc,
                   const int* blk, float* out, int n_tiles, int K, int D,
                   int H, int W, bool dead, cudaStream_t stream) {
  dim3 grid;
  int threads;
  row_grid(n_tiles, D / Vec<T>::N, &grid, &threads);
  const T* src = static_cast<const T*>(v);
  const size_t smem = K * sizeof(int);
  if (dead) {
    live_partials_weighted_kernel<T, true><<<grid, threads, smem, stream>>>(
        w, src, loc, blk, out, K, D, H, D / H, W);
  } else {
    live_partials_weighted_kernel<T, false><<<grid, threads, smem, stream>>>(
        w, src, loc, blk, out, K, D, H, D / H, W);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype (of v): 0 = float32, 1 = bfloat16; w is float32. dead_rows: the aux
// may hold negative loc entries to skip. Returns the cudaError_t of the launch.
extern "C" int live_partials_weighted_launch(const float* w, const void* v,
                                             int dtype, const int* loc,
                                             const int* blk, float* out,
                                             int n_tiles, int K, int D, int H,
                                             int W, int dead_rows,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dead = dead_rows != 0;
  cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(w, v, loc, blk, out, n_tiles, K, D, H,
                                         W, dead, s)
                 : launch<float>(w, v, loc, blk, out, n_tiles, K, D, H, W,
                                 dead, s);
  return static_cast<int>(err);
}
