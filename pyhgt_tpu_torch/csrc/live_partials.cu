// live_partials — per-(tile, local segment) partial sums of segment-sorted rows.
//
// Replaces the TPU kernel pyhgt_tpu/ops/pallas_seg.py:live_partials
// (_live_partials_call / _seg_kernel). Contract, for data [n_tiles*K, D]
// (f32 or bf16), loc [n_tiles, K] int32 and blk [>= n_tiles] int32:
//
//     out[blk[t]*W + loc[t, k], :] += data[t*K + k, :]   (f32 accumulation)
//
// out is [NB*W, D] f32 and is zero-filled by the caller, so rows that no edge
// reaches stay 0. The host aux (sampling/sorted_batch.pallas_seg_aux) numbers
// each tile's distinct segments with consecutive ranks, so loc is
// non-decreasing within a tile and no output row is reached from two tiles:
// every (tile, rank) pair owns its row. The wrapper checks exactly that, and
// that every row lies inside out, on the host before the indices reach the
// device (ops/pallas_seg.py:PallasSegAux.to). In an aux marked dead_rows (the
// singleton-split aux, sampling/sorted_batch.pallas_seg_aux_split) a negative
// loc marks a dead row: the walk stores the run it holds and skips the row.
// That test is compiled in only for such an aux (kDead): it cost the plain
// walk 5% when it was unconditional.
//
// Design. The TPU kernel builds a one-hot [K, W+V] matrix per tile and runs it
// through the MXU, carrying V straddle rows across sequential grid steps in
// VMEM; both exist only because Mosaic has no vector scatter and its grid runs
// in order. Here each CUDA block owns one tile (times a column chunk): its
// threads take adjacent 16-byte column vectors, walk the tile's K edges in
// order, accumulate the current run in f32 registers and store the row each
// time loc changes. No carry across blocks, no atomics, no one-hot.
//
// Bound. Memory: each input row is read once (16-byte streaming loads, U rows
// in flight per thread to cover latency) and each live row written once; the
// additions are ~D per edge, far below the card's f32 rate. At the bench
// shapes (226,560 x 512 bf16 in, 14,016 x 512 f32 out) that is ~262 MB, or
// ~78 us at 3.35 TB/s.

#include "seg_common.cuh"

namespace {

constexpr int kUnroll = 8;  // rows loaded ahead per thread

template <typename T, bool kDead>
__global__ void live_partials_kernel(const T* __restrict__ data,
                                     const int* __restrict__ loc,
                                     const int* __restrict__ blk,
                                     float* __restrict__ out, int K, int D,
                                     int W) {
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
  const typename V::Raw* src = reinterpret_cast<const typename V::Raw*>(
      data + static_cast<int64_t>(t) * K * D + col);
  const int64_t stride = D / N;  // Raw vectors per row
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  int cur = sloc[0];

  for (int k0 = 0; k0 < K; k0 += kUnroll) {
    typename V::Raw raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < K) raw[u] = __ldcs(src + (k0 + u) * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < K) {
        const int l = sloc[k0 + u];
        if (l != cur) {
          if (!kDead || cur >= 0) flush<N>(out, base + cur, col, D, acc);
          cur = l;
        }
        if (!kDead || l >= 0) add_row<T>(raw[u], acc);
      }
    }
  }
  if (!kDead || cur >= 0) flush<N>(out, base + cur, col, D, acc);
}

template <typename T>
cudaError_t launch(const void* data, const int* loc, const int* blk,
                   float* out, int n_tiles, int K, int D, int W, bool dead,
                   cudaStream_t stream) {
  dim3 grid;
  int threads;
  row_grid(n_tiles, D / Vec<T>::N, &grid, &threads);
  const T* src = static_cast<const T*>(data);
  const size_t smem = K * sizeof(int);
  if (dead) {
    live_partials_kernel<T, true>
        <<<grid, threads, smem, stream>>>(src, loc, blk, out, K, D, W);
  } else {
    live_partials_kernel<T, false>
        <<<grid, threads, smem, stream>>>(src, loc, blk, out, K, D, W);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dead_rows: the aux may hold negative loc
// entries to skip. Returns the cudaError_t of the launch.
extern "C" int live_partials_launch(const void* data, int dtype,
                                    const int* loc, const int* blk,
                                    float* out, int n_tiles, int K, int D,
                                    int W, int dead_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dead = dead_rows != 0;
  cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(data, loc, blk, out, n_tiles, K, D, W,
                                         dead, s)
                 : launch<float>(data, loc, blk, out, n_tiles, K, D, W, dead, s);
  return static_cast<int>(err);
}
