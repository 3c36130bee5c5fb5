// live_partials_pair — live_partials for two same-shape tensors under one aux.
//
// Replaces the TPU kernel pyhgt_tpu/ops/pallas_seg.py:live_partials_pair
// (_live_partials_pair_call / _seg_kernel_pair). Contract, for d1, d2
// [n_tiles*K, D] (both f32 or both bf16), loc [n_tiles, K] int32 and
// blk [>= n_tiles] int32:
//
//     o1[blk[t]*W + loc[t, k], :] += d1[t*K + k, :]
//     o2[blk[t]*W + loc[t, k], :] += d2[t*K + k, :]     (f32 accumulation)
//
// o1, o2 are [NB*W, D] f32, zero-filled by the caller. The host builds two
// kinds of aux and tells the wrapper which one it passes (ops/pallas_seg.py
// checks either on the host before the indices reach the device):
//
// runs    (sampling/sorted_batch.pallas_seg_aux: the src and tab groupings of
//         the backward's g_k/g_v sums). loc never decreases within a tile and
//         every (tile, rank) pair owns its output row. Same walk as
//         live_partials.cu, with both tensors' current run in f32 registers
//         and loc read once: no carry, no atomics.
// window  (sampling/sorted_batch.pallas_tab_window_aux: the RTE-table
//         gradients, summed per (block, dt) straight off src-ordered rows).
//         loc = (block - blk[t])*W + dt is in no order within a tile, lies in
//         [0, n_win = W + V), and row b*W + dt is shared by every tile of
//         meta block b. The TPU kernel handles this with the same one-hot
//         [K, W+V] MXU matmul and an accumulator carried over its sequential
//         grid. Here a CUDA block first sorts its tile's K row indices by loc
//         (a counting sort over the n_win window rows in shared memory: K and
//         n_win are a few hundred), and then walks the rows in that order
//         exactly as the runs kernel does, each thread summing a run of equal
//         loc for its 16-byte column vector in f32 registers. Because other
//         tiles add to the same output rows, a finished run is added to the
//         output with a 16-byte f32 global atomic instead of a store. The
//         order of those additions (and, within a run, of the rows the
//         counting sort placed) differs from run to run, so the sums agree to
//         f32 rounding, not bit for bit. No accumulator lives in shared
//         memory, so any window width works.
//
// No one-hot matmul in either case: it would turn ~0.6 GB of memory traffic
// into tensor-core work.
//
// Bound. Memory: both inputs read once, loc once, the outputs written once.
// At the bench shapes (2 x 226,560 x 512 bf16) the src grouping moves ~633 MB
// (2 x 41,088 x 512 f32 out), ~0.19 ms at 3.35 TB/s; the window case ~468 MB
// (2 x 768 x 512 f32 out), ~0.14 ms.

#include "seg_common.cuh"

namespace {

constexpr int kUnroll = 4;  // rows of each tensor loaded ahead per thread

template <typename T>
__global__ void pair_runs_kernel(const T* __restrict__ d1,
                                 const T* __restrict__ d2,
                                 const int* __restrict__ loc,
                                 const int* __restrict__ blk,
                                 float* __restrict__ o1,
                                 float* __restrict__ o2, int K, int D, int W) {
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
  const int64_t off = static_cast<int64_t>(t) * K * D + col;
  const typename V::Raw* s1 = reinterpret_cast<const typename V::Raw*>(d1 + off);
  const typename V::Raw* s2 = reinterpret_cast<const typename V::Raw*>(d2 + off);
  const int64_t stride = D / N;  // Raw vectors per row
  float a1[N], a2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a1[i] = a2[i] = 0.f;
  int cur = sloc[0];

  for (int k0 = 0; k0 < K; k0 += kUnroll) {
    typename V::Raw r1[kUnroll], r2[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < K) {
        r1[u] = __ldcs(s1 + (k0 + u) * stride);
        r2[u] = __ldcs(s2 + (k0 + u) * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < K) {
        const int l = sloc[k0 + u];
        if (l != cur) {
          flush<N>(o1, base + cur, col, D, a1);
          flush<N>(o2, base + cur, col, D, a2);
          cur = l;
        }
        add_row<T>(r1[u], a1);
        add_row<T>(r2[u], a2);
      }
    }
  }
  flush<N>(o1, base + cur, col, D, a1);
  flush<N>(o2, base + cur, col, D, a2);
}

// Add the N sums of one run to row `row` of out [*, D] with 16-byte f32
// atomics (other tiles add to the same row) and clear them.
template <int N>
__device__ __forceinline__ void flush_add(float* __restrict__ out,
                                          int64_t row, int col, int D,
                                          float* acc) {
  float4* dst = reinterpret_cast<float4*>(out + row * D + col);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    atomicAdd(dst + i, make_float4(acc[4 * i], acc[4 * i + 1],
                                   acc[4 * i + 2], acc[4 * i + 3]));
  }
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// Shared memory of the window kernel, in ints:
//   sloc [K] loc of the tile's rows in sorted order | srow [K] their row
//   index within the tile | bins [n_win + 1] counting-sort offsets.
inline size_t window_smem_bytes(int K, int n_win) {
  return (2 * static_cast<size_t>(K) + n_win + 1) * sizeof(int);
}

template <typename T>
__global__ void pair_window_kernel(const T* __restrict__ d1,
                                   const T* __restrict__ d2,
                                   const int* __restrict__ loc,
                                   const int* __restrict__ blk,
                                   float* __restrict__ o1,
                                   float* __restrict__ o2, int K, int D,
                                   int W, int n_win) {
  using V = Vec<T>;
  constexpr int N = V::N;
  extern __shared__ int sm[];
  int* sloc = sm;
  int* srow = sloc + K;
  int* bins = srow + K;
  const int t = blockIdx.x;
  const int* tloc = loc + static_cast<int64_t>(t) * K;

  // counting sort of the tile's rows by loc: histogram, exclusive scan (one
  // warp: each lane scans a slice of the bins, the lanes' totals by
  // shuffles), then each row takes the next slot of its bin
  for (int i = threadIdx.x; i <= n_win; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    atomicAdd(&bins[tloc[k] + 1], 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (n_win + 32) / 32;  // bins[1 .. n_win] in 32 slices
    const int lo = 1 + lane * per;
    const int hi = min(lo + per, n_win + 1);
    int total = 0;
    for (int i = lo; i < hi; ++i) total += bins[i];
    int before = total;  // inclusive scan of the lanes' totals
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, before, d);
      if (lane >= d) before += up;
    }
    int run = before - total;  // rows in the bins before this lane's slice
    for (int i = lo; i < hi; ++i) {
      run += bins[i];
      bins[i] = run;  // bins[i] = rows with loc < i, for i = 1 .. n_win
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int l = tloc[k];
    const int pos = atomicAdd(&bins[l], 1);  // bins[l] starts at loc l's slot
    sloc[pos] = l;
    srow[pos] = k;
  }
  __syncthreads();

  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * N;
  if (col >= D) return;
  const int64_t base = static_cast<int64_t>(blk[t]) * W;
  const int64_t off = static_cast<int64_t>(t) * K * D + col;
  const typename V::Raw* s1 = reinterpret_cast<const typename V::Raw*>(d1 + off);
  const typename V::Raw* s2 = reinterpret_cast<const typename V::Raw*>(d2 + off);
  const int64_t stride = D / N;  // Raw vectors per row
  float a1[N], a2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a1[i] = a2[i] = 0.f;
  int cur = sloc[0];

  for (int k0 = 0; k0 < K; k0 += kUnroll) {
    typename V::Raw r1[kUnroll], r2[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < K) {
        const int64_t row = srow[k0 + u];
        r1[u] = __ldcs(s1 + row * stride);
        r2[u] = __ldcs(s2 + row * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < K) {
        const int l = sloc[k0 + u];
        if (l != cur) {
          flush_add<N>(o1, base + cur, col, D, a1);
          flush_add<N>(o2, base + cur, col, D, a2);
          cur = l;
        }
        add_row<T>(r1[u], a1);
        add_row<T>(r2[u], a2);
      }
    }
  }
  flush_add<N>(o1, base + cur, col, D, a1);
  flush_add<N>(o2, base + cur, col, D, a2);
}

// One block per (tile, column chunk): its threads take adjacent 16-byte
// column vectors of a row.
inline void row_grid(int n_tiles, int vecs, dim3* grid, int* threads) {
  *threads = vecs >= 128 ? 128 : ((vecs + 31) / 32) * 32;
  *grid = dim3(n_tiles, (vecs + *threads - 1) / *threads);
}

template <typename T>
cudaError_t launch(const void* d1, const void* d2, const int* loc,
                   const int* blk, float* o1, float* o2, int n_tiles, int K,
                   int D, int W, int n_win, bool window,
                   cudaStream_t stream) {
  dim3 grid;
  int threads;
  row_grid(n_tiles, D / Vec<T>::N, &grid, &threads);
  const T* p1 = static_cast<const T*>(d1);
  const T* p2 = static_cast<const T*>(d2);
  if (window) {
    pair_window_kernel<T>
        <<<grid, threads, window_smem_bytes(K, n_win), stream>>>(
            p1, p2, loc, blk, o1, o2, K, D, W, n_win);
  } else {
    pair_runs_kernel<T><<<grid, threads, K * sizeof(int), stream>>>(
        p1, p2, loc, blk, o1, o2, K, D, W);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window = 0 takes the runs kernel (loc
// sorted within a tile, rows owned), window = 1 the window kernel (loc in any
// order within [0, n_win), rows shared between tiles). Returns the
// cudaError_t of the launch.
extern "C" int live_partials_pair_launch(const void* d1, const void* d2,
                                         int dtype, const int* loc,
                                         const int* blk, float* o1, float* o2,
                                         int n_tiles, int K, int D, int W,
                                         int n_win, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(d1, d2, loc, blk, o1, o2, n_tiles, K,
                                         D, W, n_win, window != 0, s)
                 : launch<float>(d1, d2, loc, blk, o1, o2, n_tiles, K, D, W,
                                 n_win, window != 0, s);
  return static_cast<int>(err);
}
