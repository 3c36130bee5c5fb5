// The two-tensor segment-sum kernels shared by live_partials_pair.cu (two
// separate [E, D] tensors) and live_partials_slab.cu (the two lane halves of
// one [E, 2D] slab). Both compute, for d1, d2 whose rows are `ld` values
// apart (both f32 or both bf16), loc [n_tiles, K] int32 and blk [>= n_tiles]
// int32:
//
//     o1[blk[t]*W + loc[t, k], :] += d1[(t*K + k)*ld : +D]
//     o2[blk[t]*W + loc[t, k], :] += d2[(t*K + k)*ld : +D]   (f32 sums)
//
// o1, o2 are [NB*W, D] f32, zero-filled by the caller. The pair passes
// ld = D; the slab passes d1 = data, d2 = data + D and ld = 2D, so one
// kernel body serves both and the slab reads its input in one stream. The
// host builds two kinds of aux and tells the wrapper which one it passes
// (ops/pallas_seg.py checks either on the host before the indices reach the
// device):
//
// runs    (sampling/sorted_batch.pallas_seg_aux: the src and tab groupings of
//         the backward's g_k/g_v sums). loc never decreases within a tile and
//         every (tile, rank) pair owns its output row. Same walk as
//         live_partials.cu, with both tensors' current run in f32 registers
//         and loc read once: no carry, no atomics. In an aux marked
//         dead_rows (the singleton-split aux, pallas_seg_aux_split: degree-1
//         segments bypass the kernel) a negative loc marks a dead row: the
//         walk stores the run it holds and skips the row (kDead; compiled
//         out for every other aux).
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

#pragma once

#include "seg_common.cuh"

namespace {

constexpr int kPairUnroll = 4;  // rows of each tensor loaded ahead per thread

// Which kernel an aux takes; the C entry points receive it as an int
// (ops/pallas_seg.py mirrors the values as PAIR_RUNS, PAIR_WINDOW,
// PAIR_RUNS_DEAD).
enum PairKind : int {
  kPairRuns = 0,      // runs aux: loc sorted within a tile, rows owned
  kPairWindow = 1,    // window aux: loc in any order, rows shared by tiles
  kPairRunsDead = 2,  // runs aux with negative loc entries to skip
};

template <typename T, bool kDead>
__global__ void pair_runs_kernel(const T* __restrict__ d1,
                                 const T* __restrict__ d2,
                                 const int* __restrict__ loc,
                                 const int* __restrict__ blk,
                                 float* __restrict__ o1,
                                 float* __restrict__ o2, int K, int D, int ld,
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
  const int64_t off = static_cast<int64_t>(t) * K * ld + col;
  const typename V::Raw* s1 = reinterpret_cast<const typename V::Raw*>(d1 + off);
  const typename V::Raw* s2 = reinterpret_cast<const typename V::Raw*>(d2 + off);
  const int64_t stride = ld / N;  // Raw vectors per row
  float a1[N], a2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a1[i] = a2[i] = 0.f;
  int cur = sloc[0];

  for (int k0 = 0; k0 < K; k0 += kPairUnroll) {
    typename V::Raw r1[kPairUnroll], r2[kPairUnroll];
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      if (k0 + u < K) {
        r1[u] = __ldcs(s1 + (k0 + u) * stride);
        r2[u] = __ldcs(s2 + (k0 + u) * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      if (k0 + u < K) {
        const int l = sloc[k0 + u];
        if (l != cur) {
          if (!kDead || cur >= 0) {
            flush<N>(o1, base + cur, col, D, a1);
            flush<N>(o2, base + cur, col, D, a2);
          }
          cur = l;
        }
        if (!kDead || l >= 0) {
          add_row<T>(r1[u], a1);
          add_row<T>(r2[u], a2);
        }
      }
    }
  }
  if (!kDead || cur >= 0) {
    flush<N>(o1, base + cur, col, D, a1);
    flush<N>(o2, base + cur, col, D, a2);
  }
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
                                   int ld, int W, int n_win) {
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
  const int64_t off = static_cast<int64_t>(t) * K * ld + col;
  const typename V::Raw* s1 = reinterpret_cast<const typename V::Raw*>(d1 + off);
  const typename V::Raw* s2 = reinterpret_cast<const typename V::Raw*>(d2 + off);
  const int64_t stride = ld / N;  // Raw vectors per row
  float a1[N], a2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a1[i] = a2[i] = 0.f;
  int cur = sloc[0];

  for (int k0 = 0; k0 < K; k0 += kPairUnroll) {
    typename V::Raw r1[kPairUnroll], r2[kPairUnroll];
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      if (k0 + u < K) {
        const int64_t row = srow[k0 + u];
        r1[u] = __ldcs(s1 + row * stride);
        r2[u] = __ldcs(s2 + row * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
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

// d1, d2: the two tensors' first rows, `ld` values from one row to the next.
// kind: a PairKind.
template <typename T>
cudaError_t launch_pair(const T* d1, const T* d2, int ld, const int* loc,
                        const int* blk, float* o1, float* o2, int n_tiles,
                        int K, int D, int W, int n_win, int kind,
                        cudaStream_t stream) {
  dim3 grid;
  int threads;
  row_grid(n_tiles, D / Vec<T>::N, &grid, &threads);
  const size_t smem = K * sizeof(int);
  if (kind == kPairWindow) {
    pair_window_kernel<T>
        <<<grid, threads, window_smem_bytes(K, n_win), stream>>>(
            d1, d2, loc, blk, o1, o2, K, D, ld, W, n_win);
  } else if (kind == kPairRunsDead) {
    pair_runs_kernel<T, true><<<grid, threads, smem, stream>>>(
        d1, d2, loc, blk, o1, o2, K, D, ld, W);
  } else {
    pair_runs_kernel<T, false><<<grid, threads, smem, stream>>>(
        d1, d2, loc, blk, o1, o2, K, D, ld, W);
  }
  return cudaGetLastError();
}

}  // namespace
