// live_partials_slab — two segment sums over the lane halves of ONE slab.
//
// Replaces the TPU kernel pyhgt_tpu/ops/pallas_seg.py:live_partials_slab
// (_live_partials_slab_call / _seg_kernel_slab). Contract, for data
// [n_tiles*K, 2D] (f32 or bf16), loc [n_tiles, K] int32 and blk [>= n_tiles]
// int32:
//
//     o1[blk[t]*W + loc[t, k], :] += data[t*K + k, :D]
//     o2[blk[t]*W + loc[t, k], :] += data[t*K + k, D:]   (f32 accumulation)
//
// o1, o2 are [n_out = NB*W, D] f32: written whole by the kernel for a runs
// aux (the caller allocates them uninitialised), zero-filled by the caller
// for a window or dead-rows aux. The caller (the edge stage's 'slab'
// backward) concatenates g_k and g_v along the lanes so that it pays one
// [E, 2D] row permute instead of two [E, D] ones; this kernel then reads that
// slab in place.
//
// Design. The walks of pair_walk.cuh (runs joined across a cluster, dead
// rows, and the window's counting sort with 16-byte f32 atomics), handed the
// two halves as data and data + D with a row stride of 2D. A runs piece's
// rows are then one contiguous range of the slab, streamed into shared
// memory as one region whose rows hold both halves; the window copies each
// half of each row in its sorted order. Both kinds of aux work: the backward
// gives the slab the src runs aux and the tab-window aux.
//
// Bound. Memory, as the pair: the slab read once, loc once, both outputs
// written once. At the bench shapes (226,560 x 1,024 bf16) the src grouping
// moves ~633 MB (~0.19 ms at 3.35 TB/s), the tab window ~468 MB (~0.14 ms).

#include "pair_walk.cuh"

// dtype: 0 = float32, 1 = bfloat16; D is the width of one half. kind: a
// PairKind of pair_walk.cuh. n_out: the outputs' rows. Returns the
// cudaError_t of the launch.
extern "C" int live_partials_slab_launch(const void* data, int dtype,
                                         const int* loc, const int* blk,
                                         float* o1, float* o2, int n_tiles,
                                         int K, int D, int W, int n_win,
                                         int kind, long long n_out,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(data);
    err = launch_walk<__nv_bfloat16, 2>(p, p + D, 2 * D, true, loc, blk, o1,
                                        o2, n_tiles, K, D, W, n_win, n_out,
                                        kind, s);
  } else {
    const float* p = static_cast<const float*>(data);
    err = launch_walk<float, 2>(p, p + D, 2 * D, true, loc, blk, o1, o2,
                                n_tiles, K, D, W, n_win, n_out, kind, s);
  }
  return static_cast<int>(err);
}

// The launch the call above makes at these shapes on the current device:
// out[7] = {S, grid.x, grid.y, threads, shared bytes, rows per stage,
// row-by-row copies}. Returns a cudaError_t.
extern "C" int live_partials_slab_plan(int dtype, int n_tiles, int K, int D,
                                       int n_win, int kind, int* out) {
  return walk_plan(2, dtype == 1 ? 2 : 4, true, kind, n_tiles, K, D, 2 * D, 0,
                   n_win, out);
}
