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
// o1, o2 are [NB*W, D] f32, zero-filled by the caller. The caller (the edge
// stage's 'slab' backward) concatenates g_k and g_v along the lanes so that
// it pays one [E, 2D] row permute instead of two [E, D] ones; this kernel
// then reads that slab in place.
//
// Design. The same kernels as live_partials_pair (pair_walk.cuh: the register
// walk over runs of equal loc, and for a window aux the counting sort and the
// 16-byte f32 atomics), handed the two halves as base pointers data and
// data + D with a row stride of 2D. A thread's two 16-byte loads of one row
// then lie D values apart in the same 2D-wide row. Both kinds of aux work: the
// backward gives the slab the src runs aux and the tab-window aux.
//
// Bound. Memory, as the pair: the slab read once, loc once, both outputs
// written once. At the bench shapes (226,560 x 1,024 bf16) the src grouping
// moves ~633 MB (~0.19 ms at 3.35 TB/s), the tab window ~468 MB (~0.14 ms).

#include "pair_walk.cuh"

// dtype: 0 = float32, 1 = bfloat16; D is the width of one half. kind: a
// PairKind of pair_walk.cuh. Returns the cudaError_t of the launch.
extern "C" int live_partials_slab_launch(const void* data, int dtype,
                                         const int* loc, const int* blk,
                                         float* o1, float* o2, int n_tiles,
                                         int K, int D, int W, int n_win,
                                         int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(data);
    err = launch_pair(p, p + D, 2 * D, loc, blk, o1, o2, n_tiles, K, D, W,
                      n_win, kind, s);
  } else {
    const float* p = static_cast<const float*>(data);
    err = launch_pair(p, p + D, 2 * D, loc, blk, o1, o2, n_tiles, K, D, W,
                      n_win, kind, s);
  }
  return static_cast<int>(err);
}
