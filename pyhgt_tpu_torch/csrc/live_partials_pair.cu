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
// o1, o2 are [NB*W, D] f32, zero-filled by the caller. The kernels (one for a
// runs aux, one for a window aux) and their design are in pair_walk.cuh, which
// live_partials_slab.cu shares; here the two tensors are separate buffers
// whose rows are D values apart.
//
// Bound. Memory: both inputs read once, loc once, the outputs written once.
// At the bench shapes (2 x 226,560 x 512 bf16) the src grouping moves ~633 MB
// (2 x 41,088 x 512 f32 out), ~0.19 ms at 3.35 TB/s; the window case ~468 MB
// (2 x 768 x 512 f32 out), ~0.14 ms.

#include "pair_walk.cuh"

// dtype: 0 = float32, 1 = bfloat16. kind: a PairKind of pair_walk.cuh (the
// runs kernel, the same with dead rows skipped, or the window kernel with loc
// in [0, n_win)). Returns the cudaError_t of the launch.
extern "C" int live_partials_pair_launch(const void* d1, const void* d2,
                                         int dtype, const int* loc,
                                         const int* blk, float* o1, float* o2,
                                         int n_tiles, int K, int D, int W,
                                         int n_win, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? launch_pair(static_cast<const __nv_bfloat16*>(d1),
                        static_cast<const __nv_bfloat16*>(d2), D, loc, blk, o1,
                        o2, n_tiles, K, D, W, n_win, kind, s)
          : launch_pair(static_cast<const float*>(d1),
                        static_cast<const float*>(d2), D, loc, blk, o1, o2,
                        n_tiles, K, D, W, n_win, kind, s);
  return static_cast<int>(err);
}
