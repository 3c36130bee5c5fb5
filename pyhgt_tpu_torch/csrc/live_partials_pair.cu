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
// o1, o2 are [n_out = NB*W, D] f32. For a runs aux the kernel writes every
// row itself (the caller allocates them uninitialised); for a window or
// dead-rows aux the caller zero-fills them. The kernels (runs, dead rows,
// window) and their design are in pair_walk.cuh, which live_partials.cu and
// live_partials_slab.cu share; here the two tensors are separate buffers,
// each streamed into its own region of the shared-memory ring.
//
// Bound. Memory: both inputs read once, loc once, the outputs written once.
// At the bench shapes (2 x 226,560 x 512 bf16) the src grouping moves ~633 MB
// (2 x 41,088 x 512 f32 out), ~0.19 ms at 3.35 TB/s; the window case ~468 MB
// (2 x 768 x 512 f32 out), ~0.14 ms. At the OAG batch (2 x 32,640 x 400
// bf16) 155.6 MB (46 us) and 66.9 MB (20 us).

#include "pair_walk.cuh"

// dtype: 0 = float32, 1 = bfloat16. kind: a PairKind of pair_walk.cuh (the
// runs walk, the same with dead rows skipped, or the window walk with loc
// in [0, n_win)). n_out: the outputs' rows. Returns the cudaError_t of the
// launch.
extern "C" int live_partials_pair_launch(const void* d1, const void* d2,
                                         int dtype, const int* loc,
                                         const int* blk, float* o1, float* o2,
                                         int n_tiles, int K, int D, int W,
                                         int n_win, int kind, long long n_out,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? launch_walk<__nv_bfloat16, 2>(
                static_cast<const __nv_bfloat16*>(d1),
                static_cast<const __nv_bfloat16*>(d2), D, false, loc, blk, o1,
                o2, n_tiles, K, D, W, n_win, n_out, kind, s)
          : launch_walk<float, 2>(static_cast<const float*>(d1),
                                  static_cast<const float*>(d2), D, false, loc,
                                  blk, o1, o2, n_tiles, K, D, W, n_win, n_out,
                                  kind, s);
  return static_cast<int>(err);
}

// The launch the call above makes at these shapes on the current device:
// out[7] = {S, grid.x, grid.y, threads, shared bytes, rows per stage,
// row-by-row copies}. Returns a cudaError_t.
extern "C" int live_partials_pair_plan(int dtype, int n_tiles, int K, int D,
                                       int n_win, int kind, int* out) {
  return walk_plan(2, dtype == 1 ? 2 : 4, false, kind, n_tiles, K, D, D, 0,
                   n_win, out);
}
