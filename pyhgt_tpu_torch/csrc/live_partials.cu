// live_partials — per-(tile, local segment) partial sums of segment-sorted rows.
//
// Replaces the TPU kernel pyhgt_tpu/ops/pallas_seg.py:live_partials
// (_live_partials_call / _seg_kernel). Contract, for data [n_tiles*K, D]
// (f32 or bf16), loc [n_tiles, K] int32 and blk [>= n_tiles] int32:
//
//     out[blk[t]*W + loc[t, k], :] += data[t*K + k, :]   (f32 accumulation)
//
// out is [n_out = NB*W, D] f32; rows that no edge reaches are 0. The host aux
// (sampling/sorted_batch.pallas_seg_aux) numbers each tile's distinct
// segments with consecutive ranks, so loc is non-decreasing within a tile
// and no output row is reached from two tiles: every (tile, rank) pair owns
// its row. The wrapper checks exactly that, and that every row lies inside
// out, on the host before the indices reach the device
// (ops/pallas_seg.py:PallasSegAux.to). In an aux marked dead_rows (the
// singleton-split aux, sampling/sorted_batch.pallas_seg_aux_split) a
// negative loc marks a dead row, which the walk skips (kPairRunsDead).
//
// Design: the walk of pair_walk.cuh with one output. A tile is split over
// S = 1, 2, 4 or 8 blocks of one thread-block cluster (the smallest that
// gives two blocks per SM: S = 4 at the OAG batch's 85 tiles, 1 at the bench
// batch's 590); a producer warp streams each block's K/S rows, one
// contiguous range, into a shared-memory ring by bulk copies; the consumer
// threads sum runs of equal loc in f32 registers, one 16-byte column vector
// each, and a run split between blocks is joined in rank order through
// distributed shared memory: no atomics, bit-identical across calls. The
// kernel writes every row of its output itself, zeros included, so the
// wrapper allocates it uninitialised and the call is one launch; the dead
// kind keeps S = 1 and the caller's zero-filled output.
//
// Bound. Memory: each input row read once, loc once, each output row written
// once; the additions are ~D per edge, far below the card's f32 rate. At the
// bench shapes (226,560 x 512 bf16 in, 14,016 x 512 f32 out) that is
// ~262 MB, or ~78 us at 3.35 TB/s; at the OAG batch (32,640 x 400 bf16 in,
// 8,832 x 400 f32 out) 40.4 MB, ~12 us.

#include "pair_walk.cuh"

// dtype: 0 = float32, 1 = bfloat16. dead_rows: the aux may hold negative loc
// entries to skip (out must then be zero-filled). n_out: out's rows.
// Returns the cudaError_t of the launch.
extern "C" int live_partials_launch(const void* data, int dtype,
                                    const int* loc, const int* blk,
                                    float* out, int n_tiles, int K, int D,
                                    int W, int dead_rows, long long n_out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kind = dead_rows ? kPairRunsDead : kPairRuns;
  cudaError_t err;
  if (dtype == 1) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(data);
    err = launch_walk<__nv_bfloat16, 1>(p, p, D, false, loc, blk, out, out,
                                        n_tiles, K, D, W, 0, n_out, kind, s);
  } else {
    const float* p = static_cast<const float*>(data);
    err = launch_walk<float, 1>(p, p, D, false, loc, blk, out, out, n_tiles,
                                K, D, W, 0, n_out, kind, s);
  }
  return static_cast<int>(err);
}

// The launch the call above makes at these shapes on the current device:
// out[7] = {S, grid.x, grid.y, threads, shared bytes, rows per stage,
// row-by-row copies}. Returns a cudaError_t.
extern "C" int live_partials_plan(int dtype, int n_tiles, int K, int D,
                                  int dead_rows, int* out) {
  const int elem = dtype == 1 ? 2 : 4;
  return walk_plan(1, elem, false, dead_rows ? kPairRunsDead : kPairRuns,
                   n_tiles, K, D, D, 0, 0, out);
}
