// segment_softmax_partials — per-(tile, local segment) online-softmax partials
// of target-sorted attention logits.
//
// Replaces the TPU kernel pyhgt_tpu/ops/pallas_seg.py:segment_softmax_partials
// (_softmax_partials_call / _softmax_kernel). Contract, for att
// [n_tiles*K, H] f32, loc [n_tiles, K] int32 (sorted within a tile: a runs
// aux) and blk [>= n_tiles] int32, per run r of equal loc in tile t and head h:
//
//     m     = max_{e in r} att[e, h]
//     m_can = f32(bf16(m))                  (round to nearest even)
//     s     = sum_{e in r} (att[e, h] > -5e29 ? exp(min(att[e, h] - m_can, 80))
//                                             : 0)
//     m_rows[blk[t]*W + loc, h] = m_can,   s_rows[blk[t]*W + loc, h] = s
//
// m_rows, s_rows are [NB*W, H] f32, zero-filled by the caller, so rows that no
// run reaches are 0 in both. The emitted max is the bf16 rounding of the run's
// max to the letter: the level-2 merge (ops/sorted_hgt._softmax_pallas)
// rescales each row by exp(m_row - m_seg), and the exp here uses the same
// rounded value, so the softmax stays exact while the stabilizer is up to
// 0.4% off the true max. Masked edges carry -1e30 and can share a run with
// live ones, so the > -5e29 gate is per row; a run of masked rows only gives
// a finite m (the rounding of -1e30) and s = 0. The min(.., 80) bounds the
// exponent when the rounded max lies below a row's logit.
//
// Design. The TPU kernel finds each run's max with forward and backward
// Hillis-Steele shift scans over the tile and emits rows through one-hot
// matmuls into a carried accumulator. Here one block owns one tile: the
// tile's [K, H] logits (12 KB at K = 384, H = 8) and its loc row sit in shared
// memory, and each (row that starts a run, head) pair is one work item: its
// thread walks the run twice in shared memory (max, then sum) and stores the
// two values. Every (tile, run) owns its output row: no carry, no atomics.
// A long run is walked by one thread per head, which costs microseconds at
// most (K rows).
//
// Bound. Memory: att read once, loc once, the two outputs written once. At
// the bench shapes (226,560 x 8 f32 in, 2 x 14,592 x 8 f32 out on the legacy
// W = 384 aux) that is ~9 MB, ~3 us at 3.35 TB/s: the launch itself is of
// the same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void softmax_partials_kernel(const float* __restrict__ att,
                                        const int* __restrict__ loc,
                                        const int* __restrict__ blk,
                                        float* __restrict__ m_rows,
                                        float* __restrict__ s_rows, int K,
                                        int H, int W) {
  extern __shared__ float smem[];
  float* satt = smem;                              // [K, H]
  int* sloc = reinterpret_cast<int*>(smem + K * H);  // [K]
  const int t = blockIdx.x;
  const float* tatt = att + static_cast<int64_t>(t) * K * H;
  for (int i = threadIdx.x; i < K * H; i += blockDim.x) satt[i] = tatt[i];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    sloc[k] = loc[static_cast<int64_t>(t) * K + k];
  }
  __syncthreads();

  const int64_t base = static_cast<int64_t>(blk[t]) * W;
  for (int i = threadIdx.x; i < K * H; i += blockDim.x) {
    const int k = i / H;
    const int h = i - k * H;
    const int l = sloc[k];
    if (k > 0 && sloc[k - 1] == l) continue;  // not the first row of a run
    float m = satt[i];
    int end = k + 1;
    while (end < K && sloc[end] == l) {
      m = fmaxf(m, satt[end * H + h]);
      ++end;
    }
    const float m_can = __bfloat162float(__float2bfloat16_rn(m));
    float s = 0.f;
    for (int j = k; j < end; ++j) {
      const float a = satt[j * H + h];
      if (a > -5e29f) s += expf(fminf(a - m_can, 80.f));
    }
    const int64_t o = (base + l) * H + h;
    m_rows[o] = m_can;
    s_rows[o] = s;
  }
}

}  // namespace

// Returns the cudaError_t of the launch. The caller keeps K*(H+1)*4 bytes
// within the 48 KB of shared memory a block gets without opting in.
extern "C" int segment_softmax_partials_launch(const float* att,
                                               const int* loc, const int* blk,
                                               float* m_rows, float* s_rows,
                                               int n_tiles, int K, int H,
                                               int W, void* stream) {
  const size_t smem = static_cast<size_t>(K) * (H + 1) * sizeof(float);
  softmax_partials_kernel<<<n_tiles, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      att, loc, blk, m_rows, s_rows, K, H, W);
  return static_cast<int>(cudaGetLastError());
}
