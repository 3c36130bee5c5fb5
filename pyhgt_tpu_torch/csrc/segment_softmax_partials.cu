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
// m_rows, s_rows are [n_out = NB*W, H] f32; rows that no run reaches are 0 in
// both, and the kernel writes them itself (the caller allocates the outputs
// uninitialised). The emitted max is the bf16 rounding of the run's max to
// the letter: the level-2 merge (ops/sorted_hgt._softmax_pallas) rescales
// each row by exp(m_row - m_seg), and the exp here uses the same rounded
// value, so the softmax stays exact while the stabilizer is up to 0.4% off
// the true max. Masked edges carry -1e30 and can share a run with live ones,
// so the > -5e29 gate is per row; a run of masked rows only gives a finite m
// (the rounding of -1e30) and s = 0. The min(.., 80) bounds the exponent when
// the rounded max lies below a row's logit.
//
// Bound. Memory: att, loc and blk read once, the two outputs written once.
// At the bench shapes (att [226,560, 8] f32 = 590 tiles of K = 384, 2 x
// [14,592, 8] f32 out on the legacy W = 384 aux) that is 9.1 MB, 2.7 us at
// 3.35 TB/s; the arithmetic (5 operations per logit) is far below it. A tile
// is only 13.5 KB, so what bounds the kernel in practice is latency: the
// launch of one wave of blocks, one round trip to memory per tile while the
// whole call's 8 MB are requested at once, and then the walk's dependent
// steps, for which the blocks of an SM compete.
//
// Design.
// - One block of 8 warps per tile, one launch per call, no memset: tile t
//   owns the output rows from its first row blk[t]*W + loc[t, 0] up to
//   tile t+1's first row (tile 0 from row 0, the last tile up to n_out). It
//   writes its runs' rows and zeroes the rest of that interval. The runs
//   contract (rows rise within a tile and strictly from tile to tile,
//   ops/pallas_seg.check_rows) makes the intervals disjoint and covering:
//   no atomics.
// - One wave: at K = 384, H = 8 a block takes 33 KB of shared memory and 48
//   registers a thread (kMinBlocks), so 5 blocks fit an SM and the 590 tiles
//   all start at once on 132 SMs.
// - The tile reaches shared memory by one bulk copy (TMA, cp.async.bulk) of
//   att's [K, H] rows and one of loc's, issued by one thread at the block's
//   start and completing on an mbarrier: no registers or load instructions
//   spent on it. It lands row-major, where a per-head walk would put all 32
//   lanes on one bank, so all threads then scatter it, 16 bytes at a time,
//   into a head-major layout.
// - Shared layout: per head, 32 lane chunks of C = ceil(K/32) rows, each
//   followed by one pad word, so lane l's row i sits at word l*(C+1) + i:
//   the walks read and write shared memory without bank conflicts. loc
//   shares that padding.
// - Every thread busy, whatever the run lengths: warp w takes heads w, w+8,
//   ...; lane l walks rows [l*C, l*C + C). Where runs start and end in its
//   chunk is the same for every head, so each lane reads its loc once into
//   two bit masks, and the passes over the logits only test bits: pass 1
//   forward keeps the running max of each piece (a run's rows inside the
//   chunk), pass 2 backward takes each piece's rounded max at its last row
//   and sums the exps, with no branch on the data. Runs that cross chunk
//   boundaries are joined by a warp-level segmented scan keyed by the
//   chunk's last loc (__shfl_up_sync, 5 rounds): a max pass, the rounded max
//   handed back to every lane of the run, then the sum pass. A hub run over
//   the whole tile costs 2 x 12 steps plus the scans, not 2 x 384 steps on
//   one thread. Every sum is taken in a fixed order (backward within a
//   chunk, the scan's tree across lanes), so two calls on the same input
//   give bit-identical sums.
// - A run's values are left at its first row (its max in a buffer that pass
//   1 used for running maxima, its sum over the logit just consumed), and a
//   table from each slot (loc - loc[t, 0]) to its run's first row, -1 where
//   no run takes the slot, lets the block write the tile's output rows as
//   one coalesced slab per output, zeros included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// blocks an SM must hold so that the bench's 590 tiles run in one wave on
// 132 SMs: caps the registers at 48 a thread
constexpr int kMinBlocks = 5;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoRow = 0x7fffffff;  // loc key of a lane without rows

// What a lane knows of its chunk, the same for every head. Bit i of starts:
// row i begins a run (bit 0 clear when the run came from the previous lane);
// bit i of ends: row i is the last of its piece (bit n - 1 always set).
// first_end is the last row of the first piece, last_start the first row of
// the last piece (0 when the whole chunk continues an earlier lane's run).
struct Lane {
  unsigned starts, ends;
  int first_end, last_start;
  int seg_lo, seg_hi;   // the lanes that share my last run
  unsigned flags;       // kHas | kCont | kSpills | kSpillEnds | kOnePiece
};
constexpr int kLaneWords = sizeof(Lane) / 4;
// flags: the chunk has rows; its first run began in an earlier lane; its
// last run goes on into the next lane; ... and ends in that lane's chunk;
// the chunk is one piece
constexpr unsigned kHas = 1, kCont = 2, kSpills = 4, kSpillEnds = 8,
                   kOnePiece = 16;

// Shared memory of one tile, in 4-byte words: the logits (then the runs'
// sums) and the running maxima (then the runs' rounded maxima), each [H][hs]
// head-major with a pad word after every lane chunk of C rows (hs =
// 32 (C + 1) + 8: the final pass reads H heads of one row, 8 words apart,
// two per bank at most); loc [32 (C + 1)] padded the same way; the first
// row of each slot's run [window]; what each lane knows of its chunk [32];
// the copy's barrier. The tile lands, as it lies in memory (att [K, H] then
// loc [K]), where the maxima go later: raw = m.
struct Layout {
  int hs, m, loc, first, lanes, bar, words;
};

__host__ __device__ inline int chunk_rows(int K) { return (K + 31) / 32; }

__host__ __device__ inline Layout layout(int C, int H, int window) {
  Layout L;
  const int K = 32 * C;       // rows the chunks hold, at least the tile's
  L.hs = 32 * (C + 1) + 8;    // a multiple of 4: raw starts 16-byte aligned
  L.m = H * L.hs;
  L.loc = L.m + (H * L.hs > K * (H + 1) ? H * L.hs : K * (H + 1));
  L.first = L.loc + 32 * (C + 1);
  L.lanes = L.first + window;
  L.bar = (L.lanes + 32 * kLaneWords + 1) & ~1;   // 8-byte aligned
  L.words = L.bar + 2;
  return L;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// Inclusive scan over the lanes [lo, lane] of the caller's segment.
template <typename Op>
__device__ __forceinline__ float seg_scan(float v, int lane, int lo, Op op) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, v, d);
    if (lane - d >= lo) v = op(v, o);
  }
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory; the copy completes on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// What lane `lane` knows of its chunk lrow[0, n) (rows k0 .., loc padded
// as in sloc), computed by one warp for all.
template <int kC>
__device__ __forceinline__ Lane lane_info(const int* lrow, const int* sloc,
                                          int k0, int n, int C, int lane) {
  Lane ln{0u, 0u, 0, 0, 0, 0, 0u};
  const bool has = n > 0;
  const int hk = has ? lrow[0] : kNoRow;
  const int tk = has ? lrow[n - 1] : kNoRow;
  if (has) {
    int prev = k0 > 0 ? sloc[(k0 - 1) + (k0 - 1) / C] : kNoRow;
#pragma unroll
    for (int i = 0; i < (kC ? kC : n); ++i) {
      const int l = lrow[i];
      const int next = i + 1 < n ? lrow[i + 1] : kNoRow;
      ln.starts |= static_cast<unsigned>(l != prev) << i;
      ln.ends |= static_cast<unsigned>(l != next) << i;
      prev = l;
    }
    ln.first_end = __ffs(ln.ends) - 1;
    ln.last_start = ln.starts ? 31 - __clz(ln.starts) : 0;
  }
  const int prev_tk = __shfl_up_sync(kFull, tk, 1);
  const int next_hk = __shfl_down_sync(kFull, hk, 1);
  const int next_tk = __shfl_down_sync(kFull, tk, 1);
  const bool spills = has && lane < 31 && next_hk == tk;
  ln.flags = (has ? kHas : 0u) |
             (has && lane > 0 && hk == prev_tk ? kCont : 0u) |
             (spills ? kSpills : 0u) |
             (spills && next_tk != tk ? kSpillEnds : 0u) |
             (hk == tk ? kOnePiece : 0u);
  // lanes sharing a last run form one segment of the scans; its first lane
  // holds the run's first row
  const unsigned seg_start = __ballot_sync(kFull, lane == 0 || prev_tk != tk);
  const unsigned seg_end = __ballot_sync(kFull, lane == 31 || next_tk != tk);
  ln.seg_lo = 31 - __clz(seg_start & (kFull >> (31 - lane)));
  ln.seg_hi = __ffs(seg_end & (kFull << lane)) - 1;
  return ln;
}

// Pass 1 over one head of one chunk, forward: the running max of every
// piece, kept at each row of rmax. Returns the last piece's max.
template <int kC>
__device__ __forceinline__ float chunk_max(const float* __restrict__ a,
                                          float* __restrict__ rmax, int n,
                                          unsigned starts) {
  float cur = -INFINITY;
#pragma unroll
  for (int i = 0; i < (kC ? kC : n); ++i) {
    const float x = a[i];
    cur = i == 0 || (starts >> i & 1u) ? x : fmaxf(cur, x);
    rmax[i] = cur;
  }
  return cur;
}

// Pass 2, backward: each piece's rounded max, taken at its last row from
// rmax (where the caller has put the first and the last piece's), and the
// sum of its gated exps. At the first row of each run the rounded max
// replaces the running max in rmax and the sum replaces the logit in a.
// Returns the first piece's sum.
//
// The exps are ex2.approx of a scaled argument (__expf): a relative error
// of about 2^-21 at the arguments of a run's larger terms, far inside the
// 1e-5 to which the sums are held, and half the instructions of expf.
template <int kC>
__device__ __forceinline__ float chunk_sum(float* __restrict__ a,
                                          float* __restrict__ rmax, int n,
                                          const Lane& ln) {
  float s = 0.f, m = 0.f;
#pragma unroll
  for (int j = (kC ? kC : n) - 1; j >= 0; --j) {
    const bool end = ln.ends >> j & 1u;
    if (end) m = bf16_round(rmax[j]);
    const float x = a[j];
    const float e = x > -5e29f ? __expf(fminf(x - m, 80.f)) : 0.f;
    s = end ? e : s + e;
    if (ln.starts >> j & 1u) {
      rmax[j] = m;
      a[j] = s;
    }
  }
  return s;
}

// kH, kC: the head count and the rows of every lane's chunk fixed at
// compile time (the bench shapes: 8 heads, K = 32 kC = 384), so that the
// index arithmetic is shifts and multiplies and the passes unroll; 0 takes
// them from the arguments (any other shape).
template <int kH, int kC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
softmax_partials_kernel(const float* __restrict__ att,
                        const int* __restrict__ loc,
                        const int* __restrict__ blk, float* __restrict__ m_rows,
                        float* __restrict__ s_rows, int n_tiles, int K,
                        int h_arg, int W, int window, int64_t n_out) {
#if SOFTMAX_PARTIALS_FLOOR == 2  // defined only to time an empty launch
  return;
#endif
  extern __shared__ __align__(16) float smem[];
  const int H = kH ? kH : h_arg;
  const int C = kC ? kC : chunk_rows(K);
  const Layout L = layout(C, H, window);
  int* sloc = reinterpret_cast<int*>(smem + L.loc);
  int* first_row = reinterpret_cast<int*>(smem + L.first);
  Lane* lanes = reinterpret_cast<Lane*>(smem + L.lanes);
  const int t = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // the interval of output rows this tile owns
  const int64_t tl = static_cast<int64_t>(t) * K;
  const int64_t start =
      static_cast<int64_t>(__ldg(blk + t)) * W + __ldg(loc + tl);
  const int64_t end = t + 1 < n_tiles
      ? static_cast<int64_t>(__ldg(blk + t + 1)) * W + __ldg(loc + tl + K)
      : n_out;
  const int64_t lo = t == 0 ? 0 : start;

  // 1. the tile into shared memory by one bulk copy (att [K, H], then loc
  // [K]), completing on an mbarrier; then scattered by all threads into the
  // head-major layout
  float* raw = smem + L.m;
  const uint32_t bar = smem_addr(smem + L.bar);
  if (tid == 0) {
    const uint32_t att_bytes = K * H * 4, loc_bytes = K * 4;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(att_bytes + loc_bytes) : "memory");
    bulk_copy(smem_addr(raw), att + tl * H, att_bytes, bar);
    bulk_copy(smem_addr(raw + K * H), loc + tl, loc_bytes, bar);
  }
  __syncthreads();          // the barrier is initialised before the waits
  uint32_t landed = 0;
  while (!landed) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(landed) : "r"(bar) : "memory");
  }
  const int n_att = K * H / 4;
  for (int i = tid; i < n_att + K / 4; i += kThreads) {
    const uint4 v = reinterpret_cast<const uint4*>(raw)[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if (i < n_att && H % 4 == 0) {     // the vector lies in one row
      const int k = 4 * i / H, h = 4 * i - k * H, p = h * L.hs + k + k / C;
#pragma unroll
      for (int q = 0; q < 4; ++q) smem[p + q * L.hs] = __uint_as_float(w[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (i < n_att) {
          const int e = 4 * i + q, k = e / H, h = e - k * H;
          smem[h * L.hs + k + k / C] = __uint_as_float(w[q]);
        } else {
          const int k = 4 * (i - n_att) + q;
          sloc[k + k / C] = static_cast<int>(w[q]);
        }
      }
    }
  }
  __syncthreads();

  // 2. the table from slot to its run's first row, -1 for the slots between
  // runs (where loc skips values), read by the final pass; and, by warp 0,
  // what each lane knows of its chunk, read by every warp's walk
  const int loc0 = sloc[0];
  for (int k = tid; k < K; k += kThreads) {
    const int l = sloc[k + k / C];
    const int lp = k > 0 ? sloc[(k - 1) + (k - 1) / C] : l - 1;
    if (l != lp) first_row[l - loc0] = k;
    for (int g = lp + 1; g < l; ++g) first_row[g - loc0] = -1;
  }
  const int k0 = lane * C, n = kC ? kC : min(C, K - k0);
  const int* lrow = sloc + lane * (C + 1);
  if (warp == 0) lanes[lane] = lane_info<kC>(lrow, sloc, k0, n, C, lane);
  __syncthreads();

  // 3. the walk: warp w takes heads w, w + 8, ...
  const Lane ln = lanes[lane];
  const bool has = ln.flags & kHas;
#ifndef SOFTMAX_PARTIALS_FLOOR  // defined only to time the loads and stores
  for (int h = warp; h < H; h += kWarps) {
    float* a = smem + h * L.hs + lane * (C + 1);
    float* rmax = smem + L.m + h * L.hs + lane * (C + 1);

    float first_max = -INFINITY, last_max = -INFINITY;
    if (has) {
      last_max = chunk_max<kC>(a, rmax, n, ln.starts);
      first_max = rmax[ln.first_end];
    }
    // the last run's max over every lane it touches
    const float next_first_max = __shfl_down_sync(kFull, first_max, 1);
    float g = seg_scan(
        ln.flags & kSpills ? fmaxf(last_max, next_first_max) : last_max, lane,
        ln.seg_lo, Max());
    g = __shfl_sync(kFull, g, ln.seg_hi);
    const float prev_g = __shfl_up_sync(kFull, g, 1);
    const float m_last = bf16_round(g);
    const float m_first = ln.flags & kCont ? bf16_round(prev_g)
                          : ln.flags & kOnePiece ? m_last
                                                 : bf16_round(first_max);

    float first_sum = 0.f, last_sum = 0.f;
    if (has) {
      rmax[ln.first_end] = m_first;
      rmax[n - 1] = m_last;
      first_sum = chunk_sum<kC>(a, rmax, n, ln);
      last_sum = ln.starts ? a[ln.last_start] : first_sum;
    }
    const float next_first_sum = __shfl_down_sync(kFull, first_sum, 1);
    float total = seg_scan(
        ln.flags & kSpillEnds ? last_sum + next_first_sum : last_sum, lane,
        ln.seg_lo, Add());
    total = __shfl_sync(kFull, total, ln.seg_hi);
    if (has && lane == ln.seg_lo) {
      rmax[ln.last_start] = m_last;
      a[ln.last_start] = total;
    }
  }
#endif
  __syncthreads();

  // 4. the rows [lo, end) as one coalesced slab per output: each slot's run
  // values from its first row, zeros for the slots no run takes, before the
  // first slot (tile 0 only) and after the last
  const int span = sloc[(K - 1) + (K - 1) / C] - loc0 + 1;
  const int64_t first_word = lo * H;
  const int n_words = static_cast<int>((end - lo) * H);
  const int skip = static_cast<int>(start - lo);   // slots before slot 0
  for (int i = tid; i < n_words; i += kThreads) {
    const int r = i / H, h = i - r * H, slot = r - skip;
    const int k = slot >= 0 && slot < span ? first_row[slot] : -1;
    float m = 0.f, s = 0.f;
    if (k >= 0) {
      const int at = h * L.hs + k + k / C;
      m = smem[L.m + at];
      s = smem[at];
    }
    m_rows[first_word + i] = m;
    s_rows[first_word + i] = s;
  }
}

size_t smem_bytes(int K, int H, int window) {
  return static_cast<size_t>(layout(chunk_rows(K), H, window).words) *
         sizeof(float);
}

using Kernel = void (*)(const float*, const int*, const int*, float*, float*,
                        int, int, int, int, int, int64_t);

// The instance for a shape: the bench's (8 heads, K = 384: 12 rows in every
// lane) or the general one.
Kernel kernel_for(int K, int H) {
  if (H == 8 && K == 32 * 12) return softmax_partials_kernel<8, 12>;
  return softmax_partials_kernel<0, 0>;
}

// Let the kernel take up to the opt-in shared memory of the device, and
// prefer shared memory over L1 so that the blocks of one wave fit (once per
// device).
int prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev]) return 0;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  const Kernel kernels[] = {softmax_partials_kernel<8, 12>,
                            softmax_partials_kernel<0, 0>};
  for (Kernel k : kernels) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(k,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
  }
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return static_cast<int>(err);
}

}  // namespace

// Returns the cudaError_t of the launch. window = W + V bounds loc: a tile's
// runs take at most that many slots. The caller keeps K a multiple of 4 and
// at most 1024, att and loc 16-byte aligned, the rows blk[t]*W + loc inside
// [0, n_out) and segment_softmax_partials_smem(K, H, window) within the
// device's opt-in shared memory per block.
extern "C" int segment_softmax_partials_launch(const float* att,
                                               const int* loc, const int* blk,
                                               float* m_rows, float* s_rows,
                                               int n_tiles, int K, int H,
                                               int W, int window,
                                               long long n_out, void* stream) {
  const int err = prepare();
  if (err) return err;
  kernel_for(K, H)<<<n_tiles, kThreads, smem_bytes(K, H, window),
                     static_cast<cudaStream_t>(stream)>>>(
      att, loc, blk, m_rows, s_rows, n_tiles, K, H, W, window, n_out);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one block takes for a tile of K rows and H heads, in bytes.
extern "C" long long segment_softmax_partials_smem(int K, int H, int window) {
  return static_cast<long long>(smem_bytes(K, H, window));
}

// Blocks of the kernel resident on one SM at (K, H, window), or
// -cudaError_t.
extern "C" int segment_softmax_partials_blocks_per_sm(int K, int H,
                                                      int window) {
  int err = prepare();
  int blocks = 0;
  if (!err) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel_for(K, H), kThreads, smem_bytes(K, H, window)));
  }
  return err ? -err : blocks;
}
