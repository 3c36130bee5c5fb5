// The segment-sum walk shared by live_partials.cu (one [E, D] tensor),
// live_partials_pair.cu (two separate [E, D] tensors) and
// live_partials_slab.cu (the two lane halves of one [E, 2D] slab). For NO = 1
// or 2 outputs, inputs d_o whose rows are `ld` values apart (f32 or bf16),
// loc [n_tiles, K] int32 and blk [>= n_tiles] int32:
//
//     out_o[blk[t]*W + loc[t, k], :] += d_o[(t*K + k)*ld : +D]   (f32 sums)
//
// The single tensor and the pair pass ld = D; the slab passes d_1 = d_0 + D
// and ld = 2D, so its rows reach shared memory in one stream. The host builds
// three kinds of aux and tells the wrapper which one it passes
// (ops/pallas_seg.py checks each on the host before the indices reach the
// device):
//
// runs    (sampling/sorted_batch.pallas_seg_aux: target aggregation, g_q, and
//         the src and tab groupings of the backward). loc never decreases
//         within a tile, and rows rise strictly from tile to tile, so every
//         (tile, rank) pair owns its output row.
// dead    the same with loc = -1 on rows that bypass the kernel (the
//         singleton-split aux, pallas_seg_aux_split: off the default paths).
// window  (sampling/sorted_batch.pallas_tab_window_aux: the RTE-table
//         gradients). loc = (block - blk[t])*W + dt is in no order within a
//         tile, lies in [0, n_win = W + V), and row b*W + dt is shared by
//         every tile of meta block b.
//
// Bound. Memory: each input row read once, loc once, each output row written
// once; the additions (one per input value) are 20-100x below the card's f32
// rate. At the OAG batch (85 tiles of K = 384, D = 400 bf16) live_partials
// moves 40.4 MB (12.1 us at 3.35 TB/s), the pair's src grouping 155.6 MB
// (46.4 us), its window 66.9 MB (20.0 us); at the bench batch (590 tiles,
// D = 512) 261.6, 633.2 and 468.0 MB.
//
// Design. The TPU kernels build a one-hot [K, W+V] matrix per tile and carry
// straddle rows across a sequential grid; here each tile's K rows are walked
// in order and every run of equal loc is summed in f32 registers.
// - Split. A tile goes to S blocks, launched as one thread-block cluster;
//   block s walks the K/S consecutive rows [s*K/S, (s+1)*K/S) (its piece). S
//   is the smallest of 1, 2, 4 and 8 that gives at least two blocks per SM
//   (the SM count read once per device), keeping pieces of at least 16 rows
//   and dividing K: at the bench batch (590 tiles) and the ogbn-mag batch
//   (~409) S = 1, at the OAG batch (85 tiles) S = 4. The dead kind keeps
//   S = 1. A block's threads take adjacent 16-byte column vectors of a row
//   (at most 256: wider rows add column chunks, grid.y).
// - Rows by bulk copy. One producer warp streams the piece's rows into a
//   ring of kStages stages in shared memory (cp.async.bulk completing on an
//   mbarrier per stage; an "empty" mbarrier per stage returns the slot once
//   every consumer warp has read it), so a block keeps up to ~16 KB of rows in
//   flight with no load instructions or registers spent on them. A runs
//   piece is one contiguous byte range of each input (of the slab, at
//   stride 2D), copied a stage at a time; the window kind, and rows split
//   into column chunks, copy row by row (the window in its sorted order).
//   The consumer warps walk the stages from shared memory.
// - Runs: joined in a fixed order, no atomics, no memset. Each piece stores
//   the runs that start in it. A piece whose first run began in an earlier
//   piece leaves that run's partial in its shared memory; after
//   cluster.sync() the piece in which the run starts reads the following
//   pieces' partials in rank order (distributed shared memory,
//   cluster.map_shared_rank) while the run continues, even across several
//   pieces (a 384-row padding run spans all of them), adds them and stores
//   the row once; a second cluster.sync() keeps every block's shared memory
//   alive until the reads are done. Two calls give bit-identical output.
//   The wrapper allocates the outputs uninitialised: tile t owns the rows
//   from its first row blk[t]*W + loc[t, 0] up to tile t+1's first row, and
//   its pieces write all of them: each run's row, zeros for rows that loc
//   skips (written where the skip happens), and zeros from the tile's last
//   row up to the next tile's first (by the tile's last piece). The rows
//   before tile 0's first row and after the last tile's last row, up to
//   n_out = NB*W, are zeroed by all blocks together.
// - Dead: dead rows are skipped without ending a run; S = 1, so no joins. An
//   all-dead tile has no first row and would need the host to say which
//   rows it owns, so this kind keeps the caller's zero-filled outputs and
//   stores only its runs' rows.
// - Window: each of the S blocks counting-sorts the tile's K row indices by
//   loc in shared memory (K and n_win are a few hundred; stable when S > 1,
//   so the S blocks agree on the order) and walks its K/S slice of the
//   sorted order, so runs of equal loc come together. Other
//   tiles, and the neighbouring slices, add to the same rows, so a finished
//   run is added with 16-byte f32 global atomics into outputs the caller
//   zero-fills. The order of those additions changes from call to call: the
//   sums agree to f32 rounding, not bit for bit.

#pragma once

#include <cooperative_groups.h>

#include "seg_common.cuh"

namespace {

namespace cg = cooperative_groups;

// Which walk an aux takes; the C entry points receive it as an int
// (ops/pallas_seg.py mirrors the values as PAIR_RUNS, PAIR_WINDOW,
// PAIR_RUNS_DEAD).
enum PairKind : int {
  kPairRuns = 0,      // runs aux: loc sorted within a tile, rows owned
  kPairWindow = 1,    // window aux: loc in any order, rows shared by tiles
  kPairRunsDead = 2,  // runs aux with negative loc entries to skip
};

// The ring: 2 stages of ~8 KB a block, the best of the shapes
// scripts/seg_walk_ring.py times across the bench, ogbn-mag and OAG batches
// (deeper or larger rings were slower: more bytes in flight is not faster
// once the card's reads are covered)
constexpr int kStages = 2;          // ring depth
constexpr int kStageBytes = 8192;   // rows a stage carries, all outputs
// The window kind's rows are read once and its output rows are added to
// again and again: it copies rows with an L2 evict-first policy, so that
// they do not push the output rows out (9% at the OAG batch, 1% at the
// bench batch on the H100); the runs kinds, which store each output row
// once, were 2-5% slower with it at the bench batch.
constexpr bool kWindowEvictFirst = true;
constexpr int kMaxStageRows = 32;
constexpr int kChunkVecs = 256;     // column vectors a block takes at most
constexpr int kMaxSplit = 8;        // blocks per tile: the portable cluster
constexpr int kMinPieceRows = 16;

// The launch, planned on the host (plan_walk) and passed by value.
struct Walk {
  int n_tiles, K, D, ld, W, n_win;
  long long n_out;
  int S, R;          // blocks per tile (cluster size), rows per piece
  int chunks, cw;    // column chunks (grid.y), column vectors per chunk
  int n_cons;        // consumer threads, a multiple of 32; + 1 producer warp
  int SR;            // rows per stage
  int per_row;       // copy row by row (window kind, or column chunks)
  int slab;          // one contiguous stream holds both outputs' rows
  int region_bytes, stage_bytes;
  int off_sloc, off_srow, off_bins, off_part, off_bar, smem;  // bytes
};

inline int align_up(int x, int a) { return (x + a - 1) / a * a; }

inline Walk plan_walk(int n_outs, int elem, bool slab, int kind, int n_tiles,
                      int K, int D, int ld, int W, int n_win,
                      long long n_out, int sms) {
  Walk g{};
  g.n_tiles = n_tiles; g.K = K; g.D = D; g.ld = ld; g.W = W;
  g.n_win = n_win; g.n_out = n_out;
  const int vecs = D * elem / 16;
  g.chunks = (vecs + kChunkVecs - 1) / kChunkVecs;
  g.cw = (vecs + g.chunks - 1) / g.chunks;
  g.n_cons = align_up(g.cw, 32);
  g.S = 1;
  if (kind != kPairRunsDead) {
    while (g.S < kMaxSplit &&
           static_cast<long long>(n_tiles) * g.S * g.chunks < 2LL * sms &&
           K % (2 * g.S) == 0 && K / (2 * g.S) >= kMinPieceRows) {
      g.S *= 2;
    }
  }
  g.R = K / g.S;
  g.per_row = kind == kPairWindow || g.chunks > 1;
  g.slab = slab && !g.per_row;
  // one row of each ring region: a chunk of the row (row by row), or the
  // input's whole row of ld values (a contiguous range)
  const int region_row = g.per_row ? g.cw * 16 : ld * elem;
  const int regions = g.slab ? 1 : n_outs;
  g.SR = kStageBytes / (regions * region_row);
  g.SR = g.SR < 1 ? 1 : (g.SR > kMaxStageRows ? kMaxStageRows : g.SR);
  g.region_bytes = g.SR * region_row;
  g.stage_bytes = regions * g.region_bytes;
  int off = kStages * g.stage_bytes;
  g.off_sloc = off;
  off += K * 4;
  g.off_srow = g.off_bins = off;
  if (kind == kPairWindow) {
    off += K * 4;
    g.off_bins = off;
    off += (n_win + 1) * 4;
  }
  off = align_up(off, 16);
  g.off_part = off;
  if (kind == kPairRuns && g.S > 1) off += n_outs * g.cw * 16 / elem * 4;
  off = align_up(off, 8);
  g.off_bar = off;
  g.smem = off + 2 * kStages * 8;
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, with an L2 evict-first policy if asked; the copy completes
// on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          bool evict_first) {
  if (evict_first) {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(policy));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(dst), "l"(src),
        "r"(bytes), "r"(bar), "l"(policy)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
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

// Zeros into the N columns from `col` of rows [lo, hi) of out [*, D].
template <int N>
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int64_t lo,
                                          int64_t hi, int col, int D) {
  for (int64_t r = lo; r < hi; ++r) {
    float4* dst = reinterpret_cast<float4*>(out + r * D + col);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Counting sort of the tile's rows by loc into sloc (sorted loc) and srow
// (row index within the tile): histogram, exclusive scan (one warp: each
// lane scans a slice of the bins, the lanes' totals by shuffles), then the
// placement. A tile split over S > 1 blocks needs the same order in each of
// them, or their slices of it would overlap and leave rows out: then one
// warp places the rows 32 at a time in row order, lanes of equal loc ranked
// among themselves (__match_any_sync), a stable sort. A block alone on its
// tile lets all threads take the next slot of their row's bin at once (an
// order that changes from call to call; the stable placement there cost the
// bench and ogbn-mag windows 1% on the H100). Ends with the block
// synchronised.
__device__ __forceinline__ void sort_tile(const int* __restrict__ tloc,
                                          int* sloc, int* srow, int* bins,
                                          int K, int n_win, bool stable) {
  for (int i = threadIdx.x; i <= n_win; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    atomicAdd(&bins[__ldg(tloc + k) + 1], 1);
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
    __syncwarp();
    for (int k0 = 0; stable && k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool has = k < K;
      const int l = has ? __ldg(tloc + k) : -1 - lane;  // unmatched if none
      const unsigned peers = __match_any_sync(0xffffffffu, l);
      const int leader = __ffs(peers) - 1;
      const int start = __shfl_sync(0xffffffffu, has ? bins[l] : 0, leader);
      if (has) {
        const int pos = start + __popc(peers & ((1u << lane) - 1u));
        sloc[pos] = l;
        srow[pos] = k;
      }
      __syncwarp();
      if (has && lane == leader) bins[l] = start + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  if (!stable) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const int l = __ldg(tloc + k);
      const int pos = atomicAdd(&bins[l], 1);  // bins[l]: loc l's next slot
      sloc[pos] = l;
      srow[pos] = k;
    }
    __syncthreads();
  }
}

template <typename T, int kKind, int NO>
__global__ void __launch_bounds__(kChunkVecs + 32)
    walk_kernel(const T* __restrict__ d0, const T* __restrict__ d1,
                const int* __restrict__ loc, const int* __restrict__ blk,
                float* __restrict__ o0, float* __restrict__ o1, const Walk g) {
  using V = Vec<T>;
  constexpr int N = V::N;
  constexpr bool kRuns = kKind == kPairRuns;
  constexpr bool kDead = kKind == kPairRunsDead;
  constexpr bool kWin = kKind == kPairWindow;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int s = blockIdx.x % g.S, t = blockIdx.x / g.S;
  const int r0 = s * g.R, r1 = r0 + g.R;
  const int n_stages = (g.R + g.SR - 1) / g.SR;
  const int vecs = g.D / N;
  const int v0 = blockIdx.y * g.cw;            // the chunk's first vector
  const int cw_here = min(g.cw, vecs - v0);
  const bool producer = tid >= g.n_cons;
  const int64_t tile_row = static_cast<int64_t>(t) * g.K;
  const int* tloc = loc + tile_row;
  int* sloc = reinterpret_cast<int*>(smem + g.off_sloc);
  int* srow = reinterpret_cast<int*>(smem + g.off_srow);
  float* part = reinterpret_cast<float*>(smem + g.off_part);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(smem + g.off_bar);
  const uint32_t empty = full + 8 * kStages;

  // Stage j's rows into its slot: lane 0 of `nl` lanes arms the barrier,
  // the lanes share the copies.
  auto issue = [&](int j, int ln, int nl) {
    const int slot = j % kStages;
    const int k0 = r0 + j * g.SR, nrows = min(g.SR, r1 - k0);
    const uint32_t bar = full + 8 * slot;
    const uint32_t dst = ring + slot * g.stage_bytes;
    if (g.per_row) {
      const uint32_t bytes = cw_here * 16;
      if (ln == 0) mbar_expect_tx(bar, NO * nrows * bytes);
      if (nl > 1) __syncwarp();
      for (int q = ln; q < NO * nrows; q += nl) {
        const int o = q >= nrows, i = q - o * nrows;
        const int row = kWin ? srow[k0 + i] : k0 + i;
        bulk_copy(dst + o * g.region_bytes + i * g.cw * 16,
                  (o ? d1 : d0) + (tile_row + row) * g.ld + v0 * N, bytes,
                  bar, kWin && kWindowEvictFirst);
      }
    } else if (ln == 0) {
      const int regions = g.slab ? 1 : NO;
      const uint32_t bytes = nrows * g.ld * static_cast<int>(sizeof(T));
      mbar_expect_tx(bar, regions * bytes);
      for (int o = 0; o < regions; ++o) {
        bulk_copy(dst + o * g.region_bytes,
                  (o ? d1 : d0) + (tile_row + k0) * g.ld, bytes, bar, false);
      }
    }
  };

  if (tid == g.n_cons) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, g.n_cons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // a runs piece needs no loc to start streaming
    if (!kWin) {
      for (int j = 0; j < min(kStages, n_stages); ++j) issue(j, 0, 1);
    }
  }
  if (kWin) {
    sort_tile(tloc, sloc, srow, reinterpret_cast<int*>(smem + g.off_bins),
              g.K, g.n_win, g.S > 1);
  } else {
    for (int k = tid; k < g.K; k += blockDim.x) sloc[k] = __ldg(tloc + k);
    __syncthreads();
  }

  if (producer) {
    for (int j = kWin ? 0 : min(kStages, n_stages); j < n_stages; ++j) {
      if (j >= kStages) {
        mbar_wait(empty + 8 * (j % kStages), ((j / kStages) - 1) & 1);
      }
      issue(j, lane, 32);
    }
  }

  // the rows before tile 0's first row and after the last tile's last row,
  // zeroed by all blocks together
  if (kRuns && !producer) {
    const int64_t first =
        static_cast<int64_t>(__ldg(blk)) * g.W + __ldg(loc);
    const int64_t last =
        static_cast<int64_t>(__ldg(blk + g.n_tiles - 1)) * g.W +
        __ldg(loc + static_cast<int64_t>(g.n_tiles) * g.K - 1);
    const int64_t row4 = g.D / 4;  // float4s a row
    const int64_t head = first * row4, tail = (last + 1) * row4;
    const int64_t count = head + (g.n_out * row4 - tail);
    const int64_t blocks = static_cast<int64_t>(gridDim.x) * gridDim.y;
    const int64_t b = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t i = b * g.n_cons + tid; i < NO * count;
         i += blocks * g.n_cons) {
      const bool second = i >= count;
      const int64_t j = i - (second ? count : 0);
      reinterpret_cast<float4*>(second ? o1 : o0)[j < head ? j
                                                          : tail + j - head] = z;
    }
  }

  const bool act = !producer && tid < cw_here;
  const int col = (v0 + tid) * N;
  const int64_t base = static_cast<int64_t>(__ldg(blk + t)) * g.W;
  float acc[NO][N];
#pragma unroll
  for (int o = 0; o < NO; ++o) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[o][i] = 0.f;
  }
  int cur = kDead ? -1 : sloc[r0];
  bool first = true;  // cur is the piece's first run
  const bool cont = kRuns && s > 0 && sloc[r0 - 1] == cur;
  // my part of a run that began in an earlier piece, for its owner
  auto keep_part = [&]() {
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      float4* p = reinterpret_cast<float4*>(part + (o * g.cw + tid) * N);
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        p[i] = make_float4(acc[o][4 * i], acc[o][4 * i + 1],
                           acc[o][4 * i + 2], acc[o][4 * i + 3]);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) acc[o][i] = 0.f;
    }
  };
  auto store = [&](int l) {
    if (!kDead || l >= 0) {
      flush<N>(o0, base + l, col, g.D, acc[0]);
      if (NO == 2) flush<N>(o1, base + l, col, g.D, acc[NO - 1]);
    }
  };

  if (!producer) {
    if (kRuns && act && s > 0 && !cont) {  // rows loc skips at my start
      zero_rows<N>(o0, base + sloc[r0 - 1] + 1, base + cur, col, g.D);
      if (NO == 2) zero_rows<N>(o1, base + sloc[r0 - 1] + 1, base + cur, col, g.D);
    }
    for (int j = 0; j < n_stages; ++j) {
      const int slot = j % kStages;
      mbar_wait(full + 8 * slot, (j / kStages) & 1);
      const int k0 = r0 + j * g.SR, nrows = min(g.SR, r1 - k0);
      if (act) {
        const unsigned char* st = smem + slot * g.stage_bytes;
#pragma unroll 4
        for (int i = 0; i < nrows; ++i) {
          const int l = sloc[k0 + i];
          if (kDead && l < 0) continue;
          if (l != cur) {  // the run cur ends
            if (kWin) {
              flush_add<N>(o0, base + cur, col, g.D, acc[0]);
              if (NO == 2) flush_add<N>(o1, base + cur, col, g.D, acc[NO - 1]);
            } else if (kRuns && first && cont) {
              keep_part();
            } else {
              store(cur);
            }
            if (kRuns) {  // rows loc skips
              zero_rows<N>(o0, base + cur + 1, base + l, col, g.D);
              if (NO == 2) zero_rows<N>(o1, base + cur + 1, base + l, col, g.D);
            }
            cur = l;
            first = false;
          }
#pragma unroll
          for (int o = 0; o < NO; ++o) {
            // region o of the stage, or the slab's one region at lane o*D
            const int off = g.per_row
                ? (o * g.region_bytes + (i * g.cw + tid) * 16)
                : g.slab ? ((i * g.ld + o * g.D + col) * int(sizeof(T)))
                         : (o * g.region_bytes + (i * g.ld + col) * int(sizeof(T)));
            add_row<T>(*reinterpret_cast<const typename V::Raw*>(st + off),
                       acc[o]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    }
  }

  bool own_last = false;  // the piece's last run starts in it (runs kind)
  if (act) {
    if (kWin) {
      flush_add<N>(o0, base + cur, col, g.D, acc[0]);
      if (NO == 2) flush_add<N>(o1, base + cur, col, g.D, acc[NO - 1]);
    } else if (kDead) {
      store(cur);
    } else if (first && cont) {
      keep_part();
    } else {
      own_last = true;
    }
  }
  if (kRuns && g.S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (own_last) {
      for (int q = s + 1; q < g.S; ++q) {  // the run's later pieces, in order
        if (sloc[q * g.R] != cur) break;
        const float* rp = cluster.map_shared_rank(part, q);
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          const float4* p =
              reinterpret_cast<const float4*>(rp + (o * g.cw + tid) * N);
#pragma unroll
          for (int i = 0; i < N / 4; ++i) {
            const float4 v = p[i];
            acc[o][4 * i] += v.x;
            acc[o][4 * i + 1] += v.y;
            acc[o][4 * i + 2] += v.z;
            acc[o][4 * i + 3] += v.w;
          }
        }
        if (sloc[(q + 1) * g.R - 1] != cur) break;
      }
    }
    cluster.sync();  // no block leaves while another reads its partials
  }
  if (own_last) store(cur);
  // the tile's last piece: zeros from its last row up to the next tile's
  // first row (the last tile's tail is zeroed above)
  if (kRuns && act && s == g.S - 1 && t + 1 < g.n_tiles) {
    const int64_t next = static_cast<int64_t>(__ldg(blk + t + 1)) * g.W +
                         __ldg(tloc + g.K);
    const int64_t last = base + sloc[g.K - 1];
    zero_rows<N>(o0, last + 1, next, col, g.D);
    if (NO == 2) zero_rows<N>(o1, last + 1, next, col, g.D);
  }
}

// The SM count of the current device, read once per device.
inline cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev]) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cached[dev] = *sms;
  return err;
}

template <typename T, int kKind, int NO>
cudaError_t launch_kind(const T* d0, const T* d1, const int* loc,
                        const int* blk, float* o0, float* o1, const Walk& g,
                        cudaStream_t stream) {
  auto kernel = walk_kernel<T, kKind, NO>;
  static bool ready[64] = {};  // the opt-in shared memory set, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(dev < 64 && ready[dev])) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    }
    if (err == cudaSuccess && dev < 64) ready[dev] = true;
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.n_tiles * g.S, g.chunks);
  cfg.blockDim = dim3(g.n_cons + 32);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, d0, d1, loc, blk, o0, o1, g);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// d0, d1: the inputs' first rows, `ld` values from one row to the next (d1
// unused when NO = 1); slab: d1 = d0 + D inside rows of ld = 2D. kind: a
// PairKind. n_out: the outputs' rows (NB*W).
template <typename T, int NO>
cudaError_t launch_walk(const T* d0, const T* d1, int ld, bool slab,
                        const int* loc, const int* blk, float* o0, float* o1,
                        int n_tiles, int K, int D, int W, int n_win,
                        long long n_out, int kind, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Walk g = plan_walk(NO, sizeof(T), slab, kind, n_tiles, K, D, ld, W,
                           n_win, n_out, sms);
  if (kind == kPairWindow) {
    return launch_kind<T, kPairWindow, NO>(d0, d1, loc, blk, o0, o1, g, stream);
  }
  if (kind == kPairRunsDead) {
    return launch_kind<T, kPairRunsDead, NO>(d0, d1, loc, blk, o0, o1, g,
                                             stream);
  }
  return launch_kind<T, kPairRuns, NO>(d0, d1, loc, blk, o0, o1, g, stream);
}

// The launch plan_walk gives on the current device, for the wrappers'
// records: {S, grid.x, grid.y, threads, shared memory bytes, rows per stage,
// row-by-row copies}. Returns the cudaError_t of reading the SM count.
inline int walk_plan(int n_outs, int elem, bool slab, int kind, int n_tiles,
                     int K, int D, int ld, int W, int n_win, int* out) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Walk g = plan_walk(n_outs, elem, slab, kind, n_tiles, K, D, ld, W,
                           n_win, 0, sms);
  const int v[7] = {g.S, g.n_tiles * g.S, g.chunks, g.n_cons + 32, g.smem,
                    g.SR, g.per_row};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

}  // namespace
