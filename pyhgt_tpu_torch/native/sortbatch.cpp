// Native host batch-prep core for the target-sorted edge layout.
//
// The TPU device program (pyhgt_tpu/ops/sorted_hgt.py) consumes
// host-precomputed permutations + segment pointers + reduction aux
// (pyhgt_tpu/sampling/sorted_batch.py documents the layout; the reference
// has no analogue — PyG scatters on GPU, reference pyHGT/conv.py:13).
// The numpy implementation costs ~57 ms/batch at bench scale, dominated by
// three O(E log E) argsorts and three per-grouping aux passes; every key
// here is a bounded int (flat node id / bank row / table row), so a stable
// counting sort + single-pass aux builders bring that to O(E + S).
//
// Exported C ABI (ctypes binding in pyhgt_tpu/sampling/native_batch.py):
//   sb_counting_sort  — stable perm + CSR seg_ptr by bounded int32 key
//   sb_tiled_aux      — hierarchical tiled-reduction aux (one grouping)
//   sb_pallas_aux     — Pallas live-partials kernel aux (one grouping)
// All outputs are caller-allocated numpy buffers; no allocation here.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Stable counting sort of key[0..E) with values in [0, S] (S = padding
// sentinel). perm[E] receives the stable order; seg_ptr[S+1] receives
// searchsorted(key_sorted, 0..S) (CSR starts; seg_ptr[S] = first sentinel).
// Returns 0, or -1 on an out-of-range key.
int sb_counting_sort(const int32_t* key, int64_t E, int32_t S,
                     int32_t* perm, int32_t* seg_ptr) {
    std::vector<int64_t> count((size_t)S + 2, 0);
    for (int64_t i = 0; i < E; ++i) {
        int32_t k = key[i];
        if (k < 0 || k > S) return -1;
        ++count[(size_t)k + 1];
    }
    for (size_t v = 1; v < count.size(); ++v) count[v] += count[v - 1];
    for (int32_t v = 0; v <= S; ++v) seg_ptr[v] = (int32_t)count[v];
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < E; ++i)
        perm[cursor[(size_t)key[i]]++] = (int32_t)i;
    return 0;
}

// Tiled-reduction aux over one grouping (mirrors sorted_batch._tiled_aux).
// key_sorted[E] non-decreasing with sentinel S for padding; K divides E.
// Outputs (M = S + E/K):
//   tl[E]          local (per-K-tile) segment rank of each edge
//   live_idx[M]    flat (tile*K + rank) index of each live partial row,
//                  segment-ordered; dead rows -> E (the extra zero row)
//   live_key[M]    segment id per live row (sentinel S for dead rows)
//   live_last[M]   flat index of each live row's last edge; dead -> E
//   seg_ptr2[S+1]  CSR over live rows per segment
// Returns the number of live rows, or -1 if it exceeds M.
int64_t sb_tiled_aux(const int32_t* key_sorted, int64_t E, int32_t S,
                     int32_t K, int32_t* tl, int32_t* live_idx,
                     int32_t* live_key, int32_t* live_last,
                     int32_t* seg_ptr2) {
    const int64_t tiles = E / K;
    const int64_t M = (int64_t)S + tiles;
    int64_t L = 0;
    for (int64_t t = 0; t < tiles; ++t) {
        const int64_t base = t * K;
        int32_t rank = -1;
        int32_t prev = -1;
        for (int32_t j = 0; j < K; ++j) {
            const int32_t k = key_sorted[base + j];
            if (j == 0 || k != prev) {
                if (L >= M) return -1;
                ++rank;
                live_key[L] = k;
                live_idx[L] = (int32_t)(base + rank);
                if (L > 0) live_last[L - 1] = (int32_t)(base + j - 1);
                ++L;
                prev = k;
            }
            tl[base + j] = rank;
        }
    }
    if (L > 0) live_last[L - 1] = (int32_t)(E - 1);
    for (int64_t i = L; i < M; ++i) {
        live_idx[i] = (int32_t)E;       // extra zero row appended on device
        live_key[i] = S;                // sentinel
        live_last[i] = (int32_t)E;      // extra NEG row
    }
    // seg_ptr2 = searchsorted(live_key[:L], 0..S) — live_key is sorted
    // because key_sorted is (ranks walk segments in order)
    int64_t pos = 0;
    for (int32_t v = 0; v <= S; ++v) {
        while (pos < L && live_key[pos] < v) ++pos;
        seg_ptr2[v] = (int32_t)pos;
    }
    return L;
}

// Pallas live-partials kernel aux (mirrors sorted_batch.pallas_seg_aux).
// key_sorted[E] non-decreasing, sentinel S; K divides E; W >= K; NB is the
// static output-block count (S + tiles + W - 1)/W + 1 computed host-side.
// Outputs:
//   loc[tiles*K]        edge's one-hot column: global live index - blk*W
//   blk_ext[tiles+NB-1] output block per grid step (+ flush tail)
//   ptr2[S+1]           CSR over live rows per segment
//   live_key_ext[NB*W]  segment id per output row (sentinel S when dead)
// Returns the number of live rows, or -1 if it exceeds NB*W.
int64_t sb_pallas_aux(const int32_t* key_sorted, int64_t E, int32_t S,
                      int32_t K, int32_t W, int64_t NB, int32_t* loc,
                      int32_t* blk_ext, int32_t* ptr2,
                      int32_t* live_key_ext) {
    const int64_t tiles = E / K;
    const int64_t cap = NB * W;
    for (int64_t i = 0; i < cap; ++i) live_key_ext[i] = S;
    int64_t live = 0;   // global live-row counter (= live_off running value)
    for (int64_t t = 0; t < tiles; ++t) {
        const int64_t base = t * K;
        const int64_t off = live % W;
        blk_ext[t] = (int32_t)(live / W);
        int32_t rank = -1;
        int32_t prev = -1;
        for (int32_t j = 0; j < K; ++j) {
            const int32_t k = key_sorted[base + j];
            if (j == 0 || k != prev) {
                ++rank;
                if (live + rank >= cap) return -1;
                live_key_ext[live + rank] = k;
                prev = k;
            }
            loc[base + j] = (int32_t)(off + rank);
        }
        live += rank + 1;
    }
    const int32_t last_blk = tiles ? blk_ext[tiles - 1] : 0;
    for (int64_t i = 0; i < NB - 1; ++i) {
        int64_t b = (int64_t)last_blk + 1 + i;
        blk_ext[tiles + i] = (int32_t)(b < NB - 1 ? b : NB - 1);
    }
    // ptr2 over the first `live` rows (their keys are sorted)
    int64_t pos = 0;
    for (int32_t v = 0; v <= S; ++v) {
        while (pos < live && live_key_ext[pos] < v) ++pos;
        ptr2[v] = (int32_t)pos;
    }
    return live;
}

// Tab-window kernel aux on SRC-ORDERED data (mirrors
// sorted_batch.pallas_tab_window_aux): in src order the meta-block is
// contiguous, so tabidx = block*L + dt has a bounded per-tile window
// loc = (block - tile_block)*W + dt. Fills loc[tiles*K] and
// blk_ext[tiles + NB - 1]; returns 0, or -1 when a tile spans >2 blocks
// / blocks are non-monotone (caller falls back to the permute path).
int sb_tab_window_aux(const int32_t* tab_src_order, int64_t E,
                      int32_t num_blocks, int32_t L, int32_t K, int32_t W,
                      int32_t* loc, int32_t* blk_ext) {
    const int64_t tiles = E / K;
    int32_t prev_blk = -1;
    for (int64_t t = 0; t < tiles; ++t) {
        const int64_t base = t * K;
        const int32_t b0 = tab_src_order[base] / L;
        if (t == 0 && b0 != 0) return -1;
        if (prev_blk >= 0 && (b0 < prev_blk || b0 > prev_blk + 1)) return -1;
        prev_blk = b0;
        blk_ext[t] = b0;
        for (int32_t j = 0; j < K; ++j) {
            const int32_t v = tab_src_order[base + j];
            const int32_t blk = v / L;
            if (blk - b0 > 1 || blk < b0) return -1;
            loc[base + j] = (blk - b0) * W + (v - blk * L);
        }
    }
    const int32_t last_blk = tiles ? blk_ext[tiles - 1] : 0;
    const int64_t NB = num_blocks;
    for (int64_t i = 0; i < NB - 1; ++i) {
        int64_t b = (int64_t)last_blk + 1 + i;
        blk_ext[tiles + i] = (int32_t)(b < NB - 1 ? b : NB - 1);
    }
    return 0;
}

// Fused permute + index build + pad for the target-sorted edge view
// (replaces the numpy body of sorted_batch.sort_edges between the target
// counting sort and the per-grouping aux: 8 fancy-index gathers, masked
// index arithmetic, the [E, R] one-hot fill, and the PK padding tail).
// Inputs are the RAW (unsorted, unpadded, length E0) edge arrays plus the
// stable target-order permutation; outputs are padded to E (>= E0).
//   tgt_safe: target ids with padded/masked rows clamped to N-1
//   key:      sort key (target id, sentinel N for masked/padded rows)
//   gidx:     row into the [B*C] relation-transformed banks (masked rows
//             keep their block's last slot — layout-static boundaries)
//   tabidx:   row into the [B*L] RTE tables (same masking convention)
//   onehot:   [E, R] f32 relation membership (masked/padded rows zero)
int sb_permute_build(
    const int32_t* src0, const int32_t* tgt0, const int32_t* dt0,
    const uint8_t* mask0, const int32_t* perm, const int32_t* edge_block,
    const int32_t* gather_off, const int32_t* edge_rel,
    int64_t E0, int64_t E, int32_t C, int32_t L, int32_t R, int32_t N,
    int32_t B, int32_t* src, int32_t* tgt_safe, int32_t* dt, uint8_t* mask,
    int32_t* key, int32_t* gidx, int32_t* tabidx, float* onehot) {
    std::memset(onehot, 0, (size_t)E * R * sizeof(float));
    for (int64_t i = 0; i < E0; ++i) {
        const int32_t p = perm[i];
        const bool m = mask0[p] != 0;
        const int32_t blk = edge_block[p];
        src[i] = src0[p];
        tgt_safe[i] = m ? tgt0[p] : N - 1;
        dt[i] = dt0[p];
        mask[i] = m ? 1 : 0;
        key[i] = m ? tgt0[p] : N;
        gidx[i] = m ? src0[p] + gather_off[p] : blk * C + (C - 1);
        tabidx[i] = m ? blk * L + dt0[p] : blk * L + (L - 1);
        if (m) onehot[i * R + edge_rel[p]] = 1.0f;
    }
    for (int64_t i = E0; i < E; ++i) {
        src[i] = 0;
        tgt_safe[i] = N - 1;
        dt[i] = 0;
        mask[i] = 0;
        key[i] = N;
        gidx[i] = B * C - 1;
        tabidx[i] = B * L - 1;
    }
    return 0;
}

}  // extern "C"
