// Native HGSampling core — C-ABI shared library used via ctypes.
//
// Implements the same budget/score^2 semantics as the Python sampler
// (pyhgt_tpu/sampling/hgsampler.py; reference algorithm at
// reference pyHGT/data.py:87-210) over the frozen CSR arrays:
//
//  - per-source-type budget accumulating 1/len(sampled_neighbors) scores
//  - `depth` rounds drawing `width` nodes per type w.p. proportional to
//    score^2 without replacement (Efraimidis–Spirakis keys, which matches
//    np.random.choice(p=w, replace=False) in distribution)
//  - temporal ceiling: sources newer than time_max are skipped
//  - untimed edges (time == NO_TIME) inherit the target's timestamp
//  - induced-subgraph reconstruction by membership probing
//
// The RNG is SplitMix64+xoshiro-style (deterministic per seed); draws do
// NOT bit-match numpy — tests assert distributional properties instead.
//
// Build: g++ -O3 -march=native -shared -fPIC hgsampler.cpp -o _hgsampler.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>
#include <algorithm>

namespace {

constexpr int32_t NO_TIME = INT32_MIN;

struct Rng {  // splitmix64
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed ^ 0x9E3779B97F4A7C15ULL) {}
    uint64_t next() {
        uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
        return z ^ (z >> 31);
    }
    double uniform() {  // (0, 1]
        return ((next() >> 11) + 1.0) * (1.0 / 9007199254740993.0);
    }
    // k distinct indices from [0, n) (partial Fisher-Yates on a scratch map)
    void sample_indices(int64_t n, int64_t k, std::vector<int64_t>& out) {
        out.clear();
        std::unordered_map<int64_t, int64_t> swapped;
        for (int64_t i = 0; i < k; ++i) {
            int64_t j = i + (int64_t)(next() % (uint64_t)(n - i));
            int64_t vi = swapped.count(i) ? swapped[i] : i;
            int64_t vj = swapped.count(j) ? swapped[j] : j;
            out.push_back(vj);
            swapped[j] = vi;
        }
    }
};

struct Meta {
    int tgt_type, src_type;
    const int64_t* indptr;
    int64_t n_rows;          // indptr length - 1
    const int32_t* src;
    const int32_t* time;
};

struct BudgetCell { double score; int32_t time; };

struct Graph {
    int num_types;
    std::vector<Meta> metas;
    std::vector<std::vector<int>> metas_by_tgt;  // type -> meta ids
};

struct LayerEntry { int64_t id; int32_t time; };

struct Sampler {
    const Graph* g;
    std::vector<std::unordered_map<int64_t, int64_t>> layer_map;  // id -> ser
    std::vector<std::vector<LayerEntry>> layer;                    // ser order
    std::vector<std::unordered_map<int64_t, BudgetCell>> budget;
    Rng rng;

    Sampler(const Graph* graph, uint64_t seed)
        : g(graph),
          layer_map(graph->num_types),
          layer(graph->num_types),
          budget(graph->num_types),
          rng(seed) {}

    void add_budget(int node_type, int64_t node_id, int32_t node_time,
                    int width, int64_t time_max, bool has_time_max,
                    std::vector<int64_t>& scratch) {
        for (int mi : g->metas_by_tgt[node_type]) {
            const Meta& m = g->metas[mi];
            if (node_id + 1 > m.n_rows) continue;
            int64_t lo = m.indptr[node_id], hi = m.indptr[node_id + 1];
            int64_t n = hi - lo;
            if (n == 0) continue;
            auto& seen = layer_map[m.src_type];
            auto& b = budget[m.src_type];
            if (n > width) {
                rng.sample_indices(n, width, scratch);
                double inv = 1.0 / (double)width;
                for (int64_t off : scratch) {
                    int64_t sid = m.src[lo + off];
                    int32_t st = m.time[lo + off];
                    if (st == NO_TIME) st = node_time;
                    if (has_time_max && st > time_max) continue;
                    if (seen.count(sid)) continue;
                    auto it = b.find(sid);
                    if (it == b.end()) b[sid] = {inv, st};
                    else { it->second.score += inv; it->second.time = st; }
                }
            } else {
                double inv = 1.0 / (double)n;
                for (int64_t e = lo; e < hi; ++e) {
                    int64_t sid = m.src[e];
                    int32_t st = m.time[e];
                    if (st == NO_TIME) st = node_time;
                    if (has_time_max && st > time_max) continue;
                    if (seen.count(sid)) continue;
                    auto it = b.find(sid);
                    if (it == b.end()) b[sid] = {inv, st};
                    else { it->second.score += inv; it->second.time = st; }
                }
            }
        }
    }

    void insert_layer(int t, int64_t id, int32_t time) {
        auto [it, fresh] = layer_map[t].try_emplace(id, (int64_t)layer[t].size());
        if (fresh) layer[t].push_back({id, time});
    }
};

}  // namespace

extern "C" {

// ---- graph lifecycle -------------------------------------------------------
void* hgs_graph_create(int num_types, int num_metas,
                       const int* meta_tgt, const int* meta_src,
                       const int64_t** indptrs, const int64_t* n_rows,
                       const int32_t** srcs, const int32_t** times) {
    Graph* g = new Graph();
    g->num_types = num_types;
    g->metas_by_tgt.resize(num_types);
    for (int i = 0; i < num_metas; ++i) {
        g->metas.push_back({meta_tgt[i], meta_src[i], indptrs[i], n_rows[i],
                            srcs[i], times[i]});
        g->metas_by_tgt[meta_tgt[i]].push_back(i);
    }
    return g;
}

void hgs_graph_destroy(void* gp) { delete (Graph*)gp; }

// ---- one sampling call -----------------------------------------------------
// Seeds: arrays of (type, id, time), length n_seeds, inserted in order.
// Outputs (caller-allocated):
//   node_ids/node_times: per type, capacity node_cap each, flat [T*node_cap]
//   node_counts[T]
//   edge_tgt/edge_src: per meta, capacity edge_cap each, flat [M*edge_cap]
//   edge_counts[M] (set to the TRUE count; writes are clamped to edge_cap,
//   callers treat count>edge_cap as overflow)
int hgs_sample(void* gp, uint64_t seed,
               int depth, int width,
               int64_t time_max, int has_time_max,
               const int* seed_types, const int64_t* seed_ids,
               const int32_t* seed_times, int64_t n_seeds,
               int64_t node_cap, int64_t* node_ids, int32_t* node_times,
               int64_t* node_counts,
               int64_t edge_cap, int32_t* edge_tgt, int32_t* edge_src,
               int64_t* edge_counts) {
    const Graph* g = (const Graph*)gp;
    Sampler s(g, seed);
    std::vector<int64_t> scratch;

    // seed insertion first, then budget expansion (pyHGT/data.py:135-141)
    for (int64_t i = 0; i < n_seeds; ++i)
        s.insert_layer(seed_types[i], seed_ids[i], seed_times[i]);
    for (int64_t i = 0; i < n_seeds; ++i)
        s.add_budget(seed_types[i], seed_ids[i], seed_times[i], width,
                     time_max, has_time_max, scratch);

    // depth rounds of score^2-weighted draws (pyHGT/data.py:147-172);
    // snapshot the round's type list like the reference
    std::vector<int64_t> keys;
    std::vector<double> es_keys;
    std::vector<int64_t> order;
    std::vector<std::pair<int64_t, int32_t>> chosen;
    for (int d = 0; d < depth; ++d) {
        std::vector<int> sts;
        for (int t = 0; t < g->num_types; ++t)
            if (!s.budget[t].empty()) sts.push_back(t);
        for (int t : sts) {
            auto& b = s.budget[t];
            if (b.empty()) continue;
            chosen.clear();
            if ((int64_t)b.size() <= width) {
                for (auto& kv : b) chosen.push_back({kv.first, kv.second.time});
            } else {
                // Efraimidis–Spirakis: top-`width` by u^(1/w), w = score^2
                keys.clear(); es_keys.clear();
                for (auto& kv : b) {
                    keys.push_back(kv.first);
                    double w = kv.second.score * kv.second.score;
                    es_keys.push_back(-std::log(s.rng.uniform()) / (w + 1e-300));
                }
                order.resize(keys.size());
                for (size_t i = 0; i < order.size(); ++i) order[i] = i;
                std::nth_element(order.begin(), order.begin() + width,
                                 order.end(), [&](int64_t a, int64_t c) {
                                     return es_keys[a] < es_keys[c];
                                 });
                for (int i = 0; i < width; ++i) {
                    int64_t id = keys[order[i]];
                    chosen.push_back({id, b[id].time});
                }
            }
            for (auto& [id, tm] : chosen) s.insert_layer(t, id, tm);
            for (auto& [id, tm] : chosen) {
                s.add_budget(t, id, tm, width, time_max, has_time_max, scratch);
                b.erase(id);
            }
        }
    }

    // emit nodes (seeds-first serial order preserved)
    for (int t = 0; t < g->num_types; ++t) {
        int64_t n = std::min((int64_t)s.layer[t].size(), node_cap);
        node_counts[t] = (int64_t)s.layer[t].size();
        for (int64_t i = 0; i < n; ++i) {
            node_ids[t * node_cap + i] = s.layer[t][i].id;
            node_times[t * node_cap + i] = s.layer[t][i].time;
        }
    }

    // induced-subgraph reconstruction (pyHGT/data.py:191-209)
    for (size_t mi = 0; mi < g->metas.size(); ++mi) {
        const Meta& m = g->metas[mi];
        auto& tl = s.layer[m.tgt_type];
        auto& sl = s.layer_map[m.src_type];
        int64_t cnt = 0;
        int32_t* et = edge_tgt + mi * edge_cap;
        int32_t* es = edge_src + mi * edge_cap;
        if (!tl.empty() && !sl.empty()) {
            int64_t n_tgt = std::min((int64_t)tl.size(), node_cap);
            for (int64_t tser = 0; tser < n_tgt; ++tser) {
                int64_t tid = tl[tser].id;
                if (tid + 1 > m.n_rows) continue;
                for (int64_t e = m.indptr[tid]; e < m.indptr[tid + 1]; ++e) {
                    auto it = sl.find(m.src[e]);
                    if (it == sl.end() || it->second >= node_cap) continue;
                    if (cnt < edge_cap) {
                        et[cnt] = (int32_t)tser;
                        es[cnt] = (int32_t)it->second;
                    }
                    ++cnt;
                }
            }
        }
        edge_counts[mi] = cnt;
    }
    return 0;
}

}  // extern "C"
