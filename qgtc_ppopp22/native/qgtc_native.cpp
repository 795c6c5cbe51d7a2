// QGTC native host library: graph building, partitioning, packing.
//
// Equivalent of the native host-side machinery the
// reference delegates to DGL's C++ core (METIS partitioning,
// partition_utils.py:11-18; subgraph extraction, partition_utils.py:
// 20-24) and to its CUDA packers (sampler.py:98-102 -> kernel.h:
// 204-242). Device-side packing/compute lives in JAX; this library
// accelerates the host data pipeline: CSR construction, multilevel
// graph partitioning (heavy-edge-matching coarsening + greedy BFS
// growing + boundary refinement - the METIS recipe), induced-subgraph
// densification, quantization and bit-plane packing.
//
// C ABI only; loaded from Python via ctypes
// (qgtc_ppopp22/native/__init__.py). Built by build.sh with
// g++ -O3 -fopenmp.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <numeric>
#include <queue>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSR construction: directed edge list -> deduplicated in-adjacency CSR
// (row = dst, col = src), matching graph/csr.py from_edges.
// Returns nnz; indptr must have n+1 slots; indices_out must have at
// least m slots (deduped nnz <= m).
// ---------------------------------------------------------------------------
int64_t csr_from_edges(const int64_t* src, const int64_t* dst, int64_t m,
                       int64_t n, int64_t* indptr, int64_t* indices_out) {
  std::vector<int64_t> deg(n, 0);
  for (int64_t e = 0; e < m; ++e) deg[dst[e]]++;
  std::vector<int64_t> start(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) start[i + 1] = start[i] + deg[i];
  std::vector<int64_t> tmp(m);
  std::vector<int64_t> fill(start.begin(), start.end() - 1);
  for (int64_t e = 0; e < m; ++e) tmp[fill[dst[e]]++] = src[e];
  // sort + dedup each row
  int64_t out = 0;
  indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t b = start[i], e = start[i] + deg[i];
    std::sort(tmp.begin() + b, tmp.begin() + e);
    int64_t prev = -1;
    for (int64_t k = b; k < e; ++k) {
      if (tmp[k] != prev) {
        indices_out[out++] = tmp[k];
        prev = tmp[k];
      }
    }
    indptr[i + 1] = out;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Multilevel partitioner (METIS-style, simplified):
//   1. heavy-edge matching coarsening until the graph is small,
//   2. greedy BFS graph-growing on the coarsest graph,
//   3. project back + boundary refinement at each level.
// Input: symmetric CSR. Output: labels[n] in [0, psize).
// ---------------------------------------------------------------------------

namespace {

struct Graph {
  std::vector<int64_t> indptr;
  std::vector<int64_t> indices;
  std::vector<int64_t> ewts;   // edge multiplicities
  std::vector<int64_t> vwts;   // vertex weights
  int64_t n() const { return (int64_t)indptr.size() - 1; }
};

// Heavy-edge matching: each unmatched vertex merges with its
// heaviest-edge unmatched neighbor.
void coarsen(const Graph& g, Graph& cg, std::vector<int64_t>& cmap,
             std::mt19937_64& rng) {
  int64_t n = g.n();
  std::vector<int64_t> match(n, -1);
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), rng);
  int64_t cn = 0;
  cmap.assign(n, -1);
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t u = order[oi];
    if (match[u] != -1) continue;
    int64_t best = -1, bw = -1;
    for (int64_t k = g.indptr[u]; k < g.indptr[u + 1]; ++k) {
      int64_t v = g.indices[k];
      if (v == u || match[v] != -1) continue;
      if (g.ewts[k] > bw) { bw = g.ewts[k]; best = v; }
    }
    match[u] = (best == -1) ? u : best;
    if (best != -1) match[best] = u;
    cmap[u] = cn;
    if (best != -1) cmap[best] = cn;
    cn++;
  }
  // build coarse graph
  cg.indptr.assign(cn + 1, 0);
  cg.vwts.assign(cn, 0);
  for (int64_t u = 0; u < n; ++u) cg.vwts[cmap[u]] += g.vwts[u];
  // collect coarse edges via hashing per coarse vertex
  std::vector<std::vector<std::pair<int64_t, int64_t>>> adj(cn);
  for (int64_t u = 0; u < n; ++u) {
    int64_t cu = cmap[u];
    for (int64_t k = g.indptr[u]; k < g.indptr[u + 1]; ++k) {
      int64_t cv = cmap[g.indices[k]];
      if (cv != cu) adj[cu].push_back({cv, g.ewts[k]});
    }
  }
  int64_t nnz = 0;
  for (int64_t c = 0; c < cn; ++c) {
    auto& a = adj[c];
    std::sort(a.begin(), a.end());
    int64_t w = 0;
    std::vector<std::pair<int64_t, int64_t>> ded;
    for (size_t i = 0; i < a.size(); ++i) {
      w += a[i].second;
      if (i + 1 == a.size() || a[i + 1].first != a[i].first) {
        ded.push_back({a[i].first, w});
        w = 0;
      }
    }
    a.swap(ded);
    nnz += (int64_t)a.size();
  }
  cg.indices.resize(nnz);
  cg.ewts.resize(nnz);
  int64_t p = 0;
  for (int64_t c = 0; c < cn; ++c) {
    cg.indptr[c] = p;
    for (auto& pr : adj[c]) {
      cg.indices[p] = pr.first;
      cg.ewts[p] = pr.second;
      p++;
    }
  }
  cg.indptr[cn] = p;
}

// Greedy BFS graph growing on (small) graph by vertex weight.
void grow_partition(const Graph& g, int64_t psize,
                    std::vector<int32_t>& label) {
  int64_t n = g.n();
  int64_t total = 0;
  for (auto w : g.vwts) total += w;
  int64_t target = std::max<int64_t>(total / psize, 1);
  label.assign(n, -1);
  std::vector<int64_t> seeds(n);
  std::iota(seeds.begin(), seeds.end(), 0);
  std::sort(seeds.begin(), seeds.end(), [&](int64_t a, int64_t b) {
    return g.indptr[a + 1] - g.indptr[a] < g.indptr[b + 1] - g.indptr[b];
  });
  size_t spos = 0;
  for (int32_t part = 0; part < psize; ++part) {
    int64_t wsum = 0;
    std::queue<int64_t> q;
    while (wsum < target) {
      if (q.empty()) {
        while (spos < seeds.size() && label[seeds[spos]] != -1) spos++;
        if (spos >= seeds.size()) break;
        label[seeds[spos]] = part;
        wsum += g.vwts[seeds[spos]];
        q.push(seeds[spos]);
        continue;
      }
      int64_t u = q.front();
      q.pop();
      for (int64_t k = g.indptr[u]; k < g.indptr[u + 1] && wsum < target;
           ++k) {
        int64_t v = g.indices[k];
        if (label[v] == -1) {
          label[v] = part;
          wsum += g.vwts[v];
          q.push(v);
        }
      }
    }
    if (spos >= seeds.size()) break;
  }
  for (int64_t u = 0; u < n; ++u)
    if (label[u] == -1) label[u] = (int32_t)(psize - 1);
}

// One boundary-refinement sweep: move a vertex to the neighboring
// partition with the largest connection if that reduces cut and
// keeps balance within 1.3x of average.
void refine(const Graph& g, int64_t psize, std::vector<int32_t>& label) {
  int64_t n = g.n();
  std::vector<int64_t> pw(psize, 0);
  int64_t total = 0;
  for (int64_t u = 0; u < n; ++u) {
    pw[label[u]] += g.vwts[u];
    total += g.vwts[u];
  }
  int64_t cap = (int64_t)(1.3 * total / psize) + 1;
  std::vector<int64_t> conn(psize, 0);
  std::vector<int32_t> touched;
  for (int64_t u = 0; u < n; ++u) {
    int32_t lu = label[u];
    touched.clear();
    for (int64_t k = g.indptr[u]; k < g.indptr[u + 1]; ++k) {
      int32_t lv = label[g.indices[k]];
      if (conn[lv] == 0) touched.push_back(lv);
      conn[lv] += g.ewts[k];
    }
    int32_t best = lu;
    int64_t bgain = 0;
    for (int32_t lv : touched) {
      if (lv == lu) continue;
      int64_t gain = conn[lv] - conn[lu];
      if (gain > bgain && pw[lv] + g.vwts[u] <= cap &&
          pw[lu] - g.vwts[u] > 0) {
        bgain = gain;
        best = lv;
      }
    }
    if (best != lu) {
      pw[lu] -= g.vwts[u];
      pw[best] += g.vwts[u];
      label[u] = best;
    }
    for (int32_t lv : touched) conn[lv] = 0;
  }
}

}  // namespace

// labels_out: int32[n]. Returns 0 on success.
int32_t partition_graph(const int64_t* indptr, const int64_t* indices,
                        int64_t n, int64_t psize, uint64_t seed,
                        int32_t* labels_out) {
  if (psize <= 1) {
    std::fill(labels_out, labels_out + n, 0);
    return 0;
  }
  std::mt19937_64 rng(seed);
  std::vector<Graph> levels(1);
  Graph& g0 = levels[0];
  g0.indptr.assign(indptr, indptr + n + 1);
  g0.indices.assign(indices, indices + indptr[n]);
  g0.ewts.assign(indptr[n], 1);
  g0.vwts.assign(n, 1);

  std::vector<std::vector<int64_t>> cmaps;
  int64_t coarse_target = std::max<int64_t>(psize * 8, 1024);
  while (levels.back().n() > coarse_target && levels.size() < 40) {
    Graph cg;
    std::vector<int64_t> cmap;
    coarsen(levels.back(), cg, cmap, rng);
    if (cg.n() >= levels.back().n() * 95 / 100) break;  // stalled
    cmaps.push_back(std::move(cmap));
    levels.push_back(std::move(cg));
  }

  std::vector<int32_t> label;
  grow_partition(levels.back(), psize, label);
  for (int r = 0; r < 4; ++r) refine(levels.back(), psize, label);

  for (int64_t lv = (int64_t)cmaps.size() - 1; lv >= 0; --lv) {
    const auto& cmap = cmaps[lv];
    std::vector<int32_t> fine(cmap.size());
    for (size_t u = 0; u < cmap.size(); ++u) fine[u] = label[cmap[u]];
    label.swap(fine);
    for (int r = 0; r < 2; ++r) refine(levels[lv], psize, label);
  }
  std::copy(label.begin(), label.end(), labels_out);
  return 0;
}

// ---------------------------------------------------------------------------
// Induced-subgraph densification (reference sampler.py:80-89 role):
// nodes must be sorted ascending; dense is uint8[pn*pn], zeroed rows
// beyond len(nodes) left untouched (caller zero-initializes).
// ---------------------------------------------------------------------------
void subgraph_dense(const int64_t* indptr, const int64_t* indices,
                    const int64_t* nodes, int64_t nn, int64_t pn,
                    uint8_t* dense) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t li = 0; li < nn; ++li) {
    int64_t gi = nodes[li];
    uint8_t* row = dense + li * pn;
    for (int64_t k = indptr[gi]; k < indptr[gi + 1]; ++k) {
      int64_t gj = indices[k];
      // binary search gj in nodes
      const int64_t* lo = std::lower_bound(nodes, nodes + nn, gj);
      if (lo != nodes + nn && *lo == gj) row[lo - nodes] = 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Quantize (reference Quantize_val, kernel.h:31-71): clip to
// [0, 2^bits] with lb+1/ub-1 edge rule, round-half-even.
// ---------------------------------------------------------------------------
void quantize_f32(const float* x, int64_t count, int32_t bits,
                  int32_t* q) {
  float ub = (float)(1 << bits);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < count; ++i) {
    float v = x[i];
    v = (v < 0.0f) ? 1.0f : (v > ub ? ub - 1.0f : v);
    q[i] = (int32_t)std::nearbyintf(v);  // round-half-even (default FE)
  }
}

// ---------------------------------------------------------------------------
// Bit-plane packing (host-side twin of ops/bitpack.py pack_bits):
// q: int32[M*K] levels; planes: uint32[bits * (Mp/32) * Kp], caller
// zero-initialized, Mp/Kp multiples of 256. Word (b, w, k) packs bit
// b of rows 32w..32w+31 at column k, little-endian.
// ---------------------------------------------------------------------------
void pack_bits_u32(const int32_t* q, int64_t M, int64_t K, int32_t bits,
                   int64_t Mp, int64_t Kp, uint32_t* planes) {
  int64_t mw = Mp / 32;
#pragma omp parallel for collapse(2) schedule(static)
  for (int32_t b = 0; b < bits; ++b) {
    for (int64_t w = 0; w < mw; ++w) {
      uint32_t* dst = planes + ((int64_t)b * mw + w) * Kp;
      int64_t r0 = w * 32;
      int64_t rend = std::min<int64_t>(r0 + 32, M);
      for (int64_t r = r0; r < rend; ++r) {
        const int32_t* src = q + r * K;
        uint32_t bitpos = (uint32_t)(r - r0);
        for (int64_t k = 0; k < K; ++k) {
          dst[k] |= (uint32_t)(((uint32_t)src[k] >> b) & 1u) << bitpos;
        }
      }
    }
  }
}

}  // extern "C"
