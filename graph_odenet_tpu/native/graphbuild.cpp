// graphbuild — native graph preprocessing for graph_odenet_tpu.
//
// The role the reference delegates to scipy.sparse (COO symmetrize, dedup,
// degree normalisation, CSR ordering — SURVEY.md §2 R1) runs here as a small
// C++ library: at OGBN scale (millions of edges) the numpy pipeline in
// graph.from_edges is seconds of host time per graph; this is the
// "graph-builder" native tier of the framework (loaded via ctypes, with the
// numpy path kept as a portable fallback).
//
// Exposed C ABI (all arrays caller-allocated):
//   god_preprocess_edges:  symmetrize → dedup → self-loops → sort by
//                          (receiver, sender) → row/sym normalise.
//                          Returns the resulting edge count (≤ capacity).
//   god_build_blocks:      CSR row-block pointers.
//
// Build: `make -C graph_odenet_tpu/native` → libgraphbuild.so.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Edge {
  int64_t s;
  int64_t r;
  double w;
};

}  // namespace

extern "C" {

// Returns the number of output edges, or -1 if capacity is insufficient.
// normalize: 0 = none, 1 = row (D^-1 A), 2 = sym (D^-1/2 A D^-1/2).
// symmetrize / add_self_loops: booleans.
int64_t god_preprocess_edges(
    int64_t n_node, int64_t n_edge,
    const int64_t* senders, const int64_t* receivers, const double* weight,
    int32_t symmetrize, int32_t add_self_loops, int32_t normalize,
    int64_t capacity,
    int64_t* out_senders, int64_t* out_receivers, double* out_weight) {
  std::vector<Edge> edges;
  edges.reserve(static_cast<size_t>(n_edge) * (symmetrize ? 2 : 1) + n_node);
  for (int64_t i = 0; i < n_edge; ++i) {
    double w = weight ? weight[i] : 1.0;
    edges.push_back({senders[i], receivers[i], w});
    if (symmetrize) edges.push_back({receivers[i], senders[i], w});
  }
  // Sort by (receiver, sender) — the CSR invariant — then dedup.
  std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
    return a.r != b.r ? a.r < b.r : a.s < b.s;
  });
  edges.erase(std::unique(edges.begin(), edges.end(),
                          [](const Edge& a, const Edge& b) {
                            return a.s == b.s && a.r == b.r;
                          }),
              edges.end());

  if (add_self_loops) {
    // Which nodes already have a loop?
    std::vector<uint8_t> has_loop(static_cast<size_t>(n_node), 0);
    for (const Edge& e : edges)
      if (e.s == e.r && e.s < n_node) has_loop[static_cast<size_t>(e.s)] = 1;
    size_t before = edges.size();
    for (int64_t v = 0; v < n_node; ++v)
      if (!has_loop[static_cast<size_t>(v)]) edges.push_back({v, v, 1.0});
    if (edges.size() != before) {
      std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
        return a.r != b.r ? a.r < b.r : a.s < b.s;
      });
    }
  }

  if (normalize != 0) {
    std::vector<double> deg(static_cast<size_t>(n_node), 0.0);
    for (const Edge& e : edges) deg[static_cast<size_t>(e.r)] += e.w;
    if (normalize == 1) {
      for (Edge& e : edges) {
        double d = deg[static_cast<size_t>(e.r)];
        e.w = d > 0 ? e.w / d : 0.0;
      }
    } else {
      std::vector<double> inv_sqrt(static_cast<size_t>(n_node), 0.0);
      for (int64_t v = 0; v < n_node; ++v)
        inv_sqrt[static_cast<size_t>(v)] =
            deg[static_cast<size_t>(v)] > 0
                ? 1.0 / std::sqrt(deg[static_cast<size_t>(v)])
                : 0.0;
      for (Edge& e : edges)
        e.w *= inv_sqrt[static_cast<size_t>(e.r)] *
               inv_sqrt[static_cast<size_t>(e.s)];
    }
  }

  int64_t n_out = static_cast<int64_t>(edges.size());
  if (n_out > capacity) return -1;
  for (int64_t i = 0; i < n_out; ++i) {
    out_senders[i] = edges[static_cast<size_t>(i)].s;
    out_receivers[i] = edges[static_cast<size_t>(i)].r;
    out_weight[i] = edges[static_cast<size_t>(i)].w;
  }
  return n_out;
}

// CSR row-block pointers: blk_ptr[b] = first edge whose receiver is in
// block b (receivers must already be sorted). blk_ptr has n_blocks+1 slots.
void god_build_blocks(
    int64_t n_edge, const int64_t* receivers,
    int64_t block_rows, int64_t n_blocks, int64_t* blk_ptr) {
  std::vector<int64_t> counts(static_cast<size_t>(n_blocks), 0);
  for (int64_t i = 0; i < n_edge; ++i) {
    int64_t b = receivers[i] / block_rows;
    if (b >= 0 && b < n_blocks) counts[static_cast<size_t>(b)]++;
  }
  blk_ptr[0] = 0;
  for (int64_t b = 0; b < n_blocks; ++b)
    blk_ptr[b + 1] = blk_ptr[b] + counts[static_cast<size_t>(b)];
}

}  // extern "C"
