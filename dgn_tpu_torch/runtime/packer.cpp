// dgn_tpu_torch native runtime: the flat layout's graph batch packer.
//
// The port's own copy of dgn_tpu/runtime/packer.cpp, the same C ABI
// (dgn_pack).  The input pipeline packs many small graphs per step into one
// fixed-shape batch (the reference's dgl.batch + collate,
// realworld_benchmark/data/molecules.py:219-230).  One pass over the edge
// lists gives globally offset COO sorted by (dst, src), with masks,
// size normalisers and in-degrees.
//
// Sorting is two stable counting sorts (src, then dst): O(E + N), no
// comparisons, against the O(E log E) lexsort of graph.py's numpy path,
// and bit-identical to it (pads at the end, the same tie-break).
//
// C ABI only; loaded from Python with ctypes (runtime/native.py), built with
// g++ -O3 -std=c++17 -shared -fPIC at first use.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Pack g graphs' edges into fixed-shape arrays.
//   n_nodes/n_edges: per-graph sizes [g]
//   src_cat/dst_cat: per-graph-local edge endpoints, concatenated [E]
// Outputs (caller-allocated):
//   src_out/dst_out[e_pad]   global node ids, sorted by (dst, src), pads last
//   perm_out[e_pad]          output slot -> concatenated input edge index
//                            (pad slots -> -1); lets the caller permute edge
//                            features without a second native call
//   edge_mask[e_pad]         1 for real edges
//   snorm_e[e_pad]           sqrt(1/E_graph) per edge
//   node_graph[n_pad]        graph id per node (pads -> g_pad-1)
//   node_mask[n_pad], snorm_n[n_pad], in_degree[n_pad]
// Returns 0 on success, nonzero on overflow.
int dgn_pack(int32_t g, const int32_t* n_nodes, const int32_t* n_edges,
             const int32_t* src_cat, const int32_t* dst_cat,
             int64_t n_pad, int64_t e_pad, int32_t g_pad, int32_t sort_edges,
             int32_t* src_out, int32_t* dst_out, int32_t* perm_out,
             uint8_t* edge_mask, float* snorm_e,
             int32_t* node_graph, uint8_t* node_mask, float* snorm_n,
             int32_t* in_degree) {
  int64_t tot_n = 0, tot_e = 0;
  for (int32_t i = 0; i < g; ++i) {
    tot_n += n_nodes[i];
    tot_e += n_edges[i];
  }
  if (tot_n > n_pad || tot_e > e_pad || g > g_pad) return 1;

  // node-side arrays
  for (int64_t v = 0; v < n_pad; ++v) {
    node_graph[v] = g_pad - 1;
    node_mask[v] = 0;
    snorm_n[v] = 0.0f;
    in_degree[v] = 0;
  }
  {
    int64_t off = 0;
    for (int32_t i = 0; i < g; ++i) {
      // double-precision sqrt then round, bit-identical to numpy's
      // float32(np.sqrt(1.0/n)) in the reference collate math
      const float sn =
          (float)__builtin_sqrt(1.0 / (double)(n_nodes[i] > 0 ? n_nodes[i] : 1));
      for (int32_t v = 0; v < n_nodes[i]; ++v) {
        node_graph[off + v] = i;
        node_mask[off + v] = 1;
        snorm_n[off + v] = sn;
      }
      off += n_nodes[i];
    }
  }

  // globally-offset edges (unsorted), per-edge snorm
  std::vector<int32_t> gsrc(tot_e), gdst(tot_e);
  std::vector<float> esn(tot_e);
  {
    int64_t eo = 0, no = 0;
    for (int32_t i = 0; i < g; ++i) {
      const float se =
          (float)__builtin_sqrt(1.0 / (double)(n_edges[i] > 0 ? n_edges[i] : 1));
      for (int32_t e = 0; e < n_edges[i]; ++e) {
        gsrc[eo + e] = src_cat[eo + e] + (int32_t)no;
        gdst[eo + e] = dst_cat[eo + e] + (int32_t)no;
        esn[eo + e] = se;
      }
      eo += n_edges[i];
      no += n_nodes[i];
    }
  }

  // order: identity or two stable counting sorts -> lexicographic (dst, src)
  std::vector<int32_t> order(tot_e);
  for (int64_t e = 0; e < tot_e; ++e) order[e] = (int32_t)e;
  if (sort_edges && tot_e > 0) {
    std::vector<int32_t> tmp(tot_e);
    std::vector<int32_t> count((size_t)n_pad + 1, 0);
    // pass 1: by src
    for (int64_t e = 0; e < tot_e; ++e) count[gsrc[e] + 1]++;
    for (int64_t v = 0; v < n_pad; ++v) count[v + 1] += count[v];
    for (int64_t e = 0; e < tot_e; ++e) tmp[count[gsrc[order[e]]]++] = order[e];
    // pass 2: by dst (stable -> src order preserved within a dst)
    std::fill(count.begin(), count.end(), 0);
    for (int64_t e = 0; e < tot_e; ++e) count[gdst[e] + 1]++;
    for (int64_t v = 0; v < n_pad; ++v) count[v + 1] += count[v];
    for (int64_t e = 0; e < tot_e; ++e) order[count[gdst[tmp[e]]]++] = tmp[e];
  }

  for (int64_t s = 0; s < e_pad; ++s) {
    if (s < tot_e) {
      const int32_t e = order[s];
      src_out[s] = gsrc[e];
      dst_out[s] = gdst[e];
      perm_out[s] = e;
      edge_mask[s] = 1;
      snorm_e[s] = esn[e];
      in_degree[gdst[e]]++;
    } else {
      src_out[s] = 0;
      dst_out[s] = 0;
      perm_out[s] = -1;
      edge_mask[s] = 0;
      snorm_e[s] = 0.0f;
    }
  }
  return 0;
}

}  // extern "C"
