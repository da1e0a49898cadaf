// dgn_tpu_torch native runtime: the graph batch packer of both layouts.
//
// The input pipeline packs many small graphs per step into one fixed-shape
// batch (the reference's dgl.batch + collate,
// realworld_benchmark/data/molecules.py:219-230).
//
// dgn_pack, the flat layout: the port's own copy of
// dgn_tpu/runtime/packer.cpp, the same C ABI.  One pass over the edge lists
// gives globally offset COO sorted by (dst, src), with masks, size
// normalisers and in-degrees.
//
// dgn_pack_block, the block layout: the port's own, with no counterpart in
// dgn_tpu.  One call places the graphs into 128-node blocks, arranges the
// edges into 128-edge chunks of one (src block, dst block) pair, and writes
// the node and edge arrays and every array of the block layout (ops/mxu.py
// MXULayout) that graph.py's numpy path (_pack_graphs_mxu, then
// build_mxu_layout) derives.
//
// Edge sorts are stable counting sorts: O(E + N), no comparisons, against
// the O(E log E) lexsorts of graph.py's numpy paths, and bit-identical to
// them (the same keys, the same tie-break by input order).
//
// C ABI only; loaded from Python with ctypes (runtime/native.py), built with
// g++ -O3 -std=c++17 -shared -fPIC at first use.

#include <algorithm>
#include <cmath>
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

namespace {

constexpr int64_t kTile = 128;

int64_t round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

}  // namespace

extern "C" {

// Pack g graphs under the block layout: the arrays of graph.py's
// _pack_graphs_mxu and ops/mxu.py's build_mxu_layout, bit for bit.
//   n_nodes/n_edges:       per-graph sizes [g], in the order of placement
//   node_first/edge_first: per graph, the row of its first node and of its
//                          first edge in a table of graphs [g]
//   src/dst:               the table's graph-local edge endpoints
//   n_pad, e_pad:          node and edge slots, multiples of 128; either
//                          < 0 asks for need[0..1] only, writing no other
//   g_pad:                 graph slots, a multiple of 128
//   n_pairs_pad:           pair slots; < 0 for the real pairs rounded up
//                          to 64
//   pair_cap:              the room of the pair arrays
// Outputs (caller-allocated):
//   need[4]            nodes used by the placement, edge slots used (each
//                      run padded to whole chunks), real pairs, pair slots
//   node_slot[n_pad]   the slot of each of the batch's N nodes, in order
//   node_row[n_pad]    its row in the table (both written up to N)
//   [n_pad]            node_mask, node_graph (a pad takes the running
//                      maximum), snorm_n, in_degree, local_graph (pads 128)
//   [n_pad / 128]      node_chunk_graph
//   [e_pad]            src, dst (a run's pads at its chunk's block starts,
//                      the slots after the last run at n_pad - 128), perm
//                      (the table's edge row of each slot, -1 for pads),
//                      edge_mask, snorm_e, local_src, local_dst
//   [e_pad / 128]      edge_chunk_src, edge_chunk_dst, chunk_pair,
//                      pair_chunk_order, pair_sorted_ids,
//                      pair_real_chunk_order
//   [pair slots]       pair_src, pair_dst, pair_covered
//   [pair slots + 1]   pair_chunk_start
// Returns 0 on success, else (need written as far as it got): 1 node
// overflow, 2 graph overflow, 3 edge overflow, 4 pair overflow, 5 a block
// invariant broken (or no real node, or no edge slot), 6 an edge endpoint
// outside its graph, 7 a pad not a multiple of 128, 8 pair_cap too small.
int dgn_pack_block(
    int32_t g, const int32_t* n_nodes, const int32_t* n_edges,
    const int64_t* node_first, const int64_t* edge_first,
    const int32_t* src_tab, const int32_t* dst_tab, int64_t n_pad,
    int64_t e_pad, int64_t g_pad, int64_t n_pairs_pad, int64_t pair_cap,
    int64_t* need, int64_t* node_slot, int64_t* node_row, uint8_t* node_mask,
    int32_t* node_graph, float* snorm_n, int32_t* in_degree,
    int32_t* local_graph, int32_t* node_chunk_graph, int32_t* src,
    int32_t* dst, int64_t* perm, uint8_t* edge_mask, float* snorm_e,
    int32_t* local_src, int32_t* local_dst, int32_t* edge_chunk_src,
    int32_t* edge_chunk_dst, int32_t* chunk_pair, int32_t* pair_chunk_order,
    int32_t* pair_sorted_ids, int32_t* pair_real_chunk_order,
    int32_t* pair_src, int32_t* pair_dst, uint8_t* pair_covered,
    int32_t* pair_chunk_start) {
  if (g < 0) return 5;
  int64_t tot_n = 0, tot_e = 0;
  for (int32_t i = 0; i < g; ++i) {
    tot_n += n_nodes[i];
    tot_e += n_edges[i];
  }

  // placement (graph.py _mxu_place): next fit into 128-node blocks, a graph
  // of more than 128 nodes where it falls, a new block at every 128th graph
  std::vector<int64_t> offset(g);
  int64_t cur = 0;
  for (int32_t i = 0; i < g; ++i) {
    const int64_t n = n_nodes[i];
    if (i > 0 && i % kTile == 0) cur = round_up(cur, kTile);
    if (n <= kTile && cur % kTile + n > kTile) cur = round_up(cur, kTile);
    offset[i] = cur;
    cur += n;
  }
  const int64_t n_used = round_up(cur, kTile);
  need[0] = n_used;

  // each graph's edges by (dst, src), stable: two counting passes over its
  // local ids.  The graphs' node ranges follow one another in graph order,
  // so their concatenation is the batch's (dst, src) order.  Each sorted
  // edge keeps its global endpoints, its table row and its graph's snorm_e.
  std::vector<int32_t> ssrc(tot_e), sdst(tot_e);
  std::vector<int64_t> srow(tot_e);
  std::vector<float> sesn(tot_e);
  {
    int32_t max_n = 0;
    for (int32_t i = 0; i < g; ++i) max_n = std::max(max_n, n_nodes[i]);
    std::vector<int32_t> count((size_t)max_n + 1), tmp;
    int64_t e0 = 0;
    for (int32_t i = 0; i < g; ++i) {
      const int32_t n = n_nodes[i], m = n_edges[i];
      const int32_t* s = src_tab + edge_first[i];
      const int32_t* d = dst_tab + edge_first[i];
      for (int32_t j = 0; j < m; ++j)
        if (s[j] < 0 || s[j] >= n || d[j] < 0 || d[j] >= n) return 6;
      tmp.resize(m);
      std::fill(count.begin(), count.begin() + n + 1, 0);
      for (int32_t j = 0; j < m; ++j) count[s[j] + 1]++;
      for (int32_t v = 0; v < n; ++v) count[v + 1] += count[v];
      for (int32_t j = 0; j < m; ++j) tmp[count[s[j]]++] = j;
      std::fill(count.begin(), count.begin() + n + 1, 0);
      for (int32_t j = 0; j < m; ++j) count[d[j] + 1]++;
      for (int32_t v = 0; v < n; ++v) count[v + 1] += count[v];
      // the sqrt in double, then rounded: numpy's float32(np.sqrt(1.0 / e))
      const float esn = (float)std::sqrt(1.0 / (double)(m > 0 ? m : 1));
      const int32_t off = (int32_t)offset[i];
      for (int32_t j = 0; j < m; ++j) {
        const int32_t t = tmp[j];
        const int64_t p = e0 + count[d[t]]++;
        ssrc[p] = s[t] + off;
        sdst[p] = d[t] + off;
        srow[p] = edge_first[i] + t;
        sesn[p] = esn;
      }
      e0 += m;
    }
  }

  // then by (dst block, src block, dst, src), graph.py _mxu_edge_arrange's
  // lexsort: the dst blocks are in order already, so each dst block's edges
  // are sorted stably by src block (only a block that edges of a graph over
  // 128 nodes enter holds more than one), and cut into runs of one
  // (src block, dst block) pair, each padded to whole chunks
  std::vector<int64_t> run_start;
  int64_t e_used = 0;
  {
    std::vector<int64_t> count, by_block;
    std::vector<int32_t> t32;
    std::vector<int64_t> t64;
    std::vector<float> tf;
    int64_t a = 0;
    while (a < tot_e) {
      const int32_t db = sdst[a] / (int32_t)kTile;
      int32_t lo = ssrc[a] / (int32_t)kTile, hi = lo;
      int64_t b = a;
      for (; b < tot_e && sdst[b] / kTile == db; ++b) {
        lo = std::min(lo, ssrc[b] / (int32_t)kTile);
        hi = std::max(hi, ssrc[b] / (int32_t)kTile);
      }
      if (hi > lo) {
        const int64_t m = b - a;
        count.assign((size_t)(hi - lo) + 2, 0);
        for (int64_t j = a; j < b; ++j) count[ssrc[j] / kTile - lo + 1]++;
        for (int32_t k = 0; k <= hi - lo; ++k) count[k + 1] += count[k];
        by_block.resize(m);
        for (int64_t j = a; j < b; ++j)
          by_block[count[ssrc[j] / kTile - lo]++] = j;
        auto permute = [&](auto& v, auto& scratch) {
          scratch.resize(m);
          for (int64_t k = 0; k < m; ++k) scratch[k] = v[by_block[k]];
          std::copy(scratch.begin(), scratch.end(), v.begin() + a);
        };
        permute(ssrc, t32);
        permute(sdst, t32);
        permute(srow, t64);
        permute(sesn, tf);
      }
      for (int64_t j = a; j < b; ++j) {
        if (j == a || ssrc[j] / kTile != ssrc[j - 1] / kTile) {
          if (!run_start.empty())
            e_used += round_up(j - run_start.back(), kTile);
          run_start.push_back(j);
        }
      }
      a = b;
    }
    if (tot_e) e_used += round_up(tot_e - run_start.back(), kTile);
    run_start.push_back(tot_e);
  }
  need[1] = e_used;
  if (n_pad < 0 || e_pad < 0) return 0;

  if (n_pad % kTile || e_pad % kTile || g_pad % kTile) return 7;
  if (n_used > n_pad) return 1;
  if (g > g_pad) return 2;
  if (e_used > e_pad) return 3;
  if (tot_n == 0 || e_pad == 0) return 5;

  // node arrays, slot by slot: a pad's node_graph is the running maximum;
  // each node block's graph block from its first slot, every real node
  // held to it (build_mxu_layout's check)
  {
    int64_t v = 0, k = 0;
    int32_t run = 0, cg = 0;
    bool ok = true;
    auto put = [&](bool real, int32_t gi, float sn) {
      if (v % kTile == 0) {
        cg = gi / (int32_t)kTile;
        node_chunk_graph[v / kTile] = cg;
      }
      node_mask[v] = real;
      node_graph[v] = gi;
      snorm_n[v] = sn;
      in_degree[v] = 0;
      local_graph[v] = real ? gi - cg * (int32_t)kTile : (int32_t)kTile;
      ok = ok && (!real || gi / kTile == cg);
      ++v;
    };
    for (int32_t i = 0; i < g; ++i) {
      while (v < offset[i]) put(false, run, 0.0f);
      // the sqrt in double, then rounded: numpy's float32(np.sqrt(1.0 / n))
      const float sn = (float)std::sqrt(
          1.0 / (double)(n_nodes[i] > 0 ? n_nodes[i] : 1));
      for (int32_t j = 0; j < n_nodes[i]; ++j) {
        node_slot[k] = v;
        node_row[k++] = node_first[i] + j;
        put(true, i, sn);
      }
      if (n_nodes[i] > 0) run = std::max(run, i);
    }
    while (v < n_pad) put(false, run, 0.0f);
    if (!ok) return 5;
  }

  // edge arrays and the chunks' blocks, run by run: the real edges, then
  // the run's pads at its blocks' starts; the slots after the last run at
  // n_pad - 128.  Every slot of a run lies in the run's blocks, so the
  // chunk invariants build_mxu_layout checks hold by construction.
  const int64_t nb = n_pad / kTile, n_chunks = e_pad / kTile;
  std::vector<uint8_t> has_real(n_chunks, 0);
  {
    auto pad = [&](int64_t s, int32_t sb, int32_t db) {
      src[s] = sb * (int32_t)kTile;
      dst[s] = db * (int32_t)kTile;
      perm[s] = -1;
      edge_mask[s] = 0;
      snorm_e[s] = 0.0f;
      local_src[s] = 0;
      local_dst[s] = 0;
    };
    int64_t slot = 0;
    for (size_t r = 0; r + 1 < run_start.size(); ++r) {
      const int64_t a = run_start[r], k = run_start[r + 1] - a;
      const int32_t sb = ssrc[a] / (int32_t)kTile;
      const int32_t db = sdst[a] / (int32_t)kTile;
      for (int64_t j = 0; j < k; ++j) {
        const int64_t s = slot + j;
        src[s] = ssrc[a + j];
        dst[s] = sdst[a + j];
        perm[s] = srow[a + j];
        edge_mask[s] = 1;
        snorm_e[s] = sesn[a + j];
        local_src[s] = ssrc[a + j] - sb * (int32_t)kTile;
        local_dst[s] = sdst[a + j] - db * (int32_t)kTile;
        in_degree[sdst[a + j]]++;
      }
      const int64_t end = slot + round_up(k, kTile);
      for (int64_t s = slot + k; s < end; ++s) pad(s, sb, db);
      for (int64_t c = slot / kTile; c < end / kTile; ++c) {
        edge_chunk_src[c] = sb;
        edge_chunk_dst[c] = db;
        has_real[c] = 1;
      }
      slot = end;
    }
    for (int64_t s = slot; s < e_pad; ++s)
      pad(s, (int32_t)(nb - 1), (int32_t)(nb - 1));
    for (int64_t c = slot / kTile; c < n_chunks; ++c) {
      edge_chunk_src[c] = (int32_t)(nb - 1);
      edge_chunk_dst[c] = (int32_t)(nb - 1);
    }
  }

  // distinct (src block, dst block) pairs, dst-major, as np.unique gives
  // them (the all-pad chunks after the last run form one too); pad pairs
  // at (src block 0, dst block nb - 1)
  std::vector<int64_t> key(n_chunks), uniq;
  for (int64_t c = 0; c < n_chunks; ++c)
    key[c] = (int64_t)edge_chunk_dst[c] * nb + edge_chunk_src[c];
  uniq = key;
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  const int64_t n_real = (int64_t)uniq.size();
  const int64_t n_pairs = n_pairs_pad >= 0
                              ? n_pairs_pad
                              : round_up(n_real > 1 ? n_real : 1, 64);
  need[2] = n_real;
  need[3] = n_pairs;
  if (n_real > n_pairs) return 4;
  if (n_pairs > pair_cap) return 8;
  for (int64_t c = 0; c < n_chunks; ++c)
    chunk_pair[c] = (int32_t)(std::lower_bound(uniq.begin(), uniq.end(),
                                               key[c]) - uniq.begin());
  for (int64_t p = 0; p < n_pairs; ++p) {
    const bool real = p < n_real;
    pair_src[p] = real ? (int32_t)(uniq[p] % nb) : 0;
    pair_dst[p] = real ? (int32_t)(uniq[p] / nb) : (int32_t)(nb - 1);
    pair_covered[p] = real;
  }

  // the chunks in pair order (a stable argsort); the adjacency kernel's
  // walk: the chunks holding a real edge in that order, then the all-pad
  // ones, and a row pointer over the first
  std::vector<int64_t> count((size_t)n_pairs + 1, 0);
  for (int64_t c = 0; c < n_chunks; ++c) count[chunk_pair[c] + 1]++;
  for (int64_t p = 0; p < n_pairs; ++p) count[p + 1] += count[p];
  for (int64_t c = 0; c < n_chunks; ++c)
    pair_chunk_order[count[chunk_pair[c]]++] = (int32_t)c;
  for (int64_t p = 0; p <= n_pairs; ++p) pair_chunk_start[p] = 0;
  int64_t w = 0;
  for (int64_t i = 0; i < n_chunks; ++i) {
    const int32_t c = pair_chunk_order[i];
    pair_sorted_ids[i] = chunk_pair[c];
    if (has_real[c]) {
      pair_real_chunk_order[w++] = c;
      pair_chunk_start[chunk_pair[c] + 1]++;
    }
  }
  for (int64_t i = 0; i < n_chunks; ++i) {
    const int32_t c = pair_chunk_order[i];
    if (!has_real[c]) pair_real_chunk_order[w++] = c;
  }
  for (int64_t p = 0; p < n_pairs; ++p)
    pair_chunk_start[p + 1] += pair_chunk_start[p];
  return 0;
}

}  // extern "C"
