"""Block layout: the batch cut into 128-node blocks and 128-edge chunks.

PyTorch counterpart of `dgn_tpu/ops/mxu.py`.  The layout is the same: the
node axis is cut into 128-node blocks that no graph straddles (unless it is
itself larger), every 128-edge chunk has one src block and one dst block,
and the graph axis is cut into 128-graph blocks.  The decomposed edge stage
then runs as one batched dense product per layer against per-(src_block,
dst_block) adjacency blocks built once per forward pass
(`build_pair_adjacency`, a hand-written CUDA kernel on the card).  The
per-edge message path reduces every weighted sum of a layer in one scatter
(`weighted_segment_sums`).

The reference expresses gathers and scatters as one-hot matmuls because
XLA:TPU scatters are slow; that is a TPU workaround.  Here the scatters
are plain `index_add_` on global indices, and the reference's
`gather_src`/`gather_dst` (`block_gather`) are `segment.gather` on the
batch's global src/dst, which the layout's local indices reproduce.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import adjacency
from .segment import segment_sum

TILE = 128


@dataclasses.dataclass
class MXULayout:
    """Host-precomputed block structure of a GraphBatch.

    Edge axis (E = n_edge_chunks * TILE):
      local_src/local_dst: [E] int32 in [0, TILE), index within the chunk's
        src/dst node block.
      edge_chunk_src/edge_chunk_dst: [E/TILE] int32 node-block id per chunk
        (edge_chunk_dst non-decreasing).
    Node axis (N = n_node_chunks * TILE):
      local_graph: [N] int32 in [0, TILE), TILE for pad nodes.
      node_chunk_graph: [N/TILE] int32 graph-block id per node chunk.
    Pair axis (P = n_pairs, padded; pad pairs get no chunks):
      chunk_pair: [C] int32 pair id of each chunk.
      pair_src/pair_dst: [P] int32 node blocks, dst-major.
      pair_chunk_order: [C] int32 chunks sorted by pair id (stable).
      pair_sorted_ids: [C] int32 chunk_pair[pair_chunk_order], non-decreasing.
      pair_covered: [P] bool, False for pad pairs.
    """
    local_src: torch.Tensor
    local_dst: torch.Tensor
    edge_chunk_src: torch.Tensor
    edge_chunk_dst: torch.Tensor
    local_graph: torch.Tensor
    node_chunk_graph: torch.Tensor
    n_node_blocks: int
    n_graph_blocks: int
    chunk_pair: torch.Tensor
    pair_src: torch.Tensor
    pair_dst: torch.Tensor
    n_pairs: int
    pair_chunk_order: torch.Tensor
    pair_sorted_ids: torch.Tensor
    pair_covered: torch.Tensor
    # static metadata of the reference's max/min lowering, at the reference
    # defaults (always correct); nothing in this package reads it
    ext_passes: int = 7
    ext_block_chunks: int = 0

    def to(self, device) -> "MXULayout":
        return MXULayout(**{
            f.name: (getattr(self, f.name).to(device)
                     if isinstance(getattr(self, f.name), torch.Tensor)
                     else getattr(self, f.name))
            for f in dataclasses.fields(self)})


def build_mxu_layout(src: np.ndarray, dst: np.ndarray, edge_mask: np.ndarray,
                     node_graph: np.ndarray, node_mask: np.ndarray,
                     n_pad: int, g_pad: int,
                     n_pairs_pad: Optional[int] = None) -> MXULayout:
    """Derive the layout arrays from already-block-aligned packed data.

    Validates the block invariants so a mis-packed batch fails loudly
    instead of silently aggregating across blocks."""
    e_pad = len(src)
    if e_pad % TILE or n_pad % TILE or g_pad % TILE:
        raise ValueError("mxu layout needs TILE-multiple axes")
    cs = src.reshape(-1, TILE) // TILE
    cd = dst.reshape(-1, TILE) // TILE
    em = edge_mask.reshape(-1, TILE)

    def _chunk_id(blocks, mask):
        first = blocks[:, 0]
        ok = np.all((blocks == first[:, None]) | ~mask, axis=1)
        if not np.all(ok):
            raise ValueError("edge chunk spans multiple node blocks")
        return first.astype(np.int32)

    chunk_src = _chunk_id(cs, em)
    chunk_dst = _chunk_id(cd, em)
    local_src = (src - chunk_src.repeat(TILE) * TILE).astype(np.int32)
    local_dst = (dst - chunk_dst.repeat(TILE) * TILE).astype(np.int32)
    if local_src.min() < 0 or local_src.max() >= TILE or \
       local_dst.min() < 0 or local_dst.max() >= TILE:
        raise ValueError("edge endpoints outside their chunk's node block")

    ng = node_graph.reshape(-1, TILE) // TILE
    nm = node_mask.reshape(-1, TILE)
    chunk_graph = _chunk_id(ng, nm)
    local_graph = (node_graph - chunk_graph.repeat(TILE) * TILE).astype(np.int32)
    local_graph = np.where(node_mask, local_graph, TILE).astype(np.int32)
    if local_graph[node_mask].min() < 0 or local_graph[node_mask].max() >= TILE:
        raise ValueError("node's graph outside its chunk's graph block")

    nb = n_pad // TILE
    # distinct (src_block, dst_block) pairs, dst-major; padded to a
    # loader-stable count.  Pad pairs point at (src block 0, dst block nb-1)
    # and receive no chunks, so their adjacency blocks are zero.
    pair_key = chunk_dst.astype(np.int64) * nb + chunk_src
    uniq_key, chunk_pair = np.unique(pair_key, return_inverse=True)
    n_real_pairs = len(uniq_key)
    if n_pairs_pad is None:
        n_pairs_pad = -(-max(n_real_pairs, 1) // 64) * 64
    if n_real_pairs > n_pairs_pad:
        raise ValueError(
            f"mxu pair overflow: {n_real_pairs} > n_pairs_pad={n_pairs_pad}")
    pad = n_pairs_pad - n_real_pairs
    pair_src = np.concatenate(
        [(uniq_key % nb), np.zeros(pad, np.int64)]).astype(np.int32)
    pair_dst = np.concatenate(
        [(uniq_key // nb), np.full(pad, nb - 1, np.int64)]).astype(np.int32)
    pair_chunk_order = np.argsort(chunk_pair, kind="stable").astype(np.int32)
    pair_covered = np.zeros(n_pairs_pad, bool)
    pair_covered[:n_real_pairs] = True
    chunk_pair = chunk_pair.astype(np.int32)

    t = torch.from_numpy
    return MXULayout(
        local_src=t(local_src), local_dst=t(local_dst),
        edge_chunk_src=t(chunk_src), edge_chunk_dst=t(chunk_dst),
        local_graph=t(local_graph), node_chunk_graph=t(chunk_graph),
        n_node_blocks=nb, n_graph_blocks=g_pad // TILE,
        chunk_pair=t(chunk_pair), pair_src=t(pair_src),
        pair_dst=t(pair_dst), n_pairs=n_pairs_pad,
        pair_chunk_order=t(pair_chunk_order),
        pair_sorted_ids=t(np.ascontiguousarray(chunk_pair[pair_chunk_order])),
        pair_covered=t(pair_covered))


def pair_adj_matmul(W: torch.Tensor, gp: torch.Tensor) -> torch.Tensor:
    """out[p,k,j,:] = sum_i W[p,k,i,j] * gp[p,i,:].

    W: [P, K, TILE, TILE] adjacency blocks (batch constants, no gradient);
    gp: [P, TILE, F] src node blocks gathered per pair.  Note the transpose
    of W in i/j: rows of a block are src nodes, columns dst nodes."""
    return torch.matmul(W.transpose(-1, -2), gp.unsqueeze(1))


def build_pair_adjacency(weights: torch.Tensor, layout: MXULayout,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """[K, E] per-family edge weights -> [P, K, TILE, TILE] adjacency blocks.

    W[p, k, i, j] = sum of weights[k, e] over the edges e of pair p with
    local_src[e]=i and local_dst[e]=j.  Pad edges must carry weight 0.
    Dispatches on the tensor's device (ops/adjacency.py): the CUDA kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    return adjacency.build_pair_adjacency(weights, layout, out_dtype)


def block_scatter_sum(data: torch.Tensor, local: torch.Tensor,
                      chunk_block: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """out[chunk_block[c]*TILE + local[c,e]] += data[c*TILE+e]; rows whose
    local index is >= TILE (pad sentinel) are dropped.  Returns
    [n_blocks*TILE, ...]."""
    valid = local < TILE
    idx = torch.where(valid,
                      chunk_block.repeat_interleave(TILE) * TILE + local, 0)
    return segment_sum(data, idx, n_blocks * TILE, mask=valid)


def weighted_segment_sums(msg: torch.Tensor, weights: torch.Tensor,
                          layout: MXULayout, n_pad: int, n_full: int):
    """Every weighted edge->dst reduction of a layer in one scatter.

    msg: [E, F]; weights: [n_w, E], pad edges already zero-weighted.  The
    first n_full weight rows get full feature sums, every row its weight
    total.  Returns (sums [n_full, n_pad, F], totals
    [n_w, n_pad])."""
    f = msg.shape[1]
    cols = [msg * weights[i][:, None] for i in range(n_full)]
    cols.append(weights.T)                              # the totals columns
    out = block_scatter_sum(torch.cat(cols, dim=1), layout.local_dst,
                            layout.edge_chunk_dst,
                            layout.n_node_blocks)[:n_pad]
    sums = out[:, :n_full * f].reshape(n_pad, n_full, f).transpose(0, 1)
    return sums, out[:, n_full * f:].T


def graph_pool_sum(h: torch.Tensor, layout: MXULayout,
                   g_pad: int) -> torch.Tensor:
    """Per-graph sum over nodes (pad nodes excluded via the TILE sentinel)."""
    return block_scatter_sum(h, layout.local_graph, layout.node_chunk_graph,
                             layout.n_graph_blocks)[:g_pad]


def graph_broadcast(vg: torch.Tensor, node_graph: torch.Tensor,
                    node_mask: torch.Tensor) -> torch.Tensor:
    """Per-node copy of its graph's row of vg [G_pad, F], one index_select
    over the batch's node_graph; pad nodes get zeros."""
    return torch.where(node_mask[:, None], vg.index_select(0, node_graph),
                       0.0)
