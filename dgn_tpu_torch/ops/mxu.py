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
`gather_src`/`gather_dst` (`block_gather`) are `gather` on the batch's
global src/dst, which the layout's local indices reproduce.

compute_dtype (a torch dtype, bfloat16 or float16; None = float32
throughout).  The reference runs its block-layout products on operands
rounded to compute_dtype with float32 accumulation and a float32 result,
in the forward AND the backward product (`dgn_tpu/ops/mxu.py:364-450`).
Plain autograd through `x.to(compute_dtype)` does not do that: the
cotangent of a float32 result is not rounded, and a low-precision result
rounds the sum.  So each primitive here is an autograd Function that
rounds its operand on the way in and the incoming gradient on the way
back:
  * pair_adj_matmul: the blocks and gp rounded, float32 accumulation (on
    CUDA `torch.bmm(..., out_dtype=torch.float32)` on the low-precision
    operands, on the CPU the float32 product of the rounded operands);
    backward the same with the rounded cotangent.  A product of two
    bfloat16 values has at most 16 significant bits and one of two
    float16 values 22, within float32's 24 (and float16's range keeps its
    products inside float32's), so each product is exact in float32 and
    the two routes differ only in summation order;
  * block_scatter_sum / weighted_segment_sums: a float32 `index_add_` of
    the rounded data (the reference's one-hot product over a chunk), whose
    backward gathers the rounded cotangent;
  * gather: the rows of the rounded table; backward an `index_add_` of
    the rounded cotangent.
graph_pool_sum and graph_broadcast never round, as in the reference.

Overflow.  float16 tops out at 65504 (bfloat16 near 3e38): a value beyond
it rounds to +-inf.  The gathers and scatters here move each row alone, so
an inf stays in the rows that hold it (and a 0 weight times an inf row
gives NaN only in the entry it multiplies).  The reference's one-hot
products multiply every row of a chunk by every one-hot column, so one inf
becomes NaN (0 * inf) across its chunk.  The port keeps its index gather
and `index_add_` and does not reproduce that spread.  pair_adj_matmul is a
real matmul in both packages and agrees: NaN where a block entry is 0, inf
where it is not.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import observe
from . import adjacency
from . import segment
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
    Edge-partitioned (build_mxu_layout_ep; None elsewhere): the pairs are
    [interior | boundary], the first n_pairs_int reading src blocks of the
    rank's own region, the rest of its halo region (pair_src -
    n_own_blocks indexes the halo's blocks); local_graph and
    node_chunk_graph are None there (per-graph pools take the flat masked
    path).
    The adjacency kernel's walk (port only; dgn_tpu's layout has neither):
      pair_real_chunk_order: [C] int32 the chunks that hold a real edge, in
        pair_chunk_order's order, then the all-pad chunks.
      pair_chunk_start: [P + 1] int32 row pointer into it: pair p's chunks
        with a real edge are [start[p], start[p+1]); start[P] counts them.
        Pad pairs and a pair that owns only all-pad chunks get empty ranges.
    """
    local_src: torch.Tensor
    local_dst: torch.Tensor
    edge_chunk_src: torch.Tensor
    edge_chunk_dst: torch.Tensor
    local_graph: Optional[torch.Tensor]
    node_chunk_graph: Optional[torch.Tensor]
    n_node_blocks: int
    n_graph_blocks: int
    chunk_pair: torch.Tensor
    pair_src: torch.Tensor
    pair_dst: torch.Tensor
    n_pairs: int
    pair_chunk_order: torch.Tensor
    pair_sorted_ids: torch.Tensor
    pair_covered: torch.Tensor
    pair_real_chunk_order: torch.Tensor
    pair_chunk_start: torch.Tensor
    # static metadata of the reference's max/min lowering, at the reference
    # defaults (always correct); nothing in this package reads it: the
    # extremes kernels walk every chunk of a dst block
    ext_passes: int = 7
    ext_block_chunks: int = 0
    n_pairs_int: Optional[int] = None
    n_own_blocks: Optional[int] = None

    def to(self, device) -> "MXULayout":
        return MXULayout(**{
            f.name: (observe.to_device(getattr(self, f.name), device)
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
    pair_real_chunk_order, pair_chunk_start = _chunk_walk(
        chunk_pair, pair_chunk_order, em, n_pairs_pad)

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
        pair_covered=t(pair_covered),
        pair_real_chunk_order=t(pair_real_chunk_order),
        pair_chunk_start=t(pair_chunk_start))


def _chunk_walk(chunk_pair: np.ndarray, pair_chunk_order: np.ndarray,
                em: np.ndarray, n_pairs: int):
    """(pair_real_chunk_order, pair_chunk_start): the adjacency kernel's
    walk over the chunks that hold a real edge (em: [C, TILE] edge mask)."""
    # all-pad chunks carry weight 0 only, so the adjacency kernel skips them
    real = em.any(axis=1)[pair_chunk_order]
    pair_real_chunk_order = np.concatenate(
        [pair_chunk_order[real], pair_chunk_order[~real]])
    pair_chunk_start = np.zeros(n_pairs + 1, np.int32)
    np.cumsum(np.bincount(chunk_pair[pair_chunk_order[real]],
                          minlength=n_pairs), out=pair_chunk_start[1:])
    return pair_real_chunk_order, pair_chunk_start


def build_mxu_layout_ep(src: np.ndarray, dst: np.ndarray,
                        edge_mask: np.ndarray, n_ext: int, nb_own: int,
                        n_pairs_int_pad: int,
                        n_pairs_bnd_pad: int) -> MXULayout:
    """The layout of ONE edge-partitioned rank (dgn_tpu/ops/mxu.py:267-355).

    The rank's node axis is [own | halo], both 128-aligned (nb_own own
    blocks); its edges are already arranged into (src_block, dst_block)
    chunks by graph._mxu_edge_arrange.  Unlike build_mxu_layout: no
    graph-pooling blocks (local_graph None), and the pairs are ordered
    [interior | boundary] by whether the src block is an own one, each group
    dst-major and padded to a size every rank shares.  Pad pairs point at
    (src block 0, or the first halo block nb_own for the boundary group;
    dst block nb - 1) and receive no chunk, so their blocks are zero."""
    e_pad = len(src)
    if e_pad % TILE or n_ext % TILE:
        raise ValueError("mxu ep layout needs TILE-multiple axes")
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
    nb = n_ext // TILE

    # distinct pairs, interior group first, dst-major inside each group
    pair_key = chunk_dst.astype(np.int64) * nb + chunk_src
    is_bnd_chunk = chunk_src >= nb_own
    uniq_key, inv = np.unique(
        pair_key + np.where(is_bnd_chunk, np.int64(nb) * nb, 0),
        return_inverse=True)
    bnd_mask = uniq_key >= np.int64(nb) * nb
    n_int_real = int((~bnd_mask).sum())
    n_bnd_real = int(bnd_mask.sum())
    if n_int_real > n_pairs_int_pad or n_bnd_real > n_pairs_bnd_pad:
        raise ValueError(
            f"ep pair overflow: ({n_int_real},{n_bnd_real}) > "
            f"({n_pairs_int_pad},{n_pairs_bnd_pad})")
    key_mod = uniq_key % (np.int64(nb) * nb)
    # pair ids: interior [0, n_int_real) then its pads, boundary from
    # n_pairs_int_pad on, then its pads
    new_id = np.where(bnd_mask,
                      n_pairs_int_pad + np.cumsum(bnd_mask) - 1,
                      np.cumsum(~bnd_mask) - 1).astype(np.int64)
    chunk_pair = new_id[inv.reshape(-1)].astype(np.int32)
    n_pairs = n_pairs_int_pad + n_pairs_bnd_pad
    pair_src = np.zeros(n_pairs, np.int32)
    pair_dst = np.full(n_pairs, nb - 1, np.int32)
    pair_src[n_pairs_int_pad:] = nb_own          # boundary pads: halo block 0
    pair_src[new_id] = (key_mod % nb).astype(np.int32)
    pair_dst[new_id] = (key_mod // nb).astype(np.int32)
    pair_covered = np.zeros(n_pairs, bool)
    pair_covered[new_id] = True
    pair_chunk_order = np.argsort(chunk_pair, kind="stable").astype(np.int32)
    pair_real_chunk_order, pair_chunk_start = _chunk_walk(
        chunk_pair, pair_chunk_order, em, n_pairs)
    t = torch.from_numpy
    return MXULayout(
        local_src=t(local_src), local_dst=t(local_dst),
        edge_chunk_src=t(chunk_src), edge_chunk_dst=t(chunk_dst),
        local_graph=None, node_chunk_graph=None,
        n_node_blocks=nb, n_graph_blocks=0,
        chunk_pair=t(chunk_pair), pair_src=t(pair_src),
        pair_dst=t(pair_dst), n_pairs=n_pairs,
        pair_chunk_order=t(pair_chunk_order),
        pair_sorted_ids=t(np.ascontiguousarray(chunk_pair[pair_chunk_order])),
        pair_covered=t(pair_covered),
        pair_real_chunk_order=t(pair_real_chunk_order),
        pair_chunk_start=t(pair_chunk_start),
        n_pairs_int=n_pairs_int_pad, n_own_blocks=nb_own)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to dtype, kept in x's dtype."""
    return x.to(dtype).to(x.dtype)


class _Round(torch.autograd.Function):
    """Identity with rounding to compute_dtype: of the value on the way
    forward (fwd) and of the gradient on the way back (bwd)."""

    @staticmethod
    def forward(ctx, x, compute_dtype, fwd: bool, bwd: bool):
        ctx.compute_dtype, ctx.bwd = compute_dtype, bwd
        return _rounded(x, compute_dtype) if fwd else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (_rounded(g, ctx.compute_dtype) if ctx.bwd else g,
                None, None, None)


def _lowp_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [P, K, T, T] @ b [P, K or 1, T, F] -> float32 [P, K, T, F] on
    operands already in a low-precision dtype, accumulating in float32."""
    if a.device.type == "cuda":
        p, k, t, _ = a.shape
        f = b.shape[-1]
        out = torch.bmm(a.reshape(p * k, t, t),
                        b.expand(p, k, t, f).reshape(p * k, t, f),
                        out_dtype=torch.float32)
        return out.view(p, k, t, f)
    return torch.matmul(a.float(), b.float())


class _PairAdjMatmulCast(torch.autograd.Function):
    """pair_adj_matmul on operands rounded to compute_dtype, float32
    accumulation and result, forward and backward; W gets no gradient."""

    @staticmethod
    def forward(ctx, W, gp, compute_dtype):
        w = W.to(compute_dtype)
        ctx.save_for_backward(w)
        ctx.compute_dtype = compute_dtype
        return _lowp_matmul(w.transpose(-1, -2),
                            gp.to(compute_dtype).unsqueeze(1))

    @staticmethod
    def backward(ctx, dT):
        (w,) = ctx.saved_tensors
        d_gp = _lowp_matmul(w, dT.to(ctx.compute_dtype)).sum(1)
        return None, d_gp, None


def pair_adj_matmul(W: torch.Tensor, gp: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """out[p,k,j,:] = sum_i W[p,k,i,j] * gp[p,i,:].

    W: [P, K, TILE, TILE] adjacency blocks (batch constants, no gradient);
    gp: [P, TILE, F] src node blocks gathered per pair.  Note the transpose
    of W in i/j: rows of a block are src nodes, columns dst nodes.  With
    compute_dtype both products (forward and gp's gradient) take operands
    rounded to it and accumulate in float32; the result is float32."""
    if compute_dtype is None:
        return torch.matmul(W.transpose(-1, -2), gp.unsqueeze(1))
    return _PairAdjMatmulCast.apply(W, gp, compute_dtype)


def gather(h: torch.Tensor, index: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """h[index] rows (the reference's gather_src/gather_dst on the block
    layout).  With compute_dtype the rows come from the table rounded to
    it, and the cotangent is rounded before the float32 sum into h's
    gradient."""
    if compute_dtype is None:
        return segment.gather(h, index)
    rows = segment.gather(_Round.apply(h, compute_dtype, True, False), index)
    return _Round.apply(rows, compute_dtype, False, True)


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
                      chunk_block: torch.Tensor, n_blocks: int,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """out[chunk_block[c]*TILE + local[c,e]] += data[c*TILE+e]; rows whose
    local index is >= TILE (pad sentinel) are dropped.  Returns
    [n_blocks*TILE, ...].  With compute_dtype the data is rounded to it
    before the float32 sum, and so is the gradient that flows back."""
    if compute_dtype is not None:
        data = _Round.apply(data, compute_dtype, True, True)
    valid = local < TILE
    idx = torch.where(valid,
                      chunk_block.repeat_interleave(TILE) * TILE + local, 0)
    return segment_sum(data, idx, n_blocks * TILE, mask=valid)


def weighted_segment_sums(msg: torch.Tensor, weights: torch.Tensor,
                          layout: MXULayout, n_pad: int, n_full: int,
                          compute_dtype: Optional[torch.dtype] = None):
    """Every weighted edge->dst reduction of a layer in one scatter.

    msg: [E, F]; weights: [n_w, E], pad edges already zero-weighted.  The
    first n_full weight rows get full feature sums, every row its weight
    total.  With compute_dtype the scatter rounds its columns (totals
    included) as block_scatter_sum does.  Returns (sums [n_full, n_pad, F],
    totals [n_w, n_pad])."""
    f = msg.shape[1]
    cols = [msg * weights[i][:, None] for i in range(n_full)]
    cols.append(weights.T)                              # the totals columns
    out = block_scatter_sum(torch.cat(cols, dim=1), layout.local_dst,
                            layout.edge_chunk_dst, layout.n_node_blocks,
                            compute_dtype)[:n_pad]
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
