"""GraphBatch: a batch of small graphs packed into fixed-shape padded tensors.

PyTorch counterpart of `dgn_tpu/graph.py`.  Packing is host numpy code,
copied from the reference package so the two produce identical arrays for
the same graphs; only the container changes (a dataclass of torch tensors
with `.to(device)` instead of a JAX pytree).

This slice carries the block ("mxu") layout only: nodes are placed so no
graph straddles a 128-node block, edges are chunked per (src_block,
dst_block) pair, and the graph axis is 128-aligned (`ops/mxu.py`).  The flat
packing, the native packer and the halo spec are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

_TILE = 128


def _move(x, device):
    return None if x is None else x.to(device)


@dataclasses.dataclass
class GraphBatch:
    """A batch of graphs packed into flat padded tensors.

    Axes: N = padded node count, E = padded edge count, G = padded graph
    count.  dtypes match the reference package: int32 indices, bool masks,
    float32 features.
    """

    # --- node axis [N, ...] ---
    node_feat: torch.Tensor          # [N] int32 (categorical) or [N, F] float
    node_mask: torch.Tensor          # [N] bool, True for real nodes
    node_graph: torch.Tensor         # [N] int32 graph id per node
    eig: torch.Tensor                # [N, K] float32 Laplacian eigenvectors
    in_degree: torch.Tensor          # [N] int32 true in-degree (0 for pad)
    snorm_n: torch.Tensor            # [N, 1] float32 sqrt(1/n_nodes(graph))
    # --- edge axis [E, ...] ---
    src: torch.Tensor                # [E] int32
    dst: torch.Tensor                # [E] int32
    edge_mask: torch.Tensor          # [E] bool
    edge_feat: Optional[torch.Tensor]
    snorm_e: torch.Tensor            # [E, 1] float32
    # --- graph axis [G, ...] ---
    graph_mask: torch.Tensor         # [G] bool
    n_nodes: torch.Tensor            # [G] int32
    n_edges: torch.Tensor            # [G] int32
    labels: Optional[torch.Tensor]   # [G, ...]
    node_labels: Optional[torch.Tensor] = None
    pos_enc: Optional[torch.Tensor] = None
    # block layout (ops/mxu.py MXULayout)
    mxu: Optional[object] = None
    # per-forward EdgeContext (ops/aggregators.py), attached by the model or
    # by the trainer's eval cache
    edge_ctx: Optional[object] = None

    @property
    def num_nodes_padded(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def num_graphs_padded(self) -> int:
        return self.graph_mask.shape[0]

    def to(self, device) -> "GraphBatch":
        """A copy with every tensor (and the layout and context) on device."""
        return GraphBatch(**{f.name: _move(getattr(self, f.name), device)
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass
class GraphData:
    """One host-side graph: the minimal ingredients for packing."""
    num_nodes: int
    src: np.ndarray                 # [e] int
    dst: np.ndarray                 # [e] int
    node_feat: np.ndarray           # [n] or [n, F]
    eig: Optional[np.ndarray] = None          # [n, K]
    edge_feat: Optional[np.ndarray] = None    # [e] or [e, Fe]
    label: Optional[np.ndarray] = None        # graph label, any shape
    node_labels: Optional[np.ndarray] = None  # [n]
    pos_enc: Optional[np.ndarray] = None      # [n, P]

    @property
    def num_edges(self) -> int:
        return len(self.src)


def pack_graphs(graphs: Sequence[GraphData], *,
                n_pad: Optional[int] = None,
                e_pad: Optional[int] = None,
                g_pad: Optional[int] = None,
                k_eig: Optional[int] = None,
                mxu_layout: bool = False,
                n_pairs_pad: Optional[int] = None) -> GraphBatch:
    """Pack graphs into one fixed-shape GraphBatch on the CPU.

    Only the block layout is ported; `mxu_layout=False` raises."""
    if not mxu_layout:
        raise NotImplementedError(
            "the flat layout is not ported yet; pass mxu_layout=True")
    return _pack_graphs_mxu(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                            k_eig=k_eig, n_pairs_pad=n_pairs_pad)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _mxu_place(sizes: Sequence[int]) -> tuple[np.ndarray, int]:
    """Node offsets such that no graph straddles a 128-node block boundary
    (graphs >128 nodes are placed as-is; their edges get per-block-pair
    chunks) and node blocks never mix graphs from two 128-graph blocks."""
    offsets = np.zeros(len(sizes), np.int64)
    cur = 0
    for gi, n in enumerate(sizes):
        if gi > 0 and gi % _TILE == 0:
            cur = round_up(cur, _TILE)          # new graph block
        if n <= _TILE and (cur % _TILE) + n > _TILE:
            cur = round_up(cur, _TILE)          # doesn't fit the remainder
        offsets[gi] = cur
        cur += n
    return offsets, round_up(cur, _TILE)


def _mxu_edge_arrange(src: np.ndarray, dst: np.ndarray):
    """Sort edges by (dst_block, src_block, dst, src) and pad every
    (src_block, dst_block) run to whole 128-edge chunks.

    Returns (order into the original edge arrays, padded src, padded dst,
    valid mask) with pad slots pointing at their chunk's block starts."""
    db = dst // _TILE
    sb = src // _TILE
    order = np.lexsort((src, dst, sb, db))
    src_s, dst_s = src[order], dst[order]
    db_s, sb_s = db[order], sb[order]
    if len(order):
        new_run = np.ones(len(order), bool)
        new_run[1:] = (db_s[1:] != db_s[:-1]) | (sb_s[1:] != sb_s[:-1])
        run_starts = np.nonzero(new_run)[0]
        run_ends = np.append(run_starts[1:], len(order))
    else:
        run_starts = run_ends = np.zeros(0, np.int64)
    out_order, out_src, out_dst, out_valid = [], [], [], []
    for s, e in zip(run_starts, run_ends):
        k = e - s
        padded = round_up(k, _TILE)
        idx = np.full(padded, -1, np.int64)
        idx[:k] = order[s:e]
        ss = np.full(padded, sb_s[s] * _TILE, np.int32)
        dd = np.full(padded, db_s[s] * _TILE, np.int32)
        ss[:k] = src_s[s:e]
        dd[:k] = dst_s[s:e]
        v = np.zeros(padded, bool)
        v[:k] = True
        out_order.append(idx)
        out_src.append(ss)
        out_dst.append(dd)
        out_valid.append(v)
    if not out_order:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int32), np.zeros(0, bool))
    return (np.concatenate(out_order), np.concatenate(out_src),
            np.concatenate(out_dst), np.concatenate(out_valid))


def mxu_bucket_sizes(graphs: Sequence[GraphData], batch_size: int,
                     slack: float = 1.05) -> tuple[int, int, int]:
    """(n_pad, e_pad, g_pad) so any `batch_size` subset packs under the block
    layout: greedy placement of the largest graphs, plus slack.  pack raises
    on overflow, so a too-tight estimate fails loudly."""
    ns = np.sort(np.array([g.num_nodes for g in graphs]))[::-1][:batch_size]
    _, n_used = _mxu_place(ns.tolist())
    es = np.sort(np.array([g.num_edges for g in graphs]))[::-1][:batch_size]
    n_blocks = n_used // _TILE
    e_used = int(es.sum()) + (_TILE - 1) * max(n_blocks, 1)
    n_pad = round_up(int(n_used * slack) + _TILE, _TILE)
    e_pad = round_up(int(e_used * slack) + _TILE, _TILE)
    return n_pad, e_pad, round_up(batch_size, _TILE)


def _pack_graphs_mxu(graphs: Sequence[GraphData], *,
                     n_pad: Optional[int], e_pad: Optional[int],
                     g_pad: Optional[int], k_eig: Optional[int],
                     n_pairs_pad: Optional[int] = None) -> GraphBatch:
    """pack_graphs under the block layout (ops/mxu.py).  gb.dst is NOT
    globally sorted."""
    from .ops.mxu import build_mxu_layout

    g = len(graphs)
    sizes = [gr.num_nodes for gr in graphs]
    offsets, n_used = _mxu_place(sizes)
    g_pad = round_up(int(g_pad if g_pad is not None else g), _TILE)
    n_pad = int(n_pad if n_pad is not None else n_used)
    if n_pad % _TILE:
        raise ValueError(f"mxu n_pad must be a multiple of {_TILE}")
    if n_used > n_pad or g > g_pad:
        raise ValueError(f"mxu pack overflow: need (n={n_used}, g={g}) "
                         f"but pad sizes are (n={n_pad}, g={g_pad})")
    if k_eig is None:
        k_eig = graphs[0].eig.shape[1] if (graphs and graphs[0].eig is not None) else 0

    nf0 = graphs[0].node_feat
    nf_dtype = nf0.dtype if nf0.dtype.kind == "f" else np.int32
    node_feat = np.zeros((n_pad,) + tuple(nf0.shape[1:]), dtype=nf_dtype)
    node_mask = np.zeros((n_pad,), dtype=bool)
    node_graph = np.zeros((n_pad,), dtype=np.int32)
    eig = np.zeros((n_pad, k_eig), dtype=np.float32)
    snorm_n = np.zeros((n_pad, 1), dtype=np.float32)
    has_nl = graphs[0].node_labels is not None
    node_labels = np.zeros((n_pad,), dtype=np.int32) if has_nl else None
    has_pe = graphs[0].pos_enc is not None
    pos_enc = (np.zeros((n_pad, graphs[0].pos_enc.shape[1]), np.float32)
               if has_pe else None)

    graph_mask = np.zeros((g_pad,), dtype=bool)
    n_nodes = np.zeros((g_pad,), dtype=np.int32)
    n_edges = np.zeros((g_pad,), dtype=np.int32)
    has_label = graphs[0].label is not None
    if has_label:
        lb0 = np.asarray(graphs[0].label)
        labels = np.zeros((g_pad,) + lb0.shape,
                          dtype=np.float32 if lb0.dtype.kind == "f" else lb0.dtype)
    else:
        labels = None

    tot_e = sum(gr.num_edges for gr in graphs)
    src_flat = np.zeros((tot_e,), np.int64)
    dst_flat = np.zeros((tot_e,), np.int64)
    e_graph = np.zeros((tot_e,), np.int32)
    e_off = 0
    for gi, gr in enumerate(graphs):
        n, e = gr.num_nodes, gr.num_edges
        off = int(offsets[gi])
        sl_n = slice(off, off + n)
        node_feat[sl_n] = gr.node_feat
        node_mask[sl_n] = True
        node_graph[sl_n] = gi
        if k_eig and gr.eig is not None:
            eig[sl_n, : gr.eig.shape[1]] = gr.eig[:, :k_eig]
        snorm_n[sl_n] = np.sqrt(1.0 / max(n, 1))
        if has_nl:
            node_labels[sl_n] = gr.node_labels
        if has_pe:
            pos_enc[sl_n] = gr.pos_enc
        graph_mask[gi] = True
        n_nodes[gi] = n
        n_edges[gi] = e
        if has_label:
            labels[gi] = np.asarray(gr.label)
        src_flat[e_off:e_off + e] = np.asarray(gr.src, np.int64) + off
        dst_flat[e_off:e_off + e] = np.asarray(gr.dst, np.int64) + off
        e_graph[e_off:e_off + e] = gi
        e_off += e
    # pad nodes: keep node_graph monotone
    run = np.maximum.accumulate(np.where(node_mask, node_graph, 0))
    node_graph = np.where(node_mask, node_graph, run).astype(np.int32)

    order, src_p, dst_p, edge_valid = _mxu_edge_arrange(
        src_flat.astype(np.int32), dst_flat.astype(np.int32))
    e_used = len(src_p)
    e_pad = int(e_pad if e_pad is not None else max(e_used, _TILE))
    if e_pad % _TILE:
        raise ValueError(f"mxu e_pad must be a multiple of {_TILE}")
    if e_used > e_pad:
        raise ValueError(f"mxu pack overflow: need e={e_used} "
                         f"but e_pad={e_pad}")
    src = np.full((e_pad,), n_pad - _TILE, np.int32)
    dst = np.full((e_pad,), n_pad - _TILE, np.int32)
    edge_mask = np.zeros((e_pad,), bool)
    src[:e_used] = src_p
    dst[:e_used] = dst_p
    edge_mask[:e_used] = edge_valid
    snorm_e = np.zeros((e_pad, 1), np.float32)
    real = np.nonzero(edge_mask)[0]
    eg = e_graph[order[edge_valid]]
    snorm_e[real, 0] = np.sqrt(1.0 / np.maximum(n_edges[eg], 1))
    edge_feat = None
    if graphs[0].edge_feat is not None:
        ef_cat = np.concatenate([np.asarray(gr.edge_feat) for gr in graphs]) \
            if tot_e else np.zeros((0,) + np.shape(graphs[0].edge_feat)[1:])
        ef_dtype = ef_cat.dtype if ef_cat.dtype.kind == "f" else np.int32
        edge_feat = np.zeros((e_pad,) + tuple(ef_cat.shape[1:]), dtype=ef_dtype)
        edge_feat[real] = ef_cat[order[edge_valid]]

    in_degree = np.zeros((n_pad,), dtype=np.int32)
    np.add.at(in_degree, dst[edge_mask], 1)

    layout = build_mxu_layout(src, dst, edge_mask, node_graph, node_mask,
                              n_pad, g_pad, n_pairs_pad=n_pairs_pad)

    def t(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x))

    return GraphBatch(
        node_feat=t(node_feat), node_mask=t(node_mask),
        node_graph=t(node_graph), eig=t(eig), in_degree=t(in_degree),
        snorm_n=t(snorm_n), src=t(src), dst=t(dst), edge_mask=t(edge_mask),
        edge_feat=t(edge_feat), snorm_e=t(snorm_e), graph_mask=t(graph_mask),
        n_nodes=t(n_nodes), n_edges=t(n_edges), labels=t(labels),
        node_labels=t(node_labels), pos_enc=t(pos_enc), mxu=layout)


def mxu_pairs_needed(batch: Sequence[GraphData]) -> int:
    """Distinct (src_block, dst_block) pair count this batch needs under the
    block layout (descending next-fit placement, the loader's order)."""
    batch = sorted(batch, key=lambda g: -g.num_nodes)
    offsets, _ = _mxu_place([g.num_nodes for g in batch])
    if not batch:
        return 1
    src = np.concatenate([np.asarray(g.src, np.int64) + offsets[i]
                          for i, g in enumerate(batch)])
    dst = np.concatenate([np.asarray(g.dst, np.int64) + offsets[i]
                          for i, g in enumerate(batch)])
    if not len(src):
        return 1
    return len(np.unique((dst // _TILE) << 32 | (src // _TILE)))


def mxu_pair_pad(graphs: Sequence[GraphData], batch_size: int,
                 n_pad: int, e_pad: int) -> int:
    """Loader-stable bound on the (src_block, dst_block) pair count of ANY
    batch_size-subset packed at (n_pad, e_pad): diagonal pairs are bounded by
    the node-block count, off-diagonal ones come only from graphs spanning
    several blocks, and everything is capped by the chunk count.  A batch
    that still overflows raises in build_mxu_layout and takes the loader's
    escape repack."""
    nb = max(n_pad // _TILE, 1)
    big = sorted((g.num_nodes for g in graphs if g.num_nodes > _TILE),
                 reverse=True)[:batch_size]
    off = sum((n // _TILE + 2) * (n // _TILE + 1) for n in big)
    return min(round_up(nb + off, 64), max(e_pad // _TILE, 1))


def pack_requirements(batch: Sequence[GraphData]) -> tuple[int, int]:
    """EXACT (n_used, e_used) slots the block layout needs for this batch,
    packed in descending num_nodes order (the loader's order)."""
    batch = sorted(batch, key=lambda g: -g.num_nodes)
    offsets, n_used = _mxu_place([g.num_nodes for g in batch])
    src = np.concatenate([np.asarray(g.src, np.int64) + offsets[i]
                          for i, g in enumerate(batch)]).astype(np.int32) \
        if batch else np.zeros(0, np.int32)
    dst = np.concatenate([np.asarray(g.dst, np.int64) + offsets[i]
                          for i, g in enumerate(batch)]).astype(np.int32) \
        if batch else np.zeros(0, np.int32)
    _, src_p, _, _ = _mxu_edge_arrange(src, dst)
    return n_used, max(len(src_p), _TILE)


def typical_bucket_sizes(graphs: Sequence[GraphData], batch_size: int, *,
                         probe_epochs: int = 4, slack: float = 1.10,
                         seed: int = 0, multiple: int = 128
                         ) -> tuple[int, int]:
    """(n_pad, e_pad) sized for TYPICAL shuffled batches: the max exact
    requirement over `probe_epochs` simulated shuffles, plus slack, capped by
    the worst-case bound.  A batch that still overflows makes pack_graphs
    raise and the loader repacks it (data/loader.py)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(len(graphs))
    need_n = need_e = 1
    for _ in range(probe_epochs):
        rng.shuffle(idx)
        for i in range(0, len(idx), batch_size):
            n_used, e_used = pack_requirements(
                [graphs[j] for j in idx[i:i + batch_size]])
            need_n = max(need_n, n_used)
            need_e = max(need_e, e_used)
    n_pad = round_up(int(need_n * slack) + 1, multiple)
    e_pad = round_up(int(need_e * slack), multiple)
    worst = mxu_bucket_sizes(graphs, batch_size)
    return min(n_pad, worst[0]), min(e_pad, worst[1])
