"""GraphBatch: a batch of small graphs packed into fixed-shape padded tensors.

PyTorch counterpart of `dgn_tpu/graph.py`.  Packing is host numpy code,
copied from the reference package so the two produce identical arrays for
the same graphs; only the container changes (a dataclass of torch tensors
with `.to(device)` instead of a JAX pytree).

Two layouts, as there.  Flat (`mxu_layout=False`, the default): graphs
follow one another on the node axis, real edges are stable-sorted by
(dst, src) and pad edges go last, pointing at the last node slot (the
"ghost" node the flat geometry helpers reserve); the segment ops of
`ops/segment.py` reduce over that edge list.  Block ("mxu"): nodes are
placed so no graph straddles a 128-node block, edges are chunked per
(src_block, dst_block) pair, and the graph axis is 128-aligned
(`ops/mxu.py`).  The port's native packer (`runtime/packer.cpp`) runs,
when it is built, the flat layout's edge pipeline (offsets, the (dst, src)
sort, masks, normalisers, in-degrees) and the whole block pack (placement,
edge arrangement, node and edge arrays, the block layout), with the same
arrays bit for bit as the numpy paths.

Edge-partitioned execution (parallel/halo.py) carries a `HaloSpec` on each
rank's batch: the rank's node axis is [own | halo], the halo rows copies
of remote nodes that its edges read.  `halo_pull` fetches them from their
owners with one boundary-only all-to-all (`_AllToAll`, whose backward is
the reverse all-to-all), or, for a spec without an exchange plan, an
all-gather (`_AllGather`, whose backward sums the cotangents over the
ranks and keeps this rank's rows).  Gloo's all-to-all takes CUDA tensors
(chip_smoke.py's ep phase runs it so on an H100); its all-gather takes
CPU tensors, so `_gather_all` stages a CUDA tensor through the host over
gloo.
"""
from __future__ import annotations

import dataclasses
import math
from collections import abc
from typing import Optional, Sequence

import numpy as np
import torch

from . import observe

_TILE = 128


def _move(x, device):
    if isinstance(x, torch.Tensor):
        return observe.to_device(x, device)
    return None if x is None else x.to(device)


@dataclasses.dataclass
class HaloSpec:
    """Where each halo slot of an edge-partitioned rank's batch lives
    (dgn_tpu/graph.py:39-61).

    The rank's node axis is [0, n_local) its own nodes (padding included)
    and [n_local, n_local + H) the halo slots.  halo_shard / halo_local:
    [H] int32 owner rank and owner-local row of each slot.  The exchange
    plan (None: the all-gather fallback): send_idx [P, S] int32, the own
    rows this rank ships to each rank q (row q), and recv_perm [H] int32,
    each halo slot's row in the [P * S] receive buffer.  group is the
    process group of the ranks (the trainer sets it; None: the world)."""
    halo_shard: torch.Tensor
    halo_local: torch.Tensor
    send_idx: Optional[torch.Tensor] = None
    recv_perm: Optional[torch.Tensor] = None
    n_local: int = 0
    axis: str = "ep"
    group: Optional[object] = None

    def to(self, device) -> "HaloSpec":
        return dataclasses.replace(self, **{
            name: _move(getattr(self, name), device)
            for name in ("halo_shard", "halo_local", "send_idx",
                         "recv_perm")})


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """All-to-all of x [P * S, ...] in P equal row blocks: block q goes to
    rank q, and the block from rank p lands at block p."""
    import torch.distributed as dist
    src = x.detach().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def _gather_all(x: torch.Tensor, group) -> torch.Tensor:
    """[P * rows, ...]: every rank's x in rank order (bool as uint8)."""
    import torch.distributed as dist
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.detach().cpu() if staged else x.detach().contiguous()
    if src.dtype == torch.bool:
        return _gather_all(src.to(torch.uint8), group).to(
            device=x.device, dtype=torch.bool)
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.to(x.device) if staged else out


def _sum_all(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the ranks."""
    import torch.distributed as dist
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """`exchange` as a differentiable op: its adjoint is the reverse
    all-to-all, which for equal blocks is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return exchange(grad.contiguous(), ctx.group), None


class _AllGather(torch.autograd.Function):
    """Every rank's x concatenated in rank order; the adjoint sums each
    rank's cotangent of the whole over the ranks and keeps this rank's
    block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group, ctx.rows = group, x.shape[0]
        ctx.rank = dist.get_rank(group)
        return _gather_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        total = _sum_all(grad, ctx.group)
        return total[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def halo_pull(own: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """Fresh halo rows [H, ...] from their owners (dgn_tpu/graph.py:64-85):
    the rows each rank references, gathered per rank ([P, S, ...]), one
    all-to-all, then routed into the halo slots by recv_perm.  Without an
    exchange plan, an all-gather of every rank's own rows.  Differentiable:
    the gradient of a halo row flows back to its owner's row."""
    import torch.distributed as dist
    group = spec.group
    if spec.send_idx is None:
        p = dist.get_world_size(group)
        allh = _AllGather.apply(own.contiguous(), group)
        allh = allh.reshape((p, spec.n_local) + tuple(own.shape[1:]))
        return allh[spec.halo_shard.long(), spec.halo_local.long()]
    send = own.index_select(0, spec.send_idx.reshape(-1).long())
    recv = _AllToAll.apply(send, group)
    return recv.index_select(0, spec.recv_perm.long())


def halo_refresh(h: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """h with its halo rows fetched anew: [own | fresh halo]."""
    own = h[:spec.n_local]
    return torch.cat([own, halo_pull(own, spec)], dim=0)


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
    # edge-partitioned execution: this rank's halo (parallel/halo.py)
    halo: Optional[HaloSpec] = None

    @property
    def num_nodes_padded(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def num_graphs_padded(self) -> int:
        return self.graph_mask.shape[0]

    def real_edge_count(self) -> torch.Tensor:
        return self.edge_mask.sum(dtype=torch.int32)

    def real_node_count(self) -> torch.Tensor:
        return self.node_mask.sum(dtype=torch.int32)

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
                native: Optional[bool] = None,
                n_pairs_pad: Optional[int] = None) -> GraphBatch:
    """Pack graphs into one fixed-shape GraphBatch on the CPU, under the
    block layout when mxu_layout, else flat (dgn_tpu/graph.py:178-332).
    Flat pads default to the exact totals (no pad node, no pad edge).

    native: pack with the C++ packer (runtime/): the flat layout's edges,
    or the whole block-layout batch; None uses it when it is built, True
    requires it (RuntimeError without it), False packs with numpy.  Both
    give the same arrays.  A block batch counts `pack.native` or
    `pack.numpy` by the path that packed it."""
    if native is None:
        from .runtime import available
        native = available()
    with observe.span("pack.arrays"):
        if mxu_layout:
            pack = _pack_graphs_mxu_native if native else _pack_graphs_mxu
            gb = pack(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                      k_eig=k_eig, n_pairs_pad=n_pairs_pad)
            observe.count("pack.native" if native else "pack.numpy")
            return gb
        pack = _pack_graphs_native if native else _pack_graphs_flat
        return pack(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                    k_eig=k_eig)


def _tensors(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _pack_graphs_flat(graphs: Sequence[GraphData], *, n_pad: Optional[int],
                      e_pad: Optional[int], g_pad: Optional[int],
                      k_eig: Optional[int]) -> GraphBatch:
    """pack_graphs under the flat layout: graphs back to back, snorm_n and
    snorm_e per graph, real edges stable-sorted by (dst, src) with the pad
    edges after them at src = dst = n_pad - 1, in_degree over real edges."""
    g = len(graphs)
    tot_n = sum(gr.num_nodes for gr in graphs)
    tot_e = sum(gr.num_edges for gr in graphs)
    n_pad = int(n_pad if n_pad is not None else tot_n)
    e_pad = int(e_pad if e_pad is not None else max(tot_e, 1))
    g_pad = int(g_pad if g_pad is not None else g)
    if tot_n > n_pad or tot_e > e_pad or g > g_pad:
        raise ValueError(
            f"pack overflow: need (n={tot_n}, e={tot_e}, g={g}) "
            f"but pad sizes are (n={n_pad}, e={e_pad}, g={g_pad})")
    if k_eig is None:
        k_eig = (graphs[0].eig.shape[1]
                 if graphs and graphs[0].eig is not None else 0)

    nf0 = graphs[0].node_feat
    nf_dtype = nf0.dtype if nf0.dtype.kind == "f" else np.int32
    node_feat = np.zeros((n_pad,) + tuple(nf0.shape[1:]), dtype=nf_dtype)
    node_mask = np.zeros((n_pad,), dtype=bool)
    node_graph = np.full((n_pad,), max(g_pad - 1, 0), dtype=np.int32)
    eig = np.zeros((n_pad, k_eig), dtype=np.float32)
    snorm_n = np.zeros((n_pad, 1), dtype=np.float32)
    src = np.zeros((e_pad,), dtype=np.int32)
    dst = np.zeros((e_pad,), dtype=np.int32)
    edge_mask = np.zeros((e_pad,), dtype=bool)
    snorm_e = np.zeros((e_pad, 1), dtype=np.float32)
    has_ef = graphs[0].edge_feat is not None
    edge_feat = None
    if has_ef:
        ef0 = graphs[0].edge_feat
        ef_dtype = ef0.dtype if ef0.dtype.kind == "f" else np.int32
        edge_feat = np.zeros((e_pad,) + tuple(ef0.shape[1:]), dtype=ef_dtype)
    graph_mask = np.zeros((g_pad,), dtype=bool)
    n_nodes = np.zeros((g_pad,), dtype=np.int32)
    n_edges = np.zeros((g_pad,), dtype=np.int32)
    has_label = graphs[0].label is not None
    labels = None
    if has_label:
        lb0 = np.asarray(graphs[0].label)
        labels = np.zeros((g_pad,) + lb0.shape, dtype=(
            np.float32 if lb0.dtype.kind == "f" else lb0.dtype))
    has_nl = graphs[0].node_labels is not None
    node_labels = np.zeros((n_pad,), dtype=np.int32) if has_nl else None
    has_pe = graphs[0].pos_enc is not None
    pos_enc = (np.zeros((n_pad, graphs[0].pos_enc.shape[1]), np.float32)
               if has_pe else None)

    n_off = e_off = 0
    for gi, gr in enumerate(graphs):
        n, e = gr.num_nodes, gr.num_edges
        sl_n = slice(n_off, n_off + n)
        sl_e = slice(e_off, e_off + e)
        node_feat[sl_n] = gr.node_feat
        node_mask[sl_n] = True
        node_graph[sl_n] = gi
        if k_eig and gr.eig is not None:
            eig[sl_n, : gr.eig.shape[1]] = gr.eig[:, :k_eig]
        snorm_n[sl_n] = np.sqrt(1.0 / max(n, 1))
        src[sl_e] = np.asarray(gr.src, dtype=np.int32) + n_off
        dst[sl_e] = np.asarray(gr.dst, dtype=np.int32) + n_off
        edge_mask[sl_e] = True
        snorm_e[sl_e] = np.sqrt(1.0 / max(e, 1))
        if has_ef:
            edge_feat[sl_e] = gr.edge_feat
        graph_mask[gi] = True
        n_nodes[gi] = n
        n_edges[gi] = e
        if has_label:
            labels[gi] = np.asarray(gr.label)
        if has_nl:
            node_labels[sl_n] = gr.node_labels
        if has_pe:
            pos_enc[sl_n] = gr.pos_enc
        n_off += n
        e_off += e

    # real edges by (dst, src), stable; the pad edges (mask False) after
    # them, pointing at the last node so the dst sequence stays monotone
    order = np.lexsort((src, dst, ~edge_mask))
    src, dst, edge_mask, snorm_e = (src[order], dst[order], edge_mask[order],
                                    snorm_e[order])
    if has_ef:
        edge_feat = edge_feat[order]
    src[~edge_mask] = n_pad - 1
    dst[~edge_mask] = n_pad - 1

    in_degree = np.zeros((n_pad,), dtype=np.int32)
    np.add.at(in_degree, dst[edge_mask], 1)

    t = _tensors
    return GraphBatch(
        node_feat=t(node_feat), node_mask=t(node_mask),
        node_graph=t(node_graph), eig=t(eig), in_degree=t(in_degree),
        snorm_n=t(snorm_n), src=t(src), dst=t(dst), edge_mask=t(edge_mask),
        edge_feat=t(edge_feat), snorm_e=t(snorm_e), graph_mask=t(graph_mask),
        n_nodes=t(n_nodes), n_edges=t(n_edges), labels=t(labels),
        node_labels=t(node_labels), pos_enc=t(pos_enc))


def _pack_graphs_native(graphs: Sequence[GraphData], *,
                        n_pad: Optional[int], e_pad: Optional[int],
                        g_pad: Optional[int],
                        k_eig: Optional[int]) -> GraphBatch:
    """_pack_graphs_flat with the edge pipeline in C++ (runtime/packer.cpp:
    offsets, the (dst, src) counting sort, masks, normalisers, in-degrees
    in one pass); the features are concatenated, and the edge features
    follow the packer's permutation with one gather."""
    from .runtime import pack_edges

    g = len(graphs)
    n_nodes = np.array([gr.num_nodes for gr in graphs], np.int32)
    n_edges = np.array([gr.num_edges for gr in graphs], np.int32)
    tot_n, tot_e = int(n_nodes.sum()), int(n_edges.sum())
    n_pad = int(n_pad if n_pad is not None else tot_n)
    e_pad = int(e_pad if e_pad is not None else max(tot_e, 1))
    g_pad = int(g_pad if g_pad is not None else g)
    if tot_n > n_pad or tot_e > e_pad or g > g_pad:
        raise ValueError(
            f"pack overflow: need (n={tot_n}, e={tot_e}, g={g}) "
            f"but pad sizes are (n={n_pad}, e={e_pad}, g={g_pad})")
    if k_eig is None:
        k_eig = (graphs[0].eig.shape[1]
                 if graphs and graphs[0].eig is not None else 0)

    def cat(arrays, dtype=None):
        return np.concatenate([np.asarray(a, dtype) for a in arrays])

    ed = pack_edges(n_nodes, n_edges, cat([gr.src for gr in graphs], np.int32),
                    cat([gr.dst for gr in graphs], np.int32),
                    n_pad, e_pad, g_pad)
    # pad edges at the last node, as the numpy path puts them
    pad = ~ed["edge_mask"]
    ed["src"][pad] = n_pad - 1
    ed["dst"][pad] = n_pad - 1

    def node_array(field, width, dtype):
        out = np.zeros((n_pad,) + width, dtype)
        out[:tot_n] = cat([getattr(gr, field) for gr in graphs])
        return out

    nf0 = graphs[0].node_feat
    node_feat = node_array("node_feat", tuple(nf0.shape[1:]),
                           nf0.dtype if nf0.dtype.kind == "f" else np.int32)
    eig = np.zeros((n_pad, k_eig), np.float32)
    if k_eig:
        off = 0
        for gr in graphs:
            if gr.eig is not None:
                eig[off:off + gr.num_nodes, :gr.eig.shape[1]] = \
                    gr.eig[:, :k_eig]
            off += gr.num_nodes
    edge_feat = None
    ef0 = graphs[0].edge_feat
    if ef0 is not None:
        edge_feat = np.zeros((e_pad,) + tuple(ef0.shape[1:]),
                             ef0.dtype if ef0.dtype.kind == "f" else np.int32)
        real = ed["perm"] >= 0
        if tot_e:
            edge_feat[real] = cat([gr.edge_feat for gr in graphs])[
                ed["perm"][real]]
    graph_mask = np.zeros((g_pad,), bool)
    graph_mask[:g] = True
    nn_ = np.zeros((g_pad,), np.int32)
    nn_[:g] = n_nodes
    ne_ = np.zeros((g_pad,), np.int32)
    ne_[:g] = n_edges
    labels = None
    if graphs[0].label is not None:
        lb0 = np.asarray(graphs[0].label)
        labels = np.zeros((g_pad,) + lb0.shape, dtype=(
            np.float32 if lb0.dtype.kind == "f" else lb0.dtype))
        labels[:g] = np.stack([np.asarray(gr.label) for gr in graphs])
    node_labels = (node_array("node_labels", (), np.int32)
                   if graphs[0].node_labels is not None else None)
    pos_enc = (node_array("pos_enc", (graphs[0].pos_enc.shape[1],),
                          np.float32)
               if graphs[0].pos_enc is not None else None)

    t = _tensors
    return GraphBatch(
        node_feat=t(node_feat), node_mask=t(ed["node_mask"]),
        node_graph=t(ed["node_graph"]), eig=t(eig),
        in_degree=t(ed["in_degree"]), snorm_n=t(ed["snorm_n"]),
        src=t(ed["src"]), dst=t(ed["dst"]), edge_mask=t(ed["edge_mask"]),
        edge_feat=t(edge_feat), snorm_e=t(ed["snorm_e"]),
        graph_mask=t(graph_mask), n_nodes=t(nn_), n_edges=t(ne_),
        labels=t(labels), node_labels=t(node_labels), pos_enc=t(pos_enc))


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


def bucket_sizes_for(graphs: Sequence[GraphData], batch_size: int, *,
                     node_multiple: int = 128,
                     edge_multiple: int = 128) -> tuple[int, int]:
    """(n_pad, e_pad) so ANY batch_size subset packs flat: the sums of the
    batch_size largest graphs, the node count plus one for the ghost node
    that pad edges point at, rounded up to the multiples."""
    ns = np.sort(np.array([g.num_nodes for g in graphs]))[::-1]
    es = np.sort(np.array([g.num_edges for g in graphs]))[::-1]
    cn = int(ns[:batch_size].sum())
    ce = int(max(es[:batch_size].sum(), 1))
    return round_up(cn + 1, node_multiple), round_up(ce, edge_multiple)


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
        ef0 = np.asarray(graphs[0].edge_feat)
        ef_cat = np.concatenate([np.asarray(gr.edge_feat) for gr in graphs]) \
            if tot_e else np.zeros((0,) + ef0.shape[1:], ef0.dtype)
        ef_dtype = ef_cat.dtype if ef_cat.dtype.kind == "f" else np.int32
        edge_feat = np.zeros((e_pad,) + tuple(ef_cat.shape[1:]), dtype=ef_dtype)
        edge_feat[real] = ef_cat[order[edge_valid]]

    in_degree = np.zeros((n_pad,), dtype=np.int32)
    np.add.at(in_degree, dst[edge_mask], 1)

    with observe.span("pack.block_layout"):
        layout = build_mxu_layout(src, dst, edge_mask, node_graph, node_mask,
                                  n_pad, g_pad, n_pairs_pad=n_pairs_pad)

    t = _tensors
    return GraphBatch(
        node_feat=t(node_feat), node_mask=t(node_mask),
        node_graph=t(node_graph), eig=t(eig), in_degree=t(in_degree),
        snorm_n=t(snorm_n), src=t(src), dst=t(dst), edge_mask=t(edge_mask),
        edge_feat=t(edge_feat), snorm_e=t(snorm_e), graph_mask=t(graph_mask),
        n_nodes=t(n_nodes), n_edges=t(n_edges), labels=t(labels),
        node_labels=t(node_labels), pos_enc=t(pos_enc), mxu=layout)


def _eig_rows(gr: GraphData, k_eig: int) -> np.ndarray:
    """gr's eigenvector rows cut or padded with zeros to k_eig columns."""
    e = (np.zeros((gr.num_nodes, 0), np.float32) if gr.eig is None
         else gr.eig[:, :k_eig])
    return np.pad(e, ((0, 0), (0, k_eig - e.shape[1])))


# fields whose dtype and shape past the first axis (a label's whole shape)
# a GraphTable over a dataset requires to agree between its graphs
_TABLE_FIELDS = ("node_feat", "eig", "edge_feat", "label", "node_labels",
                 "pos_enc")


def _gather_rows(out: np.ndarray, at: np.ndarray, table: np.ndarray,
                 rows: np.ndarray) -> None:
    """out[at] = table[rows], each row of several values moved as one
    opaque item where the dtypes agree (several times faster than numpy's
    row-wise fancy indexing)."""
    width = table.itemsize * math.prod(table.shape[1:])
    if table.ndim > 1 and table.dtype == out.dtype and width:
        item = np.dtype((np.void, width))
        out = out.reshape(len(out), -1).view(item).reshape(-1)
        table = table.reshape(len(table), -1).view(item).reshape(-1)
    out[at] = table[rows]


class GraphTable:
    """Graphs with each field concatenated once, so that a block-layout
    batch of them packs in one native call (runtime/packer.cpp
    dgn_pack_block reads each graph's edges from its first row) with its
    features following by row index, and no per-graph Python.
    pack_graphs builds one over a batch; a loader keeps one over its
    dataset (`over`) and hands pack_graphs `GraphRows` of it.  The arrays
    follow the first graph as _pack_graphs_mxu's follow the batch's first
    graph: the node and edge features keep a float dtype and take int32
    otherwise, eig is cut or padded to k_eig columns."""

    def __init__(self, graphs: Sequence[GraphData],
                 k_eig: Optional[int] = None):
        g0 = graphs[0]
        self.graphs = graphs
        self.k_eig = (k_eig if k_eig is not None
                      else g0.eig.shape[1] if g0.eig is not None else 0)
        self.n_nodes = np.array([gr.num_nodes for gr in graphs], np.int32)
        self.n_edges = np.array([len(gr.src) for gr in graphs], np.int32)
        self.node_first = np.zeros(len(graphs), np.int64)
        self.edge_first = np.zeros(len(graphs), np.int64)
        np.cumsum(self.n_nodes[:-1], out=self.node_first[1:])
        np.cumsum(self.n_edges[:-1], out=self.edge_first[1:])
        self.src = np.concatenate([gr.src for gr in graphs], dtype=np.int32)
        self.dst = np.concatenate([gr.dst for gr in graphs], dtype=np.int32)

        def cat(field):
            if getattr(g0, field) is None:
                return None
            return np.ascontiguousarray(
                np.concatenate([getattr(gr, field) for gr in graphs]))

        self.node_feat = cat("node_feat")
        nf0 = np.asarray(g0.node_feat)
        self.node_feat_dtype = nf0.dtype if nf0.dtype.kind == "f" else np.int32
        self.eig = None
        if self.k_eig:
            rows = [gr.eig for gr in graphs]
            if not all(e is not None and e.shape[1] == self.k_eig
                       for e in rows):
                rows = [_eig_rows(gr, self.k_eig) for gr in graphs]
            self.eig = np.ascontiguousarray(np.concatenate(rows))
        self.node_labels = cat("node_labels")
        self.pos_enc = cat("pos_enc")
        self.edge_feat = None
        if g0.edge_feat is not None:
            ef0 = np.asarray(g0.edge_feat)
            self.edge_feat = (cat("edge_feat") if self.n_edges.sum()
                              else np.zeros((0,) + ef0.shape[1:], ef0.dtype))
        self.labels = None
        if g0.label is not None:
            self.labels = np.array([gr.label for gr in graphs])
            lb0 = np.asarray(g0.label)
            self.label_dtype = np.float32 if lb0.dtype.kind == "f" else lb0.dtype

    @classmethod
    def over(cls, graphs: Sequence[GraphData]) -> Optional["GraphTable"]:
        """A table over a dataset's graphs, or None where a field's
        presence, dtype or trailing shape differs between them (a batch's
        arrays follow its own first graph, which one table cannot)."""
        def kind(gr):
            out = []
            for f in _TABLE_FIELDS:
                a = getattr(gr, f)
                a = None if a is None else np.asarray(a)
                out.append(None if a is None else (
                    a.dtype, a.shape if f == "label" else a.shape[1:]))
            return tuple(out)

        if not graphs or len({kind(gr) for gr in graphs}) != 1:
            return None
        return cls(graphs)

    def rows(self, ids) -> "GraphRows":
        return GraphRows(self, np.asarray(ids, np.int64))

    def pack(self, ids: np.ndarray, *, n_pad: Optional[int],
             e_pad: Optional[int], g_pad: Optional[int],
             n_pairs_pad: Optional[int] = None) -> GraphBatch:
        """The graphs ids, in that order, packed under the block layout:
        _pack_graphs_mxu's arrays, bit for bit."""
        from .ops.mxu import MXULayout
        from .runtime import pack_block

        g = len(ids)
        g_pad = round_up(int(g_pad if g_pad is not None else g), _TILE)
        if n_pad is not None and int(n_pad) % _TILE:
            raise ValueError(f"mxu n_pad must be a multiple of {_TILE}")
        if e_pad is not None and int(e_pad) % _TILE:
            raise ValueError(f"mxu e_pad must be a multiple of {_TILE}")
        n_nodes, n_edges = self.n_nodes[ids], self.n_edges[ids]
        pb = pack_block(n_nodes, n_edges, self.node_first[ids],
                        self.edge_first[ids], self.src, self.dst,
                        n_pad, e_pad, g_pad, n_pairs_pad)
        n_pad, e_pad = pb["n_pad"], pb["e_pad"]
        slot, row = pb["node_slot"], pb["node_row"]

        def nodes(table, dtype):
            if table is None:
                return None
            out = np.zeros((n_pad,) + table.shape[1:], dtype)
            _gather_rows(out, slot, table, row)
            return out

        edge_feat = None
        if self.edge_feat is not None:
            ef = self.edge_feat
            edge_feat = np.zeros((e_pad,) + ef.shape[1:],
                                 ef.dtype if ef.dtype.kind == "f" else np.int32)
            real = pb["edge_mask"]
            edge_feat[real] = ef[pb["perm"][real]]
        graph_mask = np.zeros((g_pad,), bool)
        graph_mask[:g] = True
        nn_ = np.zeros((g_pad,), np.int32)
        nn_[:g] = n_nodes
        ne_ = np.zeros((g_pad,), np.int32)
        ne_[:g] = n_edges
        labels = None
        if self.labels is not None:
            labels = np.zeros((g_pad,) + self.labels.shape[1:],
                              self.label_dtype)
            labels[:g] = self.labels[ids]

        t = torch.from_numpy
        layout = MXULayout(
            local_src=t(pb["local_src"]), local_dst=t(pb["local_dst"]),
            edge_chunk_src=t(pb["edge_chunk_src"]),
            edge_chunk_dst=t(pb["edge_chunk_dst"]),
            local_graph=t(pb["local_graph"]),
            node_chunk_graph=t(pb["node_chunk_graph"]),
            n_node_blocks=n_pad // _TILE, n_graph_blocks=g_pad // _TILE,
            chunk_pair=t(pb["chunk_pair"]), pair_src=t(pb["pair_src"]),
            pair_dst=t(pb["pair_dst"]), n_pairs=pb["n_pairs"],
            pair_chunk_order=t(pb["pair_chunk_order"]),
            pair_sorted_ids=t(pb["pair_sorted_ids"]),
            pair_covered=t(pb["pair_covered"]),
            pair_real_chunk_order=t(pb["pair_real_chunk_order"]),
            pair_chunk_start=t(pb["pair_chunk_start"]))
        tt = _tensors
        return GraphBatch(
            node_feat=tt(nodes(self.node_feat, self.node_feat_dtype)),
            node_mask=t(pb["node_mask"]), node_graph=t(pb["node_graph"]),
            eig=tt(nodes(self.eig, np.float32) if self.k_eig
                   else np.zeros((n_pad, 0), np.float32)),
            in_degree=t(pb["in_degree"]), snorm_n=t(pb["snorm_n"]),
            src=t(pb["src"]), dst=t(pb["dst"]), edge_mask=t(pb["edge_mask"]),
            edge_feat=tt(edge_feat), snorm_e=t(pb["snorm_e"]),
            graph_mask=t(graph_mask), n_nodes=t(nn_), n_edges=t(ne_),
            labels=tt(labels),
            node_labels=tt(nodes(self.node_labels, np.int32)),
            pos_enc=tt(nodes(self.pos_enc, np.float32)), mxu=layout)


class GraphRows(abc.Sequence):
    """Graphs of a GraphTable by index: the sequence of their GraphData,
    which pack_graphs packs from the table."""

    def __init__(self, table: GraphTable, ids: np.ndarray):
        self.table, self.ids = table, ids

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return GraphRows(self.table, self.ids[i])
        return self.table.graphs[self.ids[i]]

    def by_size(self) -> "GraphRows":
        """Descending node count, ties in their order (as sorted())."""
        return GraphRows(self.table, self.ids[np.argsort(
            -self.table.n_nodes[self.ids], kind="stable")])


def _pack_graphs_mxu_native(graphs: Sequence[GraphData], *,
                            n_pad: Optional[int], e_pad: Optional[int],
                            g_pad: Optional[int], k_eig: Optional[int],
                            n_pairs_pad: Optional[int] = None) -> GraphBatch:
    """_pack_graphs_mxu in one C++ call (runtime/packer.cpp
    dgn_pack_block: the placement, the edge arrangement, the node and edge
    arrays and every block-layout array), from the table that GraphRows
    carry, or from one built over the batch (each field concatenated
    once)."""
    if not (isinstance(graphs, GraphRows)
            and k_eig in (None, graphs.table.k_eig)):
        graphs = GraphTable(graphs, k_eig).rows(np.arange(len(graphs)))
    return graphs.table.pack(graphs.ids, n_pad=n_pad, e_pad=e_pad,
                             g_pad=g_pad, n_pairs_pad=n_pairs_pad)


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


def pack_requirements(batch: Sequence[GraphData],
                      mxu_layout: bool = False) -> tuple[int, int]:
    """EXACT (n_used, e_used) slots pack_graphs needs for this batch: flat,
    the totals (nodes plus the ghost node); block, the placement of the
    batch packed in descending num_nodes order (the loader's order)."""
    if not mxu_layout:
        tot_n = sum(g.num_nodes for g in batch)
        return tot_n + 1, max(sum(g.num_edges for g in batch), 1)
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
                         mxu_layout: bool = False, probe_epochs: int = 4,
                         slack: float = 1.10, seed: int = 0,
                         multiple: int = 128) -> tuple[int, int]:
    """(n_pad, e_pad) sized for TYPICAL shuffled batches of the layout: the
    max exact requirement over `probe_epochs` simulated shuffles, plus
    slack, capped by the layout's worst-case bound.  A batch that still
    overflows makes pack_graphs raise and the loader repacks it
    (data/loader.py)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(len(graphs))
    need_n = need_e = 1
    for _ in range(probe_epochs):
        rng.shuffle(idx)
        for i in range(0, len(idx), batch_size):
            n_used, e_used = pack_requirements(
                [graphs[j] for j in idx[i:i + batch_size]], mxu_layout)
            need_n = max(need_n, n_used)
            need_e = max(need_e, e_used)
    n_pad = round_up(int(need_n * slack) + 1, multiple)
    e_pad = round_up(int(need_e * slack), multiple)
    worst = (mxu_bucket_sizes(graphs, batch_size) if mxu_layout
             else bucket_sizes_for(graphs, batch_size))
    return min(n_pad, worst[0]), min(e_pad, worst[1])
