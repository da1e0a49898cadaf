"""The DGN layers and the virtual node (counterpart of `dgn_tpu/layers/dgn.py`:
DGNLayerSimple, DGNLayerComplex, DGNTower, DGNLayerTower, VirtualNode,
make_dgn_layer).

Each layer takes one of two edge stages, as dgn_tpu decides it: the
decomposed one when the EdgeContext the model attaches carries weight
families (ctx.decomposed) and the pretrans is linear, else the per-edge
message path.  A layer used on its own, on a batch without a context,
builds one as dgn_tpu's does (`_edge_context`): decomposed for the simple
layer and a linear pretrans, else per-edge with the flat layout's
normalizers.  Both stages run on the block layout (gb.mxu) and on the flat
one (gb.mxu None); the aggregators pick their reductions from the layout.

Decomposed.  Complex: with a linear pretrans over [h_src || h_dst (|| e)]
the per-edge message splits as msg_e = g[src_e] + q[dst_e] (+ c_e) with
g = h @ W1, q = h @ W2 + b and c = e @ W3.  Simple: no pretrans, the
message is h[src], so g = h and q = 0.  The aggregators run on that form
(ops/aggregators.aggregate_decomposed).

Per-edge.  Simple: msg = h[src].  Complex and tower: the pretrans
(LinearParams when pretrans_layers = 1, else an MLP of pretrans_layers
FCLayers at width in_dim) on [h[src] || h[dst] (|| e)] over every padded
edge; pad edges' messages reach no reduction (ops/aggregators.aggregate).
A complex layer or tower with pretrans_layers > 1 always takes this path.

Both paths then run the same posttrans on the unscaled aggregate.  A
linear posttrans (posttrans_layers = 1) over [h_in || scaled copies of the
aggregate] (complex) or over the scaled copies alone (simple) is applied
without materialising the concat (_fused_posttrans); a deeper one is
apply_scalers -> (concat h_in, complex) -> MLP.  On the per-edge path
dgn_tpu runs apply_scalers -> concat -> MLP(layers=1), whose parameters are
LinearParams'; this port keeps _fused_posttrans there, which agrees with it
to rounding.

Layer order: posttrans -> graph norm (h * snorm_n) -> masked BatchNorm ->
ReLU -> residual -> dropout.  A tower is a complex layer without the ReLU
and the residual.  The towers layer runs `towers` of them, each on its own
slice of the input (divide_input) or on all of it and each on the whole
edge embedding, concatenates their outputs, mixes them with a LeakyReLU
FCLayer and adds the residual.  Parity quirks kept on purpose: scalers
apply only when len(scalers) > 1 (reference nets/dgn_layer.py:95-96), the
residual only when in_dim == out_dim (:76-77), the mixing layer only when
towers > 1 (:313-316), and the simple layer ignores edge features.  Every
layer reads the one EdgeContext the model attaches to the batch, so one
adjacency build serves every tower of every layer.

The virtual node (reference nets/dgn_layer.py:12-49) pools each graph's
nodes (mean, sum or logsum), adds the graph's state vn_h, runs an FCLayer
(ReLU, dropout, masked BatchNorm over the real graphs), adds the residual to
vn_h and the new vn_h to every node of its graph.  On the block layout it
pools with `mxu.graph_pool_sum` and broadcasts to the real nodes; on the
flat one it pools with a masked segment_sum over node_graph and gathers
vn_h[node_graph] for every node slot, as dgn_tpu does.

compute_dtype (a torch dtype or None; the model resolves its config's
string) goes to every layer and tower: on the block layout their edge
stage rounds as dgn_tpu's does (ops/mxu.py, ops/aggregators.py), the
per-edge path's gathers of h at src and dst included.  The flat layout,
the pretrans and posttrans and the virtual node stay float32.

bn_axis (the config's, "dp" under data parallelism, "ep" under edge
parallelism) makes every layer's and tower's batch norm and the virtual
node's a sync batch norm over the ranks of the mesh bound to the model
(nn.MaskedBatchNorm, nn.bind_mesh), as dgn_tpu/layers/dgn.py:173-489
threads it.

Edge-partitioned batches (gb.halo set, parallel/halo.py): on the block
layout with the interior/boundary pair split (ep_fused_layout), a
decomposed layer or tower pulls its own halo (graph.halo_pull) inside the
edge stage: the simple layer hands (own, halo) rows to the aggregators,
the complex layer and each tower (g_own, g_halo) = (own @ W1, halo @ W1)
with q on the own rows and 0 on the halo rows (_ep_pretrans_parts), so
the interior pair products read nothing of the exchange.  Otherwise the
model refreshes the halo before each layer (models/dgn_net.py).  The
virtual node sums its per-graph pools over the ranks.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .. import nn as tnn
from ..graph import GraphBatch, halo_pull
from ..nn import MLP, FCLayer, LinearParams, MaskedBatchNorm, dropout
from ..ops import aggregators as agg_ops
from ..ops import mxu
from ..ops import scalers as scaler_ops
from ..ops.segment import gather, segment_sum


def _linear_pretrans_parts(kernel, bias, h, e):
    """(g_node = h @ W1, q_node = h @ W2 + b, c_edge = e @ W3 or None) such
    that the linear pretrans of [h_src || h_dst (|| e)] is
    g_node[src] + q_node[dst] (+ c_edge)."""
    f = h.shape[-1]
    c_edge = None if e is None else e @ kernel[2 * f:]
    return h @ kernel[:f], h @ kernel[f:2 * f] + bias, c_edge


def ep_fused_layout(gb: GraphBatch) -> bool:
    """Whether gb is an edge-partitioned rank's block layout with the
    interior/boundary pair split: a decomposed layer then pulls its own
    halo, and the model must not refresh it (dgn_tpu/layers/dgn.py:96-103)."""
    return (gb.halo is not None and gb.mxu is not None
            and gb.mxu.n_pairs_int is not None)


def _ep_pretrans_parts(gb: GraphBatch, kernel, bias, h, e):
    """_linear_pretrans_parts on an edge-partitioned rank
    (dgn_tpu/layers/dgn.py:106-122): g as (own @ W1, fresh halo @ W1), q
    on the own rows and 0 on the halo rows (theirs are never read)."""
    f = h.shape[-1]
    own = h[:gb.halo.n_local]
    g_node = (own @ kernel[:f], halo_pull(own, gb.halo) @ kernel[:f])
    q_own = own @ kernel[f:2 * f] + bias
    q_node = torch.cat([q_own, q_own.new_zeros(
        (h.shape[0] - own.shape[0], q_own.shape[-1]))])
    c_edge = None if e is None else e @ kernel[2 * f:]
    return g_node, q_node, c_edge


def _fused_posttrans(kernel, bias, h_in, h_agg, gb: GraphBatch,
                     scaler_names: Sequence[str], avg_d: Dict[str, float]):
    """Linear posttrans over concat([h_in?, scaler-scaled copies of h_agg])
    without the concats: scalers are per-node scalars, so
    (s * x) @ W == s * (x @ W).  h_in is None for the simple layer (no input
    concat, reference nets/dgn_layer.py:146-148)."""
    f_in = 0 if h_in is None else h_in.shape[-1]
    out = bias if h_in is None else h_in @ kernel[:f_in] + bias
    w_agg = h_agg.shape[-1]
    s = len(scaler_names)
    if s <= 1:      # reference quirk: a single scaler means no scaling
        return out + h_agg @ kernel[f_in:f_in + w_agg]
    blocks = torch.cat(
        [kernel[f_in + i * w_agg: f_in + (i + 1) * w_agg] for i in range(s)],
        dim=1)                                    # [w_agg, S*out]
    t = h_agg @ blocks
    cols = scaler_ops.scaler_columns(scaler_names, gb.in_degree, avg_d,
                                     dtype=t.dtype)
    o = kernel.shape[-1]
    for i in range(s):
        out = out + cols[:, i:i + 1] * t[:, i * o:(i + 1) * o]
    return out


def _edge_context(gb: GraphBatch, names, decomposed: bool,
                  compute_dtype: Optional[torch.dtype]):
    """The EdgeContext the model attached, else one for this layer alone
    (dgn_tpu/layers/dgn.py:47-79): decomposed, with its blocks in
    compute_dtype, or per-edge with the flat layout's normalizers."""
    if gb.edge_ctx is not None:
        return gb.edge_ctx
    return agg_ops.build_edge_context(
        gb.eig, gb.src, gb.dst, gb.edge_mask, gb.in_degree, names,
        mxu_layout=gb.mxu, decomposed=decomposed, adj_dtype=compute_dtype,
        need_norms=gb.mxu is None and not decomposed)


class _DGNLayer(nn.Module):
    """What the simple and complex layers and the tower share: the
    aggregator and scaler setup, the posttrans, and the tail graph norm ->
    masked BN -> (ReLU -> residual) -> dropout."""

    relu = True

    def __init__(self, in_dim: int, out_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], avg_d: Dict[str, float],
                 generator: torch.Generator, dropout: float,
                 graph_norm: bool, batch_norm: bool, residual: bool,
                 posttrans_layers: int, input_concat: bool,
                 compute_dtype: Optional[torch.dtype],
                 bn_axis: Optional[str] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.aggregators = tuple(agg_ops.parse_names(aggregators))
        self.scalers = tuple(scalers)
        self.avg_d = avg_d
        self.dropout = dropout
        self.graph_norm = graph_norm
        self.residual = residual and in_dim == out_dim
        n_scal = len(self.scalers) if len(self.scalers) > 1 else 1
        width = (in_dim if input_concat else 0) \
            + len(self.aggregators) * in_dim * n_scal
        self.posttrans_layers = posttrans_layers
        self.posttrans = (
            LinearParams(width, out_dim, generator) if posttrans_layers == 1
            else MLP(width, out_dim, out_dim, posttrans_layers, generator))
        self.batchnorm_h = (MaskedBatchNorm(out_dim, axis_name=bn_axis)
                            if batch_norm else None)

    def _gather(self, gb: GraphBatch, h: torch.Tensor,
                index: torch.Tensor) -> torch.Tensor:
        """h[index], rounded as compute_dtype asks on the block layout."""
        return mxu.gather(h, index,
                          self.compute_dtype if gb.mxu is not None else None)

    def _posttrans(self, gb: GraphBatch, h_in: Optional[torch.Tensor],
                   agg: torch.Tensor) -> torch.Tensor:
        """h_in None: no input concat (the simple layer)."""
        if self.posttrans_layers == 1:
            return _fused_posttrans(self.posttrans.kernel, self.posttrans.bias,
                                    h_in, agg, gb, self.scalers, self.avg_d)
        if len(self.scalers) > 1:
            agg = scaler_ops.apply_scalers(self.scalers, agg, gb.in_degree,
                                           self.avg_d)
        x = agg if h_in is None else torch.cat([h_in, agg], dim=-1)
        return self.posttrans(x)

    def _tail(self, gb: GraphBatch, h_in: torch.Tensor, h: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.graph_norm:
            h = h * gb.snorm_n
        if self.batchnorm_h is not None:
            h = self.batchnorm_h(h, gb.node_mask)
        if self.relu:
            h = torch.relu(h)
        if self.residual:
            h = h_in + h
        return dropout(h, self.dropout, self.training, generator)


class DGNLayerSimple(_DGNLayer):
    """No pretrans, the message is h[src]; posttrans over the aggregate
    alone (reference nets/dgn_layer.py:135-202): decomposed with g = h and
    q = 0, or per-edge on msg = h[src].  Edge features are ignored."""

    def __init__(self, in_dim: int, out_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], avg_d: Dict[str, float],
                 generator: torch.Generator, dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 residual: bool = True, posttrans_layers: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 bn_axis: Optional[str] = None):
        super().__init__(in_dim, out_dim, aggregators, scalers, avg_d,
                         generator, dropout, graph_norm, batch_norm, residual,
                         posttrans_layers, input_concat=False,
                         compute_dtype=compute_dtype, bn_axis=bn_axis)

    def forward(self, gb: GraphBatch, h: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                e: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = _edge_context(gb, self.aggregators, True, self.compute_dtype)
        if ctx.decomposed:
            g_in = h
            if ep_fused_layout(gb):
                own = h[:gb.halo.n_local]
                g_in = (own, halo_pull(own, gb.halo))
            agg = agg_ops.aggregate_decomposed(
                self.aggregators, ctx, g_in, None, h, layout=gb.mxu,
                compute_dtype=self.compute_dtype)
        else:
            agg = agg_ops.aggregate(self.aggregators, ctx,
                                    self._gather(gb, h, ctx.src), h,
                                    layout=gb.mxu,
                                    compute_dtype=self.compute_dtype)
        return self._tail(gb, h, self._posttrans(gb, None, agg), generator)


class DGNLayerComplex(_DGNLayer):
    """Pretrans on [h_src || h_dst (|| e)], input-concat posttrans
    (reference nets/dgn_layer.py:52-132).  edge_dim is the width of the
    edge embedding e, 0 without edge features."""

    def __init__(self, in_dim: int, out_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], avg_d: Dict[str, float],
                 generator: torch.Generator, dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 residual: bool = True, posttrans_layers: int = 1,
                 edge_dim: int = 0, pretrans_layers: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 bn_axis: Optional[str] = None):
        super().__init__(in_dim, out_dim, aggregators, scalers, avg_d,
                         generator, dropout, graph_norm, batch_norm, residual,
                         posttrans_layers, input_concat=True,
                         compute_dtype=compute_dtype, bn_axis=bn_axis)
        self.pretrans_layers = pretrans_layers
        width = 2 * in_dim + edge_dim
        self.pretrans = (
            LinearParams(width, in_dim, generator) if pretrans_layers == 1
            else MLP(width, in_dim, in_dim, pretrans_layers, generator))

    def forward(self, gb: GraphBatch, h: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                e: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = _edge_context(gb, self.aggregators, self.pretrans_layers == 1,
                            self.compute_dtype)
        if ctx.decomposed and self.pretrans_layers == 1:
            k, b = self.pretrans.kernel, self.pretrans.bias
            g_node, q_node, c_edge = (
                _ep_pretrans_parts(gb, k, b, h, e) if ep_fused_layout(gb)
                else _linear_pretrans_parts(k, b, h, e))
            agg = agg_ops.aggregate_decomposed(
                self.aggregators, ctx, g_node, q_node, h, c_edge=c_edge,
                layout=gb.mxu, compute_dtype=self.compute_dtype)
        else:
            z = [self._gather(gb, h, ctx.src), self._gather(gb, h, ctx.dst)]
            z = torch.cat(z if e is None else z + [e], dim=-1)
            msg = (z @ self.pretrans.kernel + self.pretrans.bias
                   if self.pretrans_layers == 1 else self.pretrans(z))
            agg = agg_ops.aggregate(self.aggregators, ctx, msg, h,
                                    layout=gb.mxu,
                                    compute_dtype=self.compute_dtype)
        return self._tail(gb, h, self._posttrans(gb, h, agg), generator)


class DGNTower(DGNLayerComplex):
    """One tower: the complex layer without its ReLU and residual,
    posttrans -> graph norm -> BN -> dropout (reference
    nets/dgn_layer.py:205-276)."""

    relu = False

    def __init__(self, in_dim: int, out_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], avg_d: Dict[str, float],
                 generator: torch.Generator, dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 posttrans_layers: int = 1, edge_dim: int = 0,
                 pretrans_layers: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 bn_axis: Optional[str] = None):
        super().__init__(in_dim, out_dim, aggregators, scalers, avg_d,
                         generator, dropout, graph_norm, batch_norm,
                         residual=False, posttrans_layers=posttrans_layers,
                         edge_dim=edge_dim, pretrans_layers=pretrans_layers,
                         compute_dtype=compute_dtype, bn_axis=bn_axis)


class DGNLayerTower(nn.Module):
    """`towers` DGNTowers (children tower_0 ..), each on its slice of the
    input when divide_input and on the whole edge embedding, then the
    LeakyReLU mixing FCLayer when towers > 1, then the residual (reference
    nets/dgn_layer.py:279-325)."""

    def __init__(self, in_dim: int, out_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], avg_d: Dict[str, float],
                 generator: torch.Generator, towers: int = 5,
                 divide_input: bool = True, dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 residual: bool = False, posttrans_layers: int = 1,
                 edge_dim: int = 0, pretrans_layers: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 bn_axis: Optional[str] = None):
        super().__init__()
        if divide_input and in_dim % towers != 0:
            raise ValueError("towers must divide in_dim when divide_input")
        if out_dim % towers != 0:
            raise ValueError("towers must divide out_dim")
        self.towers = towers
        self.divide_input = divide_input
        self.residual = residual and in_dim == out_dim
        self.input_tower = in_dim // towers if divide_input else in_dim
        for t in range(towers):
            self.add_module(f"tower_{t}", DGNTower(
                self.input_tower, out_dim // towers, aggregators, scalers,
                avg_d, generator, dropout=dropout, graph_norm=graph_norm,
                batch_norm=batch_norm, posttrans_layers=posttrans_layers,
                edge_dim=edge_dim, pretrans_layers=pretrans_layers,
                compute_dtype=compute_dtype, bn_axis=bn_axis))
        self.mixing = (FCLayer(out_dim, out_dim, generator, "leakyrelu")
                       if towers > 1 else None)

    def forward(self, gb: GraphBatch, h: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                e: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.input_tower
        outs = [getattr(self, f"tower_{t}")(
            gb, h[:, t * w:(t + 1) * w] if self.divide_input else h,
            generator, e) for t in range(self.towers)]
        h_out = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        if self.mixing is not None:
            h_out = self.mixing(h_out, gb.node_mask)
        return h + h_out if self.residual else h_out


VN_TYPES = ("mean", "sum", "logsum")


class VirtualNode(nn.Module):
    """Graph-global virtual node.  The state vn_h ([G_pad, dim], one row per
    graph) is threaded by the caller: forward returns (new vn_h, new h)."""

    def __init__(self, dim: int, generator: torch.Generator,
                 dropout: float = 0.0, batch_norm: bool = False,
                 residual: bool = True, vn_type: str = "mean",
                 bn_axis: Optional[str] = None):
        super().__init__()
        if vn_type not in VN_TYPES:
            raise ValueError(f"bad vn_type {vn_type!r} (one of {VN_TYPES})")
        self.vn_type = vn_type
        self.residual = residual
        self.fc_layer = FCLayer(dim, dim, generator, "relu", dropout,
                                batch_norm, bn_axis=bn_axis)

    def forward(self, gb: GraphBatch, h: torch.Tensor, vn_h: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        g = gb.num_graphs_padded
        blocks = gb.mxu is not None and gb.mxu.local_graph is not None
        pool = (mxu.graph_pool_sum(h, gb.mxu, g) if blocks
                else segment_sum(h, gb.node_graph, g, gb.node_mask))
        if self.vn_type != "sum":
            n = gb.n_nodes.to(pool.dtype)[:, None]
            pool = torch.where(n > 0, pool / n.clamp_min(1.0), 0.0)
            if self.vn_type == "logsum":
                pool = pool * torch.log(n.clamp_min(1.0))
        if gb.halo is not None:
            # partial pools of each rank's nodes (the division by the
            # replicated n_nodes commutes with the sum)
            pool = tnn._AllReduceSum.apply(pool, gb.halo.group)
        vn_tmp = self.fc_layer(vn_h + pool, gb.graph_mask, generator)
        vn_h = vn_h + vn_tmp if self.residual else vn_tmp
        if not blocks:
            return vn_h, h + gather(vn_h, gb.node_graph)
        return vn_h, h + mxu.graph_broadcast(vn_h, gb.node_graph,
                                             gb.node_mask)


def make_dgn_layer(type_net: str, **kw) -> nn.Module:
    """DGNLayer(type_net=...) dispatch (reference nets/dgn_layer.py:328);
    the simple and complex layers take no towers or divide_input, and the
    simple layer no edge_dim or pretrans_layers."""
    if type_net == "towers":
        return DGNLayerTower(**kw)
    kw.pop("towers", None)
    kw.pop("divide_input", None)
    if type_net == "simple":
        kw.pop("edge_dim", None)
        kw.pop("pretrans_layers", None)
        return DGNLayerSimple(**kw)
    if type_net == "complex":
        return DGNLayerComplex(**kw)
    raise ValueError(f"unknown type_net {type_net!r}")
