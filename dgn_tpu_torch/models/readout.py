"""Graph-level readouts over either layout (counterpart of
`dgn_tpu/models/readout.py`): dgl.{mean,sum,max}_nodes in the reference
(nets/molecules_graph_regression/dgn_net.py:70-86), plus the directional
readouts.  The reference's 'directional' weight h * eig1 / sum(|eig1|, dim=1)
sums over a single column, so it is sign(eig1); that is what runs here (it
also avoids the reference's 0/0 where eig1 == 0), and 'directional_abs'
weighs by 1.  Unknown kinds fall through to mean, as in the reference.
Per-graph sums are `mxu.graph_pool_sum` on the block layout and a masked
segment_sum over node_graph on the flat one and on an edge-partitioned
rank's block layout, which has no graph blocks.

Edge-partitioned (gb.halo set): each rank pools its own nodes, and the
partial sums are summed over the ranks (nn._AllReduceSum) and the partial
maxima maxed over them (_AllReduceMax), so every rank holds the pooled
features of the whole batch (dgn_tpu/models/readout.py:25-49)."""
from __future__ import annotations

import torch

from .. import nn as tnn
from ..graph import GraphBatch, _sum_all
from ..ops import mxu
from ..ops.segment import segment_sum


def _part_sum(gb: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    if gb.mxu is not None and gb.mxu.local_graph is not None:
        s = mxu.graph_pool_sum(h, gb.mxu, gb.num_graphs_padded)
    else:
        s = segment_sum(h, gb.node_graph, gb.num_graphs_padded, gb.node_mask)
    if gb.halo is not None:
        s = tnn._AllReduceSum.apply(s, gb.halo.group)
    return s


def _part_mean(gb: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    s = _part_sum(gb, h)
    n = gb.n_nodes.to(s.dtype)[:, None]
    return torch.where(n > 0, s / n.clamp_min(1), 0.0)


class _AllReduceMax(torch.autograd.Function):
    """The per-graph max over the ranks' real nodes from each rank's h:
    forward the max of the local maxima over the ranks; backward the
    cotangent summed over the ranks (every rank holds the max) and split
    equally among the nodes, on every rank, that equal it, as a one-process
    scatter max splits it among its ties."""

    @staticmethod
    def forward(ctx, h, node_graph, node_mask, n_graphs, group):
        import torch.distributed as dist
        data = torch.where(node_mask[:, None], h, -torch.inf)
        idx = node_graph.long()[:, None].expand_as(data)
        m = h.new_full((n_graphs, h.shape[-1]), -torch.inf).scatter_reduce(
            0, idx, data, "amax")
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        tie = (data == m.gather(0, idx)) & node_mask[:, None]
        count = torch.zeros_like(m).scatter_add_(0, idx, tie.to(h.dtype))
        ctx.save_for_backward(tie, idx, _sum_all(count, group))
        ctx.group = group
        return m

    @staticmethod
    def backward(ctx, grad):
        tie, idx, count = ctx.saved_tensors
        share = _sum_all(grad, ctx.group) / count.clamp_min(1.0)
        return (torch.where(tie, share.gather(0, idx), 0.0), None, None,
                None, None)


def _part_max(gb: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    """Per-graph max over real nodes; 0 for a graph without nodes."""
    if gb.halo is not None:
        m = _AllReduceMax.apply(h, gb.node_graph, gb.node_mask,
                                gb.num_graphs_padded, gb.halo.group)
    else:
        data = torch.where(gb.node_mask[:, None], h, -torch.inf)
        out = h.new_full((gb.num_graphs_padded, h.shape[-1]), -torch.inf)
        idx = gb.node_graph.long()[:, None].expand_as(data)
        m = out.scatter_reduce(0, idx, data, "amax")
    return torch.where(torch.isfinite(m), m, 0.0)


def graph_readout(gb: GraphBatch, h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "sum":
        return _part_sum(gb, h)
    if kind == "max":
        return _part_max(gb, h)
    if kind == "directional":
        sgn = torch.sign(gb.eig[:, 1:2])
        return torch.cat([_part_mean(gb, h * sgn).abs(), _part_mean(gb, h)],
                         dim=-1)
    if kind == "directional_abs":
        return torch.cat([_part_mean(gb, h), _part_mean(gb, h)], dim=-1)
    return _part_mean(gb, h)
