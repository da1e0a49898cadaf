"""Graph-level readouts over either layout (counterpart of
`dgn_tpu/models/readout.py`): dgl.{mean,sum,max}_nodes in the reference
(nets/molecules_graph_regression/dgn_net.py:70-86), plus the directional
readouts.  The reference's 'directional' weight h * eig1 / sum(|eig1|, dim=1)
sums over a single column, so it is sign(eig1); that is what runs here (it
also avoids the reference's 0/0 where eig1 == 0), and 'directional_abs'
weighs by 1.  Unknown kinds fall through to mean, as in the reference.
Per-graph sums are `mxu.graph_pool_sum` on the block layout and a masked
segment_sum over node_graph on the flat one."""
from __future__ import annotations

import torch

from ..graph import GraphBatch
from ..ops import mxu
from ..ops.segment import segment_sum


def _part_sum(gb: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    if gb.mxu is not None:
        return mxu.graph_pool_sum(h, gb.mxu, gb.num_graphs_padded)
    return segment_sum(h, gb.node_graph, gb.num_graphs_padded, gb.node_mask)


def _part_mean(gb: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    s = _part_sum(gb, h)
    n = gb.n_nodes.to(s.dtype)[:, None]
    return torch.where(n > 0, s / n.clamp_min(1), 0.0)


def _part_max(gb: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    """Per-graph max over real nodes; 0 for a graph without nodes."""
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
