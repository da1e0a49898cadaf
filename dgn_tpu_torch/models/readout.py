"""Graph-level readout over the block layout (counterpart of
`dgn_tpu/models/readout.py`): the mean readout, dgl.mean_nodes in the
reference (nets/molecules_graph_regression/dgn_net.py:70-86).  The sum,
max and directional readouts are not ported yet."""
from __future__ import annotations

import torch

from ..graph import GraphBatch
from ..ops import mxu


def _part_sum(gb: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    return mxu.graph_pool_sum(h, gb.mxu, gb.num_graphs_padded)


def _part_mean(gb: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    s = _part_sum(gb, h)
    n = gb.n_nodes.to(s.dtype)[:, None]
    return torch.where(n > 0, s / n.clamp_min(1), 0.0)


def graph_readout(gb: GraphBatch, h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("mean", "default"):
        return _part_mean(gb, h)
    raise NotImplementedError(f"readout {kind!r} is not ported yet")
