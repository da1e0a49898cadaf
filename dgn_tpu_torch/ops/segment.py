"""Masked segment reductions (PyTorch counterpart of `dgn_tpu/ops/segment.py`).

Only what this slice calls: `EPS`, `gather` and the masked `segment_sum`.
`out[v] = sum_{e: ids[e]=v, mask[e]} data[e]`.
"""
from __future__ import annotations

from typing import Optional

import torch

# the epsilon the DGN benchmarks ran with (reference nets/aggregators.py:5)
EPS = 1e-8


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is not None:
        data = torch.where(mask.reshape(mask.shape + (1,) * (data.ndim - 1)),
                           data, 0)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def gather(node_data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Edge-parallel gather of node features: node_data[indices]."""
    return node_data.index_select(0, indices)
