"""Masked segment reductions (PyTorch counterpart of `dgn_tpu/ops/segment.py`).

What the block layout calls: `EPS`, `gather`, the masked `segment_sum`
(`out[v] = sum_{e: ids[e]=v, mask[e]} data[e]`) and `segment_softmax`.  The
other reductions there (mean, max, min, var, std as separate segment ops)
belong to the flat layout and are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

# the epsilon the DGN benchmarks ran with (reference nets/aggregators.py:5)
EPS = 1e-8


def _expand(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Broadcast an [E] tensor against [E, ...] data."""
    return mask.reshape(mask.shape + (1,) * (data.ndim - 1))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is not None:
        data = torch.where(_expand(mask, data), data, 0)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-destination softmax over the real incoming edges, shifted by each
    destination's max (torch.nn.Softmax over the DGL mailbox axis,
    reference nets/aggregators.py:42-45).  Masked logits are -inf, a
    destination without an edge gets max 0, pad edges get weight 0, and
    the denominator is floored at the dtype's smallest normal number.

    The max starts from -inf, not 0, with include_self=False: a zero start
    would cap negative logits at 0 (see ops/extremes.py on torch's tie
    gradient through an untouched start)."""
    if mask is not None:
        logits = torch.where(_expand(mask, logits), logits, float("-inf"))
    idx = _expand(segment_ids.long(), logits).expand_as(logits)
    seg_max = logits.new_full((num_segments,) + tuple(logits.shape[1:]),
                              float("-inf")).scatter_reduce(
        0, idx, logits, "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(logits - seg_max.index_select(0, segment_ids))
    if mask is not None:
        ex = torch.where(_expand(mask, ex), ex, 0.0)
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / denom.index_select(0, segment_ids).clamp_min(
        torch.finfo(ex.dtype).tiny)


def gather(node_data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Edge-parallel gather of node features: node_data[indices]."""
    return node_data.index_select(0, indices)
