"""Masked segment reductions (PyTorch counterpart of `dgn_tpu/ops/segment.py`).

`out[v] = reduce_{e: ids[e]=v, mask[e]} data[e]` over an edge list, pad
edges (mask False) excluded: sum, mean, max, min, both extremes at once,
var, std and the per-destination softmax, plus the edge gather.  The flat
layout reduces every aggregator with them; the block layout takes the sum,
the softmax and the gather.  A destination without a real edge gets 0
(std: sqrt(0 + EPS)).

Sums are `index_add_` (an int32 index will do); max and min are
`scatter_reduce` ("amax"/"amin", include_self=False, int64 index) from a
-inf / +inf start, then 0 where nothing arrived.  The start must not be 0:
torch's gradient counts an untouched start that equals the result as one
more tie (see ops/extremes.py).  From an infinite start the gradient splits
equally among the tied edges, as XLA's scatter-max gradient does.
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


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: Optional[torch.Tensor] = None,
                 degree: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the real incoming edges; 0 where the degree (given, or
    counted over the real edges) is 0."""
    s = segment_sum(data, segment_ids, num_segments, mask)
    if degree is None:
        degree = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                             num_segments, mask)
    d = degree.to(s.dtype).reshape((num_segments,) + (1,) * (s.ndim - 1))
    return torch.where(d > 0, s / d.clamp_min(1.0), 0.0)


def _segment_extreme(data, segment_ids, num_segments, mask, reduce: str):
    start = float("-inf") if reduce == "amax" else float("inf")
    if mask is not None:
        data = torch.where(_expand(mask, data), data, start)
    idx = _expand(segment_ids.long(), data).expand_as(data)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        start).scatter_reduce(0, idx, data, reduce,
                                              include_self=False)
    return torch.where(torch.isfinite(out), out, 0.0)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, mask, "amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, mask, "amin")


def segment_extremes(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int,
                     mask: Optional[torch.Tensor] = None):
    """(segment_max, segment_min) in one scatter over [data, -data] side by
    side, as dgn_tpu computes both extremes in one pass."""
    d2 = data.reshape(data.shape[0], -1)
    f = d2.shape[1]
    out = segment_max(torch.cat([d2, -d2], dim=1), segment_ids,
                      num_segments, mask)
    tail = (num_segments,) + tuple(data.shape[1:])
    return out[:, :f].reshape(tail), (-out[:, f:]).reshape(tail)


def segment_var(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                degree: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(E[x^2] - E[x]^2) over the incoming edges (reference
    nets/aggregators.py:24-28)."""
    m2 = segment_mean(data * data, segment_ids, num_segments, mask, degree)
    m1 = segment_mean(data, segment_ids, num_segments, mask, degree)
    return torch.relu(m2 - m1 * m1)


def segment_std(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                degree: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sqrt(var + EPS) (reference nets/aggregators.py:20-21)."""
    return torch.sqrt(segment_var(data, segment_ids, num_segments, mask,
                                  degree) + EPS)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-destination softmax over the real incoming edges, shifted by each
    destination's max (torch.nn.Softmax over the DGL mailbox axis,
    reference nets/aggregators.py:42-45).  Masked logits are -inf, a
    destination without an edge gets max 0, pad edges get weight 0, and
    the denominator is floored at the dtype's smallest normal number.

    The max is segment_max's, from -inf: a zero start would cap negative
    logits at 0."""
    seg_max = segment_max(logits, segment_ids, num_segments, mask)
    if mask is not None:
        logits = torch.where(_expand(mask, logits), logits, float("-inf"))
    ex = torch.exp(logits - seg_max.index_select(0, segment_ids))
    if mask is not None:
        ex = torch.where(_expand(mask, ex), ex, 0.0)
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / denom.index_select(0, segment_ids).clamp_min(
        torch.finfo(ex.dtype).tiny)


def gather(node_data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Edge-parallel gather of node features: node_data[indices]."""
    return node_data.index_select(0, indices)
