"""The complex DGN layer, decomposed edge stage (counterpart of
`dgn_tpu/layers/dgn.py:DGNLayerComplex`).

With a linear pretrans over [h_src || h_dst] the per-edge message splits as
msg_e = g[src_e] + q[dst_e] with g = h @ W1 and q = h @ W2 + b; the
aggregators run on that form (ops/aggregators.aggregate_decomposed), and a
linear posttrans over [h_in || scaled copies of the aggregate] is applied
without materialising the concat (_fused_posttrans).

Layer order: posttrans -> graph norm (h * snorm_n) -> masked BatchNorm ->
ReLU -> residual.  Parity quirks kept on purpose: scalers apply only when
len(scalers) > 1 (reference nets/dgn_layer.py:95-96), and the residual only
when in_dim == out_dim (:76-77).  Not ported yet: the simple and towers
layers, the virtual node, deeper pretrans/posttrans MLPs, edge features and
dropout.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..graph import GraphBatch
from ..nn import LinearParams, MaskedBatchNorm
from ..ops import aggregators as agg_ops
from ..ops import scalers as scaler_ops


def _linear_pretrans_parts(kernel, bias, h):
    """(g_node = h @ W1, q_node = h @ W2 + b) such that the linear pretrans
    of [h_src || h_dst] is g_node[src] + q_node[dst]."""
    f = h.shape[-1]
    return h @ kernel[:f], h @ kernel[f:2 * f] + bias


def _fused_posttrans(kernel, bias, h_in, h_agg, gb: GraphBatch,
                     scaler_names: Sequence[str], avg_d: Dict[str, float]):
    """Linear posttrans over concat([h_in, scaler-scaled copies of h_agg])
    without the concats: scalers are per-node scalars, so
    (s * x) @ W == s * (x @ W)."""
    f_in = h_in.shape[-1]
    out = h_in @ kernel[:f_in] + bias
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


class DGNLayerComplex(nn.Module):
    """Linear pretrans on [h_src || h_dst], input-concat linear posttrans
    (reference nets/dgn_layer.py:52-132), decomposed edge stage."""

    def __init__(self, in_dim: int, out_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], avg_d: Dict[str, float],
                 generator: torch.Generator, graph_norm: bool = True,
                 batch_norm: bool = True, residual: bool = True):
        super().__init__()
        self.aggregators = tuple(aggregators)
        agg_ops.check_ported(self.aggregators)
        self.scalers = tuple(scalers)
        self.avg_d = avg_d
        self.graph_norm = graph_norm
        self.residual = residual and in_dim == out_dim
        n_scal = len(self.scalers) if len(self.scalers) > 1 else 1
        self.pretrans = LinearParams(2 * in_dim, in_dim, generator)
        self.posttrans = LinearParams(
            in_dim + len(self.aggregators) * in_dim * n_scal, out_dim,
            generator)
        self.batchnorm_h = MaskedBatchNorm(out_dim) if batch_norm else None

    def forward(self, gb: GraphBatch, h: torch.Tensor) -> torch.Tensor:
        h_in = h
        g_node, q_node = _linear_pretrans_parts(self.pretrans.kernel,
                                                self.pretrans.bias, h)
        agg = agg_ops.aggregate_decomposed(self.aggregators, gb.edge_ctx,
                                           g_node, q_node, h_in,
                                           layout=gb.mxu)
        h = _fused_posttrans(self.posttrans.kernel, self.posttrans.bias,
                             h_in, agg, gb, self.scalers, self.avg_d)
        if self.graph_norm:
            h = h * gb.snorm_n
        if self.batchnorm_h is not None:
            h = self.batchnorm_h(h, gb.node_mask)
        h = torch.relu(h)
        if self.residual:
            h = h_in + h
        return h
