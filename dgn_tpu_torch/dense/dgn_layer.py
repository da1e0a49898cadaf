"""Dense DGN layer over [B, N, N] adjacencies (counterpart of
`dgn_tpu/dense/dgn_layer.py`).

DenseDGNTower: the pretrans MLP (`MLP_0`) on every [h_i || h_j] pair, the
aggregators (dense/aggregators.py) times the scalers, concatenated, then
the posttrans MLP (`MLP_1`) on [x || aggregate].  DenseDGNLayer: `towers`
towers (`DenseDGNTower_t`), each on its slice of the features when
divide_input, concatenated, then the LeakyReLU mixing FCLayer
(`FCLayer_0`), always applied in the dense variant.  The children carry
dgn_tpu's flax names, so convert.load_jax_params maps one tree onto the
other.  Unlike flax, torch needs the input width at construction
(in_features); the aggregate's width is total_channels x in_features per
scaler.  No dropout or batch norm: the dense modules have none.

With eigvec None, a tower or layer solves the eigenvectors once per
forward pass (k_lowest_eigvecs at the widest k its aggregators read) and
hands them to every aggregator and tower; dgn_tpu's aggregators each ask
for their own, the same columns (they are prefix-consistent in k), and
XLA computes the one eigh they share once.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn import MLP, FCLayer
from . import aggregators as dense_agg
from .scalers import SCALERS
from .spectral import k_lowest_eigvecs


def _solved(aggregators, adj, eigvec):
    """eigvec, or the eigenvectors the aggregators read, solved once."""
    k = dense_agg.eigvecs_needed(aggregators)
    if eigvec is None and k:
        eigvec = k_lowest_eigvecs(adj, k)
    return eigvec


class DenseDGNTower(nn.Module):
    """One tower over a dense adjacency."""

    def __init__(self, in_features: int, out_features: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: dict, generator: torch.Generator,
                 self_loop: bool = False, pretrans_layers: int = 1,
                 posttrans_layers: int = 1):
        super().__init__()
        self.aggregators = tuple(aggregators)
        self.scalers = tuple(scalers)
        self.avg_d = avg_d
        self.self_loop = self_loop
        self.MLP_0 = MLP(2 * in_features, in_features, in_features,
                         pretrans_layers, generator)
        width = in_features * (1 + dense_agg.total_channels(self.aggregators)
                               * len(self.scalers))
        self.MLP_1 = MLP(width, out_features, out_features, posttrans_layers,
                         generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                eigvec: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, f = x.shape[-2], x.shape[-1]
        shape = x.shape[:-2] + (n, n, f)
        h_cat = torch.cat([x[..., :, None, :].expand(shape),
                           x[..., None, :, :].expand(shape)], dim=-1)
        h_mod = self.MLP_0(h_cat)
        eigvec = _solved(self.aggregators, adj, eigvec)
        m = dense_agg.aggregate(self.aggregators, h_mod, adj, eigvec=eigvec,
                                self_loop=self.self_loop, avg_d=self.avg_d)
        m = torch.cat([SCALERS[s](m, adj, self.avg_d) for s in self.scalers],
                      dim=-1)
        return self.MLP_1(torch.cat([x, m], dim=-1))


class DenseDGNLayer(nn.Module):
    """Towers and the mixing FCLayer."""

    def __init__(self, in_features: int, out_features: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: dict, generator: torch.Generator, towers: int = 1,
                 self_loop: bool = False, pretrans_layers: int = 1,
                 posttrans_layers: int = 1, divide_input: bool = True):
        super().__init__()
        if divide_input and in_features % towers != 0:
            raise ValueError("towers must divide in_features with "
                             "divide_input")
        if out_features % towers != 0:
            raise ValueError("towers must divide out_features")
        self.towers = towers
        self.divide_input = divide_input
        self.in_tower = in_features // towers if divide_input else in_features
        for t in range(towers):
            self.add_module(f"DenseDGNTower_{t}", DenseDGNTower(
                self.in_tower, out_features // towers, aggregators, scalers,
                avg_d, generator, self_loop=self_loop,
                pretrans_layers=pretrans_layers,
                posttrans_layers=posttrans_layers))
        self.FCLayer_0 = FCLayer(out_features, out_features, generator,
                                 "leakyrelu")

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                eigvec: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.in_tower
        eigvec = _solved(self.DenseDGNTower_0.aggregators, adj, eigvec)
        ys = [getattr(self, f"DenseDGNTower_{t}")(
            x[..., t * w:(t + 1) * w] if self.divide_input else x, adj,
            eigvec) for t in range(self.towers)]
        return self.FCLayer_0(torch.cat(ys, dim=-1))
