"""OGB atom and bond encoders (counterpart of `dgn_tpu/models/encoders.py`).

Sums of per-column categorical embeddings over the standard OGB molecule
feature columns (ogb.graphproppred.mol_encoder, which the DGN HIV/PCBA nets
import): one table per column, xavier-uniform initialised like OGB's, ids
clipped to the table.  The lookups are plain `index_select`; the reference's
one-hot matmuls are a TPU workaround for slow scatters in the backward.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

# OGB full_atom_feature_dims / full_bond_feature_dims (ogb.utils.features)
ATOM_FEATURE_DIMS: Tuple[int, ...] = (119, 4, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS: Tuple[int, ...] = (5, 6, 2)


class MultiEmbedding(nn.Module):
    """Sum of per-column embeddings of an integer feature matrix [N, C].

    Parameters emb_0 .. emb_{C-1}, each [dims[i], emb_dim], xavier uniform
    (bound sqrt(6 / (dims[i] + emb_dim)))."""

    def __init__(self, dims: Tuple[int, ...], emb_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.dims = tuple(dims)
        for i, d in enumerate(self.dims):
            bound = math.sqrt(6.0 / (d + emb_dim))
            self.register_parameter(f"emb_{i}", nn.Parameter(
                (torch.rand((d, emb_dim), generator=generator) * 2.0 - 1.0)
                * bound))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 1:
            x = x[:, None]
        x = x.long()
        out = 0.0
        for i, d in enumerate(self.dims):
            out = out + getattr(self, f"emb_{i}").index_select(
                0, x[:, i].clamp(0, d - 1))
        return out


class AtomEncoder(nn.Module):
    def __init__(self, emb_dim: int, generator: torch.Generator):
        super().__init__()
        self.atom = MultiEmbedding(ATOM_FEATURE_DIMS, emb_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.atom(x)


class BondEncoder(nn.Module):
    def __init__(self, emb_dim: int, generator: torch.Generator):
        super().__init__()
        self.bond = MultiEmbedding(BOND_FEATURE_DIMS, emb_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bond(x)
