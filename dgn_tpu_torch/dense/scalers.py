"""Dense scalers over [..., N, D] aggregates with [..., N, N] adjacency
(counterpart of `dgn_tpu/dense/scalers.py`): identity, amplification
log(D + 1) / d_log, attenuation d_log / log(D + 1), linear D / d_lin and
inverse_linear d_lin / D, with D the weighted row degree."""
from __future__ import annotations

from typing import Dict

import torch


def scale_identity(X, adj, avg_d=None):
    return X


def scale_amplification(X, adj, avg_d=None):
    D = adj.sum(-1)
    return X * (torch.log(D + 1.0) / avg_d["log"])[..., None]


def scale_attenuation(X, adj, avg_d=None):
    D = adj.sum(-1)
    return X * (avg_d["log"] / torch.log(D + 1.0))[..., None]


def scale_linear(X, adj, avg_d=None):
    D = adj.sum(-1, keepdim=True)
    return D * X / avg_d["lin"]


def scale_inverse_linear(X, adj, avg_d=None):
    D = adj.sum(-1, keepdim=True)
    return avg_d["lin"] * X / D


SCALERS: Dict[str, object] = {
    "identity": scale_identity,
    "linear": scale_linear,
    "inverse_linear": scale_inverse_linear,
    "amplification": scale_amplification,
    "attenuation": scale_attenuation,
}


def apply_scaler(name: str, X: torch.Tensor, adj: torch.Tensor, avg_d=None):
    return SCALERS[name](X, adj, avg_d)
