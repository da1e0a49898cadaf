"""Shared NN primitives (PyTorch counterpart of `dgn_tpu/nn.py`).

Parameters keep the reference package's names and layouts, so its weights
load without transposes (convert.py): a linear kernel is stored [in, out]
and applied as x @ kernel.  Initialisers reproduce the reference DGN
distributions and draw from an explicit torch.Generator:
  * LinearParams (the DGN layers' pretrans/posttrans FCLayer): xavier
    uniform with gain 1/in_size, zero bias (reference nets/layers.py:96-99);
  * Linear (MLPReadout): torch.nn.Linear's default U(+-1/sqrt(in));
  * Embedding: N(0, 1).
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _uniform(shape, bound: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(
        (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound)


class LinearParams(nn.Module):
    """{kernel [in, out], bias [out]} of a linear layer whose computation
    lives in the caller: the decomposed DGN layer splits the pretrans kernel
    across edge endpoints and folds the scalers into the posttrans kernel
    (layers/dgn.py)."""

    def __init__(self, in_size: int, out_size: int,
                 generator: torch.Generator):
        super().__init__()
        a = (1.0 / in_size) * math.sqrt(6.0 / (in_size + out_size))
        self.kernel = _uniform((in_size, out_size), a, generator)
        self.bias = nn.Parameter(torch.zeros(out_size))


class Linear(nn.Module):
    """torch.nn.Linear with its default init, kernel stored [in, out]."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
        self.kernel = _uniform((in_features, out_features), bound, generator)
        self.bias = _uniform((out_features,), bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class Embedding(nn.Module):
    """torch.nn.Embedding parity: weights ~ N(0, 1)."""

    def __init__(self, num_embeddings: int, features: int,
                 generator: torch.Generator):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn((num_embeddings, features), generator=generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding.index_select(0, ids)


class MaskedBatchNorm(nn.Module):
    """torch BatchNorm1d over the node axis, masked for padding.

    In training mode the statistics come from rows with mask True only,
    normalisation uses the biased variance, and the running buffers take the
    UNBIASED variance with momentum 0.1; eps 1e-5.  In eval mode the running
    statistics normalise.  Every row is normalised (pad rows stay masked
    downstream)."""

    def __init__(self, features: int, momentum: float = 0.1,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask.to(x.dtype)[:, None]
            count = m.sum().clamp_min(1.0)
            mean = (x * m).sum(0) / count
            var = ((x * x * m).sum(0) / count - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                unbiased = var * count / (count - 1.0).clamp_min(1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.scale \
            + self.bias


class MLPReadout(nn.Module):
    """L hidden Linears (halving dims, or constant) with ReLU, then a final
    Linear (reference nets/mlp_readout_layer.py:13-30).  Children are named
    Linear_0 .. Linear_L like the reference's parameter tree."""

    def __init__(self, input_dim: int, output_dim: int,
                 generator: torch.Generator, L: int = 2,
                 decreasing_dim: bool = True):
        super().__init__()
        self.L = L
        dim = input_dim
        for l in range(L):
            feat = input_dim // 2 ** (l + 1) if decreasing_dim else input_dim
            self.add_module(f"Linear_{l}", Linear(dim, feat, generator))
            dim = feat
        self.add_module(f"Linear_{L}", Linear(dim, output_dim, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for l in range(self.L):
            x = torch.relu(getattr(self, f"Linear_{l}")(x))
        return getattr(self, f"Linear_{self.L}")(x)
