"""Shared NN primitives (PyTorch counterpart of `dgn_tpu/nn.py`).

Parameters keep the reference package's names and layouts, so its weights
load without transposes (convert.py): a linear kernel is stored [in, out]
and applied as x @ kernel.  Initialisers reproduce the reference DGN
distributions and draw from an explicit torch.Generator:
  * LinearParams and FCLayer (the DGN layers' pretrans/posttrans, the towers'
    mixing, the virtual node's fc_layer): xavier uniform with gain
    1/in_size, zero bias (reference nets/layers.py:96-99);
  * Linear (MLPReadout, the linear encoders): torch.nn.Linear's default
    U(+-1/sqrt(in));
  * Embedding: N(0, 1).
`dropout` has flax `nn.Dropout` semantics and draws from an explicit
generator on the tensor's device.

Sync batch norm: a MaskedBatchNorm built with axis_name (the config's
`bn_axis`, threaded through FCLayer, MLP and the DGN layers as dgn_tpu
threads it) sums its statistics over the ranks of the mesh that
`bind_mesh` gives the model (parallel/dp.py DataParallelTrainer does).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _glu(x):
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


ACTIVATIONS: Dict[str, Optional[Callable]] = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "selu": F.selu,
    "glu": _glu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),  # torch's default slope
    "softplus": F.softplus,
    "none": None,
}


def get_activation(name) -> Optional[Callable]:
    """Name (any case), callable or None -> activation function, None for
    "none" (reference nets/layers.py:7-18)."""
    if name is None:
        return None
    if callable(name):
        return name
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {name!r}")
    return ACTIVATIONS[key]


def _uniform(shape, bound: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(
        (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound)


class LinearParams(nn.Module):
    """{kernel [in, out], bias [out]} of a linear layer whose computation
    lives in the caller: the decomposed DGN layer splits the pretrans kernel
    across edge endpoints, the per-edge one applies it to the edge rows,
    and both fold the scalers into the posttrans kernel (layers/dgn.py).  The reference nests these under a `FCLayer_0` holder
    level, which convert.py drops."""

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


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group's ranks; its backward sums the cotangents over
    the ranks (the transpose of a psum)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


class MaskedBatchNorm(nn.Module):
    """torch BatchNorm1d over the node axis, masked for padding.

    In training mode the statistics come from rows with mask True only,
    normalisation uses the biased variance, and the running buffers take the
    UNBIASED variance with momentum 0.1; eps 1e-5.  In eval mode the running
    statistics normalise.  Every row is normalised (pad rows stay masked
    downstream).

    axis_name set (sync batch norm, dgn_tpu/nn.py:95-140): the count and
    the masked sums of x and x^2 are summed over the ranks of the bound
    mesh (`mesh`, set by bind_mesh) before the mean and variance, so every
    rank normalises with, and keeps running buffers of, the statistics of
    the whole super-batch.  The sum is differentiable and its backward sums
    the cotangents over the ranks (_AllReduceSum), as a psum's transpose
    does, so each rank's gradient carries the other ranks'
    loss terms.  Without a bound mesh such a layer raises in training, as
    dgn_tpu's psum over an unbound axis name does."""

    def __init__(self, features: int, momentum: float = 0.1,
                 epsilon: float = 1e-5, axis_name: Optional[str] = None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.axis_name = axis_name
        self.mesh = None
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def _sync(self, count, s1, s2):
        """(count, s1, s2) summed over the bound mesh's ranks, in one
        differentiable all-reduce."""
        if self.mesh is None:
            raise RuntimeError(
                f"MaskedBatchNorm(axis_name={self.axis_name!r}) has no mesh "
                "bound: call nn.bind_mesh(model, mesh) (DataParallelTrainer "
                "does), or build the model with bn_axis=None")
        f = s1.shape[0]
        total = _AllReduceSum.apply(torch.cat([count.reshape(1), s1, s2]),
                                    self.mesh.group)
        return total[0], total[1:1 + f], total[1 + f:]

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask.to(x.dtype)[:, None]
            count = m.sum()
            s1 = (x * m).sum(0)
            s2 = (x * x * m).sum(0)
            if self.axis_name is not None:
                count, s1, s2 = self._sync(count, s1, s2)
            count = count.clamp_min(1.0)
            mean = s1 / count
            var = (s2 / count - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                unbiased = var * count / (count - 1.0).clamp_min(1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.scale \
            + self.bias


def bind_mesh(model: nn.Module, mesh) -> None:
    """Give every sync batch norm of model (axis_name set) the mesh whose
    ranks it sums over."""
    for module in model.modules():
        if isinstance(module, MaskedBatchNorm) and module.axis_name:
            module.mesh = mesh


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout` semantics: in training, keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate); outside
    training, or at rate 0, the identity.  The mask draws from `generator`,
    which must live on x's device (no global random state)."""
    if not training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit "
                         "torch.Generator on the model's device")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class FCLayer(LinearParams):
    """Dense -> activation -> dropout -> masked batch norm, in that order
    (reference nets/layers.py:101-112; batch norm after dropout is a quirk
    kept on purpose).  kernel and bias as LinearParams; the batch norm is
    the child `MaskedBatchNorm_0`, as the reference names it, and takes its
    statistics over the rows where `mask` is True (summed over the mesh's
    ranks with bn_axis)."""

    def __init__(self, in_size: int, out_size: int,
                 generator: torch.Generator, activation="relu",
                 dropout: float = 0.0, b_norm: bool = False,
                 bn_axis: Optional[str] = None):
        super().__init__(in_size, out_size, generator)
        self.activation = get_activation(activation)
        self.rate = dropout
        self.MaskedBatchNorm_0 = (MaskedBatchNorm(out_size, axis_name=bn_axis)
                                  if b_norm else None)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x @ self.kernel + self.bias
        if self.activation is not None:
            h = self.activation(h)
        h = dropout(h, self.rate, self.training, generator)
        if self.MaskedBatchNorm_0 is not None:
            h = self.MaskedBatchNorm_0(h, mask)
        return h


class MLP(nn.Module):
    """`layers` FCLayers: all but the last at hidden_size with ReLU, the
    last at out_size with no activation; no dropout, no batch norm
    (reference nets/layers.py:120-155 as every DGN layer calls it).
    Children FCLayer_0 .. FCLayer_{layers-1}.  The DGN layers use it for
    pretrans_layers > 1 and posttrans_layers > 1; a single linear layer is
    LinearParams there.  bn_axis passes through to the FCLayers, as in
    dgn_tpu; with no batch norm in them it changes nothing."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int,
                 layers: int, generator: torch.Generator,
                 bn_axis: Optional[str] = None):
        super().__init__()
        layers = max(layers, 1)
        dims = [in_size] + [hidden_size] * (layers - 1) + [out_size]
        for i in range(layers):
            self.add_module(f"FCLayer_{i}", FCLayer(
                dims[i], dims[i + 1], generator,
                "none" if i == layers - 1 else "relu", bn_axis=bn_axis))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


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
