"""Dense aggregator registry over [..., N, N, D] neighbour tensors X and
[..., N, N] adjacencies (counterpart of `dgn_tpu/dense/aggregators.py`):
out[..., i, d] = reduce_j f(adj_ij, X_ijd), concatenated on the feature
axis by `aggregate`.

The 15 standard aggregators (mean, sum, max, min, identity, std, var,
normalised_mean, softmax, softmin, moment3-5, mean_amplified,
mean_attenuated), dir0 and dir{1..5}-dx|smooth|both, with dgn_tpu's
choices kept on purpose:
  * max and min reduce over the -3 axis (the reference's torch.max(M,
    -3)), mean, sum and softmax over -2; a row without edges gives 0;
  * std and mean_amplified / mean_attenuated always add the self-loop (the
    reference passes its arguments positionally, landing a truthy device
    string in the self_loop slot);
  * softmax subtracts the row max; the moments snap |m| < 1e-6 to 0.
Max and min take torch.amax / amin, whose gradient splits equally among
ties, as jnp.max's does.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from .scalers import scale_amplification, scale_attenuation
from .spectral import EPS, aggregate_eigs


def _with_self_loop(adj, self_loop):
    if self_loop:
        adj = adj + torch.eye(adj.shape[-1], dtype=adj.dtype,
                              device=adj.device)
    return adj


def aggregate_identity(X, adj, eigvec=None, self_loop=False, avg_d=None):
    """The node's own (i, i) entry of X."""
    eye = torch.eye(X.shape[-2], dtype=X.dtype, device=X.device)[..., None]
    return (X * eye).sum(-2)


def aggregate_sum(X, adj, eigvec=None, self_loop=False, avg_d=None):
    adj = _with_self_loop(adj, self_loop)
    return (X * adj[..., None]).sum(-2)


def aggregate_mean(X, adj, eigvec=None, self_loop=False, avg_d=None):
    adj = _with_self_loop(adj, self_loop)
    D = adj.sum(-1, keepdim=True)
    return (X * adj[..., None]).sum(-2) / D


def aggregate_max(X, adj, eigvec=None, self_loop=False, avg_d=None):
    adj = _with_self_loop(adj, self_loop)
    out = torch.where(adj[..., None] > 0, X, -torch.inf).amax(-3)
    return torch.where(torch.isfinite(out), out, 0.0)


def aggregate_min(X, adj, eigvec=None, self_loop=False, avg_d=None):
    adj = _with_self_loop(adj, self_loop)
    out = torch.where(adj[..., None] > 0, X, torch.inf).amin(-3)
    return torch.where(torch.isfinite(out), out, 0.0)


def aggregate_var(X, adj, eigvec=None, self_loop=False, avg_d=None):
    adj = _with_self_loop(adj, self_loop)
    D = adj.sum(-1, keepdim=True)
    mean_sq = (X * X * adj[..., None]).sum(-2) / D
    mean = (X * adj[..., None]).sum(-2) / D
    return torch.relu(mean_sq - mean * mean)


def aggregate_std(X, adj, eigvec=None, self_loop=False, avg_d=None):
    return torch.sqrt(aggregate_var(X, adj, self_loop=True) + EPS)


def aggregate_normalised_mean(X, adj, eigvec=None, self_loop=False,
                              avg_d=None):
    """D^-1/2 A D^-1/2 X."""
    adj = _with_self_loop(adj, self_loop)
    rD = adj.sum(-1) ** -0.5
    adj = rD[..., :, None] * adj * rD[..., None, :]
    return (X * adj[..., None]).sum(-2)


def aggregate_softmax(X, adj, eigvec=None, self_loop=False, avg_d=None):
    """sum_j softmax_j(X_ij) X_ij over the neighbourhood, per feature."""
    adj = _with_self_loop(adj, self_loop)
    a = adj[..., None]
    mx = torch.where(a > 0, X, -torch.inf).amax(-2, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(X - mx) * a
    w = ex / ex.sum(-2, keepdim=True).clamp_min(EPS)
    return (w * X).sum(-2)


def aggregate_softmin(X, adj, eigvec=None, self_loop=False, avg_d=None):
    return -aggregate_softmax(-X, adj, self_loop=self_loop)


def aggregate_moment_rooted(X, adj, eigvec=None, self_loop=False, n=3,
                            avg_d=None):
    """sign(m_n) (|m_n| + EPS)^(1/n), m_n the centred n-th moment."""
    adj = _with_self_loop(adj, self_loop)
    D = adj.sum(-1, keepdim=True)
    mean = aggregate_mean(X, adj)
    m_n = (((X - mean[..., :, None, :]) ** n) * adj[..., None]).sum(-2) / D
    m_n = torch.where(m_n.abs() < 1e-6, 0.0, m_n)
    return torch.sign(m_n) * (m_n.abs() + EPS) ** (1.0 / n)


def aggregate_moment_div_stdn(X, adj, eigvec=None, self_loop=False, n=3,
                              avg_d=None):
    """Centred n-th moment / std^n."""
    adj = _with_self_loop(adj, self_loop)
    D = adj.sum(-1, keepdim=True)
    mean = aggregate_mean(X, adj)
    m_n = (((X - mean[..., :, None, :]) ** n) * adj[..., None]).sum(-2) / D
    return m_n / (aggregate_std(X, adj) ** n + EPS)


def aggregate_mean_amplified(X, adj, eigvec=None, self_loop=False,
                             avg_d=None):
    return scale_amplification(aggregate_mean(X, adj, self_loop=True),
                               adj, avg_d)


def aggregate_mean_attenuated(X, adj, eigvec=None, self_loop=False,
                              avg_d=None):
    return scale_attenuation(aggregate_mean(X, adj, self_loop=True),
                             adj, avg_d)


def _dir(X, adj, eigvec=None, self_loop=False, avg_d=None, *, eig_idx,
         agg_type):
    return aggregate_eigs(X, adj, eig_idx, eigvec=eigvec,
                          normalization="row-abs", add_diag=True,
                          agg_type=agg_type, eig_acos=True,
                          self_loop=self_loop)


def _channels(name: str) -> int:
    """Output channels per input feature."""
    if name.startswith("dir") and name != "dir0":
        k, kind = name[3:].split("-")
        return int(k) * (2 if kind == "both" else 1)
    return 1


AGGREGATORS: Dict[str, object] = {
    "mean": aggregate_mean,
    "sum": aggregate_sum,
    "max": aggregate_max,
    "min": aggregate_min,
    "identity": aggregate_identity,
    "std": aggregate_std,
    "var": aggregate_var,
    "normalised_mean": aggregate_normalised_mean,
    "softmax": aggregate_softmax,
    "softmin": aggregate_softmin,
    "moment3": functools.partial(aggregate_moment_rooted, n=3),
    "moment4": functools.partial(aggregate_moment_rooted, n=4),
    "moment5": functools.partial(aggregate_moment_rooted, n=5),
    "mean_amplified": aggregate_mean_amplified,
    "mean_attenuated": aggregate_mean_attenuated,
    "dir0": functools.partial(_dir, eig_idx=[0], agg_type="smoothing"),
}
for _k in range(1, 6):
    _idx = list(range(1, _k + 1))
    for _kind, _type in (("dx", "derivative"), ("smooth", "smoothing"),
                         ("both", "both")):
        AGGREGATORS[f"dir{_k}-{_kind}"] = functools.partial(
            _dir, eig_idx=_idx, agg_type=_type)


def total_channels(names) -> int:
    return sum(_channels(n) for n in names)


def eigvecs_needed(names) -> int:
    """Eigenvector columns the named aggregators read (dir{k}: k + 1; 0
    when none reads one)."""
    return max([int(n[3:].split("-")[0]) + 1 for n in names
                if n.startswith("dir") and n != "dir0"], default=0)


def aggregate(names, X, adj, eigvec: Optional[torch.Tensor] = None,
              self_loop: bool = False, avg_d=None) -> torch.Tensor:
    """The named aggregators concatenated on the feature axis."""
    return torch.cat([AGGREGATORS[n](X, adj, eigvec=eigvec,
                                     self_loop=self_loop, avg_d=avg_d)
                      for n in names], dim=-1)
