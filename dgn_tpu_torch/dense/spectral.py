"""Dense spectral engine (counterpart of `dgn_tpu/dense/spectral.py`):
runtime Laplacian eigenvectors and the gradient adjacencies of the dense
research path, batched over leading axes of [..., N, N] adjacencies.

  laplacian          L = D - A, or D^-1 (D - A)
  component_labels   exact connected components: the boolean closure of
                     A + I by ceil(log2 N) squarings
  k_lowest_eigvecs   torch.linalg.eigh, the |eigenvalue|-ascending basis
                     (a stable sort, as jnp.argsort is); a graph with more
                     than one null eigenvalue (|lambda| < EPS) is
                     disconnected: column 0 zero and columns 1.. each
                     node's own component's lowest non-null eigenvectors
  grad_adjacency     G_ij = A_ij (f_j - f_i + EPS), normalisations
                     'none' | 'row-abs' | 'in-out-field', add_diag,
                     absolute_adj
  eig_adjacency      {idx: gradient adjacency of eigenvector idx}; idx 0
                     the row-normalised adjacency; eig_acos divides by the
                     max of |v| over the WHOLE batched tensor, not per graph
  aggregate_sum      out[..., i, d] = sum_j adj_ij X_ijd
  aggregate_eigs     derivative / smoothing / both along the eigenvectors

component_labels squares 0/1 float32 matrices; it turns TF32 off for them
on the GPU (0 and 1 are exact in TF32, but its sums need not stay exact).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Union

import torch

EPS = 1e-5


def laplacian(adj: torch.Tensor, normalize_L: bool = False) -> torch.Tensor:
    """L = D - A, optionally D^-1 (D - A); batched over leading axes."""
    deg = adj.sum(-1)
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
    L = -adj + deg[..., :, None] * eye
    if normalize_L:
        L = L / deg[..., :, None]
    return L


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def component_labels(adj: torch.Tensor) -> torch.Tensor:
    """label[..., v] = the smallest node index reachable from v (int32)."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    reach = (adj > 0) | eye
    steps = max(1, int(math.ceil(math.log2(max(n, 2)))))
    with _no_tf32():
        for _ in range(steps):
            f = reach.to(torch.float32)
            reach = torch.matmul(f, f) > 0
    idx = torch.arange(n, dtype=torch.int64, device=adj.device)
    return torch.where(reach, idx, n).amin(-1).to(torch.int32)


def _redistribute_components(vecs: torch.Tensor, nc: torch.Tensor,
                             labels: torch.Tensor, k: int) -> torch.Tensor:
    """Per-component eigenvector assignment, batched over graphs ([B, N,
    N] sorted vecs, [B] null counts, [B, N] labels): each eigenvector j >=
    nc goes to the component where its mean |amplitude| is largest (the
    first such component on a tie); each component's first k-1 of them
    fill output columns 1..k-1 on that component's rows."""
    b, n = vecs.shape[0], vecs.shape[-1]
    labels = labels.long()
    onehot = torch.nn.functional.one_hot(labels, n).to(vecs.dtype)
    counts = onehot.sum(1)                                   # [B, C]
    mass = torch.einsum("bvc,bvj->bcj", onehot, vecs.abs())
    mass = mass / counts.clamp_min(1.0)[..., None]
    comp_of_vec = mass.argmax(1)                             # [B, J]
    j_idx = torch.arange(n, device=vecs.device)
    valid = j_idx[None, :] >= nc[:, None]                    # [B, J]
    same = comp_of_vec[:, None, :] == comp_of_vec[:, :, None]
    before = (j_idx[:, None] < j_idx[None, :])[None] & valid[:, :, None]
    rank = (same & before).sum(1)                            # [B, J]
    kk = torch.arange(max(k - 1, 1), device=vecs.device)
    sel = (valid[..., None] & (rank[..., None] == kk)).to(vecs.dtype)
    match = (comp_of_vec[:, None, :] == labels[:, :, None]).to(vecs.dtype)
    body = (vecs * match) @ sel                              # [B, N, k-1]
    out = torch.cat([vecs.new_zeros((b, n, 1)), body], dim=-1)
    return out[..., :k]


def null_counts(adj: torch.Tensor) -> torch.Tensor:
    """The count of |eigenvalue| < EPS of each graph's Laplacian: above 1,
    k_lowest_eigvecs treats the graph as disconnected."""
    vals = torch.linalg.eigvalsh(laplacian(adj))
    return (vals.abs() < EPS).sum(-1)


def k_lowest_eigvecs(adj: torch.Tensor, k: int) -> torch.Tensor:
    """k lowest eigenvectors of L = D - A per graph: [..., N, k], one
    batched eigh for every graph."""
    batch, n = adj.shape[:-2], adj.shape[-1]
    flat = adj.reshape((-1, n, n))
    vals, vecs = torch.linalg.eigh(laplacian(flat))
    order = torch.argsort(vals.abs(), dim=-1, stable=True)
    vecs = torch.gather(vecs, -1, order[:, None, :].expand_as(vecs))
    nc = (vals.abs() < EPS).sum(-1)
    kc = min(k, n)
    conn = vecs[..., :kc]
    disc = _redistribute_components(vecs, nc, component_labels(flat), kc)
    out = torch.where((nc > 1)[:, None, None], disc, conn)
    if kc < k:
        out = torch.nn.functional.pad(out, (0, k - kc))
    return out.reshape(batch + out.shape[-2:])


def grad_adjacency(adj: torch.Tensor, features: torch.Tensor,
                   normalization: str = "none", add_diag: bool = True,
                   absolute_adj: bool = False) -> torch.Tensor:
    """The adjacency of the gradient of a node function f, G_ij = A_ij
    (f_j - f_i + EPS), normalised ('row-abs': rows sum to 1 in |.| over
    entries above EPS; 'in-out-field': the positive and negative fields
    over the sum of their L2 norms); add_diag puts minus the row sum on
    the diagonal; absolute_adj takes |G|."""
    g = adj * (features[..., None, :] - features[..., :, None] + EPS)
    norm = (normalization or "none").lower()
    if norm == "row-abs":
        gn = g.abs()
        gn = gn * (gn > EPS)
        g = g / (gn.sum(-1, keepdim=True) + EPS)
    elif norm == "in-out-field":
        pos = g * (g > EPS)
        neg = g * (g < -EPS)
        out_f = torch.sqrt((pos ** 2).sum(-1, keepdim=True)) + EPS
        in_f = torch.sqrt((neg ** 2).sum(-1, keepdim=True)) + EPS
        g = (pos + neg) / (out_f + in_f)
    elif norm != "none":
        raise ValueError(f"unsupported normalization {normalization!r}")
    if add_diag:
        eye = torch.eye(adj.shape[-1], dtype=g.dtype, device=g.device)
        g = g - eye * g.sum(-1, keepdim=True)
    if absolute_adj:
        g = g.abs()
    return g


def eig_adjacency(adj: torch.Tensor, eig_idx: Union[int, Sequence[int]],
                  eigvec: Optional[torch.Tensor] = None,
                  normalization: str = "none", add_diag: bool = True,
                  absolute_adj: bool = False,
                  eig_acos: bool = True) -> Dict[int, torch.Tensor]:
    """{idx: gradient adjacency of eigenvector idx}; eigvec [..., N, K]
    or, when None, k_lowest_eigvecs of adj."""
    try:
        eig_idx = list(eig_idx)
    except TypeError:
        eig_idx = [eig_idx]
    if eigvec is None:
        eigvec = k_lowest_eigvecs(adj, max(eig_idx) + 1)
    out = {}
    for ii in eig_idx:
        if ii == 0:
            out[ii] = adj / (adj.abs().sum(-1, keepdim=True) + EPS)
            continue
        v = eigvec[..., ii]
        if eig_acos:
            v = torch.arccos(torch.clamp(v / v.abs().max(), -1.0, 1.0))
        out[ii] = grad_adjacency(adj, v, normalization=normalization,
                                 add_diag=add_diag,
                                 absolute_adj=absolute_adj)
    return out


def aggregate_sum(X: torch.Tensor, adj: torch.Tensor,
                  self_loop: bool = False) -> torch.Tensor:
    """out[..., i, d] = sum_j adj[..., i, j] X[..., i, j, d]."""
    if self_loop:
        adj = adj + torch.eye(adj.shape[-1], dtype=adj.dtype,
                              device=adj.device)
    return (X * adj[..., None]).sum(-2)


def aggregate_eigs(X: torch.Tensor, adj: torch.Tensor,
                   eig_idx: Union[int, Sequence[int]],
                   eigvec: Optional[torch.Tensor] = None,
                   normalization: str = "none", add_diag: bool = True,
                   agg_type: str = "derivative", eig_acos: bool = True,
                   self_loop: bool = False) -> torch.Tensor:
    """Directional aggregation along eigenvector gradients, channels
    concatenated on the feature axis; agg_type 'derivative' | 'smoothing'
    | 'both'; idx 0 always smooths."""
    agg_type = agg_type.lower()
    if agg_type not in ("derivative", "smoothing", "both"):
        raise ValueError(f"unknown agg_type {agg_type!r}")
    adjs = eig_adjacency(adj, eig_idx, eigvec=eigvec,
                         normalization=normalization, add_diag=add_diag,
                         absolute_adj=False, eig_acos=eig_acos)
    outs = []
    for ii, a in adjs.items():
        if agg_type in ("derivative", "both") and ii != 0:
            outs.append(aggregate_sum(X, a, self_loop=self_loop))
        if agg_type in ("smoothing", "both") or ii == 0:
            outs.append(aggregate_sum(X, a.abs(), self_loop=self_loop))
    return torch.cat(outs, dim=-1)
