"""Host-side Laplacian eigenvectors (counterpart of `dgn_tpu/spectral.py`).

Laplacian variant ('none' L=D-A | 'sym' | 'walk'), ascending eigenvalue
sort, first k eigenvectors including the trivial one, from scipy's dense
solvers (reference data/molecules.py:100-116 used ARPACK).  The disk cache
of the reference package is not ported: only the real-file loaders use it.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg


def laplacian(num_nodes: int, src: np.ndarray, dst: np.ndarray,
              norm: str = "none") -> np.ndarray:
    """Dense graph Laplacian from COO edges; degrees clipped at 1 like the
    reference (data/molecules.py:105-113)."""
    n = num_nodes
    A = np.zeros((n, n), dtype=np.float64)
    np.add.at(A, (np.asarray(dst, dtype=np.int64),
                  np.asarray(src, dtype=np.int64)), 1.0)
    deg = np.zeros((n,), dtype=np.float64)
    np.add.at(deg, np.asarray(dst, dtype=np.int64), 1.0)
    deg = np.clip(deg, 1.0, None)
    if norm == "none":
        return np.diag(deg) - A
    if norm == "sym":
        d = deg ** -0.5
        return np.eye(n) - (d[:, None] * A) * d[None, :]
    if norm == "walk":
        return np.eye(n) - A / deg[:, None]
    raise ValueError(f"unknown laplacian norm {norm!r}")


def k_lowest_eigvecs(L: np.ndarray, k: int) -> np.ndarray:
    """First k eigenvectors by ascending eigenvalue (incl. the trivial one);
    the non-symmetric 'walk' Laplacian keeps real parts, like the reference's
    np.real(EigVec)."""
    n = L.shape[0]
    k = min(k, n)
    if np.allclose(L, L.T, atol=1e-12):
        vals, vecs = scipy.linalg.eigh(L)
    else:
        vals, vecs = scipy.linalg.eig(L)
        order = np.argsort(vals.real)
        vecs = vecs[:, order].real
    return np.real(vecs[:, :k]).astype(np.float32)


def graph_eig(num_nodes: int, src: np.ndarray, dst: np.ndarray, k: int,
              norm: str = "none") -> np.ndarray:
    """[n, k] float32 eig features; trailing columns zero-padded when the
    graph has fewer than k nodes."""
    vecs = k_lowest_eigvecs(laplacian(num_nodes, src, dst, norm), k)
    if vecs.shape[1] < k:
        vecs = np.pad(vecs, ((0, 0), (0, k - vecs.shape[1])))
    return vecs
