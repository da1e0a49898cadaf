"""Laplacian eigenvectors, as a dataset file carries them: the dense
Laplacian from COO edges (degrees clipped at 1), its first k eigenvectors
by ascending eigenvalue, the trivial one included, trailing columns
zero-padded for graphs with fewer than k nodes.  A non-symmetric Laplacian
(the sym-normalised one of a directed kNN graph) keeps the real parts."""
from __future__ import annotations

import numpy as np
import scipy.linalg


def laplacian(n: int, src: np.ndarray, dst: np.ndarray,
              norm: str = "none") -> np.ndarray:
    A = np.zeros((n, n), dtype=np.float64)
    np.add.at(A, (dst.astype(np.int64), src.astype(np.int64)), 1.0)
    deg = np.clip(np.bincount(dst, minlength=n).astype(np.float64), 1.0, None)
    if norm == "none":
        return np.diag(deg) - A
    if norm == "sym":
        d = deg ** -0.5
        return np.eye(n) - (d[:, None] * A) * d[None, :]
    raise ValueError(f"unknown laplacian norm {norm!r}")


def graph_eig(n: int, src: np.ndarray, dst: np.ndarray, k: int,
              norm: str = "none") -> np.ndarray:
    """[n, k] float32."""
    L = laplacian(n, src, dst, norm)
    if np.allclose(L, L.T, atol=1e-12):
        _, vecs = scipy.linalg.eigh(L)
    else:
        vals, vecs = scipy.linalg.eig(L)
        vecs = vecs[:, np.argsort(vals.real)].real
    vecs = np.real(vecs[:, :min(k, n)]).astype(np.float32)
    if vecs.shape[1] < k:
        vecs = np.pad(vecs, ((0, 0), (0, k - vecs.shape[1])))
    return vecs
