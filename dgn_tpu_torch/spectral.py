"""Host-side Laplacian eigenvectors (counterpart of `dgn_tpu/spectral.py`).

Laplacian variant ('none' L=D-A | 'sym' | 'walk'), ascending eigenvalue
sort, first k eigenvectors including the trivial one, from scipy's dense
solvers (reference data/molecules.py:100-116 used ARPACK).  `EigCache`
stores each solve on disk under the content hash dgn_tpu/spectral.py:101-108
computes, byte for byte, so either package reads a cache directory the
other wrote without a solve.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional

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


class EigCache:
    """Disk cache of per-graph eig features keyed by content hash: one
    `<key>.npy` per (graph, k, norm).  Without a directory every get
    solves."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    @staticmethod
    def _key(num_nodes, src, dst, k, norm) -> str:
        """SHA-256 of int64 num_nodes, src and dst, then "k:norm"; the first
        32 hex characters."""
        h = hashlib.sha256()
        h.update(np.int64(num_nodes).tobytes())
        h.update(np.asarray(src, dtype=np.int64).tobytes())
        h.update(np.asarray(dst, dtype=np.int64).tobytes())
        h.update(f"{k}:{norm}".encode())
        return h.hexdigest()[:32]

    def get(self, num_nodes, src, dst, k, norm="none") -> np.ndarray:
        if not self.cache_dir:
            return graph_eig(num_nodes, src, dst, k, norm)
        path = os.path.join(self.cache_dir,
                            self._key(num_nodes, src, dst, k, norm) + ".npy")
        if os.path.exists(path):
            return np.load(path)
        out = graph_eig(num_nodes, src, dst, k, norm)
        # written whole or not at all: a run stopped mid-write leaves no
        # truncated entry behind
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, out)
        os.replace(tmp, path)
        return out


def add_eig(graphs, k: int, norm: str = "none",
            cache: Optional[EigCache] = None) -> None:
    """Set .eig of each GraphData in place, through the cache if given."""
    cache = cache or EigCache(None)
    for g in graphs:
        g.eig = cache.get(g.num_nodes, g.src, g.dst, k, norm)


def batch_eig_cache_path(root: str, dataset: str, norm: str, k: int) -> str:
    return os.path.join(root, f"eig_{dataset}_{norm}_{k}")
