"""CIFAR10-like superpixel graphs (frozen copy of the port's synthetic
superpixel generator at the dataset's published statistics, Dwivedi et al.
arXiv:2003.00982): directed kNN edges (each node to its k nearest) over 2D
coordinates, gaussian edge weights, node features [feat_dim - 2 noise
columns, x, y], and the eig of the sym-normalised Laplacian (not symmetric:
the kNN graph is directed).  Class c draws the coordinates from (c mod 5) + 1
clusters, gaussian blobs for c < 5 and thin rings otherwise; the classes
are balanced.  The non-symmetric eigensolves dominate (about 10 ms a
graph on one core): a split of POOL_FROM graphs or more, some seconds of
them, runs across a pool of processes."""
from __future__ import annotations

import contextlib
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import List

import numpy as np

from .graph import Graph, spread_sizes
from .spectral import graph_eig

POOL_FROM = 512
_BLAS_THREADS = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")


def superpixel(rng: np.random.Generator, n: int, label: int, knn: int,
               feat_dim: int, k_eig: int) -> Graph:
    n_clusters = (label % 5) + 1
    centers = rng.random((n_clusters, 2))
    which = rng.integers(0, n_clusters, size=n)
    if label >= 5:
        ang = rng.uniform(0.0, 2.0 * np.pi, size=n)
        rad = 0.13 + rng.normal(scale=0.012, size=n)
        off = rad[:, None] * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    else:
        off = rng.normal(scale=0.05, size=(n, 2))
    xy = (centers[which] + off).astype(np.float32)
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    k = min(knn, n - 1)
    nbr = np.argsort(d2, axis=1, kind="stable")[:, :k]
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = nbr.reshape(-1).astype(np.int32)
    sigma = np.sqrt(d2[d2 != np.inf]).mean() + 1e-8
    w = np.exp(-np.sqrt(d2[src, dst]) / sigma).astype(np.float32)
    feat = np.concatenate(
        [rng.normal(size=(n, feat_dim - 2)).astype(np.float32), xy], axis=1)
    return Graph(num_nodes=n, src=src, dst=dst, node_feat=feat,
                 eig=graph_eig(n, src, dst, k_eig, "sym"),
                 edge_feat=w[:, None], label=np.array(label, np.int32))


@contextlib.contextmanager
def _blas_threads(n: int):
    """BLAS held to n threads where threadpoolctl is installed: a
    multi-threaded BLAS that competes for the cores makes these small
    eigensolves take seconds each."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(n):
        yield


@contextlib.contextmanager
def _single_threaded_blas_children():
    """Pool workers inherit the environment: one BLAS thread each, so the
    pool does not oversubscribe the host's cores."""
    old = {k: os.environ.get(k) for k in _BLAS_THREADS}
    os.environ.update({k: "1" for k in _BLAS_THREADS})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _one(args) -> Graph:
    seed, split, i, n, label, spec = args
    return superpixel(np.random.default_rng([seed, split, i]), n, label,
                      spec["knn"], spec["feat_dim"], spec["k_eig"])


def make(spec: dict, count: int, seed: int, split: int) -> List[Graph]:
    """count graphs of spec["nodes"] = [lo, hi] superpixels; each graph
    draws from its own stream, so whether a pool runs changes nothing."""
    lo, hi = spec["nodes"]
    rng = np.random.default_rng([seed, split])
    sizes = spread_sizes(rng, count, lo, hi)
    labels = rng.permutation(np.arange(count) % spec["classes"])
    jobs = [(seed, split, i, int(n), int(c), spec)
            for i, (n, c) in enumerate(zip(sizes, labels))]
    processes = max(1, min(8, len(os.sched_getaffinity(0))))
    if count < POOL_FROM or processes == 1:
        with _blas_threads(1):
            return [_one(j) for j in jobs]
    # a worker that dies raises BrokenProcessPool here rather than hanging
    with _single_threaded_blas_children(), ProcessPoolExecutor(
            processes, mp_context=get_context("spawn")) as ex:
        return list(ex.map(_one, jobs, chunksize=16))
