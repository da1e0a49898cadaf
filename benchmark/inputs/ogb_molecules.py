"""ogbg-molpcba-like molecules (frozen copy of the port's synthetic OGB
molecule generator at the dataset's statistics: Hu et al.,
arXiv:2005.00687, ogbg-molpcba, 26.0 atoms and 28.1 bonds a graph, 128
binary tasks): the valence-capped construction of molecules.py (degree at
most 4, about 12 % ring-closing edges: about 28 bonds at 26 atoms), both
directions of every bond stored, 9 integer atom columns and 3 integer bond
columns in OGB's order, the combinatorial Laplacian's first k_eig
eigenvectors, and tasks labels from the graph's structure with a share of
them missing (NaN), as ogbg-molpcba leaves most (graph, task) entries
unlabeled.

Assumed, not published: the feature values, each column drawn uniformly
below min(its OGB table size, atom_values or bond_values) (the real ones
are skewed: most atoms are carbon); the label function (task t thresholds
the score mean degree + 0.3 x mean of atom column 0 + 0.02 x atoms at the
(0.25 + 0.5 t / (tasks - 1)) quantile of a fixed probe of that score, so
every split and seed shares one function); the missing share (nan_share,
each entry alone); the size distribution (uniform over nodes = [lo, hi],
every seed the same multiset in a seeded order, as molecules.py)."""
from __future__ import annotations

import functools
from typing import List

import numpy as np

from .graph import Graph, spread_sizes
from .molecules import molecule_edges
from .spectral import graph_eig

# OGB's full_atom_feature_dims and full_bond_feature_dims (ogb.utils.features)
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)
PROBE_GRAPHS = 1024
PROBE_SEED = 123456789


def _score(src, dst, n: int, atom0: np.ndarray) -> float:
    deg = np.bincount(dst, minlength=n)
    return float(deg.mean() + atom0.mean() * 0.3 + n * 0.02)


@functools.lru_cache(maxsize=None)
def thresholds(lo: int, hi: int, atom_values: int, tasks: int) -> np.ndarray:
    """[tasks] score thresholds at quantiles of a fixed-seed probe of
    PROBE_GRAPHS structures (no eigensolve) over lo..hi atoms."""
    rng = np.random.default_rng(PROBE_SEED)
    scores = np.empty(PROBE_GRAPHS)
    for i in range(PROBE_GRAPHS):
        n = int(rng.integers(lo, hi + 1))
        src, dst = molecule_edges(rng, n)
        atom0 = rng.integers(0, min(ATOM_FEATURE_DIMS[0], atom_values), n)
        scores[i] = _score(src, dst, n, atom0)
    q = np.linspace(0.25, 0.75, tasks) if tasks > 1 else np.array([0.5])
    return np.quantile(scores, q)


def molecule(rng: np.random.Generator, n: int, spec: dict,
             thr: np.ndarray) -> Graph:
    src, dst = molecule_edges(rng, n)
    atom = np.stack([rng.integers(0, min(d, spec["atom_values"]), size=(n,))
                     for d in ATOM_FEATURE_DIMS], axis=1).astype(np.int32)
    e_und = len(src) // 2
    bond_und = np.stack([rng.integers(0, min(d, spec["bond_values"]),
                                      size=(e_und,))
                         for d in BOND_FEATURE_DIMS], axis=1)
    bond = np.concatenate([bond_und, bond_und]).astype(np.int32)
    label = (_score(src, dst, n, atom[:, 0]) > thr).astype(np.float32)
    label[rng.random(len(thr)) < spec["nan_share"]] = np.nan
    return Graph(num_nodes=n, src=src, dst=dst, node_feat=atom,
                 eig=graph_eig(n, src, dst, spec["k_eig"], "none"),
                 edge_feat=bond, label=label)


def make(spec: dict, count: int, seed: int, split: int) -> List[Graph]:
    """count molecules of spec["nodes"] = [lo, hi] atoms."""
    lo, hi = spec["nodes"]
    thr = thresholds(lo, hi, spec["atom_values"], spec["tasks"])
    sizes = spread_sizes(np.random.default_rng([seed, split]), count, lo, hi)
    return [molecule(np.random.default_rng([seed, split, i]), int(n), spec,
                     thr)
            for i, n in enumerate(sizes)]
