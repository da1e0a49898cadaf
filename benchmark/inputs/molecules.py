"""ZINC-like molecules (frozen copy of the port's synthetic ZINC generator
at the dataset's published statistics, Dwivedi et al. arXiv:2003.00982):
connected valence-capped graphs (degree at most 4, about 12 % ring-closing
edges), both directions of every bond, integer atom types and bond types,
a regression target that mixes algebraic connectivity, mean degree and
atom composition, and the combinatorial Laplacian's first k_eig
eigenvectors."""
from __future__ import annotations

from typing import List

import numpy as np

from .graph import Graph, spread_sizes
from .spectral import graph_eig, laplacian


def molecule_edges(rng: np.random.Generator, n: int, max_degree: int = 4):
    deg = np.zeros(n, np.int32)
    edges = set()
    for v in range(1, n):
        cands = np.nonzero(deg[:v] < max_degree)[0]
        u = int(rng.choice(cands)) if len(cands) else int(rng.integers(0, v))
        edges.add((u, v))
        deg[u] += 1
        deg[v] += 1
    for _ in range(int(n * 0.12)):
        u, v = (int(x) for x in rng.integers(0, n, 2))
        key = (min(u, v), max(u, v))
        if u != v and key not in edges \
                and deg[u] < max_degree and deg[v] < max_degree:
            edges.add(key)
            deg[u] += 1
            deg[v] += 1
    und = sorted(edges)
    src = np.array([u for u, v in und] + [v for u, v in und], np.int32)
    dst = np.array([v for u, v in und] + [u for u, v in und], np.int32)
    return src, dst


def molecule(rng: np.random.Generator, n: int, atom_types: int,
             bond_types: int, k_eig: int) -> Graph:
    src, dst = molecule_edges(rng, n)
    atom = rng.integers(0, atom_types, size=(n,)).astype(np.int32)
    bond_und = rng.integers(1, bond_types, size=(len(src) // 2,))
    bond = np.concatenate([bond_und, bond_und]).astype(np.int32)
    deg = np.bincount(dst, minlength=n)
    lam = np.sort(np.linalg.eigvalsh(laplacian(n, src, dst, "sym")))
    target = (lam[1] * 2.0 + deg.mean() * 0.5 + (atom < 5).mean()
              - 0.1 * n / 20.0)
    return Graph(num_nodes=n, src=src, dst=dst, node_feat=atom,
                 eig=graph_eig(n, src, dst, k_eig, "none"), edge_feat=bond,
                 label=np.array([target], np.float32))


def make(spec: dict, count: int, seed: int, split: int) -> List[Graph]:
    """count molecules of spec["nodes"] = [lo, hi] atoms."""
    lo, hi = spec["nodes"]
    sizes = spread_sizes(np.random.default_rng([seed, split]), count, lo, hi)
    return [molecule(np.random.default_rng([seed, split, i]), int(n),
                     spec["atom_types"], spec["bond_types"], spec["k_eig"])
            for i, n in enumerate(sizes)]
