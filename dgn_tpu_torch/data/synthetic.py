"""Synthetic ZINC-like molecules (counterpart of
`dgn_tpu/data/synthetic.py:synthetic_zinc`).

The same generator and numpy seed stream as the reference package, so both
produce identical graphs: 9..37 atoms, integer atom/bond types, valence-
bounded sparse structure, and a learnable structure-dependent scalar target.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .. import spectral
from ..graph import GraphData


def _random_molecule_graph(rng: np.random.Generator, n: int,
                           max_degree: int = 4):
    """Connected sparse graph, avg degree ~2.2, max degree capped at 4; both
    edge directions emitted."""
    deg = np.zeros(n, np.int32)
    edges = set()
    for v in range(1, n):
        cands = np.nonzero(deg[:v] < max_degree)[0]
        u = int(rng.choice(cands)) if len(cands) else int(rng.integers(0, v))
        edges.add((u, v))
        deg[u] += 1
        deg[v] += 1
    extra = max(0, int(n * 0.12))
    for _ in range(extra):
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


def synthetic_zinc(num_graphs: int, seed: int = 0,
                   num_atom_type: int = 28, num_bond_type: int = 4,
                   k_eig: int = 6, norm: str = "none") -> List[GraphData]:
    """ZINC-like molecules; target mixes algebraic connectivity, mean degree
    and atom composition."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(9, 38))
        src, dst = _random_molecule_graph(rng, n)
        atom = rng.integers(0, num_atom_type, size=(n,)).astype(np.int32)
        bond_und = rng.integers(1, num_bond_type, size=(len(src) // 2,))
        bond = np.concatenate([bond_und, bond_und]).astype(np.int32)
        eig = spectral.graph_eig(n, src, dst, k_eig, norm)
        deg = np.bincount(dst, minlength=n)
        L = spectral.laplacian(n, src, dst, "sym")
        lam = np.sort(np.linalg.eigvalsh(L))
        target = (lam[1] * 2.0 + deg.mean() * 0.5
                  + (atom < 5).mean() - 0.1 * n / 20.0)
        out.append(GraphData(num_nodes=n, src=src, dst=dst, node_feat=atom,
                             eig=eig, edge_feat=bond,
                             label=np.array([target], np.float32)))
    return out
