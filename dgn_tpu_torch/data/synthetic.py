"""Synthetic datasets (counterpart of `dgn_tpu/data/synthetic.py`:
`synthetic_zinc`, `synthetic_sbm`, `synthetic_superpixels`,
`synthetic_ogb_mol` and `synthetic_collab`).

The same generators and numpy seed streams as the reference package, so both
produce identical graphs with learnable structure-dependent targets:
valence-bounded molecules with integer atom and bond features (a scalar for
ZINC, binary labels for ogbg-molhiv/molpcba), PATTERN-like SBM graphs with
node labels, superpixel-like kNN graphs with float node features and a
class label, and one large community graph with link-prediction splits.
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


def synthetic_sbm(num_graphs: int, seed: int = 0, n_classes: int = 2,
                  nodes: int = 80, p_in: float = 0.2, p_out: float = 0.05,
                  k_eig: int = 5, norm: str = "none",
                  n_node_types: int = 3) -> List[GraphData]:
    """PATTERN-like SBM node classification: three background blocks plus
    planted denser pattern subgraphs; a node's label is the pattern it
    belongs to (0 = background).  Node features are uninformative integer
    types, so the signal is purely structural (labelling nodes by community
    id instead would be unlearnable by symmetry)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(nodes - 20, nodes + 20))
        comm = rng.integers(0, 3, size=(n,))          # background blocks
        label = np.zeros(n, np.int32)
        psize = max(int(0.15 * n), 5)
        perm = rng.permutation(n)
        for c in range(1, n_classes):
            label[perm[(c - 1) * psize: c * psize]] = c
        same_bg = comm[:, None] == comm[None, :]
        prob = np.where(same_bg, p_in, p_out)
        for c in range(1, n_classes):
            in_pat = label == c
            pp = min(3.0 * p_in + 0.1 * (c - 1), 0.9)
            prob = np.where(in_pat[:, None] & in_pat[None, :], pp, prob)
        draw = rng.random((n, n))
        upper = np.triu(draw < prob, k=1)
        us, vs = np.nonzero(upper)
        if len(us) == 0:
            us, vs = np.array([0]), np.array([1 % n])
        src = np.concatenate([us, vs]).astype(np.int32)
        dst = np.concatenate([vs, us]).astype(np.int32)
        feat = rng.integers(0, n_node_types, size=(n,)).astype(np.int32)
        eig = spectral.graph_eig(n, src, dst, k_eig, norm)
        out.append(GraphData(num_nodes=n, src=src, dst=dst, node_feat=feat,
                             eig=eig, node_labels=label,
                             label=np.array([0.0], np.float32)))
    return out


def synthetic_superpixels(num_graphs: int, seed: int = 0, n_classes: int = 10,
                          nodes: int = 75, knn: int = 8, feat_dim: int = 5,
                          k_eig: int = 7, coord_eig: bool = False
                          ) -> List[GraphData]:
    """Superpixel-like graphs: directed kNN edges (each node to its `knn`
    nearest) over 2D coordinates, gaussian edge weights, node features
    [feat_dim - 2 noise columns, x, y].

    Class c = style * 5 + (clusters - 1) draws the coordinates from a
    mixture of (c mod 5) + 1 clusters, each a 2D gaussian blob (c < 5) or a
    thin ring (c >= 5), so every class pair differs in what the kNN graph
    expresses.  The eig field is the sym-normalised Laplacian's (the kNN
    graph is directed, so the Laplacian is not symmetric), or [0, x, y]
    with coord_eig."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(nodes - 10, nodes + 10))
        label = int(rng.integers(0, n_classes))
        n_clusters = (label % 5) + 1
        ring = label >= 5
        centers = rng.random((n_clusters, 2))
        which = rng.integers(0, n_clusters, size=n)
        if ring:
            ang = rng.uniform(0.0, 2.0 * np.pi, size=n)
            rad = 0.13 + rng.normal(scale=0.012, size=n)
            off = rad[:, None] * np.stack([np.cos(ang), np.sin(ang)], axis=1)
        else:
            off = rng.normal(scale=0.05, size=(n, 2))
        xy = (centers[which] + off).astype(np.float32)
        d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        k = min(knn, n - 1)
        nbr = np.argsort(d2, axis=1)[:, :k]
        src = np.repeat(np.arange(n, dtype=np.int32), k)
        dst = nbr.reshape(-1).astype(np.int32)
        sigma = np.sqrt(d2[d2 != np.inf]).mean() + 1e-8
        w = np.exp(-np.sqrt(d2[src, dst]) / sigma).astype(np.float32)
        feat = np.concatenate(
            [rng.normal(size=(n, feat_dim - 2)).astype(np.float32), xy], axis=1)
        if coord_eig:
            eig = np.concatenate([np.zeros((n, 1), np.float32), xy], axis=1)
        else:
            eig = spectral.graph_eig(n, src, dst, k_eig, "sym")
        out.append(GraphData(num_nodes=n, src=src, dst=dst, node_feat=feat,
                             eig=eig, edge_feat=w[:, None],
                             label=np.array(label, np.int32)))
    return out


_SCORE_PROBE = None


def _score_probe(n: int = 2048) -> np.ndarray:
    """Fixed-seed sample of the synthetic_ogb_mol score distribution:
    structure only, no eig solve, so it is cheap and computed once."""
    global _SCORE_PROBE
    if _SCORE_PROBE is None:
        rng = np.random.default_rng(123456789)
        scores = np.empty(n)
        for i in range(n):
            nn = int(rng.integers(10, 40))
            src, dst = _random_molecule_graph(rng, nn)
            atom0 = rng.integers(0, 8, size=(nn,))
            deg = np.bincount(dst, minlength=nn)
            scores[i] = deg.mean() + atom0.mean() * 0.3 + nn * 0.02
        _SCORE_PROBE = scores
    return _SCORE_PROBE


def synthetic_ogb_mol(num_graphs: int, seed: int = 0, n_tasks: int = 1,
                      k_eig: int = 4, norm: str = "none",
                      nan_frac: float = 0.0) -> List[GraphData]:
    """ogbg-mol{hiv,pcba}-like: 9-column int atom features, 3-column bond
    features, binary (or n_tasks-wide, NaN-sparse) labels from structure.

    The labels threshold each graph's score at quantiles of a large
    fixed-seed probe of the score distribution (_score_probe), not of this
    call's graphs, so the train/val/test splits share one label function and
    the single-task labels are balanced."""
    from ..models.encoders import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS
    rng = np.random.default_rng(seed)
    out = []
    scores = []
    for _ in range(num_graphs):
        n = int(rng.integers(10, 40))
        src, dst = _random_molecule_graph(rng, n)
        atom = np.stack([rng.integers(0, min(d, 8), size=(n,))
                         for d in ATOM_FEATURE_DIMS], axis=1).astype(np.int32)
        e_und = len(src) // 2
        bond_u = np.stack([rng.integers(0, min(d, 4), size=(e_und,))
                           for d in BOND_FEATURE_DIMS], axis=1)
        bond = np.concatenate([bond_u, bond_u]).astype(np.int32)
        eig = spectral.graph_eig(n, src, dst, k_eig, norm)
        deg = np.bincount(dst, minlength=n)
        scores.append(deg.mean() + atom[:, 0].mean() * 0.3 + n * 0.02)
        out.append(GraphData(num_nodes=n, src=src, dst=dst, node_feat=atom,
                             eig=eig, edge_feat=bond, label=None))
    scores = np.asarray(scores)
    probe = _score_probe()
    if n_tasks == 1:
        thr = np.quantile(probe, 0.5)[None]
    else:
        thr = np.quantile(probe, np.linspace(0.25, 0.75, n_tasks))
    for g, sc in zip(out, scores):
        label = (sc > thr).astype(np.float32)
        if n_tasks > 1 and nan_frac > 0:
            label[rng.random(n_tasks) < nan_frac] = np.nan
        g.label = label
    return out


def synthetic_collab(num_nodes: int = 400, seed: int = 0, k_eig: int = 4,
                     avg_deg: int = 8, n_communities: int = 12,
                     feat_dim: int = 8):
    """One large COLLAB-like graph for link prediction: community structure
    (so held-out intra-community edges are learnable), float node features,
    and edge splits.  Returns (GraphData, splits) where splits maps
    'train'/'valid'/'test' to positive [K, 2] edge arrays and
    'valid_neg'/'test_neg' to sampled negatives (the ogbl-collab protocol).
    The message-passing graph is the train edges, both directions.  Its
    eig is the dense eigensolve of spectral.graph_eig, whose cost grows as
    num_nodes^3."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_communities, num_nodes)
    und = set()
    target = num_nodes * avg_deg // 2
    while len(und) < target:
        if rng.random() < 0.8:     # intra-community
            c = rng.integers(0, n_communities)
            members = np.nonzero(comm == c)[0]
            if len(members) < 2:
                continue
            u, v = rng.choice(members, 2, replace=False)
        else:
            u, v = rng.integers(0, num_nodes, 2)
        if u != v:
            und.add((min(u, v), max(u, v)))
    und = np.array(sorted(und))
    rng.shuffle(und)
    n_val = n_test = max(len(und) // 10, 1)
    test_pos, val_pos, train_pos = (und[:n_test], und[n_test:n_test + n_val],
                                    und[n_test + n_val:])
    src = np.concatenate([train_pos[:, 0], train_pos[:, 1]]).astype(np.int32)
    dst = np.concatenate([train_pos[:, 1], train_pos[:, 0]]).astype(np.int32)
    feat = (np.eye(n_communities, feat_dim)[comm] * 0.5
            + rng.normal(0, 0.3, (num_nodes, feat_dim))).astype(np.float32)
    eig = spectral.graph_eig(num_nodes, src, dst, k_eig, "none")
    g = GraphData(num_nodes=num_nodes, src=src, dst=dst, node_feat=feat,
                  eig=eig, edge_feat=np.ones((len(src), 1), np.float32),
                  label=np.array([0.0], np.float32))

    def negs(n):
        e = rng.integers(0, num_nodes, (n, 2))
        return e[e[:, 0] != e[:, 1]].astype(np.int64)

    splits = dict(train=train_pos.astype(np.int64),
                  valid=val_pos.astype(np.int64),
                  test=test_pos.astype(np.int64),
                  valid_neg=negs(len(val_pos) * 4),
                  test_neg=negs(len(test_pos) * 4))
    return g, splits
