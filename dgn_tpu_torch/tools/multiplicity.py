"""Eigenvalue-multiplicity analysis: how often are direction fields
degenerate?  (Counterpart of `dgn_tpu/tools/multiplicity.py`, on this
package's datasets and spectral module.)

Near-equal low eigenvalues mean the eigenvector directions are arbitrary
within the degenerate subspace, a known DGN failure mode that the field
augmentations mitigate (reference realworld_benchmark/data/
multiplicity_eig.py).

Usage:
  python -m dgn_tpu_torch.tools.multiplicity --dataset ZINC [--first 1
      --second 2] [--tol 1e-3] [--lap_norm none] [--synthetic_size 256]

Prints, as one JSON line, the fraction of graphs whose chosen eigenvalues
are separated by more than tol (higher = fewer degenerate fields) and the
percentiles of the gap.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import scipy.linalg

from .. import spectral
from ..config import DataParams
from ..data.datasets import load_dataset


def eigvals_of(graph, k: int, norm: str) -> np.ndarray:
    """The k lowest Laplacian eigenvalues of a graph (real parts, ascending,
    for the non-symmetric walk Laplacian)."""
    L = spectral.laplacian(graph.num_nodes, graph.src, graph.dst, norm)
    vals = scipy.linalg.eigvalsh(L) if np.allclose(L, L.T) else \
        np.sort(np.real(scipy.linalg.eigvals(L)))
    return vals[:k]


def multiplicity(graphs, first: int = 1, second: int = 2, tol: float = 1e-3,
                 norm: str = "none"):
    """Fraction of graphs with |lambda_first - lambda_second| > tol
    (reference multiplicity_eig.py:30-55) and the gap distribution; a graph
    with too few eigenvalues counts as a gap of 0."""
    k = max(first, second) + 1
    gaps = []
    for g in graphs:
        vals = eigvals_of(g, k, norm)
        gaps.append(0.0 if len(vals) <= max(first, second)
                    else abs(float(vals[first] - vals[second])))
    gaps = np.asarray(gaps)
    distinct = int((gaps > tol).sum())
    return {
        "fraction_distinct": distinct / len(gaps) if len(gaps) else 1.0,
        "n_distinct": distinct,
        "n_graphs": len(gaps),
        "gap_percentiles": {p: float(np.percentile(gaps, p))
                            for p in (5, 25, 50, 75, 95)} if len(gaps) else {},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="eigenvalue multiplicity")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--second", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--lap_norm", default="none")
    ap.add_argument("--data_dir", default="")
    ap.add_argument("--synthetic_size", type=int, default=256)
    args = ap.parse_args(argv)
    ds = load_dataset(args.dataset,
                      DataParams(data_dir=args.data_dir,
                                 lap_norm=args.lap_norm,
                                 synthetic_size=args.synthetic_size))
    out = multiplicity(ds.train + ds.val + ds.test, args.first, args.second,
                       args.tol, args.lap_norm)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
