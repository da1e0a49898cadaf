"""One generated graph, in plain numpy (the harness hands its fields to
the program's own graph type)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    num_nodes: int
    src: np.ndarray                 # [e] int32, edge u -> v
    dst: np.ndarray                 # [e] int32
    node_feat: np.ndarray           # [n] int32 types or [n, F] float32
    eig: np.ndarray                 # [n, k] float32 Laplacian eigenvectors
    edge_feat: Optional[np.ndarray]
    label: np.ndarray               # the graph's target or class


def spread_sizes(rng: np.random.Generator, count: int, lo: int,
                 hi: int) -> np.ndarray:
    """count node counts spread evenly over lo..hi (both included), in an
    order drawn from rng: every seed gets the same multiset of sizes, so
    the seed changes which graphs a batch holds, not the work."""
    span = hi - lo + 1
    sizes = lo + (np.arange(count) * span) // max(count, 1)
    return rng.permutation(sizes)
