"""The dense [B, N, N] research path (counterpart of `dgn_tpu/dense/`):
runtime Laplacian eigenvectors with connected-component handling, the
gradient adjacencies, the dense aggregator registry, the five scalers and
the dense DGN tower and layer.  For small padded graphs; no config or
training path of the package uses it."""
from .spectral import (EPS, laplacian, component_labels, k_lowest_eigvecs,
                       grad_adjacency, eig_adjacency, aggregate_sum,
                       aggregate_eigs)
from .aggregators import AGGREGATORS, aggregate as dense_aggregate
from .scalers import SCALERS, apply_scaler
from .dgn_layer import DenseDGNTower, DenseDGNLayer

__all__ = [
    "EPS", "laplacian", "component_labels", "k_lowest_eigvecs",
    "grad_adjacency", "eig_adjacency", "aggregate_sum", "aggregate_eigs",
    "AGGREGATORS", "dense_aggregate", "SCALERS", "apply_scaler",
    "DenseDGNTower", "DenseDGNLayer",
]
