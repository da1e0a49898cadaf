"""Task model factories (counterpart of `dgn_tpu/models/__init__.py`).

Each factory pins the per-task DGNConfig defaults and pairs the net with its
masked loss.  Only ZINC is ported in this slice."""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from ..graph import GraphBatch
from ..train import losses
from .dgn_net import DGNConfig, DGNModel

LossFn = Callable[..., torch.Tensor]


def zinc_model(cfg: DGNConfig, generator: torch.Generator
               ) -> Tuple[DGNModel, LossFn]:
    """ZINC graph regression (reference molecules_graph_regression/
    dgn_net.py): atom-type Embedding input, L1 loss."""
    cfg = dataclasses.replace(cfg, node_encoder="embedding",
                              edge_encoder="embedding", n_out=1)

    def loss(scores, gb: GraphBatch):
        return losses.l1_loss(scores, gb.labels, gb.graph_mask)

    return DGNModel(cfg, generator), loss


MODEL_FACTORIES = {"zinc": zinc_model}

__all__ = ["DGNConfig", "DGNModel", "zinc_model", "MODEL_FACTORIES"]
