"""Task model factories (counterpart of `dgn_tpu/models/__init__.py`).

Each factory pins the per-task DGNConfig defaults and pairs the net with its
masked loss: ZINC (L1), ogbg-molhiv (BCE with logits) and ogbg-molpcba
(NaN-masked 128-task BCE).  SBM and superpixels are not ported yet."""
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


def hiv_model(cfg: DGNConfig, generator: torch.Generator
              ) -> Tuple[DGNModel, LossFn]:
    """ogbg-molhiv (reference HIV_graph_classification/dgn_net.py):
    AtomEncoder input, one logit, BCE with logits."""
    cfg = dataclasses.replace(cfg, node_encoder="atom", edge_encoder="bond",
                              n_out=1)

    def loss(scores, gb: GraphBatch):
        labels = gb.labels.squeeze(-1) if gb.labels.ndim > 1 else gb.labels
        return losses.bce_with_logits(scores, labels.float(), gb.graph_mask)

    return DGNModel(cfg, generator), loss


def pcba_model(cfg: DGNConfig, generator: torch.Generator
               ) -> Tuple[DGNModel, LossFn]:
    """ogbg-molpcba 128-task (reference PCBA_graph_classification/
    dgn_net.py): AtomEncoder input, NaN-masked multi-task BCE."""
    cfg = dataclasses.replace(cfg, node_encoder="atom", edge_encoder="bond",
                              n_out=128)

    def loss(scores, gb: GraphBatch):
        return losses.masked_bce_multitask(scores, gb.labels, gb.graph_mask)

    return DGNModel(cfg, generator), loss


MODEL_FACTORIES = {"zinc": zinc_model, "hiv": hiv_model, "pcba": pcba_model}

__all__ = ["DGNConfig", "DGNModel", "zinc_model", "hiv_model", "pcba_model",
           "MODEL_FACTORIES"]
