"""Task model factories (counterpart of `dgn_tpu/models/__init__.py`).

Each factory pins the per-task DGNConfig defaults and pairs the net with its
masked loss: ZINC (L1), SBM PATTERN/CLUSTER (class-weighted CE per node),
MNIST/CIFAR10 superpixels (CE), ogbg-molhiv (BCE with logits) and
ogbg-molpcba (NaN-masked 128-task BCE).  pos_enc_in is the width of the
positional encoding when cfg.pos_enc_dim > 0 (DGNModel)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..graph import GraphBatch
from ..train import losses
from .dgn_net import DGNConfig, DGNModel

LossFn = Callable[..., torch.Tensor]


def zinc_model(cfg: DGNConfig, generator: torch.Generator,
               pos_enc_in: Optional[int] = None) -> Tuple[DGNModel, LossFn]:
    """ZINC graph regression (reference molecules_graph_regression/
    dgn_net.py): atom-type Embedding input, L1 loss."""
    cfg = dataclasses.replace(cfg, node_encoder="embedding",
                              edge_encoder="embedding", n_out=1)

    def loss(scores, gb: GraphBatch):
        return losses.l1_loss(scores, gb.labels, gb.graph_mask)

    return DGNModel(cfg, generator, pos_enc_in=pos_enc_in), loss


def sbm_model(cfg: DGNConfig, n_classes: int, generator: torch.Generator,
              pos_enc_in: Optional[int] = None) -> Tuple[DGNModel, LossFn]:
    """SBM PATTERN/CLUSTER node classification (reference
    SBMs_node_classification/dgn_net.py): atom-type Embedding input, a
    per-node head, class-weighted CE."""
    cfg = dataclasses.replace(cfg, node_encoder="embedding", readout="node",
                              n_out=n_classes)

    def loss(logits, gb: GraphBatch):
        return losses.weighted_cross_entropy_sbm(
            logits, gb.node_labels, gb.node_mask, n_classes)

    return DGNModel(cfg, generator, pos_enc_in=pos_enc_in), loss


def superpixels_model(cfg: DGNConfig, n_classes: int, in_dim: int,
                      generator: torch.Generator,
                      pos_enc_in: Optional[int] = None, edge_in: int = 1
                      ) -> Tuple[DGNModel, LossFn]:
    """MNIST/CIFAR10 superpixels (reference
    superpixels_graph_classification/dgn_net.py): a Linear over the in_dim
    float node features (and, with edge_feat, one over the edge_in float
    edge features), the config's graph readout, CE."""
    cfg = dataclasses.replace(cfg, node_encoder="linear",
                              edge_encoder="linear", n_out=n_classes)

    def loss(logits, gb: GraphBatch):
        labels = gb.labels.squeeze(-1) if gb.labels.ndim > 1 else gb.labels
        return losses.cross_entropy(logits, labels, gb.graph_mask)

    return DGNModel(cfg, generator, in_dim=in_dim, pos_enc_in=pos_enc_in,
                    edge_in=edge_in), loss


def hiv_model(cfg: DGNConfig, generator: torch.Generator,
              pos_enc_in: Optional[int] = None) -> Tuple[DGNModel, LossFn]:
    """ogbg-molhiv (reference HIV_graph_classification/dgn_net.py):
    AtomEncoder input, one logit, BCE with logits."""
    cfg = dataclasses.replace(cfg, node_encoder="atom", edge_encoder="bond",
                              n_out=1)

    def loss(scores, gb: GraphBatch):
        labels = gb.labels.squeeze(-1) if gb.labels.ndim > 1 else gb.labels
        return losses.bce_with_logits(scores, labels.float(), gb.graph_mask)

    return DGNModel(cfg, generator, pos_enc_in=pos_enc_in), loss


def pcba_model(cfg: DGNConfig, generator: torch.Generator,
               pos_enc_in: Optional[int] = None) -> Tuple[DGNModel, LossFn]:
    """ogbg-molpcba 128-task (reference PCBA_graph_classification/
    dgn_net.py): AtomEncoder input, NaN-masked multi-task BCE."""
    cfg = dataclasses.replace(cfg, node_encoder="atom", edge_encoder="bond",
                              n_out=128)

    def loss(scores, gb: GraphBatch):
        return losses.masked_bce_multitask(scores, gb.labels, gb.graph_mask)

    return DGNModel(cfg, generator, pos_enc_in=pos_enc_in), loss


MODEL_FACTORIES = {"zinc": zinc_model, "sbm": sbm_model,
                   "superpixels": superpixels_model, "hiv": hiv_model,
                   "pcba": pcba_model}

__all__ = ["DGNConfig", "DGNModel", "zinc_model", "sbm_model",
           "superpixels_model", "hiv_model", "pcba_model", "MODEL_FACTORIES"]
