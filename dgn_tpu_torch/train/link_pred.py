"""Link prediction (ogbl-collab style): DGN node embeddings and an edge
predictor (counterpart of `dgn_tpu/train/link_pred.py`).

One large graph, batches of positive edges with uniform negatives drawn
from the real nodes, BCE on the edge scores, and Hits@{10, 50, 100} against
fixed negative sets (reference train/train_COLLAB_edge_classification.py:
44-52, 115-145), with the optional rotation of the eig field (:31-38).
Each train step embeds the whole graph once in train mode (batch norm over
all its real nodes), scores the positive and the negative batch from those
embeddings and takes one Adam(+L2) step.

Random streams.  dgn_tpu draws each step's rotation, negatives and dropout
from one JAX key, and those streams cannot match across frameworks.  Here
they come from three torch.Generators on the trainer's device, seeded from
params.seed: dropout from the seed itself, as the Trainer's, rotation and
negatives from two streams of their own.  `train_step` takes the
negatives and the rotation draws from the caller instead, so the same
draws can go through both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph import GraphBatch
from ..nn import Linear
from ..ops import field
from . import metrics as M
from .optim import ReduceLROnPlateau, adam_l2, set_learning_rate
from .trainer import TrainParams


class EdgePredictor(nn.Module):
    """score(u, v) = MLP(h_u * h_v): `layers` Linears (Linear_0 ..), ReLU
    between them, the last of width 1 (the OGB link-prediction
    convention)."""

    def __init__(self, hidden: int, generator: torch.Generator,
                 layers: int = 3):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"Linear_{i}", Linear(
                hidden, 1 if i == layers - 1 else hidden, generator))

    def forward(self, h_u: torch.Tensor, h_v: torch.Tensor) -> torch.Tensor:
        x = h_u * h_v
        for i in range(self.layers - 1):
            x = torch.relu(getattr(self, f"Linear_{i}")(x))
        return getattr(self, f"Linear_{self.layers - 1}")(x)[..., 0]


class LinkPredModel(nn.Module):
    """A DGN backbone with readout "none" and the edge predictor head."""

    def __init__(self, backbone: nn.Module, hidden: int,
                 generator: torch.Generator):
        super().__init__()
        self.backbone = backbone
        self.predictor = EdgePredictor(hidden, generator)

    def embed(self, gb: GraphBatch,
              dropout_generator: Optional[torch.Generator] = None
              ) -> torch.Tensor:
        return self.backbone(gb, dropout_generator)

    forward = embed

    def predict(self, h: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        return self.predictor(h.index_select(0, u), h.index_select(0, v))


def link_bce_loss(pos_scores: torch.Tensor,
                  neg_scores: torch.Tensor) -> torch.Tensor:
    """mean(-log sigma(pos)) + mean(-log(1 - sigma(neg))) (the reference
    model.loss)."""
    return (-F.logsigmoid(pos_scores)).mean() \
        + (-F.logsigmoid(-neg_scores)).mean()


class LinkPredTrainer:
    """Epoch driver for one-big-graph link prediction on `device`."""

    def __init__(self, model: LinkPredModel, params: TrainParams,
                 edge_batch: int = 4096, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.p = params
        self.edge_batch = edge_batch
        self.optimizer = adam_l2(self.model.parameters(), params.init_lr,
                                 params.weight_decay)
        self.scheduler = ReduceLROnPlateau(
            lr=params.init_lr, factor=params.lr_reduce_factor,
            patience=params.lr_schedule_patience, min_lr=params.min_lr)
        aug_seed, neg_seed = (int(s.generate_state(1)[0]) for s in
                              np.random.SeedSequence(params.seed).spawn(2))
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(params.seed)
        self.aug_generator = torch.Generator(
            device=self.device).manual_seed(aug_seed)
        self.neg_generator = torch.Generator(
            device=self.device).manual_seed(neg_seed)

    def train_step(self, gb: GraphBatch, pos_edges: torch.Tensor,
                   neg_edges: Optional[torch.Tensor] = None,
                   aug: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """One Adam step at the scheduler's lr on the [B, 2] positive edges;
        returns the detached loss and (positive, negative) scores.

        neg_edges: [B, 2] negatives, else drawn uniformly from the real
        nodes [0, real_node_count) (pack_graphs places them first; padded
        slots would be trivially separable).  aug: the [N] uniforms of the
        eig rotation when params.augmentation > 1e-7, else drawn."""
        gb = gb.to(self.device)
        pos_edges = pos_edges.to(self.device)
        self.model.train()
        set_learning_rate(self.optimizer, self.scheduler.lr)
        self.optimizer.zero_grad(set_to_none=True)
        if self.p.augmentation > 1e-7:
            if aug is None:
                aug = torch.rand(gb.num_nodes_padded,
                                 generator=self.aug_generator,
                                 device=self.device)
            gb = dataclasses.replace(
                gb, eig=field.rotate_field(gb.eig, aug.to(self.device),
                                           self.p.augmentation),
                edge_ctx=None)
        elif aug is not None:
            raise ValueError("rotation draws for params that do not rotate")
        if neg_edges is None:
            neg_edges = torch.randint(
                0, int(gb.real_node_count()), tuple(pos_edges.shape),
                generator=self.neg_generator, device=self.device)
        neg_edges = neg_edges.to(self.device)
        h = self.model.embed(gb, self.dropout_generator)
        pos = self.model.predict(h, pos_edges[:, 0], pos_edges[:, 1])
        neg = self.model.predict(h, neg_edges[:, 0], neg_edges[:, 1])
        loss = link_bce_loss(pos, neg)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), (pos.detach(), neg.detach())

    def train_epoch(self, gb: GraphBatch, train_edges: np.ndarray,
                    epoch: int) -> float:
        """One pass over the train edges in fixed-size batches, in the
        order dgn_tpu draws (default_rng(seed * 7919 + epoch)); the last
        short batch is filled from the head of the order.  Returns the
        mean loss."""
        rng = np.random.default_rng(self.p.seed * 7919 + epoch)
        order = rng.permutation(len(train_edges))
        bs = self.edge_batch
        losses = []
        for i in range(max(len(order) // bs, 1)):
            sel = order[i * bs:(i + 1) * bs]
            if len(sel) < bs:
                sel = np.concatenate([sel, order[: bs - len(sel)]])
            batch = torch.as_tensor(train_edges[sel], dtype=torch.int64)
            loss, _ = self.train_step(gb, batch)
            losses.append(float(loss))
        return float(np.mean(losses))

    @torch.no_grad()
    def evaluate(self, gb: GraphBatch, pos_edges: np.ndarray,
                 neg_edges: np.ndarray, ks=(10, 50, 100)) -> Dict[str, float]:
        """Hits@K of the [K, 2] positive edges against the negatives, from
        one eval-mode embedding."""
        self.model.eval()
        h = self.model.embed(gb.to(self.device))

        def score(edges):
            e = torch.as_tensor(edges, dtype=torch.int64, device=self.device)
            return self.model.predict(h, e[:, 0], e[:, 1]).cpu().numpy()

        pos, neg = score(pos_edges), score(neg_edges)
        return {f"hits@{k}": M.hits_at_k(pos, neg, k) for k in ks}


def collab_model(cfg, in_dim: int, generator: torch.Generator,
                 pos_enc_in: Optional[int] = None) -> LinkPredModel:
    """The DGN backbone with raw node-embedding output (readout "none") and
    the predictor head at the backbone's out_dim."""
    from ..models.dgn_net import DGNModel
    cfg = dataclasses.replace(cfg, readout="none")
    backbone = DGNModel(cfg, generator, in_dim=in_dim, pos_enc_in=pos_enc_in)
    return LinkPredModel(backbone, cfg.out_dim, generator)
