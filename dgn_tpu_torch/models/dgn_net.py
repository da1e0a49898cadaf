"""The DGN task network (counterpart of `dgn_tpu/models/dgn_net.py`).

Structure: atom-type embedding -> L complex DGN layers ((L-1) at hidden_dim,
the last at out_dim; reference molecules dgn_net.py:40-50) -> mean readout
-> MLPReadout.  The batch-constant EdgeContext (eig deltas, weight families,
adjacency blocks) is built once per forward pass, or reused when the batch
arrives with one attached (the trainer's eval cache).

`DGNConfig` keeps the reference's full field set so the same JSON configs
load; `DGNModel` raises NotImplementedError for any value this slice does
not cover instead of silently running something else.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..graph import GraphBatch
from ..layers.dgn import DGNLayerComplex
from ..nn import Embedding, MLPReadout
from ..ops import aggregators as agg_ops
from ..ops import scalers as scaler_ops
from .readout import graph_readout


@dataclasses.dataclass(frozen=True)
class DGNConfig:
    """net_params, typed (reference configs/*.json net_params)."""
    hidden_dim: int = 45
    out_dim: int = 45
    L: int = 4
    type_net: str = "complex"             # simple | complex | towers
    aggregators: str = "mean dir1-dx dir1-av"
    scalers: str = "identity amplification attenuation"
    avg_d: Optional[dict] = None          # filled from train degree stats
    residual: bool = True
    edge_feat: bool = False
    edge_dim: int = 0
    readout: str = "mean"
    in_feat_dropout: float = 0.0
    dropout: float = 0.0
    graph_norm: bool = True
    batch_norm: bool = True
    towers: int = 5
    divide_input: bool = True
    divide_input_last: Optional[bool] = None
    pretrans_layers: int = 1
    posttrans_layers: int = 1
    pos_enc_dim: int = 0
    node_encoder: str = "embedding"       # embedding | linear | atom
    num_node_types: int = 28
    edge_encoder: str = "embedding"
    num_edge_types: int = 4
    n_out: int = 1
    decreasing_dim: bool = True
    readout_L: int = 2
    virtual_node: str = "none"
    bn_axis: Optional[str] = None
    compute_dtype: Optional[str] = None
    decompose: bool = True

    def agg_names(self) -> Tuple[str, ...]:
        return tuple(agg_ops.parse_names(self.aggregators))

    def scaler_names(self) -> Tuple[str, ...]:
        return tuple(scaler_ops.parse_names(self.scalers))


def check_ported(cfg: DGNConfig) -> None:
    """Raise NotImplementedError for a configuration this slice lacks."""
    wanted = dict(type_net="complex", edge_feat=False, node_encoder="embedding",
                  pretrans_layers=1, posttrans_layers=1, pos_enc_dim=0,
                  in_feat_dropout=0.0, dropout=0.0, bn_axis=None,
                  compute_dtype=None, decompose=True)
    for name, value in wanted.items():
        if getattr(cfg, name) != value:
            raise NotImplementedError(
                f"DGNConfig.{name}={getattr(cfg, name)!r} is not ported yet "
                f"(this slice runs {name}={value!r})")
    if cfg.virtual_node and cfg.virtual_node.lower() != "none":
        raise NotImplementedError("the virtual node is not ported yet")
    if cfg.readout not in ("mean", "default"):
        raise NotImplementedError(f"readout {cfg.readout!r} is not ported yet")
    agg_ops.check_ported(cfg.agg_names())


def edge_context_for(gb: GraphBatch, cfg: DGNConfig) -> agg_ops.EdgeContext:
    """The EdgeContext DGNModel attaches.  It depends only on (eig, edges,
    layout), not on the parameters, so fixed batches can reuse it."""
    return agg_ops.build_edge_context(
        gb.eig, gb.src, gb.dst, gb.edge_mask, gb.in_degree,
        names=cfg.agg_names(), mxu_layout=gb.mxu, decomposed=True)


class DGNModel(nn.Module):
    """Embedding -> L x DGNLayerComplex -> mean readout -> MLPReadout.

    Children carry the reference's parameter names (embedding_h, layer_i,
    MLP_layer) so convert.load_jax_params maps one tree onto the other."""

    def __init__(self, cfg: DGNConfig, generator: torch.Generator):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        avg_d = cfg.avg_d or {"log": 1.0, "lin": 1.0}
        self.embedding_h = Embedding(cfg.num_node_types, cfg.hidden_dim,
                                     generator)
        in_dim = cfg.hidden_dim
        for i in range(cfg.L):
            out_dim = cfg.out_dim if i == cfg.L - 1 else cfg.hidden_dim
            self.add_module(f"layer_{i}", DGNLayerComplex(
                in_dim, out_dim, cfg.agg_names(), cfg.scaler_names(), avg_d,
                generator, graph_norm=cfg.graph_norm,
                batch_norm=cfg.batch_norm, residual=cfg.residual))
            in_dim = out_dim
        self.MLP_layer = MLPReadout(in_dim, cfg.n_out, generator,
                                    L=cfg.readout_L,
                                    decreasing_dim=cfg.decreasing_dim)

    def forward(self, gb: GraphBatch) -> torch.Tensor:
        """[G, n_out] scores.  Batch norm follows self.training."""
        if gb.edge_ctx is None:
            gb = dataclasses.replace(gb, edge_ctx=edge_context_for(gb, self.cfg))
        h = self.embedding_h(gb.node_feat)
        for i in range(self.cfg.L):
            h = getattr(self, f"layer_{i}")(gb, h)
        return self.MLP_layer(graph_readout(gb, h, self.cfg.readout))
