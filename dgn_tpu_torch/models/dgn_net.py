"""The DGN task network (counterpart of `dgn_tpu/models/dgn_net.py`).

Structure: node encoder (atom-type Embedding for ZINC and SBM, the OGB
AtomEncoder for HIV/PCBA, a Linear over float features for superpixels) ->
input dropout (in_feat_dropout) -> + Linear(positional encoding) when
pos_enc_dim > 0 -> L simple, complex or towers DGN layers ((L-1) at
hidden_dim, the last at out_dim; reference molecules dgn_net.py:40-50),
each ending in dropout, with the virtual node after each but the last when
virtual_node is set (PCBA dgn_net.py:78-83) -> graph readout (mean, sum,
max, directional, directional_abs) -> MLPReadout per graph, MLPReadout
per node (readout "node", SBM), or the node embeddings themselves (readout
"none", the link-prediction backbone of train/link_pred.py, with no
MLP_layer).  The batch-constant EdgeContext (eig
deltas, weight families, adjacency blocks) is built once per forward pass,
from the batch's eig as it arrives (augmented in training), or reused when
the batch arrives with one attached (the trainer's eval cache).  It is
decomposed when cfg.decompose and the pretrans is linear (the simple layer
has none); otherwise it holds the eig deltas (and on the flat layout the
directional normalizers), every layer takes the per-edge message path and
no adjacency is built.  The flat layout (gb.mxu None) builds no adjacency
at all.

With edge_feat, the edge encoder embeds gb.edge_feat once per forward pass
and every layer gets the embedding e: `embedding` (ZINC bond types, an
Embedding of num_edge_types rows), `linear` (superpixels, a Linear over the
float feature, of width edge_in) or `bond` (HIV/PCBA, the OGB BondEncoder),
each edge_dim wide.  The entry point sets edge_dim to hidden_dim for ZINC
and superpixels when the config leaves it 0, as dgn_tpu/run.py does; for
HIV/PCBA it stays the config's 0 unless --edge_dim is given, and the bond
encoder then yields a zero-width e, as in dgn_tpu.

The positional encoding is the batch's `pos_enc` where it carries one
(ZINC stores eig[:, 1:P+1] of the loaded, unaugmented eig), else
eig[:, 1:P+1] of the batch.  Its Linear takes the width that slice has,
min(P, k_eig - 1); flax infers it, here the caller passes it (pos_enc_in).

compute_dtype "bfloat16" or "float16" (`--compute_dtype`) rounds the block
layout's edge stage as dgn_tpu does: the adjacency blocks are built in that
dtype (the CUDA kernel's bf16 or f16 output mode on the card) and every
layer's products, gathers and scatters take operands rounded to it with
float32 accumulation (ops/mxu.py).  None and "float32" run float32
throughout; the flat layout rounds nothing.

`DGNConfig` keeps the reference's full field set so the same JSON configs
load; `DGNModel` raises ValueError for a compute_dtype it does not know
instead of silently running something else.  bn_axis ("dp", "ep") makes every batch norm a sync batch norm over
the ranks of the mesh that nn.bind_mesh gives the model (parallel/dp.py,
parallel/halo.py).  On an edge-partitioned rank's batch (gb.halo) the
halo rows are refreshed before each layer unless the layer pulls them
itself (dgn_tpu/models/dgn_net.py:167-186), and the readouts combine the
ranks' partial pools (models/readout.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..graph import GraphBatch, halo_refresh
from ..layers.dgn import VirtualNode, ep_fused_layout, make_dgn_layer
from ..nn import Embedding, Linear, MLPReadout, dropout
from ..ops import aggregators as agg_ops
from ..ops import scalers as scaler_ops
from .encoders import AtomEncoder, BondEncoder
from .readout import graph_readout

# the low-precision compute dtypes, as a config names them
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


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

    def torch_compute_dtype(self) -> Optional[torch.dtype]:
        """compute_dtype as the layers take it: torch.bfloat16,
        torch.float16, or None for float32 (None or "float32", which round
        nothing)."""
        if self.compute_dtype in (None, "float32"):
            return None
        if self.compute_dtype in COMPUTE_DTYPES:
            return COMPUTE_DTYPES[self.compute_dtype]
        raise ValueError(
            f"DGNConfig.compute_dtype={self.compute_dtype!r}: not one of "
            "None, 'float32', 'bfloat16', 'float16'")


def check_ported(cfg: DGNConfig) -> None:
    """Raise ValueError (KeyError for an aggregator) for a configuration
    the port does not know."""
    if cfg.type_net not in ("simple", "complex", "towers"):
        raise ValueError(f"unknown type_net {cfg.type_net!r}")
    if cfg.node_encoder not in ("embedding", "atom", "linear"):
        raise ValueError(f"unknown node_encoder {cfg.node_encoder!r}")
    if cfg.edge_feat and cfg.edge_encoder not in ("embedding", "linear",
                                                  "bond"):
        raise ValueError(f"unknown edge_encoder {cfg.edge_encoder!r}")
    cfg.torch_compute_dtype()
    cfg.agg_names()             # KeyError for an unknown aggregator


def decomposes(cfg: DGNConfig) -> bool:
    """Whether the net takes the decomposed edge stage (dgn_tpu/models/
    dgn_net.py:100-101): decompose on and a linear pretrans, which the
    simple layer always has."""
    return cfg.decompose and (cfg.type_net == "simple"
                              or cfg.pretrans_layers == 1)


def edge_context_for(gb: GraphBatch, cfg: DGNConfig) -> agg_ops.EdgeContext:
    """The EdgeContext DGNModel attaches.  It depends only on (eig, edges,
    layout), not on the parameters, so fixed batches can reuse it.  The
    flat per-edge path takes the directional normalizers (need_norms); the
    adjacency blocks come in the config's compute dtype (bfloat16, float16
    or float32)."""
    decomposed = decomposes(cfg)
    return agg_ops.build_edge_context(
        gb.eig, gb.src, gb.dst, gb.edge_mask, gb.in_degree,
        names=cfg.agg_names(), mxu_layout=gb.mxu, decomposed=decomposed,
        adj_dtype=cfg.torch_compute_dtype(),
        need_norms=gb.mxu is None and not decomposed)


class DGNModel(nn.Module):
    """Node encoder -> L x DGN layer (+ virtual node) -> graph readout ->
    MLPReadout, or MLPReadout per node.

    Children carry the reference's parameter names (embedding_h,
    embedding_pos_enc, layer_i, virtual_node_i, MLP_layer) so
    convert.load_jax_params maps one tree onto the other.  in_dim is the
    float feature width the `linear` node encoder takes and pos_enc_in the
    positional encoding's width (flax infers both from the first batch;
    here they come from the dataset, run.build_model).  edge_in is the
    float edge feature width the `linear` edge encoder takes."""

    def __init__(self, cfg: DGNConfig, generator: torch.Generator,
                 in_dim: Optional[int] = None,
                 pos_enc_in: Optional[int] = None,
                 edge_in: Optional[int] = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        avg_d = cfg.avg_d or {"log": 1.0, "lin": 1.0}
        if cfg.node_encoder == "atom":
            self.embedding_h = AtomEncoder(cfg.hidden_dim, generator)
        elif cfg.node_encoder == "linear":
            if in_dim is None:
                raise ValueError("the linear node encoder needs in_dim")
            self.embedding_h = Linear(in_dim, cfg.hidden_dim, generator)
        else:
            self.embedding_h = Embedding(cfg.num_node_types, cfg.hidden_dim,
                                         generator)
        if cfg.pos_enc_dim > 0:
            if pos_enc_in is None:
                raise ValueError("pos_enc_dim > 0 needs pos_enc_in, the "
                                 "width of the batches' positional encoding")
            self.embedding_pos_enc = Linear(pos_enc_in, cfg.hidden_dim,
                                            generator)
        if cfg.edge_feat:
            if cfg.edge_encoder == "embedding":
                self.embedding_e = Embedding(cfg.num_edge_types, cfg.edge_dim,
                                             generator)
            elif cfg.edge_encoder == "linear":
                if edge_in is None:
                    raise ValueError("the linear edge encoder needs edge_in")
                self.embedding_e = Linear(edge_in, cfg.edge_dim, generator)
            else:
                self.embedding_e = BondEncoder(cfg.edge_dim, generator)
        self.use_vn = bool(cfg.virtual_node) \
            and cfg.virtual_node.lower() != "none"
        in_dim = cfg.hidden_dim
        for i in range(cfg.L):
            last = i == cfg.L - 1
            out_dim = cfg.out_dim if last else cfg.hidden_dim
            divide = cfg.divide_input
            if last and cfg.divide_input_last is not None:
                divide = cfg.divide_input_last
            self.add_module(f"layer_{i}", make_dgn_layer(
                cfg.type_net, in_dim=in_dim, out_dim=out_dim,
                aggregators=cfg.agg_names(), scalers=cfg.scaler_names(),
                avg_d=avg_d, generator=generator, dropout=cfg.dropout,
                graph_norm=cfg.graph_norm, batch_norm=cfg.batch_norm,
                residual=cfg.residual, posttrans_layers=cfg.posttrans_layers,
                towers=cfg.towers, divide_input=divide,
                edge_dim=cfg.edge_dim if cfg.edge_feat else 0,
                pretrans_layers=cfg.pretrans_layers,
                compute_dtype=cfg.torch_compute_dtype(),
                bn_axis=cfg.bn_axis))
            if self.use_vn and not last:
                self.add_module(f"virtual_node_{i}", VirtualNode(
                    cfg.hidden_dim, generator, dropout=cfg.dropout,
                    batch_norm=cfg.batch_norm, residual=cfg.residual,
                    vn_type=cfg.virtual_node, bn_axis=cfg.bn_axis))
            in_dim = out_dim
        # the per-node head keeps MLPReadout's default halving widths, as in
        # the reference (dgn_net.py:205-206); the directional readouts
        # concatenate two poolings
        if cfg.readout in ("directional", "directional_abs"):
            in_dim *= 2
        if cfg.readout != "none":
            self.MLP_layer = MLPReadout(
                in_dim, cfg.n_out, generator, L=cfg.readout_L,
                decreasing_dim=cfg.readout == "node" or cfg.decreasing_dim)

    def forward(self, gb: GraphBatch,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """[G, n_out] scores ([N, n_out] per node for readout "node", the
        [N, out_dim] node embeddings for readout "none").
        Batch norm and dropout follow self.training; dropout and input
        dropout in training draw their masks from dropout_generator, a
        torch.Generator on the model's device."""
        cfg = self.cfg
        if gb.edge_ctx is None:
            gb = dataclasses.replace(gb, edge_ctx=edge_context_for(gb, cfg))
        h = self.embedding_h(gb.node_feat)
        h = dropout(h, cfg.in_feat_dropout, self.training, dropout_generator)
        if cfg.pos_enc_dim > 0:
            pe = gb.pos_enc if gb.pos_enc is not None \
                else gb.eig[:, 1:cfg.pos_enc_dim + 1]
            h = h + self.embedding_pos_enc(pe)
        e = self.embedding_e(gb.edge_feat) if cfg.edge_feat else None
        vn_h = h.new_zeros((gb.num_graphs_padded, cfg.hidden_dim))
        # an edge-partitioned batch: a decomposed layer on the split block
        # layout pulls its own halo (layers/dgn.py); otherwise the halo
        # rows are fetched anew before each layer
        refresh = gb.halo is not None and not (ep_fused_layout(gb)
                                               and decomposes(cfg))
        for i in range(cfg.L):
            if refresh:
                h = halo_refresh(h, gb.halo)
            h = getattr(self, f"layer_{i}")(gb, h, dropout_generator, e)
            if self.use_vn and i < cfg.L - 1:
                vn_h, h = getattr(self, f"virtual_node_{i}")(
                    gb, h, vn_h, dropout_generator)
        if self.cfg.readout == "none":
            return h
        if self.cfg.readout == "node":
            return self.MLP_layer(h)
        return self.MLP_layer(graph_readout(gb, h, self.cfg.readout))
