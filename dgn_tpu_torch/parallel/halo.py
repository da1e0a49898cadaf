"""Edge-partitioned graph parallelism over torch.distributed (counterpart of
`dgn_tpu/parallel/halo.py`).

One batch is cut across P ranks: its packed node axis into P contiguous
ranges with about equal edge counts, every edge on the rank that owns its
destination, and each rank carries a halo region with copies of the remote
source nodes its edges read.  Per layer one boundary-only all-to-all
refreshes the halo (graph.halo_pull: each rank ships exactly the rows its
peers' halos reference); per-graph readouts and the virtual node sum
their partial pools over the ranks, the readout's max takes the max over
them, and sync batch norm sums its statistics over them.

dgn_tpu runs the forward under shard_map and takes the loss and its
gradient outside, so the collectives' transposes place the cross-rank
terms.  Here each rank is a process and every collective is an autograd
Function with its exact adjoint: the halo all-to-all's is the reverse
all-to-all (graph._AllToAll), a sum over the ranks sums the cotangents
(nn._AllReduceSum), the max routes the summed cotangent to the rank and
node that hold it (models/readout.py), the node-level gather keeps this
rank's block of the summed cotangent (graph._AllGather).  Each rank holds
the replicated loss L and backpropagates L / P; the parameter gradients
summed over the ranks are then the one-process gradients of L, which is
what dgn_tpu's step takes (tests/test_halo.py:80-114).

`partition_shards` packs all P shards (the tests compare each with
dgn_tpu's stacked batch); `partition_batch` packs one rank's, after the
cut, halos, exchange plan and pads that every rank derives alike.
"""
from __future__ import annotations

import dataclasses
import types
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import observe
from ..graph import (GraphBatch, GraphData, HaloSpec, _mxu_edge_arrange,
                     _tensors)
from ..ops.mxu import TILE, build_mxu_layout_ep
from ..train.trainer import TrainParams, augments
from .dp import RankTrainer
from .mesh import Mesh


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


@dataclasses.dataclass
class _Plan:
    """What every rank derives alike from the whole batch: the concatenated
    arrays, the cut, the halos, the per-shard edge arrangement and layout
    inputs, the exchange plan and the shared pads."""
    cat: dict
    los: np.ndarray
    his: np.ndarray
    shard_of_node: np.ndarray
    per_e: list
    halos: list
    send_lists: list
    s_max: int
    n_loc_pad: int
    h_pad: int
    e_pad: int
    edge_plan: list          # per shard (perm, src, dst, edge mask)
    mxu_args: Optional[list]  # per shard build_mxu_layout_ep arguments


def _plan(graphs: Sequence[GraphData], n_shards: int, multiple: int,
          layout: str) -> _Plan:
    """dgn_tpu/parallel/halo.py:38-219, up to the per-shard arrays."""
    tot_n = sum(gr.num_nodes for gr in graphs)
    node_feat = np.concatenate([np.asarray(gr.node_feat) for gr in graphs])
    if node_feat.dtype.kind != "f":
        node_feat = node_feat.astype(np.int32)
    k_eig = graphs[0].eig.shape[1] if graphs[0].eig is not None else 0
    eig = (np.concatenate([gr.eig for gr in graphs]).astype(np.float32)
           if k_eig else np.zeros((tot_n, 0), np.float32))
    node_graph = np.concatenate([np.full(gr.num_nodes, i, np.int32)
                                 for i, gr in enumerate(graphs)])
    snorm_n = np.concatenate([np.full(
        (gr.num_nodes, 1), np.float32(np.sqrt(1.0 / max(gr.num_nodes, 1))))
        for gr in graphs])
    node_labels = (np.concatenate([gr.node_labels for gr in graphs])
                   .astype(np.int32)
                   if graphs[0].node_labels is not None else None)
    pos_enc = (np.concatenate([gr.pos_enc for gr in graphs])
               .astype(np.float32)
               if graphs[0].pos_enc is not None else None)
    offs = np.cumsum([0] + [gr.num_nodes for gr in graphs])
    src = np.concatenate([np.asarray(gr.src, np.int64) + offs[i]
                          for i, gr in enumerate(graphs)])
    dst = np.concatenate([np.asarray(gr.dst, np.int64) + offs[i]
                          for i, gr in enumerate(graphs)])
    snorm_e = np.concatenate([np.full(
        (gr.num_edges, 1), np.float32(np.sqrt(1.0 / max(gr.num_edges, 1))))
        for gr in graphs])
    edge_feat = None
    if graphs[0].edge_feat is not None:
        edge_feat = np.concatenate([gr.edge_feat for gr in graphs])
        if edge_feat.dtype.kind != "f":
            edge_feat = edge_feat.astype(np.int32)

    # the node axis cut into P ranges of about equal edge counts (by dst)
    deg = np.bincount(dst, minlength=tot_n)
    cum = np.concatenate([[0], np.cumsum(deg)])
    cuts = [0] + [int(np.searchsorted(cum, cum[-1] * p / n_shards))
                  for p in range(1, n_shards)] + [tot_n]
    cuts = sorted(set(cuts))
    while len(cuts) < n_shards + 1:      # degenerate tiny inputs
        cuts.append(tot_n)
    los, his = np.array(cuts[:-1]), np.array(cuts[1:])
    shard_of_node = np.zeros(tot_n, np.int32)
    for p in range(n_shards):
        shard_of_node[los[p]:his[p]] = p

    e_shard = shard_of_node[dst]
    per_e = [np.nonzero(e_shard == p)[0] for p in range(n_shards)]
    halos = []
    for p in range(n_shards):
        s = src[per_e[p]]
        halos.append(np.unique(s[(s < los[p]) | (s >= his[p])]))

    if layout not in ("flat", "mxu"):
        raise ValueError(f"unknown ep layout {layout!r}")
    if layout == "mxu":
        multiple = TILE
    n_loc_pad = _round_up(int((his - los).max()), multiple)
    h_pad = _round_up(max((len(h) for h in halos), default=1), multiple)
    e_pad = _round_up(max((len(e) for e in per_e), default=1), multiple)
    n_ext = n_loc_pad + h_pad

    # local edge endpoints: dst always own, src own or a halo slot
    shard_lsrc, shard_ldst = [], []
    for p in range(n_shards):
        lo, hi = int(los[p]), int(his[p])
        gsrc = src[per_e[p]]
        remote = (gsrc < lo) | (gsrc >= hi)
        lsrc = np.where(remote, 0, gsrc - lo)
        if remote.any():
            lsrc[remote] = n_loc_pad + np.searchsorted(halos[p],
                                                       gsrc[remote])
        shard_lsrc.append(lsrc.astype(np.int32))
        shard_ldst.append((dst[per_e[p]] - lo).astype(np.int32))

    mxu_args = None
    if layout == "mxu":
        arranged = [_mxu_edge_arrange(shard_lsrc[p], shard_ldst[p])
                    for p in range(n_shards)]
        e_pad = _round_up(max((len(a[1]) for a in arranged), default=1),
                          TILE)
        nb, nb_own = n_ext // TILE, n_loc_pad // TILE
        edge_plan, counts = [], []
        for order, src_p, dst_p, valid in arranged:
            used = len(src_p)
            s_arr = np.full(e_pad, n_ext - TILE, np.int32)
            d_arr = np.full(e_pad, n_ext - TILE, np.int32)
            em = np.zeros(e_pad, bool)
            perm = np.full(e_pad, -1, np.int64)
            s_arr[:used], d_arr[:used] = src_p, dst_p
            em[:used], perm[:used] = valid, order
            csb = s_arr.reshape(-1, TILE)[:, 0] // TILE
            cdb = d_arr.reshape(-1, TILE)[:, 0] // TILE
            keys = np.unique(cdb.astype(np.int64) * nb + csb)
            n_int = int(((keys % nb) < nb_own).sum())
            edge_plan.append((perm, s_arr, d_arr, em))
            counts.append((n_int, len(keys) - n_int))
        ip = _round_up(max(c[0] for c in counts), 8)
        bp = _round_up(max(c[1] for c in counts), 8)
        mxu_args = [(s, d, em, n_ext, nb_own, ip, bp)
                    for _, s, d, em in edge_plan]
    else:
        edge_plan = []
        for p in range(n_shards):
            lsrc, ldst = shard_lsrc[p], shard_ldst[p]
            order = np.lexsort((lsrc, ldst))
            n_real = len(order)
            perm = np.full(e_pad, -1, np.int64)
            s_arr = np.zeros(e_pad, np.int32)
            d_arr = np.zeros(e_pad, np.int32)
            em = np.zeros(e_pad, bool)
            perm[:n_real] = order
            s_arr[:n_real], d_arr[:n_real] = lsrc[order], ldst[order]
            em[:n_real] = True
            edge_plan.append((perm, s_arr, d_arr, em))

    # the exchange plan: send_lists[p][q] = p-local rows q's halo reads, in
    # q's (sorted) halo order
    send_lists = [[halos[q][shard_of_node[halos[q]] == p] - los[p]
                   for q in range(n_shards)] for p in range(n_shards)]
    s_max = max(max((len(lst) for row in send_lists for lst in row),
                    default=1), 1)
    cat = dict(node_feat=node_feat, eig=eig, node_graph=node_graph,
               snorm_n=snorm_n, node_labels=node_labels, pos_enc=pos_enc,
               snorm_e=snorm_e, edge_feat=edge_feat)
    return _Plan(cat, los, his, shard_of_node, per_e, halos, send_lists,
                 int(s_max), n_loc_pad, h_pad, e_pad, edge_plan, mxu_args)


def _shard(plan: _Plan, graphs: Sequence[GraphData], p: int, g_pad: int,
           axis: str) -> GraphBatch:
    """Shard p's GraphBatch (dgn_tpu/parallel/halo.py:220-287): node arrays
    [own | pad | halo | pad], its edges in the layout's arrangement, the
    graph arrays replicated, its HaloSpec and block layout."""
    c = plan.cat
    n_shards = len(plan.los)
    lo, hi = int(plan.los[p]), int(plan.his[p])
    n_loc = hi - lo
    halo = plan.halos[p]
    n_halo = len(halo)
    n_ext = plan.n_loc_pad + plan.h_pad
    g = len(graphs)

    def ext(a):
        out = np.zeros((n_ext,) + a.shape[1:], a.dtype)
        out[:n_loc] = a[lo:hi]
        out[plan.n_loc_pad:plan.n_loc_pad + n_halo] = a[halo]
        return out

    ng = np.full(n_ext, g_pad - 1, np.int32)
    ng[:n_loc] = c["node_graph"][lo:hi]    # halo rows: the ghost graph id
    nm = np.zeros(n_ext, bool)
    nm[:n_loc] = True
    perm, s_arr, d_arr, em = plan.edge_plan[p]
    es = plan.per_e[p]
    sel = perm >= 0
    se = np.zeros((plan.e_pad, 1), np.float32)
    se[sel] = c["snorm_e"][es][perm[sel]]
    ef = None
    if c["edge_feat"] is not None:
        ef = np.zeros((plan.e_pad,) + c["edge_feat"].shape[1:],
                      c["edge_feat"].dtype)
        ef[sel] = c["edge_feat"][es][perm[sel]]
    indeg = np.zeros(n_ext, np.int32)
    np.add.at(indeg, d_arr[em], 1)

    gm = np.zeros(g_pad, bool)
    gm[:g] = True
    nn_ = np.zeros(g_pad, np.int32)
    nn_[:g] = [gr.num_nodes for gr in graphs]
    ne = np.zeros(g_pad, np.int32)
    ne[:g] = [gr.num_edges for gr in graphs]
    labels = None
    if graphs[0].label is not None:
        lb = np.stack([np.asarray(gr.label) for gr in graphs])
        labels = np.zeros((g_pad,) + lb.shape[1:],
                          np.float32 if lb.dtype.kind == "f" else lb.dtype)
        labels[:g] = lb

    hs = np.zeros(plan.h_pad, np.int32)
    hl = np.zeros(plan.h_pad, np.int32)
    owners = plan.shard_of_node[halo]
    hs[:n_halo] = owners
    hl[:n_halo] = halo - plan.los[owners]
    si = np.zeros((n_shards, plan.s_max), np.int32)
    for q in range(n_shards):
        rows = plan.send_lists[p][q]
        si[q, :len(rows)] = rows
    # halo slot j <- receive row owner * S + its rank among the slots of
    # that owner (the order send_lists was built in)
    rank = np.zeros(n_halo, np.int64)
    for o in np.unique(owners):
        m = owners == o
        rank[m] = np.arange(int(m.sum()))
    rp = np.zeros(plan.h_pad, np.int32)
    rp[:n_halo] = owners * plan.s_max + rank

    t = _tensors
    spec = HaloSpec(halo_shard=t(hs), halo_local=t(hl), send_idx=t(si),
                    recv_perm=t(rp), n_local=plan.n_loc_pad, axis=axis)
    mxu = (build_mxu_layout_ep(*plan.mxu_args[p])
           if plan.mxu_args is not None else None)
    return GraphBatch(
        node_feat=t(ext(c["node_feat"])), node_mask=t(nm),
        node_graph=t(ng), eig=t(ext(c["eig"])), in_degree=t(indeg),
        snorm_n=t(ext(c["snorm_n"])), src=t(s_arr), dst=t(d_arr),
        edge_mask=t(em), edge_feat=t(ef), snorm_e=t(se), graph_mask=t(gm),
        n_nodes=t(nn_), n_edges=t(ne), labels=t(labels),
        node_labels=(t(ext(c["node_labels"]))
                     if c["node_labels"] is not None else None),
        pos_enc=(t(ext(c["pos_enc"])) if c["pos_enc"] is not None
                 else None),
        mxu=mxu, halo=spec)


def partition_shards(graphs: Sequence[GraphData], n_shards: int,
                     g_pad: Optional[int] = None, axis: str = "ep",
                     multiple: int = 8, layout: str = "flat"
                     ) -> List[GraphBatch]:
    """All n_shards shards of one batch of graphs, in rank order: what
    dgn_tpu's partition_batch stacks on its leading axis.

    Every shard shares its shapes (the largest own range, halo and edge
    count, rounded up to `multiple`, or to 128 under layout "mxu", whose
    shards carry a build_mxu_layout_ep layout with the interior/boundary
    pair split; "flat" keeps the COO segment path).  Graph-level arrays
    are replicated on every shard."""
    plan = _plan(graphs, n_shards, multiple, layout)
    g_pad = int(g_pad or len(graphs))
    return [_shard(plan, graphs, p, g_pad, axis) for p in range(n_shards)]


def partition_batch(graphs: Sequence[GraphData], n_shards: int, rank: int,
                    g_pad: Optional[int] = None, axis: str = "ep",
                    multiple: int = 8, layout: str = "flat") -> GraphBatch:
    """Rank `rank`'s shard of partition_shards(graphs, n_shards, ...),
    without packing the others."""
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} outside {n_shards} shards")
    plan = _plan(graphs, n_shards, multiple, layout)
    return _shard(plan, graphs, rank, int(g_pad or len(graphs)), axis)


class PartitionedLoader:
    """This rank's shard of each batch of a graph list: the batches of
    BatchLoader's granularity (one numpy default_rng(seed) shuffle, the
    same on every rank), each partitioned over n_shards ranks
    (dgn_tpu/parallel/halo.py:426-455)."""

    def __init__(self, graphs: Sequence[GraphData], batch_size: int,
                 n_shards: int, rank: int = 0, shuffle: bool = False,
                 seed: int = 0, g_pad: Optional[int] = None,
                 axis: str = "ep", multiple: int = 8, layout: str = "flat"):
        if not 0 <= rank < n_shards:
            raise ValueError(f"rank {rank} outside {n_shards} shards")
        self.graphs = list(graphs)
        self.bs = batch_size
        self.n_shards = n_shards
        self.rank = rank
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.g_pad = g_pad or batch_size
        self.axis = axis
        self.multiple = multiple
        self.layout = layout

    def __len__(self):
        return (len(self.graphs) + self.bs - 1) // self.bs

    def batches(self):
        """The graph lists of one pass, advancing the shuffle."""
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.bs):
            yield [self.graphs[j] for j in idx[i:i + self.bs]]

    def __iter__(self):
        for sel in self.batches():
            with observe.span("loader.pack"):
                gb = partition_batch(sel, self.n_shards, self.rank,
                                     g_pad=self.g_pad, axis=self.axis,
                                     multiple=self.multiple,
                                     layout=self.layout)
            yield gb


class EdgeParallelTrainer(RankTrainer):
    """The Trainer of one rank of an edge-partitioned mesh
    (dgn_tpu/parallel/halo.py:311-423).

    The model should be built with DGNConfig(bn_axis="ep"): its batch
    norms are bound to the mesh here, and its halo exchanges, pools and
    max run over the mesh's group, which the trainer sets on each batch's
    HaloSpec.  Graph-level tasks: every rank holds the replicated scores.
    Node-level tasks (SBM; train/tasks.py): the per-node scores of every
    rank's [own | halo] rows are gathered in rank order, with the node
    masks and labels, before the loss, as dgn_tpu's out_specs=P('ep')
    stacks them (dgn_tpu's node_level); each step leaves that view, or the
    rank's own batch for graph-level tasks (every rank has the same graph
    arrays), where _host_values hands it to the metric, so reading a step
    back issues no collective.  train_step backpropagates L / P on each
    rank and sums the parameter gradients over the ranks (module
    docstring), so they are the one-process gradients of L.  Dropout
    draws from the same seed on every rank, as dgn_tpu hands every shard
    the same key.  dgn_tpu's ep step applies no augmentation; this one
    refuses params that augment.  The parameters come from the model's
    constructor (dgn_tpu's init_state on one shard's view with no halo has
    no counterpart)."""

    def __init__(self, model: torch.nn.Module, loss_fn, params: TrainParams,
                 mesh: Mesh, task: str = "zinc"):
        if augments(params):
            raise NotImplementedError(
                "edge-partitioned training applies no augmentation (as "
                "dgn_tpu's EdgeParallelTrainer): set flip, augmentation "
                "and distortion off")
        super().__init__(model, loss_fn, params, mesh, task=task)
        self._view = None    # the last step's loss view (loss_view)

    def on_device(self, gb: GraphBatch) -> GraphBatch:
        """gb on the trainer's device, its HaloSpec bound to the mesh's
        group."""
        if gb.halo is None:
            raise ValueError("an edge-parallel step needs a partitioned "
                             "batch (PartitionedLoader, partition_batch)")
        dev = gb.to(self.device)
        return dataclasses.replace(dev, halo=dataclasses.replace(
            dev.halo, group=self.mesh.group))

    def loss_view(self, gb: GraphBatch, scores: torch.Tensor):
        """(scores, batch view) the loss and the metrics read, for a batch
        on the device: the rank's own for graph-level tasks; node-level,
        every rank's rows, masks and labels concatenated in rank order."""
        if not self.spec.node_level:
            return scores, gb
        from ..graph import _AllGather, _gather_all
        group = self.mesh.group
        view = types.SimpleNamespace(
            node_mask=_gather_all(gb.node_mask, group),
            node_labels=_gather_all(gb.node_labels, group))
        return _AllGather.apply(scores.contiguous(), group), view

    def _forward(self, g: GraphBatch, generator=None):
        """(scores, loss) of this rank's shard of a batch, on the device
        (on_device); the loss view stays in _view."""
        scores, self._view = self.loss_view(g, self.model(g, generator))
        return scores, self.loss_fn(scores, self._view)

    def train_step(self, gb: GraphBatch, aug=None):
        """One Adam step on this rank's shard of a batch; returns the loss
        (the same on every rank) and the scores the loss read."""
        if isinstance(gb, (list, tuple)) or aug is not None:
            raise ValueError("an edge-parallel step takes one partitioned "
                             "batch and no augmentation draws")

        def passes():
            with observe.span("step.h2d"):
                g = self.on_device(gb)
            with observe.span("step.forward"):
                scores, loss = self._forward(g, self.dropout_generator)
            with observe.span("step.backward"):
                (loss / self.mesh.size).backward()
            return loss.detach(), scores.detach()

        return self._adam_step(passes)

    @torch.no_grad()
    def eval_step(self, gb: GraphBatch):
        self.model.eval()
        return self._forward(self.on_device(gb))

    def _host_values(self, micros, loss, scores):
        """The step's loss view (left by _forward) and its scores."""
        return [self._view], [scores[0].cpu().numpy()], float(loss)
