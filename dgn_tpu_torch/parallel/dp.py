"""Data-parallel training over torch.distributed (counterpart of
`dgn_tpu/parallel/dp.py`).

dgn_tpu stacks D packed shards into one batch with a leading device axis
and runs its step under shard_map over the mesh axis 'dp'.  Here each of
the D ranks is a process of its own: it packs and moves only its shard,
runs the port's Trainer step on it, and then all-reduces the parameter
gradients (a sum) before one Adam step that leaves the weights identical
on every rank, and the loss and the batch-norm running buffers (a mean).
Those are what dgn_tpu's step computes: its pmean of the gradients acts on
gradients that shard_map has already summed over the devices (the
gradient of a replicated parameter), so Adam takes D times the gradient
of the mean loss (ROADMAP C6).  With the model built at bn_axis="dp"
(sync batch norm, nn.MaskedBatchNorm) a D-rank step's gradients are D
times the one-rank step's on the concatenated batch; Adam hardly sees the
factor, but its L2 weight decay weighs 1/D as much as on one device.

Shards are composed as dgn_tpu composes them (`StackedLoader`), so the
same seed gives each rank the graphs dgn_tpu's device of that index gets.
The loss of a step is the mean over ranks of each shard's batch-mean loss,
as dgn_tpu computes it: a shard one graph short weighs its graphs a little
more, and a ghost shard (the ragged last super-batch) adds a loss of 0
and gradients of 0 to the mean (ROADMAP C4).
"""
from __future__ import annotations

import dataclasses
import types
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import observe
from ..graph import (GraphBatch, GraphData, bucket_sizes_for,
                     mxu_bucket_sizes, mxu_pair_pad, mxu_pairs_needed,
                     pack_graphs, pack_requirements, round_up)
from ..nn import bind_mesh
from ..train.trainer import Trainer, TrainParams
from .mesh import Mesh

_TILE = 128


def shard_fits(graphs: Sequence[GraphData], layout: str, n_pad: int,
               e_pad: int, pair_pad: Optional[int]) -> bool:
    """Whether pack_graphs packs these graphs (in the loader's order) at
    (n_pad, e_pad, pair_pad) without raising: the same tests, computed
    from the graphs alone, so every rank decides for every shard without
    packing it.  Block layout: the placement's node slots, the chunked
    edge slots, and the distinct (src block, dst block) pairs, counting
    the pair that the pad chunks take when any edge slot is left."""
    if layout != "mxu":
        return (sum(g.num_nodes for g in graphs) <= n_pad
                and sum(g.num_edges for g in graphs) <= e_pad)
    n_used, e_used = pack_requirements(graphs, mxu_layout=True)
    if n_used > n_pad or e_used > e_pad:
        return False
    has_edges = any(g.num_edges for g in graphs)
    pairs = mxu_pairs_needed(graphs) if has_edges else 0
    # the real edge slots fill whole chunks; any slot left is a pad chunk
    if (not has_edges or e_used < e_pad) \
            and not _has_last_diagonal_pair(graphs, n_pad):
        pairs += 1
    return pairs <= pair_pad


def _has_last_diagonal_pair(graphs, n_pad: int) -> bool:
    """Whether a real edge lies in the (last node block, last node block)
    pair, the one the pad chunks of pack_graphs point at."""
    from ..graph import _mxu_place
    graphs = sorted(graphs, key=lambda g: -g.num_nodes)
    offsets, _ = _mxu_place([g.num_nodes for g in graphs])
    last = n_pad // _TILE - 1
    for off, g in zip(offsets, graphs):
        if len(g.src) and np.any(((np.asarray(g.src) + off) // _TILE == last)
                                 & ((np.asarray(g.dst) + off) // _TILE
                                    == last)):
            return True
    return False


class StackedLoader:
    """Yields this rank's shard of each super-batch: D shards of up to
    per_device_batch graphs, one per rank (dgn_tpu/parallel/dp.py:44-145).

    The super-batch order is one numpy default_rng(seed) shuffle, the same
    on every rank.  Graphs are dealt round-robin (`chunk[d::D][:bs]`), so
    shard sizes differ by one at most; under the block layout each shard
    is ordered by descending node count.  On a ragged last super-batch a
    rank without graphs gets a ghost shard: the chunk's first graph with
    every mask zeroed.  All shards of a super-batch share one geometry: if
    any shard overflows the loader's (shard_fits, decided from every
    shard's requirements on every rank), every rank repacks at one common
    escape geometry and counts it in n_escapes.  dgn_tpu's ext_caps is TPU
    metadata and has no counterpart here."""

    def __init__(self, graphs: Sequence[GraphData], per_device_batch: int,
                 n_shards: int, rank: int = 0, shuffle: bool = False,
                 seed: int = 0, n_pad: Optional[int] = None,
                 e_pad: Optional[int] = None, layout: str = "flat"):
        if not 0 <= rank < n_shards:
            raise ValueError(f"rank {rank} outside {n_shards} shards")
        self.graphs = list(graphs)
        self.bs = per_device_batch
        self.d = n_shards
        self.rank = rank
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.layout = layout
        self.n_escapes = 0
        self.g_pad = (round_up(per_device_batch, _TILE) if layout == "mxu"
                      else per_device_batch)
        if n_pad is None or e_pad is None:
            if layout == "mxu":
                a, b, _ = mxu_bucket_sizes(self.graphs, per_device_batch)
            else:
                a, b = bucket_sizes_for(self.graphs, per_device_batch)
            n_pad = n_pad or a
            e_pad = e_pad or b
        self.n_pad, self.e_pad = n_pad, e_pad
        self.pair_pad = (mxu_pair_pad(self.graphs, per_device_batch,
                                      n_pad, e_pad)
                         if layout == "mxu" else None)

    def __len__(self):
        sz = self.bs * self.d
        return (len(self.graphs) + sz - 1) // sz

    def super_batches(self):
        """Per super-batch: ([(graphs, ghost) per shard], (n_pad, e_pad,
        pair_pad)), advancing the shuffle as one pass does."""
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.bs * self.d):
            chunk = idx[i:i + self.bs * self.d]
            shards = []
            for d in range(self.d):
                gs = [self.graphs[j] for j in chunk[d::self.d][:self.bs]]
                ghost = not gs
                if ghost:
                    gs = [self.graphs[chunk[0]]]
                if self.layout == "mxu":
                    gs = sorted(gs, key=lambda g: -g.num_nodes)
                shards.append((gs, ghost))
            yield shards, self._geometry([gs for gs, _ in shards])

    def _geometry(self, shards: List[List[GraphData]]):
        if all(shard_fits(gs, self.layout, self.n_pad, self.e_pad,
                          self.pair_pad) for gs in shards):
            return self.n_pad, self.e_pad, self.pair_pad
        self.n_escapes += 1
        mxu = self.layout == "mxu"
        reqs = [pack_requirements(gs, mxu_layout=mxu) for gs in shards]
        n_pad = round_up(max(max(r[0] for r in reqs) + 1, self.n_pad), 512)
        e_pad = round_up(max(max(r[1] for r in reqs), self.e_pad), 512)
        pair_pad = (round_up(max(max(mxu_pairs_needed(gs) for gs in shards),
                                 self.pair_pad), 64) if mxu else None)
        return n_pad, e_pad, pair_pad

    def pack_shard(self, graphs, ghost: bool, geometry) -> GraphBatch:
        n_pad, e_pad, pair_pad = geometry
        gb = pack_graphs(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=self.g_pad,
                         mxu_layout=self.layout == "mxu",
                         n_pairs_pad=pair_pad)
        if ghost:
            gb = dataclasses.replace(
                gb, node_mask=torch.zeros_like(gb.node_mask),
                edge_mask=torch.zeros_like(gb.edge_mask),
                graph_mask=torch.zeros_like(gb.graph_mask))
        return gb

    def __iter__(self):
        for shards, geometry in self.super_batches():
            with observe.span("loader.pack"):
                gs, ghost = shards[self.rank]
                gb = self.pack_shard(gs, ghost, geometry)
            yield gb


def rank_seeds(seed: int, rank: int) -> Tuple[int, int]:
    """(dropout seed, augmentation seed) of a rank: rank 0 takes the
    single-device Trainer's, every other rank its own stream, as dgn_tpu
    splits one key per device (dgn_tpu/parallel/dp.py:215)."""
    base = seed if rank == 0 else [seed, rank]
    ss = np.random.SeedSequence(base)
    dropout = seed if rank == 0 else int(ss.generate_state(1)[0])
    return dropout, int(ss.spawn(1)[0].generate_state(1)[0])


class RankTrainer(Trainer):
    """What the trainers of one rank of a mesh share: the model's batch
    norms bound to the mesh, the gradient sum over the ranks, the max_time
    stop decided by rank 0, and logging, metric records and checkpoints
    on rank 0 only.  Trainer's epoch loops run as they are, but for how a
    step's values reach the host (_host_values); a rank reports no edges/s
    or edge padding efficiency, as its shard's rate is not the run's."""

    reports_rate = False

    def __init__(self, model: torch.nn.Module, loss_fn, params: TrainParams,
                 mesh: Mesh, task: str = "zinc"):
        super().__init__(model, loss_fn, params, task=task,
                         device=mesh.device)
        self.mesh = mesh
        bind_mesh(self.model, mesh)

    def _all_reduce(self, tensors: List[torch.Tensor],
                    mean: bool = True) -> None:
        """Each tensor replaced, in place, by its mean (else its sum) over
        the ranks: one all-reduce of their concatenation."""
        if not tensors or self.mesh.size == 1:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.mesh.group)
        if mean:
            flat /= self.mesh.size
        off = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n

    def _reduce_grads(self) -> None:
        """The gradients summed over the ranks, as dgn_tpu's step applies
        them (ROADMAP C6)."""
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        self._all_reduce(grads, mean=False)

    def out_of_time(self, t0: float) -> bool:
        """The max_time stop, decided by rank 0 for every rank (the ranks'
        clocks differ, and a rank that stops alone would hang the
        others)."""
        flag = torch.tensor([float(super().out_of_time(t0))],
                            device=self.device)
        if self.mesh.size > 1:
            dist.broadcast(flag, src=0, group=self.mesh.group)
        return bool(flag.item())

    def fit(self, train_loader, val_loader=None, test_loader=None,
            log=print, checkpointer=None, start_epoch: int = 0,
            stream=None):
        if self.mesh.rank != 0:
            log, checkpointer, stream = (lambda s: None), None, None
        return super().fit(train_loader, val_loader, test_loader, log=log,
                           checkpointer=checkpointer,
                           start_epoch=start_epoch, stream=stream)


class DataParallelTrainer(RankTrainer):
    """The Trainer of one rank of a data-parallel mesh.

    train_step runs the Trainer's forward and backward on this rank's
    shard, then all-reduces the gradients (sum, ROADMAP C6) before the
    Adam step, and the loss and the batch-norm buffers (mean) after it.
    The model should be built with DGNConfig(bn_axis="dp") for the D-vs-1
    equivalence
    (its batch norms are bound to the mesh here); without it each rank
    normalises with its own shard's statistics, the reference's per-GPU
    batch norm.  train_epoch and evaluate feed the task metric every
    shard's scores, labels and masks (all-gathered), as dgn_tpu's
    _flatten_stacked does, and evaluate's loss is the mean over ranks.
    Only rank 0 logs, writes metric records and saves checkpoints; every
    rank restores one."""

    def __init__(self, model: torch.nn.Module, loss_fn, params: TrainParams,
                 mesh: Mesh, task: str = "zinc"):
        super().__init__(model, loss_fn, params, mesh, task=task)
        dropout_seed, aug_seed = rank_seeds(params.seed, mesh.rank)
        self.dropout_generator.manual_seed(dropout_seed)
        self.aug_generator.manual_seed(aug_seed)

    def train_step(self, gb, aug=None):
        """One data-parallel step on this rank's shard; returns the loss
        averaged over the ranks and this rank's scores."""
        loss, scores = super().train_step(gb, aug)
        with observe.span("step.grad_sync"):
            loss = loss.clone()
            buffers = [b for b in self.model.buffers()
                       if b.is_floating_point()]
            self._all_reduce([loss] + buffers)
        return loss, scores

    @torch.no_grad()
    def eval_step(self, gb: GraphBatch):
        scores, loss = super().eval_step(gb)
        loss = loss.clone()
        self._all_reduce([loss])
        return scores, loss

    def gather_shards(self, gb: GraphBatch, scores: torch.Tensor):
        """(batch-like view, scores) of the whole super-batch: every rank's
        masks, labels and scores, concatenated in rank order (dgn_tpu's
        _flatten_stacked), as CPU tensors and a numpy array."""
        fields = self.spec.fields
        # gloo gathers CPU tensors only
        where = (torch.device("cpu") if self.mesh.size == 1
                 or dist.get_backend(self.mesh.group) == "gloo"
                 else self.device)
        parts = [scores.detach().to(where)] + [getattr(gb, f).to(where)
                                               for f in fields]
        if self.mesh.size == 1:
            got = [parts]
        else:
            flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
            out = [torch.empty_like(flat) for _ in range(self.mesh.size)]
            dist.all_gather(out, flat, group=self.mesh.group)
            got = []
            for buf in out:
                buf, off, one = buf.cpu(), 0, []
                for p in parts:
                    n = p.numel()
                    one.append(buf[off:off + n].view(p.shape).to(p.dtype))
                    off += n
                got.append(one)
        cat = [torch.cat([g[i] for g in got]) for i in range(len(parts))]
        view = types.SimpleNamespace(**dict(zip(fields, cat[1:])))
        return view, cat[0].numpy()

    def _host_values(self, micros, loss, scores):
        """Every rank's shard of the step (gather_shards), and the loss."""
        view, s = self.gather_shards(micros[0], scores[0])
        return [view], [s], float(loss)
