"""Training harness (counterpart of `dgn_tpu/train/trainer.py`).

The reference train_val_pipeline skeleton (reference main_molecules.py:
68-156): seeded init, Adam(+L2) with ReduceLROnPlateau on the validation
objective, per-epoch train/val/test evaluation, min-lr and max_time stops.

The model and optimizer live on `device`; the loaders yield CPU batches and
each step moves its batch over.  Eval batches that a loader replays
(BatchLoader(cache=True)) keep their device copy with the EdgeContext
attached, so their adjacency blocks (block layout) or their directional
normalizers (flat layout) are built once (with_edge_context).

Each task's epoch metric, plateau objective and loss weight come from the
table of train/tasks.py.  Dropout draws from one torch.Generator on the
trainer's device, seeded from params.seed.

Augmentation (params flip / augmentation / distortion, dgn_tpu
trainer.py:58-68): each train step rotates, then flips, then distorts the
batch's eig field (ops/field.py), each only when on (augmentation and
distortion above 1e-7), before the model builds the step's EdgeContext
from it.  The draws come from a second generator on the trainer's device,
seeded from params.seed on a stream of its own, as dgn_tpu splits its
augmentation key from its dropout key.  Eval batches are never augmented.

Micro-batching: a loader batch that arrives as a list of K micro-batches
(BatchLoader(micro_batches=K)) takes K forward/backward passes and ONE
optimizer step (`train_step`); see there for where it departs from
dgn_tpu's step.

Each train epoch counts its real edges, nodes and graphs from the loader's
CPU batches (observe.Throughput) and leaves edges/s and the edge padding
efficiency (and the loader's pack escapes of the epoch, when any) in
`_last_throughput`.  `fit` can snapshot the trainer after every epoch
(train/checkpoint.py), start at a later epoch after a restore, and write
one "epoch" record per epoch to an observe.MetricStream, with dgn_tpu's
keys (dgn_tpu/train/trainer.py:282-336), and, while the recorder of
observe.py is on, the train epoch's spans and counters per step
(`spans`).  A KeyboardInterrupt ends the epoch loop and `fit` returns what
it has, so the caller's final evaluation still runs, as in dgn_tpu.

CUDA graphs (train/graphs.py): on a CUDA device, where its steps draw no
random numbers, the single-device trainer captures its step on the block
layout as three graphs (forward and loss, backward, Adam) the second time
it meets a batch signature, and replays them for every later batch of that
signature; its Adam is then adam_l2(graphed=True).  Every other step runs
eagerly, as before.

Spans (observe.py): `step` and inside it its phases (`_adam_step`, which
the rank trainers' steps share; `_graph_step`; on a step of micro-batches
`step.micro` around each micro-batch's copy, forward and backward, and the
counter `step.micro_batches`, one a micro-batch); per batch of train_epoch
`epoch.readback` (the scores and the loss to the host) and
`epoch.account` (the metric accumulator and Throughput), then
`epoch.finish`.  train_epoch reads step n back after it has asked the
loader for batch n+1 (`_train_epoch`), so one iteration holds batch n's
pack, step n-1's `epoch.readback` and `epoch.account`, and step n; the
epoch's last step is read back after the loop, in the iteration of
`epoch.finish`.  Counters `epoch.readback_deferred` (steps read back after
the next batch's pack) and `epoch.readback_ready` (those of them whose
copies to the host had finished when the host came to read them).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np
import torch

from .. import observe
from ..graph import GraphBatch
from ..ops import field
from . import graphs, tasks
from .optim import ReduceLROnPlateau, adam_l2, set_learning_rate


@dataclasses.dataclass
class TrainParams:
    """The `params` block of the reference configs (configs/*.json)."""
    seed: int = 41
    epochs: int = 1000
    batch_size: int = 128
    init_lr: float = 1e-3
    lr_reduce_factor: float = 0.5
    lr_schedule_patience: int = 20
    min_lr: float = 1e-5
    weight_decay: float = 0.0
    print_epoch_interval: int = 5
    max_time: float = 48.0            # hours
    flip: bool = False
    augmentation: float = 0.0
    distortion: float = 0.0


Batch = Union[GraphBatch, List[GraphBatch]]


@dataclasses.dataclass
class AugDraws:
    """One train step's augmentation draws: uniforms in [0, 1) at the
    packed batch's node count N and eig width K, None where that
    augmentation is off."""
    rotate: Optional[torch.Tensor] = None     # [N]
    flip: Optional[torch.Tensor] = None       # [N, K]
    distort: Optional[torch.Tensor] = None    # [N]

    def to(self, device) -> "AugDraws":
        return AugDraws(*(None if t is None else observe.to_device(t, device)
                          for t in (self.rotate, self.flip, self.distort)))


def augments(p: TrainParams) -> bool:
    return p.flip or p.augmentation > 1e-7 or p.distortion > 1e-7


def draw_augmentation(shape, p: TrainParams, generator: torch.Generator
                      ) -> Optional[AugDraws]:
    """The draws for an eig of `shape` (N, K) under p, from generator (on
    the device it draws on); None when p augments nothing."""
    if not augments(p):
        return None
    n, k = shape

    def u(*size):
        return torch.rand(size, generator=generator, device=generator.device)

    return AugDraws(rotate=u(n) if p.augmentation > 1e-7 else None,
                    flip=u(n, k) if p.flip else None,
                    distort=u(n) if p.distortion > 1e-7 else None)


def augment(gb: GraphBatch, draws: AugDraws, p: TrainParams) -> GraphBatch:
    """gb with its eig rotated, flipped and distorted, in that order
    (dgn_tpu trainer.py:58-68 _augment), and no EdgeContext attached, so
    the model builds the step's context from the augmented eig."""
    eig = gb.eig
    if draws.rotate is not None:
        eig = field.rotate_field(eig, draws.rotate, p.augmentation)
    if draws.flip is not None:
        eig = field.sign_flip(eig, draws.flip)
    if draws.distort is not None:
        eig = field.distort_field(eig, draws.distort, p.distortion,
                                  node_mask=gb.node_mask)
    return dataclasses.replace(gb, eig=eig, edge_ctx=None)


class Trainer:
    """The training loop of the five graph tasks, on one device; the rank
    trainers (parallel/) run it with their own steps and _host_values.

    graph_factory makes the graphs of a captured step (train/graphs.py;
    None: CUDA graphs on a CUDA device, none elsewhere)."""

    # whether train_epoch reports edges/s and the edge padding efficiency
    reports_rate = True

    def __init__(self, model: torch.nn.Module, loss_fn, params: TrainParams,
                 task: str = "zinc", device="cuda", graph_factory=None):
        self.spec = tasks.get(task)
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.p = params
        self.task = task
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(params.seed)
        aug_seed = np.random.SeedSequence(params.seed).spawn(1)[0]
        self.aug_generator = torch.Generator(device=self.device).manual_seed(
            int(aug_seed.generate_state(1)[0]))
        factory = graph_factory or graphs.default_factory(self.device)
        cfg = getattr(self.model, "cfg", None)
        # the graphs hold no random draws and no collective
        graphable = (factory is not None and cfg is not None
                     and cfg.dropout <= 0 and cfg.in_feat_dropout <= 0
                     and not augments(params) and _own_reduce(self))
        self.step_graphs = graphs.StepGraphs(factory) if graphable else None
        self._families = tuple(cfg.agg_names()) if graphable else ()
        self.optimizer = adam_l2(self.model.parameters(), params.init_lr,
                                 params.weight_decay, graphed=graphable)
        self._lr_set: Optional[float] = None
        self.scheduler = ReduceLROnPlateau(
            lr=params.init_lr, factor=params.lr_reduce_factor,
            patience=params.lr_schedule_patience, min_lr=params.min_lr)
        # eval-context cache, keyed by host batch identity
        self._ctx_cache: Dict[int, Tuple[GraphBatch, GraphBatch]] = {}

    # ------------------------------------------------------------- steps
    def _loss_weight(self, gb: GraphBatch) -> torch.Tensor:
        """The denominator of this task's batch-mean loss: weighting the
        micro-batch losses by it makes their weighted mean EXACTLY the
        full-batch loss (train/losses.py normalisations)."""
        return self.spec.loss_weight(gb)

    def train_step(self, gb: Batch, aug: Optional[AugDraws] = None):
        """One Adam step at the scheduler's lr on one batch, or on a list of
        K micro-batches; returns the (detached) loss and the scores (a list
        of K score tensors for a list).

        When params augment, the step draws once from aug_generator, unless
        the caller hands in the draws (aug), and every micro-batch takes the
        same draws: micro-batches share their pads, and dgn_tpu hands each
        the same augmentation key, hence the same draws at the same padded
        positions.

        Micro-batches (dgn_tpu trainer.py:162-201): K forward/backward
        passes, the k-th loss scaled by w_k / sum(w) (w = _loss_weight) so
        the accumulated gradient and the returned loss are the full-batch
        ones, then one optimizer step.  As in dgn_tpu, batch norm takes each
        micro-batch's own statistics and its running stats update K times,
        and SBM's class weights are estimated per micro-batch.  Unlike
        dgn_tpu, which hands every micro-batch the same dropout rng, dropout
        draws from the one device generator in micro-batch order.  Each
        micro-batch counts `step.micro_batches` and opens `step.micro`
        around its copy, forward and backward; a single batch opens
        neither."""
        micro = isinstance(gb, (list, tuple))
        micros = list(gb) if micro else [gb]
        scales = [None]
        if micro:
            # from the host batches, before they move to the device
            w = [float(self._loss_weight(g)) for g in micros]
            scales = [x / max(sum(w), 1.0) for x in w]
        if aug is not None and not augments(self.p):
            raise ValueError("augmentation draws for params that augment "
                             "nothing")
        if aug is None and self.step_graphs is not None \
                and not micro and _own_reduce(self):
            sig = graphs.signature(gb, self._families)
            route = self.step_graphs.route(sig)
            if route != "eager":
                return self._graph_step(gb, sig if route == "capture"
                                        else None)

        def passes():
            draws = aug
            if draws is None:
                draws = draw_augmentation(micros[0].eig.shape, self.p,
                                          self.aug_generator)
            if draws is not None:
                with observe.span("step.h2d"):
                    draws = draws.to(self.device)
            losses, scores = [], []
            for g, scale in zip(micros, scales):
                if micro:
                    observe.count("step.micro_batches")
                with (observe.span("step.micro") if micro
                      else contextlib.nullcontext()):
                    with observe.span("step.h2d"):
                        g = g.to(self.device)
                    with observe.span("step.forward"):
                        if draws is not None:
                            g = augment(g, draws, self.p)
                        s = self.model(g, self.dropout_generator)
                        loss = self.loss_fn(s, g)
                        if scale is not None:
                            loss = loss * scale
                    with observe.span("step.backward"):
                        loss.backward()
                losses.append(loss.detach())
                scores.append(s.detach())
            if not micro:
                return losses[0], scores[0]
            return torch.stack(losses).sum(), scores

        return self._adam_step(passes)

    def _adam_step(self, passes: Callable[[], Any]) -> Any:
        """One Adam step at the scheduler's lr around passes(), which runs
        the step's forward and backward passes and returns what the step
        returns; the spans `step`, `step.optimizer` (zero_grad and the lr
        before the passes, Adam's step after them) and `step.grad_sync`
        (_reduce_grads).  passes() opens `step.h2d`, `step.forward` and
        `step.backward` itself."""
        # a captured step's .grad tensors are the ones its Adam reads
        held = self.step_graphs is not None and self.step_graphs.held
        with observe.span("step"):
            observe.count("step.eager")
            with observe.span("step.optimizer"):
                self.model.train()
                self._apply_lr()
                self.optimizer.zero_grad(set_to_none=not held)
            out = passes()
            with observe.span("step.grad_sync"):
                self._reduce_grads()
            with observe.span("step.optimizer"):
                self.optimizer.step()
        return out

    def _graph_step(self, gb: GraphBatch, capture_sig=None):
        """One Adam step replayed from the step's graphs (train/graphs.py),
        captured first for the signature capture_sig where it is given;
        returns copies of the loss and the scores, which the next replay
        leaves alone.  The spans `step.forward` (with the copies),
        `step.backward` and `step.optimizer` (the lr before, then Adam)
        each hold a replay."""
        g = self.step_graphs
        with observe.span("step"):
            with observe.span("step.optimizer"):
                self.model.train()
                self._apply_lr()
            if capture_sig is not None:
                with observe.span("step.h2d"):
                    static = gb.to(self.device)
                with observe.span("step.capture"):
                    self._capture(capture_sig, static)
            else:
                with observe.span("step.h2d"):
                    g.load(gb)
            with observe.span("step.forward"):
                g.replay("forward")
                # the backward and Adam replays leave them as they are
                out = (g.out["loss"].detach().clone(),
                       g.out["scores"].detach().clone())
            with observe.span("step.backward"):
                g.replay("backward")
            with observe.span("step.optimizer"):
                g.replay("optimizer")
            observe.count("step.graph_replays")
        return out

    def _capture(self, sig, static: GraphBatch) -> None:
        """Capture the step on the device batch static: the forward pass
        and the loss, loss.backward() onto .grad tensors that start as
        None, and Adam's step."""
        out = self.step_graphs.out

        def forward():
            s = self.model(static, self.dropout_generator)
            out["scores"], out["loss"] = s, self.loss_fn(s, static)

        def backward():
            out["loss"].backward()
            out["loss"], out["scores"] = (out["loss"].detach(),
                                          out["scores"].detach())

        self.optimizer.zero_grad(set_to_none=True)
        self.step_graphs.capture(sig, static, {
            "forward": forward, "backward": backward,
            "optimizer": self.optimizer.step})

    def _apply_lr(self) -> None:
        """The scheduler's lr into the optimizer when it changed (a graphed
        Adam's lr is a device tensor, and each fill a device operation)."""
        if self._lr_set != self.scheduler.lr:
            set_learning_rate(self.optimizer, self.scheduler.lr)
            self._lr_set = self.scheduler.lr

    def forget_step_graphs(self) -> None:
        """Drop the captured step, whose graphs read the optimizer's state
        tensors (a checkpoint restore replaces them); the steps that follow
        capture anew."""
        if self.step_graphs is not None:
            self.step_graphs = graphs.StepGraphs(self.step_graphs.factory)

    def _reduce_grads(self) -> None:
        """Between the backward passes and the optimizer step: nothing on
        one device; the data-parallel trainer averages over its ranks."""

    def out_of_time(self, t0: float) -> bool:
        """The max_time stop of a run that started at t0."""
        return (time.time() - t0) / 3600.0 > self.p.max_time

    @torch.no_grad()
    def eval_step(self, gb: GraphBatch):
        gb = gb.to(self.device)
        self.model.eval()
        scores = self.model(gb)
        return scores, self.loss_fn(scores, gb)

    def with_edge_context(self, gb: GraphBatch) -> GraphBatch:
        """gb on the device with its batch-constant EdgeContext attached,
        cached by batch identity."""
        hit = self._ctx_cache.get(id(gb))
        if hit is not None and hit[0] is gb:
            return hit[1]
        from ..models.dgn_net import edge_context_for
        dev = gb.to(self.device)
        with torch.no_grad():
            ctx = edge_context_for(dev, self.model.cfg)
        out = dataclasses.replace(dev, edge_ctx=ctx)
        self._ctx_cache[id(gb)] = (gb, out)
        return out

    # ------------------------------------------------------------- epochs
    def train_epoch(self, loader) -> Dict[str, float]:
        """One epoch of train_step over loader (the recorder on for it
        while a torch.profiler is active)."""
        with observe.following_profiler():
            return self._train_epoch(loader)

    def _train_epoch(self, loader) -> Dict[str, float]:
        """One step of software pipelining: step n's loss and scores start
        for the host as soon as the step is issued (_read_back), the loader
        packs batch n+1 while the card runs step n, and only then is step n
        read back and accounted (_account); the last step is read back once
        the loader is exhausted.  The same work on the same values as
        reading each step back at once, in another order.  Every trainer
        runs this loop; a rank trainer's reading back (_host_values) issues
        its collectives after the next pack, which issues none, so each
        rank still issues step n's, then its readback's, then step n+1's."""
        acc = _MetricAccumulator(self.task)
        tp = observe.Throughput()
        escapes0 = getattr(loader, "n_escapes", 0)
        pending = None
        for gb in loader:
            if pending is not None:
                self._account(pending, acc, tp, deferred=True)
            loss, scores = self.train_step(gb)
            pending = self._read_back(gb, loss, scores)
            observe.next_step()
        if pending is not None:
            self._account(pending, acc, tp, deferred=False)
        with observe.span("epoch.finish"):
            r = tp.result()
            self._last_throughput = {
                "edges_per_s": round(r["edges_per_s"], 1),
                "edge_padding_efficiency": round(
                    r["edge_padding_efficiency"], 4),
            } if self.reports_rate else {}
            # repacks of THIS epoch, not the loader's lifetime count
            escapes = getattr(loader, "n_escapes", 0) - escapes0
            if escapes:
                self._last_throughput["pack_escapes"] = escapes
            return acc.result()

    def _read_back(self, gb: Batch, loss, scores) -> "_Pending":
        """A step's batch (its micro-batches) with its loss and scores on
        their way to the host.  On a CUDA device: copied without blocking
        into pinned host tensors (torch's caching host allocator), behind
        the step's work on the current stream, with an event recorded after
        the copies.  Elsewhere the tensors themselves, read as before."""
        if isinstance(gb, (list, tuple)):
            micros, scores = list(gb), list(scores)
        else:
            micros, scores = [gb], [scores]
        if self.device.type != "cuda":
            return _Pending(micros, loss, scores, None)
        host = []
        for t in [loss] + scores:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return _Pending(micros, host[0], host[1:], done)

    def _account(self, p: "_Pending", acc: "_MetricAccumulator",
                 tp: observe.Throughput, deferred: bool) -> None:
        """Wait for a step's host values (`epoch.readback`), then add them
        to the epoch's metric and its batches to Throughput
        (`epoch.account`).  deferred: read back after the next batch's
        pack, counted in `epoch.readback_deferred`, and in
        `epoch.readback_ready` when its copies had finished by now."""
        if deferred:
            observe.count("epoch.readback_deferred")
            if p.done is None or p.done.query():
                observe.count("epoch.readback_ready")
        with observe.span("epoch.readback"):
            if p.done is not None:
                p.done.synchronize()
            views, host, value = self._host_values(p.micros, p.loss,
                                                   p.scores)
        with observe.span("epoch.account"):
            # one loss per super-batch, recorded with its first micro
            for k, (v, s, g) in enumerate(zip(views, host, p.micros)):
                acc.add(v, s, value if k == 0 else None)
                tp.add_batch(g)

    def _host_values(self, micros: List[GraphBatch], loss: torch.Tensor,
                     scores: List[torch.Tensor]):
        """How a step's loss and scores (one per micro-batch) become host
        values for the metric: (what the metric reads of each micro-batch,
        its scores as a numpy array, the loss as a float).  The rank
        trainers override it: the data-parallel one gathers every rank's
        shard, the edge-parallel one reads its step's loss view."""
        return micros, [s.cpu().numpy() for s in scores], float(loss)

    def evaluate(self, loader) -> Dict[str, float]:
        """Each micro-batch of a list is evaluated as a batch of its own."""
        acc = _MetricAccumulator(self.task)
        # context reuse only helps a loader that replays identical batch
        # objects; otherwise id() never hits and the cache would only grow
        reuse = getattr(loader, "cache", False)
        for gb in loader:
            for g in (gb if isinstance(gb, (list, tuple)) else [gb]):
                scores, loss = self.eval_step(
                    self.with_edge_context(g) if reuse else g)
                (view,), (host,), value = self._host_values([g], loss,
                                                            [scores])
                acc.add(view, host, value)
        return acc.result()

    def fit(self, train_loader, val_loader=None, test_loader=None,
            log: Callable[[str], None] = print, checkpointer=None,
            start_epoch: int = 0, stream=None) -> Dict[str, Any]:
        """Epochs start_epoch .. params.epochs - 1.  checkpointer: a
        train/checkpoint.Checkpointer that snapshots the trainer after each
        epoch; stream: an observe.MetricStream that receives one "epoch"
        record per epoch (epoch, lr, train/val/test metrics, seconds,
        edges_per_s, edge_padding_efficiency, and while the recorder is on
        the train epoch's `spans`, observe.per_step)."""
        p = self.p
        t0 = time.time()
        history = []
        best_val = None
        best_epoch = -1
        test_at_best = None
        maximize = self.spec.maximize
        try:
            for epoch in range(start_epoch, p.epochs):
                te0 = time.time()
                traced = observe.snapshot() if observe.RECORDER.on else None
                train_m = self.train_epoch(train_loader)
                spans = (None if traced is None else
                         observe.per_step(observe.summary(traced)))
                val_m = self.evaluate(val_loader) if val_loader else None
                test_m = self.evaluate(test_loader) if test_loader else None
                row = dict(epoch=epoch, lr=self.scheduler.lr,
                           time=time.time() - te0, train=train_m, val=val_m,
                           test=test_m)
                history.append(row)
                if stream is not None:
                    stream.log("epoch", **{k: v for k, v in row.items()
                                           if k != "time"},
                               seconds=row["time"],
                               **getattr(self, "_last_throughput", {}),
                               **({} if spans is None else {"spans": spans}))
                if val_m is not None:
                    obj = val_m["objective"]
                    # the plateau scheduler steps on the minimised objective
                    self.scheduler.step(-obj if maximize else obj)
                    if best_val is None or (obj > best_val if maximize
                                            else obj < best_val):
                        best_val, best_epoch = obj, epoch
                        test_at_best = test_m
                if epoch % p.print_epoch_interval == 0:
                    log(f"epoch {epoch}: lr={self.scheduler.lr:.2e} "
                        f"train={train_m} val={val_m} test={test_m}")
                if checkpointer is not None:
                    checkpointer.save(epoch, self)
                if self.scheduler.lr <= p.min_lr * (1 + 1e-9):
                    log("lr reached min_lr — stopping (reference "
                        "main_molecules.py:130-132)")
                    break
                if self.out_of_time(t0):
                    log("max_time reached — stopping")
                    break
        except KeyboardInterrupt:
            log("interrupted — falling through to final eval")
        return dict(history=history, best_epoch=best_epoch,
                    best_val=best_val, test_at_best=test_at_best)


class _Pending(NamedTuple):
    """A train step on its way to the host (Trainer._read_back)."""
    micros: List[GraphBatch]        # the loader's CPU batches
    loss: torch.Tensor
    scores: List[torch.Tensor]      # one per micro-batch
    done: Optional[torch.cuda.Event]    # after the copies (CUDA only)


def _own_reduce(trainer: Trainer) -> bool:
    """Whether trainer reduces its gradients as the single-device Trainer
    does (nothing), with no override on its class or the instance."""
    return getattr(trainer._reduce_grads, "__func__", None) \
        is Trainer._reduce_grads


class _MetricAccumulator:
    """A task's epoch metric and objective (train/tasks.py Task),
    padding-stripped, with the reference's semantics."""

    def __init__(self, task: str):
        self.spec = tasks.get(task)
        self.loss_sum = 0.0
        self.n_batches = 0
        self.per_batch = []
        self.scores = []
        self.labels = []

    def add(self, gb: GraphBatch, scores: np.ndarray,
            loss: Optional[float]):
        """loss None: a further micro-batch of a super-batch whose loss was
        recorded with its first."""
        if loss is not None:
            self.loss_sum += loss
            self.n_batches += 1
        t = self.spec
        mask, labels = (getattr(gb, f).cpu().numpy() for f in t.fields)
        if t.per_batch:
            self.per_batch.append(t.score(scores[mask], labels[mask]))
        else:
            self.scores.append(scores[mask])
            self.labels.append(labels[mask])

    def result(self) -> Dict[str, float]:
        t = self.spec
        out = {"loss": self.loss_sum / max(self.n_batches, 1)}
        if t.per_batch:
            out[t.metric] = (float(np.mean(self.per_batch)) if self.per_batch
                             else t.empty)
        else:
            s = np.concatenate(self.scores) if self.scores else np.zeros((0, 1))
            y = np.concatenate(self.labels) if self.labels else np.zeros((0, 1))
            out[t.metric] = t.score(s, y) if len(s) else t.empty
        out["objective"] = out[t.metric] if t.maximize else out["loss"]
        return out
