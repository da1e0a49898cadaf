"""Training harness (counterpart of `dgn_tpu/train/trainer.py`).

The reference train_val_pipeline skeleton (reference main_molecules.py:
68-156): seeded init, Adam(+L2) with ReduceLROnPlateau on the validation
objective, per-epoch train/val/test evaluation, min-lr and max_time stops.

The model and optimizer live on `device`; the loaders yield CPU batches and
each step moves its batch over.  Eval batches that a loader replays
(BatchLoader(cache=True)) keep their device copy with the EdgeContext
attached, so their adjacency blocks are built once (with_edge_context).

Not ported yet: augmentation (flip / rotate / distort), micro-batching,
checkpointing, and tasks other than ZINC.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..graph import GraphBatch
from . import metrics as M
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


class Trainer:
    """Single-device training loop for the ZINC task."""

    def __init__(self, model: torch.nn.Module, loss_fn, params: TrainParams,
                 task: str = "zinc", device="cuda"):
        if task != "zinc":
            raise NotImplementedError(f"task {task!r} is not ported yet")
        if params.flip or params.augmentation > 1e-7 \
                or params.distortion > 1e-7:
            raise NotImplementedError("augmentation (flip, augmentation, "
                                      "distortion) is not ported yet")
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.p = params
        self.task = task
        self.optimizer = adam_l2(self.model.parameters(), params.init_lr,
                                 params.weight_decay)
        self.scheduler = ReduceLROnPlateau(
            lr=params.init_lr, factor=params.lr_reduce_factor,
            patience=params.lr_schedule_patience, min_lr=params.min_lr)
        # eval-context cache, keyed by host batch identity
        self._ctx_cache: Dict[int, Tuple[GraphBatch, GraphBatch]] = {}

    # ------------------------------------------------------------- steps
    def train_step(self, gb: GraphBatch):
        """One Adam step on one batch at the scheduler's lr; returns the
        (detached) loss and scores."""
        gb = gb.to(self.device)
        self.model.train()
        set_learning_rate(self.optimizer, self.scheduler.lr)
        scores = self.model(gb)
        loss = self.loss_fn(scores, gb)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), scores.detach()

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
        acc = _MetricAccumulator()
        for gb in loader:
            loss, scores = self.train_step(gb)
            acc.add(gb, scores.cpu().numpy(), float(loss))
        return acc.result()

    def evaluate(self, loader) -> Dict[str, float]:
        acc = _MetricAccumulator()
        # context reuse only helps a loader that replays identical batch
        # objects; otherwise id() never hits and the cache would only grow
        reuse = getattr(loader, "cache", False)
        for gb in loader:
            scores, loss = self.eval_step(
                self.with_edge_context(gb) if reuse else gb)
            acc.add(gb, scores.cpu().numpy(), float(loss))
        return acc.result()

    def fit(self, train_loader, val_loader=None, test_loader=None,
            log: Callable[[str], None] = print) -> Dict[str, Any]:
        p = self.p
        t0 = time.time()
        history = []
        best_val = None
        best_epoch = -1
        test_at_best = None
        for epoch in range(p.epochs):
            te0 = time.time()
            train_m = self.train_epoch(train_loader)
            val_m = self.evaluate(val_loader) if val_loader else None
            test_m = self.evaluate(test_loader) if test_loader else None
            history.append(dict(epoch=epoch, lr=self.scheduler.lr,
                                time=time.time() - te0, train=train_m,
                                val=val_m, test=test_m))
            if val_m is not None:
                obj = val_m["objective"]
                self.scheduler.step(obj)
                if best_val is None or obj < best_val:
                    best_val, best_epoch = obj, epoch
                    test_at_best = test_m
            if epoch % p.print_epoch_interval == 0:
                log(f"epoch {epoch}: lr={self.scheduler.lr:.2e} "
                    f"train={train_m} val={val_m} test={test_m}")
            if self.scheduler.lr <= p.min_lr * (1 + 1e-9):
                log("lr reached min_lr — stopping (reference "
                    "main_molecules.py:130-132)")
                break
            if (time.time() - t0) / 3600.0 > p.max_time:
                log("max_time reached — stopping")
                break
        return dict(history=history, best_epoch=best_epoch,
                    best_val=best_val, test_at_best=test_at_best)


class _MetricAccumulator:
    """ZINC epoch metric, padding-stripped, reference semantics: mean of
    per-batch MAEs, and the mean batch loss as the scheduler objective."""

    def __init__(self):
        self.loss_sum = 0.0
        self.n_batches = 0
        self.per_batch = []

    def add(self, gb: GraphBatch, scores: np.ndarray, loss: float):
        self.loss_sum += loss
        self.n_batches += 1
        gmask = gb.graph_mask.cpu().numpy()
        self.per_batch.append(M.mae(scores[gmask].reshape(-1),
                                    gb.labels.cpu().numpy()[gmask].reshape(-1)))

    def result(self) -> Dict[str, float]:
        out = {"loss": self.loss_sum / max(self.n_batches, 1)}
        out["mae"] = (float(np.mean(self.per_batch)) if self.per_batch
                      else float("nan"))
        out["objective"] = out["loss"]
        return out
