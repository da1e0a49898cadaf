"""Optimizer and LR schedule (counterpart of `dgn_tpu/train/optim.py`).

The reference trains with torch.optim.Adam(weight_decay=wd), i.e. L2 decay
added to the gradient before the moment update, and a plateau schedule on
the validation objective (reference main_molecules.py:88-91).  The JAX
package reproduces Adam with an optax chain; here it is torch's own Adam.
The plateau schedule keeps the repo's own semantics (see ReduceLROnPlateau).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch


def adam_l2(params: Iterable[torch.nn.Parameter], learning_rate: float,
            weight_decay: float = 0.0) -> torch.optim.Adam:
    """torch.optim.Adam(lr, weight_decay): L2 form, eps 1e-8."""
    return torch.optim.Adam(params, lr=learning_rate,
                            weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Plateau schedule, mode 'min', with the reference package's semantics:
    improvement iff metric < best * (1 - threshold) (relative threshold
    1e-4); after MORE than `patience` consecutive bad epochs
    (num_bad > patience) lr *= factor, floored at min_lr.  Step on -metric
    for quantities to maximise."""
    lr: float
    factor: float = 0.5
    patience: int = 10
    min_lr: float = 0.0
    threshold: float = 1e-4

    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> float:
        is_better = (self.best == float("inf")
                     or metric < self.best * (1 - self.threshold))
        if is_better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr
