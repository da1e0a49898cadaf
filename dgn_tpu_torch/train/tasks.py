"""What each task is, in one table (counterpart of the branches on the task's
name in `dgn_tpu/train/trainer.py` and `dgn_tpu/run.py`).

One `Task` per key of `ExperimentConfig.task` but COLLAB (one graph,
batches of edges: train/link_pred.py).  The trainers, the metric
accumulator and `run` read the table; none of them names a task.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from . import metrics as M


def _graphs(gb) -> torch.Tensor:
    return gb.graph_mask.sum()


class Task(NamedTuple):
    """node_level: scores, masks and labels per node, else per graph.
    maximize: the epoch objective is the metric, maximised (the plateau
    scheduler steps on -metric, reference main_HIV.py:144); else the mean
    batch loss, minimised.  metric: the epoch metric's key; score(scores,
    labels), padding stripped, gives it for each batch and the epoch takes
    their mean (per_batch), or once for the epoch's concatenation; empty:
    its value when nothing was scored.  loss_weight(batch): the
    denominator of the batch's mean loss.  model_args(meta): what the
    model factory (models.MODEL_FACTORIES) takes from the dataset's meta,
    (arguments before the generator, keywords).  derive(cfg, meta): the
    DGNConfig fields `run.prepare` sets from them (reference
    main_*.py:285-304)."""
    node_level: bool
    maximize: bool
    metric: str
    score: Callable[[np.ndarray, np.ndarray], float]
    per_batch: bool
    empty: float
    loss_weight: Callable[[Any], torch.Tensor] = _graphs
    model_args: Callable[[dict], Tuple[tuple, dict]] = lambda meta: ((), {})
    derive: Callable[[Any, dict], dict] = lambda cfg, meta: {}

    @property
    def fields(self) -> Tuple[str, str]:
        """The batch's (mask, labels) fields that the metric reads."""
        return (("node_mask", "node_labels") if self.node_level
                else ("graph_mask", "labels"))


def _labeled_entries(gb) -> torch.Tensor:
    """PCBA's loss is a mean over labeled (graph, task) entries."""
    lab = gb.labels
    return ((lab == lab) & gb.graph_mask[:, None]).sum()


def _mae(s: np.ndarray, y: np.ndarray) -> float:
    return M.mae(s.reshape(-1), y.reshape(-1))


def _accuracy(s: np.ndarray, y: np.ndarray) -> float:
    """Correct over count, x 100."""
    return 100.0 * int((s.argmax(-1) == y.reshape(-1)).sum()) / len(y)


TASKS: Dict[str, Task] = {
    "zinc": Task(
        node_level=False, maximize=False, metric="mae", score=_mae,
        per_batch=True, empty=float("nan"),
        derive=lambda cfg, meta: dict(
            num_node_types=meta["num_atom_type"],
            num_edge_types=meta["num_bond_type"],
            edge_dim=cfg.edge_dim or cfg.hidden_dim)),
    "sbm": Task(
        node_level=True, maximize=False, metric="acc",
        score=M.accuracy_sbm, per_batch=True, empty=0.0,
        loss_weight=lambda gb: gb.node_mask.sum(),
        model_args=lambda meta: ((meta["n_classes"],), {}),
        derive=lambda cfg, meta: dict(
            num_node_types=meta["num_node_types"])),
    "superpixels": Task(
        node_level=False, maximize=False, metric="acc", score=_accuracy,
        per_batch=False, empty=0.0,
        model_args=lambda meta: ((meta["n_classes"], meta["in_dim"]),
                                 {"edge_in": meta["edge_dim"]}),
        derive=lambda cfg, meta: dict(
            edge_dim=cfg.edge_dim or cfg.hidden_dim)),
    "hiv": Task(node_level=False, maximize=True, metric="rocauc",
                score=M.roc_auc, per_batch=False, empty=float("nan")),
    "pcba": Task(node_level=False, maximize=True, metric="ap",
                 score=M.multitask_ap, per_batch=False, empty=float("nan"),
                 loss_weight=_labeled_entries),
}


def get(name: str) -> Task:
    """The table's entry for a task; ValueError for an unknown one, as
    dgn_tpu's metric accumulator raises."""
    try:
        return TASKS[name]
    except KeyError:
        raise ValueError(name) from None
