"""The task table (dgn_tpu_torch/train/tasks.py) == what dgn_tpu decides
from a task's name, for each of the five tasks, on the same inputs:

  * node-level: the node_level that dgn_tpu's prepare hands its
    EdgeParallelTrainer (dgn_tpu/run.py, `--partition ep`);
  * what prepare derives from the dataset's meta: every DGNConfig field of
    the prepared model, beside dgn_tpu's;
  * maximised: which of two epochs dgn_tpu's fit keeps as the best, with
    its train and eval epochs stubbed, and the port's fit on the same
    metrics;
  * the loss weight: dgn_tpu's Trainer._loss_weight on the same packed
    batch (PCBA's labels NaN-sparse);
  * the epoch metric: dgn_tpu's _MetricAccumulator against the port's on
    the same batches, scores and losses (one batch's loss left to its
    first micro-batch), and on none.
And an unknown dataset or task raises ValueError, with dgn_tpu's message.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from dgn_tpu import config as jconfig
from dgn_tpu import graph as jgraph
from dgn_tpu import run as jrun
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.train import trainer as JT

from dgn_tpu_torch import config as tconfig
from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import run as trun
from dgn_tpu_torch.models import DGNConfig, zinc_model
from dgn_tpu_torch.train import tasks
from dgn_tpu_torch.train import trainer as T

torch.set_num_threads(1)

# (dataset, graphs of dgn_tpu's synthetic generators, model outputs)
CASES = {
    "zinc": ("ZINC", lambda: jsyn.synthetic_zinc(9, seed=1), 1),
    "sbm": ("SBM_PATTERN", lambda: jsyn.synthetic_sbm(3, seed=2), 2),
    "superpixels": ("CIFAR10", lambda: jsyn.synthetic_superpixels(
        9, seed=3, n_classes=3), 3),
    "hiv": ("HIV", lambda: jsyn.synthetic_ogb_mol(12, seed=4), 1),
    "pcba": ("PCBA", lambda: jsyn.synthetic_ogb_mol(
        12, seed=5, n_tasks=128, nan_frac=0.3), 128),
}
DATA = dict(synthetic_size=4)


def test_the_table_holds_every_task():
    assert set(tasks.TASKS) == set(CASES)


def _reference(task):
    """dgn_tpu's prepare of the task's dataset under --partition ep on 2 of
    the 8 virtual devices (nothing compiled): (model, trainer)."""
    cfg = jconfig.ExperimentConfig(dataset=CASES[task][0],
                                   data=jconfig.DataParams(**DATA))
    assert cfg.task == task
    _, model, _, trainer, _, _ = jrun.prepare(cfg, n_devices=2,
                                              partition="ep")
    return model, trainer


def _batches(task):
    """(dgn_tpu's, the port's) packed batches of the task's graphs, in two
    batches with a pad graph each."""
    graphs = CASES[task][1]()
    half = len(graphs) // 2
    out = []
    for part in (graphs[:half], graphs[half:]):
        out.append((jgraph.pack_graphs(part, g_pad=len(part) + 1),
                    tgraph.pack_graphs(
                        [tgraph.GraphData(**dataclasses.asdict(g))
                         for g in part], g_pad=len(part) + 1)))
    return out


def _stub_epochs(trainer, objectives, train_takes_state: bool):
    """trainer's train_epoch and evaluate replaced by stubs whose val
    objective is objectives[epoch]."""
    seen = iter(range(len(objectives)))
    metrics = {"loss": 0.0, "objective": 0.0}

    def evaluate(*args):
        return dict(metrics, objective=objectives[evaluate.epoch])

    def train_epoch(*args):
        evaluate.epoch = next(seen)
        return (args[0], metrics) if train_takes_state else metrics

    trainer.train_epoch, trainer.evaluate = train_epoch, evaluate


@pytest.mark.parametrize("task", list(CASES))
def test_the_table_holds_what_dgn_tpu_decides_by_name(task):
    spec = tasks.get(task)
    jmodel, jtrainer = _reference(task)
    assert spec.node_level == jtrainer.node_level

    # what prepare derives: the prepared model's config, field by field
    cfg = tconfig.ExperimentConfig(dataset=CASES[task][0],
                                   data=tconfig.DataParams(**DATA))
    _, model, *_ = trun.prepare(cfg, device="cpu")
    want = dataclasses.asdict(dataclasses.replace(jmodel.cfg, bn_axis=None))
    got = dataclasses.asdict(model.cfg)
    for k in set(got) & set(want):
        assert got[k] == want[k], k

    # maximised: the best of two epochs whose val objective rises
    jtrainer.p = dataclasses.replace(jtrainer.p, epochs=2)
    _stub_epochs(jtrainer, [1.0, 2.0], train_takes_state=True)
    trainer = T.Trainer(model, lambda s, gb: s.sum(),
                        T.TrainParams(epochs=2), task=task, device="cpu")
    _stub_epochs(trainer, [1.0, 2.0], train_takes_state=False)
    best = [jtrainer.fit(None, "train", "val", log=print)["best_epoch"],
            trainer.fit("train", "val", log=print)["best_epoch"]]
    assert best == [1 if spec.maximize else 0] * 2

    # the loss weight, and the epoch metric on the same scores ...
    rng = np.random.default_rng(0)
    jacc, acc = JT._MetricAccumulator(task), T._MetricAccumulator(task)
    for k, (jgb, gb) in enumerate(_batches(task)):
        assert float(spec.loss_weight(gb)) == float(
            jtrainer._loss_weight(jgb))
        rows = (gb.num_nodes_padded if spec.node_level
                else gb.num_graphs_padded)
        scores = rng.normal(size=(rows, CASES[task][2])).astype(np.float32)
        loss = None if k else 0.5
        jacc.add(jgb, scores, loss)
        acc.add(gb, scores, loss)
    # and of an epoch that scored nothing
    for want, got in ((jacc.result(), acc.result()),
                      (JT._MetricAccumulator(task).result(),
                       T._MetricAccumulator(task).result())):
        assert set(got) == set(want) == {"loss", "objective", spec.metric}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_an_unknown_dataset_or_task_raises_as_dgn_tpu_does():
    with pytest.raises(ValueError) as want:
        jconfig.ExperimentConfig(dataset="QM9").task
    with pytest.raises(ValueError) as got:
        tconfig.ExperimentConfig(dataset="QM9").task
    assert str(got.value) == str(want.value) == "unknown dataset 'QM9'"

    gb = _batches("zinc")[0]
    with pytest.raises(ValueError) as want:
        JT._MetricAccumulator("qm9").add(gb[0], np.zeros((5, 1)), 0.0)
    model, loss_fn = zinc_model(DGNConfig(hidden_dim=4, out_dim=4, L=1),
                                torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as got:
        T.Trainer(model, loss_fn, T.TrainParams(), task="qm9", device="cpu")
    assert str(got.value) == str(want.value) == "qm9"
