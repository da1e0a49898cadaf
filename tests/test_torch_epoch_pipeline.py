"""train_epoch's pipelined readback (dgn_tpu_torch/train/trainer.py
`_train_epoch`): step n is read back and accounted after the loader has
packed batch n+1, and the epoch's last step once the loader is exhausted.

On the CPU: the epoch's metrics, `_last_throughput`, weights and Adam state
equal those of a loop that reads each step back at once, bit for bit, on
the block layout with replayed steps (FakeGraph, as in
test_torch_train_graphs.py) and on eager micro-batched steps; the order of
requests, steps and accounting, an epoch of one batch among them; the
counters `epoch.readback_deferred` and `epoch.readback_ready`; and the
benchmark's readback_ready_share reader.  The order holds for the data-
and edge-parallel trainers too, on a one-rank gloo mesh.  On the card
(marked `gpu`, skipped without one; `python -m pytest --noconftest -m gpu
tests/test_torch_epoch_pipeline.py`): the host values of every step, taken
from pinned copies while later steps were issued, equal what the step's
device tensors read at the end, and `epoch.readback_ready` counts what the
step's event answered."""
from __future__ import annotations

import copy
import importlib.util
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dgn_tpu_torch import observe
from dgn_tpu_torch.data.loader import BatchLoader
from dgn_tpu_torch.data.synthetic import synthetic_zinc
from dgn_tpu_torch.models import DGNConfig, zinc_model
from dgn_tpu_torch.ops.scalers import degree_stats
from dgn_tpu_torch.parallel import (DataParallelTrainer, EdgeParallelTrainer,
                                    PartitionedLoader, StackedLoader,
                                    make_mesh)
from dgn_tpu_torch.train import trainer as T
from dgn_tpu_torch.train.trainer import TrainParams, Trainer

from test_torch_train_graphs import Fakes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GRAPHS = synthetic_zinc(40, seed=3)
BATCH = 8


@pytest.fixture(autouse=True)
def fresh_recorder():
    observe.disable()
    observe.reset()
    yield
    observe.disable()
    observe.reset()


@pytest.fixture
def fixed_clock(monkeypatch):
    """Throughput's clock held still, so edges/s depends on the counts
    alone."""
    monkeypatch.setattr(observe, "time", types.SimpleNamespace(
        perf_counter=lambda: 1.0, perf_counter_ns=time.perf_counter_ns))


def _model(seed=0, bn_axis=None):
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in GRAPHS])
    cfg = DGNConfig(hidden_dim=8, out_dim=8, L=2, avg_d=degree_stats(degs),
                    bn_axis=bn_axis)
    return zinc_model(cfg, torch.Generator().manual_seed(seed))


def _trainer(model, loss_fn):
    """A CPU trainer that replays its block-layout steps from FakeGraphs."""
    return Trainer(model, loss_fn, TrainParams(seed=41, weight_decay=3e-6),
                   device="cpu", graph_factory=Fakes(model))


def _loader(kind):
    if kind == "micro":
        return BatchLoader(GRAPHS, BATCH, layout="mxu", shuffle=True, seed=0,
                           micro_batches=2)
    return BatchLoader(GRAPHS, BATCH, layout="mxu", shuffle=True, seed=0)


def _serial_epoch(trainer, loader):
    """The epoch as a loop that reads each step back at once."""
    acc = T._MetricAccumulator(trainer.task)
    tp = observe.Throughput()
    escapes0 = loader.n_escapes
    for gb in loader:
        loss, scores = trainer.train_step(gb)
        many = isinstance(gb, list)
        micros, scores = (gb, scores) if many else ([gb], [scores])
        host = [s.cpu().numpy() for s in scores]
        value = float(loss)
        for k, (g, s) in enumerate(zip(micros, host)):
            acc.add(g, s, value if k == 0 else None)
            tp.add_batch(g)
    r = tp.result()
    throughput = {"edges_per_s": round(r["edges_per_s"], 1),
                  "edge_padding_efficiency": round(
                      r["edge_padding_efficiency"], 4)}
    if loader.n_escapes - escapes0:
        throughput["pack_escapes"] = loader.n_escapes - escapes0
    return acc.result(), throughput


def _adam_state(trainer):
    return [{k: v.clone() if torch.is_tensor(v) else v
             for k, v in st.items()}
            for st in trainer.optimizer.state_dict()["state"].values()]


@pytest.mark.parametrize("kind", ["block", "micro"])
def test_pipelined_epoch_equals_the_serial_loop_bit_for_bit(kind,
                                                            fixed_clock):
    model, loss_fn = _model()
    twin = copy.deepcopy(model)
    piped, serial = _trainer(model, loss_fn), _trainer(twin, loss_fn)
    ld_a, ld_b = _loader(kind), _loader(kind)
    with observe.tracing():
        for _ in range(2):
            ma = piped.train_epoch(ld_a)
            mb, tb = _serial_epoch(serial, ld_b)
            assert ma == mb
            assert piped._last_throughput == tb
    c = observe.summary()["counters"]
    if kind == "block":
        assert c["step.graph_replays"] > 0
    else:
        assert "step.graph_replays" not in c
    sa, sb = model.state_dict(), twin.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = _adam_state(piped), _adam_state(serial)
    assert len(oa) == len(ob) > 0
    for a, b in zip(oa, ob):
        assert a.keys() == b.keys()
        for k in a:
            assert (torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
                    else a[k] == b[k]), k


class _Logged:
    """A loader that logs each request it answers and its end."""

    def __init__(self, loader, log):
        self.loader, self.log = loader, log

    def __iter__(self):
        for n, gb in enumerate(self.loader):
            self.log.append(f"pack {n}")
            yield gb
        self.log.append("end")


def _logging_trainer(monkeypatch, log, t=None):
    """t (default: a single-device trainer) with its steps and the metric
    accumulator's adds logged."""
    if t is None:
        t = _trainer(*_model())
    inner = t.train_step

    def step(gb, aug=None):
        log.append(f"step {sum(e.startswith('step') for e in log)}")
        return inner(gb, aug)

    t.train_step = step
    add = T._MetricAccumulator.add

    def logged_add(self, gb, scores, loss):
        log.append(f"account {sum(e.startswith('account') for e in log)}")
        return add(self, gb, scores, loss)

    monkeypatch.setattr(T._MetricAccumulator, "add", logged_add)
    return t


@pytest.fixture
def one_rank(tmp_path):
    """A mesh of one gloo rank, this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        yield make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _three_batches(kind, request):
    """(trainer, loader of 3 batches) of a kind of trainer: the
    single-device one, or a rank trainer on a one-rank mesh with the
    loader of its partition."""
    if kind == "single":
        return None, BatchLoader(GRAPHS[:24], BATCH, layout="mxu",
                                 shuffle=True, seed=0)
    mesh = request.getfixturevalue("one_rank")
    model, loss_fn = _model(bn_axis=kind)
    if kind == "dp":
        return (DataParallelTrainer(model, loss_fn, TrainParams(seed=41),
                                    mesh),
                StackedLoader(GRAPHS[:24], BATCH, 1, shuffle=True, seed=0,
                              layout="mxu"))
    return (EdgeParallelTrainer(model, loss_fn, TrainParams(seed=41), mesh),
            PartitionedLoader(GRAPHS[:24], BATCH, 1, shuffle=True, seed=0,
                              layout="mxu"))


@pytest.mark.parametrize("kind", ["single", "dp", "ep"])
def test_batch_n_plus_1_is_requested_before_step_n_is_accounted(
        monkeypatch, request, kind):
    log = []
    t, three = _three_batches(kind, request)
    t = _logging_trainer(monkeypatch, log, t)
    m = t.train_epoch(_Logged(three, log))
    assert log == ["pack 0", "step 0",
                   "pack 1", "account 0", "step 1",
                   "pack 2", "account 1", "step 2",
                   "end", "account 2"]
    assert np.isfinite(m["loss"]) and np.isfinite(m["mae"])


def test_an_epoch_of_one_batch_still_accounts_it(monkeypatch, fixed_clock):
    log = []
    t = _logging_trainer(monkeypatch, log)
    one = BatchLoader(GRAPHS[:BATCH], BATCH, layout="mxu", shuffle=True,
                      seed=0)
    model, loss_fn = _model()
    serial = _trainer(model, loss_fn)
    with observe.tracing():
        m = t.train_epoch(_Logged(one, log))
    assert log == ["pack 0", "step 0", "end", "account 0"]
    assert (m, t._last_throughput) == _serial_epoch(
        serial, BatchLoader(GRAPHS[:BATCH], BATCH, layout="mxu",
                            shuffle=True, seed=0))
    c = observe.summary()["counters"]
    assert "epoch.readback_deferred" not in c
    assert "epoch.readback_ready" not in c


@pytest.mark.parametrize("kind", ["block", "micro"])
def test_every_step_but_the_epochs_last_is_deferred(kind):
    model, loss_fn = _model()
    t = _trainer(model, loss_fn)
    ld = _loader(kind)
    for epoch in range(2):
        with observe.tracing():
            t.train_epoch(ld)
        c = observe.summary()["counters"]
        # on the CPU every deferred step is ready
        assert c["epoch.readback_deferred"] == (epoch + 1) * (len(ld) - 1)
        assert c["epoch.readback_ready"] == c["epoch.readback_deferred"]


# ------------------------------------------------------------- benchmark
def _reader():
    spec = importlib.util.spec_from_file_location(
        "readback_ready_share", ROOT / "benchmark" / "metrics" /
        "readback_ready_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("counters, want", [
    ({"epoch.readback_ready": 15, "epoch.readback_deferred": 15}, 93.75),
    ({"epoch.readback_ready": 12, "epoch.readback_deferred": 15}, 75.0),
    ({"epoch.readback_deferred": 15}, 0.0),
    ({"step.graph_replays": 16, "h2d.copies": 464}, None),
])
def test_readback_ready_share_reads_the_ready_counter(counters, want):
    spans = {"spans": {"step": {"count": 16, "ms": 1.0, "self_ms": 1.0}},
             "counters": counters, "top_level_ms": 1.0, "on_ms": 1.0}
    run = types.SimpleNamespace(trace={}, spans=spans)
    assert _reader()(run) == want
    assert _reader()(types.SimpleNamespace(trace=None)) is None


# ------------------------------------------------------------- the card
class _Slow:
    """A loader that takes ms milliseconds over each batch, as a pack of a
    real batch does, so the card finishes the step it runs meanwhile."""

    def __init__(self, loader, ms):
        self.loader, self.ms = loader, ms

    def __iter__(self):
        for gb in self.loader:
            time.sleep(self.ms / 1e3)
            yield gb


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["block", "micro"])
def test_deferred_host_values_equal_the_steps_device_values(kind,
                                                            monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    model, loss_fn = _model()
    t = Trainer(model, loss_fn, TrainParams(seed=41), device="cuda")
    assert t.step_graphs is not None
    issued, accounted, answers = [], [], []
    inner = t.train_step

    def step(gb, aug=None):
        loss, scores = inner(gb, aug)
        # one (loss or None, scores) per micro-batch, as accounted
        for k, s in enumerate(scores if kind == "micro" else [scores]):
            issued.append((loss if k == 0 else None, s))
        return loss, scores

    t.train_step = step
    add = T._MetricAccumulator.add

    def logged_add(self, gb, scores, loss):
        accounted.append((loss, scores.copy()))
        return add(self, gb, scores, loss)

    monkeypatch.setattr(T._MetricAccumulator, "add", logged_add)
    real = torch.cuda.Event

    class Event(real):
        def query(self):
            answers.append(super().query())
            return answers[-1]

    monkeypatch.setattr(torch.cuda, "Event", Event)
    ld = _loader(kind)
    with observe.tracing():
        t.train_epoch(ld)                  # eager, capture, replays
        t.train_epoch(_Slow(ld, 50.0))     # each step ready when read
    c = observe.summary()["counters"]
    if kind == "block":
        assert c["step.graph_replays"] > len(ld)
    else:
        assert c["step.eager"] == 2 * len(ld)
    micros = 2 if kind == "micro" else 1
    assert len(issued) == len(accounted) == 2 * len(ld) * micros
    # read only now, long after the later steps were issued
    for (loss, scores), (value, host) in zip(issued, accounted):
        assert value == (None if loss is None else loss.item())
        assert np.array_equal(host, scores.cpu().numpy())
    assert len(answers) == c["epoch.readback_deferred"] == 2 * (len(ld) - 1)
    assert c.get("epoch.readback_ready", 0) == sum(answers)
    assert all(answers[len(ld) - 1:])
