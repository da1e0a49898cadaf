"""The single-device train step replayed from CUDA graphs
(dgn_tpu_torch/train/graphs.py), its bookkeeping on the CPU: the trainer
takes a graph factory, and these tests hand it FakeGraph, which re-runs
the captured callable on each replay as a CUDA graph re-runs its kernels.
Covered: the signature and where the path engages (the block layout yes;
the flat layout, micro-batches, dropout, input dropout, augmentation and
a rank trainer no), the capture on a signature's second step, one captured
signature with an escape-sized batch eager, the launch counters per
replay, the static copies in h2d.copies, an lr drop reaching the replayed
Adam, grads zeroed in place on an eager step after the capture, clones
returned, a checkpoint restore dropping the graphs, and the benchmark's
graph_replay_share reader.  Every replayed step is held against a trainer
without graphs from the same weights and with the same Adam: the same
losses, scores, gradients and weights, bit for bit."""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from dgn_tpu_torch import observe
from dgn_tpu_torch.data.loader import BatchLoader
from dgn_tpu_torch.data.synthetic import synthetic_zinc
from dgn_tpu_torch.graph import pack_graphs
from dgn_tpu_torch.models import DGNConfig, zinc_model
from dgn_tpu_torch.ops import adjacency
from dgn_tpu_torch.ops.scalers import degree_stats
from dgn_tpu_torch.train import graphs
from dgn_tpu_torch.train.checkpoint import Checkpointer
from dgn_tpu_torch.train.trainer import TrainParams, Trainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


class FakeGraph:
    """CudaGraph's stand-in on the CPU.  capture runs fn once, and that run
    is the first replay after it (a CUDA capture runs nothing, and the
    trainer replays at once); every later replay runs fn again, putting
    back what a replay of kernels would not do: the Python launch counters
    fn moves stay as they were, and a backward's gradients land in the
    .grad tensors the capture made."""

    def __init__(self, kind, params):
        self.kind, self.params = kind, params
        self.fn, self.pending, self.replays = None, False, 0

    def capture(self, fn, pool=None):
        fn()
        self.fn, self.pending = fn, True
        return "pool"

    def replay(self):
        self.replays += 1
        if self.pending:
            self.pending = False
            return
        counts = observe.launch_counts()
        held = None
        if self.kind == "backward":
            held = [p.grad for p in self.params]
            for p in self.params:
                p.grad = None
        self.fn()
        if held is not None:
            for p, g in zip(self.params, held):
                g.copy_(p.grad)
                p.grad = g
        observe.add_launches({k: counts[k] - n for k, n in
                              observe.launch_counts().items()})


class Fakes:
    """A graph factory that keeps the graphs it made."""

    def __init__(self, model):
        self.params = list(model.parameters())
        self.made = []

    def __call__(self, kind):
        g = FakeGraph(kind, self.params)
        self.made.append(g)
        return g


@pytest.fixture(autouse=True)
def fresh_recorder():
    observe.disable()
    observe.reset()
    yield
    observe.disable()
    observe.reset()


@pytest.fixture
def counted(monkeypatch):
    """build_pair_adjacency counting its calls, as the kernel counts its
    launches, over the plain version."""
    plain = adjacency.build_pair_adjacency_plain

    def build(weights, layout, out_dtype=None):
        build.launches += 1
        return plain(weights, layout, out_dtype)

    build.launches = 0
    monkeypatch.setattr(adjacency, "build_pair_adjacency", build)
    return build


GRAPHS = synthetic_zinc(32, seed=1)
BATCH = 8


def _model(seed=0, **net):
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in GRAPHS])
    cfg = DGNConfig(hidden_dim=8, out_dim=8, L=2, avg_d=degree_stats(degs),
                    **net)
    return zinc_model(cfg, torch.Generator().manual_seed(seed))


def _pair(net=None, params=None):
    """(graph trainer, its factory, a trainer without graphs) from the same
    weights, with the same Adam (adam_l2(graphed=True): its lr a float32
    tensor, which rounds the lr as a Python float does not)."""
    model, loss_fn = _model(**(net or {}))
    twin = copy.deepcopy(model)
    p = TrainParams(seed=41, weight_decay=3e-6, **(params or {}))
    fakes = Fakes(model)
    eager = Trainer(twin, loss_fn, p, device="cpu", graph_factory=Fakes(twin))
    eager.step_graphs = None
    return (Trainer(model, loss_fn, p, device="cpu", graph_factory=fakes),
            fakes, eager)


def _loader(layout="mxu"):
    return BatchLoader(GRAPHS, BATCH, layout=layout, shuffle=True, seed=0)


def _batches(n, layout="mxu"):
    out, ld = [], _loader(layout)
    while len(out) < n:
        out += list(ld)
    return out[:n]


def _escape(ld):
    """The first batch's graphs at larger pads than the loader's: another
    signature, as the loader's escape repack makes."""
    gs = sorted(GRAPHS[:BATCH], key=lambda g: -g.num_nodes)
    return pack_graphs(gs, n_pad=ld.n_pad + 128, e_pad=ld.e_pad + 128,
                       g_pad=ld.g_pad, mxu_layout=True,
                       n_pairs_pad=ld.pair_pad)


def _counters():
    return observe.summary()["counters"]


def _state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _grads(trainer):
    return [None if p.grad is None else p.grad.clone()
            for p in trainer.model.parameters()]


def _assert_same(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------- signature
def test_the_signature_of_block_batches_and_none_elsewhere():
    ld = _loader()
    a, b = list(ld)[:2]
    fam = ("mean", "dir1-dx")
    assert graphs.signature(a, fam) == graphs.signature(b, fam)
    assert graphs.signature(a, fam) != graphs.signature(a, ("mean",))
    assert graphs.signature(_escape(ld), fam) != graphs.signature(a, fam)
    assert graphs.signature(_batches(1, "flat")[0], fam) is None
    assert graphs.signature([a, b], fam) is None
    assert graphs.signature(dataclasses.replace(a, edge_ctx=object()),
                            fam) is None
    sig = graphs.signature(a, fam)
    layout = sig[1]
    for name in ("n_pairs", "n_node_blocks", "n_graph_blocks"):
        assert getattr(a.mxu, name) in layout, name


@pytest.mark.parametrize("net, params", [
    ({"dropout": 0.3}, {}),
    ({"in_feat_dropout": 0.1}, {}),
    ({}, {"flip": True}),
    ({}, {"augmentation": 15.0}),
    ({}, {"distortion": 0.1}),
])
def test_no_graphs_where_the_step_draws_random_numbers(net, params):
    model, loss_fn = _model(**net)
    t = Trainer(model, loss_fn, TrainParams(seed=41, **params),
                device="cpu", graph_factory=Fakes(model))
    assert t.step_graphs is None
    assert not isinstance(t.optimizer.param_groups[0]["lr"], torch.Tensor)
    with observe.tracing():
        for gb in _batches(3):
            t.train_step(gb)
    assert _counters()["step.eager"] == 3


def test_graphs_only_with_a_factory_and_a_graphed_adam():
    model, loss_fn = _model()
    assert Trainer(model, loss_fn, TrainParams(), device="cpu"
                   ).step_graphs is None
    assert graphs.default_factory("cpu") is None
    assert graphs.default_factory("cuda") is graphs.CudaGraph
    t, _, _ = _pair()
    lr = t.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
    assert lr.item() == pytest.approx(1e-3)
    assert t.optimizer.param_groups[0]["weight_decay"] == 3e-6


def test_a_rank_trainer_takes_no_graphs(monkeypatch):
    from dgn_tpu_torch.parallel.dp import DataParallelTrainer
    from dgn_tpu_torch.parallel.halo import EdgeParallelTrainer
    model, loss_fn = _model()
    monkeypatch.setattr(graphs, "default_factory",
                        lambda device: Fakes(model))
    mesh = types.SimpleNamespace(device=torch.device("cpu"), rank=0, size=1,
                                 group=None)
    t = DataParallelTrainer(model, loss_fn, TrainParams(seed=41), mesh)
    assert t.step_graphs is None
    for cls in (DataParallelTrainer, EdgeParallelTrainer):
        assert cls._reduce_grads is not Trainer._reduce_grads
    with observe.tracing():
        for gb in _batches(3):
            t.train_step(gb)
    c = _counters()
    assert c["step.eager"] == 3 and "step.graph_replays" not in c


def test_an_instance_override_of_reduce_grads_keeps_the_step_eager():
    t, fakes, _ = _pair()
    t._reduce_grads = lambda: None
    with observe.tracing():
        for gb in _batches(3):
            t.train_step(gb)
    assert _counters()["step.eager"] == 3 and not fakes.made


@pytest.mark.parametrize("kind", ["flat", "micro", "aug_draws"])
def test_flat_micro_batches_and_handed_draws_run_eagerly(kind):
    t, fakes, _ = _pair()
    if kind == "flat":
        steps = [(gb, None) for gb in _batches(3, "flat")]
    elif kind == "micro":
        a, b, c, d = _batches(4)
        steps = [([a, b], None), ([c, d], None), ([a, b], None)]
    else:
        t.p = dataclasses.replace(t.p, flip=True)
        from dgn_tpu_torch.train.trainer import AugDraws
        steps = [(gb, AugDraws(flip=torch.rand(gb.eig.shape)))
                 for gb in _batches(3)]
    with observe.tracing():
        for gb, aug in steps:
            t.train_step(gb, aug)
    assert _counters()["step.eager"] == 3 and not fakes.made


# ------------------------------------------------------------- lifecycle
def test_capture_on_the_signatures_second_step():
    t, fakes, _ = _pair()
    gbs = _batches(4)
    seen = []
    with observe.tracing():
        for gb in gbs:
            t.train_step(gb)
            c = _counters()
            seen.append((c.get("step.eager", 0),
                         c.get("step.graph_captures", 0),
                         c.get("step.graph_replays", 0)))
    assert seen == [(1, 0, 0), (1, 1, 1), (1, 1, 2), (1, 1, 3)]
    assert [g.kind for g in fakes.made] == list(graphs.KINDS)
    assert all(g.replays == 3 for g in fakes.made)
    s = observe.summary()["spans"]
    assert s["step"]["count"] == 4 and s["step.capture"]["count"] == 1
    for name in ("step.forward", "step.backward", "step.h2d"):
        assert s[name]["count"] == 4, name
    assert s["step.optimizer"]["count"] == 8
    # the one eager step's
    assert s["step.grad_sync"]["count"] == 1


def test_replayed_steps_match_eager_steps_bit_for_bit():
    """Six steps, an escape-sized batch among them and an lr drop after the
    third: the same losses, scores, gradients and weights after every step
    as a trainer without graphs."""
    t, _, ref = _pair()
    ld = _loader()
    gbs = _batches(6)
    gbs[3] = _escape(ld)
    with observe.tracing():
        for i, gb in enumerate(gbs):
            if i == 3:
                for tr in (t, ref):
                    tr.scheduler.lr = 2.5e-4
            (la, sa), (lb, sb) = t.train_step(gb), ref.train_step(gb)
            assert torch.equal(la, lb) and torch.equal(sa, sb), i
            for ga, gb_ in zip(_grads(t), _grads(ref)):
                assert torch.equal(ga, gb_), i
            _assert_same(_state(t), _state(ref))
    c = _counters()
    # the graph trainer's 2 eager steps and the other trainer's 6
    assert c["step.graph_replays"] == 4 and c["step.eager"] == 2 + 6


def test_one_captured_signature_and_escapes_stay_eager():
    t, fakes, _ = _pair()
    ld = _loader()
    a, b, c = _batches(3)
    esc = _escape(ld)
    with observe.tracing():
        for gb in (a, b, esc, esc, c, esc):
            t.train_step(gb)
    cnt = _counters()
    assert cnt["step.graph_captures"] == 1 and len(fakes.made) == 3
    assert cnt["step.graph_replays"] == 2 and cnt["step.eager"] == 4
    assert t.step_graphs.sig == graphs.signature(a, t._families)


def test_the_first_signature_met_twice_is_the_one_captured():
    t, _, _ = _pair()
    ld = _loader()
    a, b = _batches(2)
    esc = _escape(ld)
    with observe.tracing():
        for gb in (esc, a, esc, b):
            t.train_step(gb)
    c = _counters()
    assert t.step_graphs.sig == graphs.signature(esc, t._families)
    assert c["step.eager"] == 3 and c["step.graph_replays"] == 1


# ------------------------------------------------------------- counters
def test_launch_counters_count_each_replay(counted):
    t, _, ref = _pair()
    gbs = _batches(5)
    grown = []
    for gb in gbs:
        before = counted.launches
        t.train_step(gb)
        grown.append(counted.launches - before)
    assert grown == [1] * 5
    assert t.step_graphs.launches["forward"] == {
        "build_pair_adjacency.launches": 1}
    assert t.step_graphs.launches["backward"] == {}
    counted.launches = 0
    for gb in gbs:
        ref.train_step(gb)
    assert counted.launches == 5
    with observe.tracing():
        t.train_step(gbs[0])
    assert _counters()["build_pair_adjacency.launches"] == 1


def test_h2d_counts_the_copies_into_the_captured_inputs():
    t, _, _ = _pair()
    gbs = _batches(3)
    with observe.tracing():
        for gb in gbs:
            t.train_step(gb)
    # the CPU is the device here: nothing changes device
    assert "h2d.copies" not in _counters()
    tensors = [v for v in vars(gbs[0]).values()
               if isinstance(v, torch.Tensor)]
    layout = [v for v in vars(gbs[0].mxu).values()
              if isinstance(v, torch.Tensor)]
    # captured inputs on another device (meta stands in for a card): one
    # copy per tensor of the batch and of its layout
    observe.reset()
    t.step_graphs.static = gbs[0].to("meta")
    with observe.tracing():
        t.step_graphs.load(gbs[1])
        moved = _counters()
    assert moved["h2d.copies"] == len(tensors) + len(layout)
    assert moved["h2d.bytes"] == sum(x.numel() * x.element_size()
                                     for x in tensors + layout)


def test_an_lr_drop_reaches_the_replayed_adam():
    t, _, ref = _pair()
    gbs = _batches(5)
    lr = t.optimizer.param_groups[0]["lr"]
    for i, gb in enumerate(gbs):
        if i == 3:
            t.scheduler.lr = ref.scheduler.lr = 1e-4
        t.train_step(gb)
        ref.train_step(gb)
    assert t.optimizer.param_groups[0]["lr"] is lr
    assert lr.item() == pytest.approx(1e-4)
    _assert_same(_state(t), _state(ref))
    # and against a trainer that kept the old lr, the weights moved less
    t2, _, _ = _pair()
    for gb in gbs:
        t2.train_step(gb)
    w0 = dict(_model()[0].named_parameters())
    moved = sum(float((p.detach() - w0[k].detach()).abs().sum())
                for k, p in t.model.named_parameters())
    moved2 = sum(float((p.detach() - w0[k].detach()).abs().sum())
                 for k, p in t2.model.named_parameters())
    assert moved < moved2


def test_an_eager_step_after_the_capture_zeroes_grads_in_place():
    t, _, ref = _pair()
    ld = _loader()
    a, b = _batches(2)
    for gb in (a, b):
        t.train_step(gb)
        ref.train_step(gb)
    held = [p.grad for p in t.model.parameters()]
    assert all(g is not None for g in held)
    esc = _escape(ld)
    t.train_step(esc)
    ref.train_step(esc)
    for p, g in zip(t.model.parameters(), held):
        assert p.grad is g
    for ga, gb_ in zip(_grads(t), _grads(ref)):
        assert torch.equal(ga, gb_)
    t.train_step(a)
    ref.train_step(a)
    assert all(p.grad is g for p, g in zip(t.model.parameters(), held))
    _assert_same(_state(t), _state(ref))


def test_returned_loss_and_scores_are_clones():
    t, _, _ = _pair()
    a, b, c = _batches(3)
    t.train_step(a)
    l2, s2 = t.train_step(b)
    keep = (l2.clone(), s2.clone())
    out = t.step_graphs.out
    assert l2.data_ptr() != out["loss"].data_ptr()
    assert s2.data_ptr() != out["scores"].data_ptr()
    assert not l2.requires_grad and not s2.requires_grad
    l3, s3 = t.train_step(c)
    assert torch.equal(l2, keep[0]) and torch.equal(s2, keep[1])
    assert not torch.equal(s3, s2)


def test_train_epoch_replays_and_eval_stays_eager():
    t, _, ref = _pair()
    ld, ld2 = _loader(), _loader()
    with observe.tracing():
        ma = t.train_epoch(ld)
        mb = ref.train_epoch(ld2)
    assert ma == mb
    c = _counters()
    assert c["step.graph_replays"] == len(ld) - 1
    assert c["step.eager"] == 1 + len(ld2)
    ev = BatchLoader(GRAPHS, BATCH, layout="mxu", cache=True)
    assert t.evaluate(ev) == ref.evaluate(ev)


def test_a_restore_drops_the_captured_step(tmp_path):
    t, _, ref = _pair()
    gbs = _batches(4)
    for gb in gbs[:2]:
        t.train_step(gb)
        ref.train_step(gb)
    ck = Checkpointer(str(tmp_path))
    ck.save(0, ref)
    assert t.step_graphs.held
    ck.restore(t)
    assert not t.step_graphs.held
    _assert_same(_state(t), _state(ref))
    with observe.tracing():
        for gb in gbs[2:]:
            la, _ = t.train_step(gb)
            lb, _ = ref.train_step(gb)
            assert torch.equal(la, lb)
    c = _counters()
    assert c["step.graph_captures"] == 1 and c["step.eager"] == 3
    _assert_same(_state(t), _state(ref))


# ------------------------------------------------------------- benchmark
def _reader():
    spec = importlib.util.spec_from_file_location(
        "graph_replay_share", ROOT / "benchmark" / "metrics" /
        "graph_replay_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("counters, want", [
    ({"step.graph_replays": 9, "step.eager": 1}, 90.0),
    ({"step.graph_replays": 10}, 100.0),
    ({"step.eager": 10}, 0.0),
    ({"h2d.copies": 290}, None),
])
def test_graph_replay_share_reads_the_replay_counter(counters, want):
    spans = {"spans": {"step": {"count": 10, "ms": 1.0, "self_ms": 1.0}},
             "counters": counters, "top_level_ms": 1.0, "on_ms": 1.0}
    run = types.SimpleNamespace(trace={}, spans=spans)
    assert _reader()(run) == want
    assert _reader()(types.SimpleNamespace(trace=None)) is None
