"""The span and counter recorder of dgn_tpu_torch/observe.py and the spans
the port opens: off, span() is one shared no-op and nothing is recorded;
on, spans nest with their parent, self time and step index; counters,
h2d counted per tensor that changes device (the meta device stands in for
a card); the "dgn." ranges under torch.profiler (profile_steps' trace:
tests/test_torch_observe.py); a gc span per collection; a CPU train_epoch
of a toy ZINC net with each phase once a step; the same loss and weights
with tracing on and off; the entry point's --trace_spans records and the
report's span table."""
from __future__ import annotations

import contextlib
import gc
import json
import time

import numpy as np
import pytest
import torch

from dgn_tpu_torch import observe
from dgn_tpu_torch import run as trun
from dgn_tpu_torch import runtime
from dgn_tpu_torch.data.loader import BatchLoader
from dgn_tpu_torch.data.synthetic import synthetic_zinc
from dgn_tpu_torch.graph import mxu_bucket_sizes, pack_graphs
from dgn_tpu_torch.models import DGNConfig, zinc_model
from dgn_tpu_torch.ops.scalers import degree_stats
from dgn_tpu_torch.tools import report as treport
from dgn_tpu_torch.train.trainer import AugDraws, TrainParams, Trainer

torch.set_num_threads(1)

PHASES = ("step", "step.h2d", "step.forward", "step.backward",
          "step.grad_sync", "epoch.readback", "epoch.account")


@pytest.fixture(autouse=True)
def fresh_recorder():
    observe.disable()
    observe.reset()
    yield
    observe.disable()
    observe.reset()


def _records(name=None):
    return [r for r in observe.RECORDER.records
            if name is None or r[1] == name]


def test_off_span_is_the_shared_no_op_and_records_nothing():
    a, b = observe.span("x"), observe.span("y")
    assert a is b is observe._NO_SPAN
    with a:
        observe.count("c", 3)
    assert observe.to_device(torch.ones(3), "meta").device.type == "meta"
    r = observe.RECORDER
    assert not r.records and not r.totals and not r.counters
    assert observe.summary()["spans"] == {}


def test_nesting_parent_self_time_and_step():
    with observe.tracing():
        with observe.span("outer"):
            time.sleep(0.002)
            with observe.span("inner"):
                time.sleep(0.004)
        observe.next_step()
        with observe.span("outer"):
            pass
    assert not observe.RECORDER.on
    (inner,), outer = _records("inner"), _records("outer")
    assert inner[4] == outer[0][0]                      # parent id
    assert outer[0][4] is None and outer[1][4] is None
    assert inner[5] == outer[0][5] == outer[1][5] - 1   # step index
    assert outer[0][2] <= inner[2] <= inner[3] <= outer[0][3]
    t = observe.RECORDER.totals
    assert t["outer"][0] == 2 and t["inner"][0] == 1
    inner_ns = inner[3] - inner[2]
    assert t["outer"][2] == t["outer"][1] - inner_ns    # self time
    assert t["inner"][1] == t["inner"][2] == inner_ns
    s = observe.summary()
    assert s["top_level_ms"] == pytest.approx(t["outer"][1] / 1e6)
    assert s["on_ms"] >= s["top_level_ms"]


def test_tracing_nests_and_summary_since_a_snapshot():
    with observe.tracing():
        with observe.span("a"):
            pass
        snap = observe.snapshot()
        with observe.tracing():
            with observe.span("a"):
                pass
        assert observe.RECORDER.on        # the inner block left it on
        observe.count("c", 2)
    s = observe.summary(snap)
    assert s["spans"]["a"]["count"] == 1 and s["counters"]["c"] == 2
    assert observe.summary()["spans"]["a"]["count"] == 2


def test_records_are_bounded():
    observe.RECORDER.records = observe.collections.deque(maxlen=4)
    try:
        with observe.tracing():
            for _ in range(10):
                with observe.span("s"):
                    pass
        assert len(observe.RECORDER.records) == 4
        assert observe.RECORDER.totals["s"][0] == 10
    finally:
        observe.RECORDER.records = observe.collections.deque(
            maxlen=observe.RECORD_CAPACITY)


def _packed(n=8, seed=3):
    graphs = synthetic_zinc(n, seed=seed)
    n_pad, e_pad, g_pad = mxu_bucket_sizes(graphs, n)
    return pack_graphs(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                       mxu_layout=True)


def test_h2d_counts_each_tensor_that_changes_device():
    gb = _packed()
    tensors = [v for v in vars(gb).values() if isinstance(v, torch.Tensor)]
    layout = [v for v in vars(gb.mxu).values() if isinstance(v, torch.Tensor)]
    want = len(tensors) + len(layout)
    nbytes = sum(t.numel() * t.element_size() for t in tensors + layout)
    with observe.tracing():
        gb.to("cpu")                                 # no device change
        assert "h2d.copies" not in observe.RECORDER.counters
        meta = gb.to("meta")
        AugDraws(rotate=torch.rand(4)).to("meta")
    assert meta.node_mask.device.type == "meta"
    c = observe.summary()["counters"]
    assert c["h2d.copies"] == want + 1
    assert c["h2d.bytes"] == nbytes + 4 * 4
    assert "build_pair_adjacency.launches" in c


def test_summary_counts_the_launches_made_while_on(monkeypatch):
    from dgn_tpu_torch.ops import adjacency
    monkeypatch.setattr(adjacency.build_pair_adjacency, "launches", 0)
    adjacency.build_pair_adjacency.launches += 5        # while off
    with observe.tracing():
        adjacency.build_pair_adjacency.launches += 2
        assert observe.summary()["counters"][
            "build_pair_adjacency.launches"] == 2
    adjacency.build_pair_adjacency.launches += 7        # off again
    with observe.tracing():
        adjacency.build_pair_adjacency.launches += 1
    c = observe.summary()["counters"]
    assert c["build_pair_adjacency.launches"] == 3
    assert c["segment_extremes_fwd.launches"] == 0


def test_spans_are_dgn_ranges_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    with observe.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with observe.span("outer"):
                with observe.span("inner"):
                    torch.ones(4).sum()
        with observe.span("after"):
            pass
    names = {e.name for e in prof.events()}
    assert {"dgn.outer", "dgn.inner"} <= names and "dgn.after" not in names


def test_a_collection_is_a_gc_span():
    with observe.tracing():
        with observe.span("work"):
            gc.collect()
    (work,) = _records("work")
    spans = _records("gc")
    assert [g[4] for g in spans].count(work[0]) >= 1
    assert observe.RECORDER.counters["gc.gen2"] >= 1
    n = len(spans)
    gc.collect()                                     # off: not recorded
    assert len(_records("gc")) == n


def _toy(seed=0, n=24, batch=8, L=2):
    graphs = synthetic_zinc(n, seed=1)
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    cfg = DGNConfig(hidden_dim=8, out_dim=8, L=L, avg_d=degree_stats(degs))
    model, loss_fn = zinc_model(cfg, torch.Generator().manual_seed(seed))
    trainer = Trainer(model, loss_fn, TrainParams(seed=41), device="cpu")
    return trainer, BatchLoader(graphs, batch, layout="mxu", shuffle=True,
                                seed=0)


def test_train_epoch_opens_each_phase_once_a_step():
    trainer, loader = _toy(L=3)
    with observe.tracing():
        trainer.train_epoch(loader)
    s = observe.summary()["spans"]
    steps = len(loader)
    assert s["step"]["count"] == steps == 3
    for name in PHASES:
        assert s[name]["count"] == steps, name
    assert s["step.optimizer"]["count"] == 2 * steps   # before and after
    assert s["loader.pack"]["count"] == s["pack.arrays"]["count"] == steps
    # the block pack is one native call where the packer is built, else
    # numpy with build_mxu_layout's span inside pack.arrays
    counters = observe.RECORDER.counters
    if runtime.available():
        assert counters["pack.native"] == steps and "pack.numpy" not in counters
        assert "pack.block_layout" not in s
    else:
        assert counters["pack.numpy"] == steps
        assert s["pack.block_layout"]["count"] == steps
    assert s["loader.shuffle"]["count"] == s["epoch.finish"]["count"] == 1
    for name in ("model.edge_context", "model.encode", "model.readout",
                 "model.layer_0", "model.layer_1", "model.layer_2"):
        assert s[name]["count"] == steps, name
    assert "model.layer_3" not in s
    parents = {r[0]: r[1] for r in observe.RECORDER.records}
    for r in observe.RECORDER.records:
        if r[1].startswith("step."):
            assert parents[r[4]] == "step"
        if r[1].startswith("model."):
            assert parents[r[4]] == "step.forward"
        if r[1] in ("loader.pack", "step", "epoch.readback"):
            assert r[4] is None
    # one iteration's pack, the previous step's readback and its own step
    # share a step index; the last step is read back with epoch.finish
    by_step = {}
    for r in observe.RECORDER.records:
        by_step.setdefault(r[5], set()).add(r[1])
    full = [by_step[k] for k in sorted(by_step) if "step" in by_step[k]]
    assert len(full) == steps
    assert all({"loader.pack", "step"} <= v for v in full)
    assert "epoch.readback" not in full[0]
    assert all("epoch.readback" in v for v in full[1:])
    (last,) = [v for v in by_step.values() if "epoch.finish" in v]
    assert {"epoch.readback", "epoch.account"} <= last
    assert "step" not in last


def test_an_escape_repack_is_its_own_span():
    trainer, loader = _toy()
    loader.n_pad = 128                   # too small for a batch of 8
    with observe.tracing():
        trainer.train_epoch(loader)
    s = observe.summary()["spans"]
    assert loader.n_escapes == s["loader.escape"]["count"] > 0
    parents = {r[0]: r[1] for r in observe.RECORDER.records}
    assert all(parents[r[4]] == "loader.pack" for r in _records(
        "loader.escape"))


def test_tracing_changes_no_number():
    out = []
    for traced in (False, True):
        observe.reset()
        trainer, loader = _toy(seed=5)
        gbs = list(loader)[:3]
        with observe.tracing() if traced else contextlib.nullcontext():
            losses = [float(trainer.train_step(gb)[0]) for gb in gbs]
        out.append((losses, {k: v.clone() for k, v in
                             trainer.model.state_dict().items()}))
        assert bool(observe.RECORDER.totals) == traced
    (la, wa), (lb, wb) = out
    assert la == lb
    for k in wa:
        assert torch.equal(wa[k], wb[k]), k


def test_train_epoch_follows_an_active_profiler():
    from torch.profiler import ProfilerActivity, profile
    trainer, loader = _toy()
    trainer.train_epoch(loader)
    assert not observe.RECORDER.totals
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_epoch(loader)
    assert not observe.RECORDER.on
    assert observe.summary()["spans"]["step"]["count"] == len(loader)
    names = {e.name for e in prof.events()}
    assert {"dgn.step", "dgn.loader.pack", "dgn.step.forward"} <= names


def test_entry_point_records_spans_per_epoch(tmp_path, capsys):
    flags = ["--dataset", "ZINC", "--batch_size", "8", "--hidden_dim", "8",
             "--out_dim", "8", "--L", "2", "--synthetic_size", "24",
             "--device", "cpu", "--epochs", "2", "--out_dir",
             str(tmp_path)]
    trun.run(flags + ["--trace_spans"])
    assert not observe.RECORDER.on
    recs = [json.loads(x) for x in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["epoch", "epoch"]
    for r in recs:
        sp = r["spans"]
        assert sp["steps"] == 3
        assert sp["spans"]["step.forward"]["count"] == 3
        assert sp["spans"]["model.layer_1"]["ms_per_step"] > 0
        assert sp["counters"]["build_pair_adjacency.launches"] == 0
    capsys.readouterr()
    assert treport.main([str(tmp_path / "metrics.jsonl")]) == 0
    text = capsys.readouterr().out
    assert "| span | count | ms | self ms |" in text
    assert "| step.backward | 3 |" in text
    trun.run(flags + ["--out_dir", str(tmp_path / "plain")])
    plain = json.loads((tmp_path / "plain" / "metrics.jsonl")
                       .read_text().splitlines()[0])
    assert "spans" not in plain


def test_a_micro_batched_step_opens_step_micro_once_a_micro_batch():
    """A step of K micro-batches opens `step.micro` K times, each under
    `step` and around that micro-batch's copy, forward and backward, and
    counts `step.micro_batches` K times; a single-batch eager step opens
    and counts neither."""
    trainer, loader = _toy()
    a, b, c = list(loader)
    with observe.tracing():
        trainer.train_step([a, b])
        trainer.train_step([a, b, c])
        observe.next_step()
        trainer.train_step(c)
    s = observe.summary()
    assert s["spans"]["step.micro"]["count"] == 5
    assert s["counters"]["step.micro_batches"] == 5
    assert s["counters"]["step.eager"] == 3
    parents = {r[0]: r[1] for r in observe.RECORDER.records}
    micro_ids = {r[0] for r in _records("step.micro")}
    assert all(parents[r[4]] == "step" for r in _records("step.micro"))
    inner = [r for r in observe.RECORDER.records
             if r[1] in ("step.h2d", "step.forward", "step.backward")]
    assert sum(r[4] in micro_ids for r in inner) == 3 * 5
    # the single batch's three phases sit directly under its step
    assert sum(parents[r[4]] == "step" for r in inner) == 3


def test_neither_a_single_nor_a_replayed_step_opens_step_micro():
    from test_torch_train_graphs import Fakes
    trainer, loader = _toy()
    graphed = Trainer(trainer.model, trainer.loss_fn, TrainParams(seed=41),
                      device="cpu", graph_factory=Fakes(trainer.model))
    gb = next(iter(loader))
    with observe.tracing():
        trainer.train_step(gb)
        for _ in range(3):
            graphed.train_step(gb)
    s = observe.summary()
    assert s["counters"]["step.graph_replays"] == 2
    assert s["counters"]["step.eager"] == 2
    assert "step.micro" not in s["spans"]
    assert "step.micro_batches" not in s["counters"]
