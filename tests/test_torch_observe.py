"""The port's observability module and tools against dgn_tpu's:
MetricStream, Throughput (real elements only, from the CPU batch, and the
trainer's per-epoch figures), poison_padding on both layouts,
step_fingerprint, profile_steps on the CPU, tools/report on one stream and
tools/multiplicity on the same synthetic graphs.

poison_padding NaNs the same lanes as dgn_tpu's on both layouts (compared
array by array, NaN positions included).  On the flat layout, in eval mode,
the port's ZINC and HIV nets give the clean batch's scores from the
poisoned batch, finite, at rtol 1e-5 / atol 1e-6 (dgn_tpu's own check,
tests/test_observe.py).  Both packages let pad lanes in elsewhere, so no
model-level check is made there: in train mode batch norm's masked
statistics multiply pad rows by 0, and on the block layout the dense block
products multiply pad rows by zero entries (0 * NaN is NaN).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from dgn_tpu import observe as jobserve
from dgn_tpu.graph import GraphData as JGraphData
from dgn_tpu.graph import pack_graphs as jpack
from dgn_tpu.tools import multiplicity as jmult
from dgn_tpu.tools import report as jreport

from dgn_tpu_torch import observe
from dgn_tpu_torch.data.loader import BatchLoader
from dgn_tpu_torch.data.synthetic import synthetic_ogb_mol, synthetic_zinc
from dgn_tpu_torch.graph import GraphData, mxu_bucket_sizes, pack_graphs
from dgn_tpu_torch.models import DGNConfig, hiv_model, zinc_model
from dgn_tpu_torch.tools import multiplicity as tmult
from dgn_tpu_torch.tools import report as treport
from dgn_tpu_torch.train.trainer import TrainParams, Trainer

torch.set_num_threads(1)


def test_metric_stream_jsonl(tmp_path):
    path = str(tmp_path / "sub" / "m.jsonl")
    ms = observe.MetricStream(path)
    ms.log("step", loss=1.5, lr=1e-3)
    rec = ms.log("epoch", epoch=0, mae=np.float32(0.7))
    ms.close()
    recs = [json.loads(line) for line in open(path)]
    assert recs[0]["kind"] == "step" and recs[0]["loss"] == 1.5
    assert recs[1]["epoch"] == 0 and recs[1]["mae"] == pytest.approx(0.7)
    assert rec["kind"] == "epoch" and set(recs[0]) == {"t", "kind", "loss",
                                                        "lr"}


def test_throughput_counts_real_elements_only():
    graphs = synthetic_zinc(4, seed=0)
    gb = pack_graphs(graphs, n_pad=512, e_pad=1024, g_pad=8)
    tp = observe.Throughput()
    tp.add_batch(gb)
    tp.add_batch(gb)
    r = tp.result()
    real_e = sum(g.num_edges for g in graphs)
    real_n = sum(g.num_nodes for g in graphs)
    assert r["steps"] == 2
    assert abs(r["edges_per_s"] * r["seconds"] - 2 * real_e) < 1e-6
    assert abs(r["nodes_per_s"] * r["seconds"] - 2 * real_n) < 1e-6
    assert abs(r["graphs_per_s"] * r["seconds"] - 8) < 1e-6
    assert r["edge_padding_efficiency"] == pytest.approx(real_e / 1024)
    assert r["node_padding_efficiency"] == pytest.approx(real_n / 512)
    # the loader's host batch only: a device copy would cost a sync
    with pytest.raises(ValueError, match="CPU batch"):
        tp.add_batch(gb.to("meta"))


def test_train_epoch_reports_throughput():
    graphs = synthetic_zinc(12, seed=1)
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    from dgn_tpu_torch.ops.scalers import degree_stats
    cfg = DGNConfig(hidden_dim=8, out_dim=8, L=1, avg_d=degree_stats(degs))
    model, loss_fn = zinc_model(cfg, torch.Generator().manual_seed(0))
    trainer = Trainer(model, loss_fn, TrainParams(), device="cpu")
    loader = BatchLoader(graphs, 4, layout="mxu", shuffle=True, seed=0)
    trainer.train_epoch(loader)
    tp = trainer._last_throughput
    assert set(tp) <= {"edges_per_s", "edge_padding_efficiency",
                       "pack_escapes"}
    real_e = sum(g.num_edges for g in graphs)
    slots = sum(gb.num_edges_padded for gb in loader)
    assert tp["edge_padding_efficiency"] == pytest.approx(real_e / slots,
                                                          abs=1e-4)
    assert tp["edges_per_s"] > 0


def _port(graphs):
    return [GraphData(**dataclasses.asdict(g)) for g in graphs]


def _jax_graphs(graphs):
    return [JGraphData(**dataclasses.asdict(g)) for g in graphs]


@pytest.mark.parametrize("mxu", [False, True], ids=["flat", "block"])
def test_poison_padding_poisons_the_reference_lanes(mxu):
    graphs = synthetic_ogb_mol(6, seed=2, n_tasks=1, k_eig=3)
    n, e, g = mxu_bucket_sizes(graphs, 6) if mxu else (384, 512, 8)
    kw = dict(n_pad=n, e_pad=e, g_pad=g, mxu_layout=mxu)
    tb = observe.poison_padding(pack_graphs(graphs, **kw))
    jb = jobserve.poison_padding(jpack(_jax_graphs(graphs), **kw))
    n_nan = 0
    for f in ("eig", "snorm_n", "snorm_e", "node_feat", "edge_feat",
              "pos_enc"):
        got, want = getattr(tb, f), getattr(jb, f)
        assert (got is None) == (want is None), f
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f)
            if got.is_floating_point():
                n_nan += int(torch.isnan(got).sum())
    assert n_nan > 0 and tb.edge_ctx is None


@pytest.mark.parametrize("task", ["zinc", "hiv"])
def test_poison_padding_is_harmless_on_the_flat_layout(task):
    """NaN-poisoned pads leave the flat layout's eval scores and loss as
    they are (max/min included)."""
    if task == "zinc":
        graphs, factory = synthetic_zinc(6, seed=2), zinc_model
        net = dict(aggregators="mean dir1-dx dir1-av max min")
    else:
        graphs = synthetic_ogb_mol(6, seed=2, n_tasks=1, k_eig=3)
        factory = hiv_model
        net = dict(type_net="simple", scalers="identity", graph_norm=False,
                   aggregators="mean max min dir1-dx dir1-av")
    gb = pack_graphs(graphs, n_pad=384, e_pad=512, g_pad=8)
    cfg = DGNConfig(hidden_dim=10, out_dim=10, L=2,
                    avg_d={"log": 1.0, "lin": 2.0}, **net)
    model, loss_fn = factory(cfg, torch.Generator().manual_seed(0))
    m = gb.graph_mask
    model.eval()
    with torch.no_grad():
        clean = model(gb)
        poisoned = model(observe.poison_padding(gb))
    assert torch.isfinite(poisoned[m]).all()
    np.testing.assert_allclose(poisoned[m].numpy(), clean[m].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss_fn(poisoned, gb)),
                               float(loss_fn(clean, gb)), rtol=1e-5)


def test_step_fingerprint_detects_divergence():
    p1 = {"w": torch.ones(4, 4), "b": torch.zeros(4)}
    p2 = {"w": torch.ones(4, 4), "b": torch.zeros(4)}
    assert observe.step_fingerprint(p1) == observe.step_fingerprint(p2)
    p3 = {"w": torch.ones(4, 4), "b": torch.zeros(4)}
    p3["w"][0, 0] = 1.0000001
    assert observe.step_fingerprint(p1) != observe.step_fingerprint(p3)
    m1 = torch.nn.Linear(3, 2)
    m2 = torch.nn.Linear(3, 2)
    m2.load_state_dict(m1.state_dict())
    assert observe.step_fingerprint(m1) == observe.step_fingerprint(m2)
    with torch.no_grad():
        m2.bias[0] += 1e-6
    assert observe.step_fingerprint(m1) != observe.step_fingerprint(m2)


def test_step_fingerprint_is_order_sensitive():
    a = {"w": torch.tensor([1.0, 2.0, 3.0, 4.0])}
    b = {"w": torch.tensor([2.0, 1.0, 3.0, 4.0])}          # element swap
    assert observe.step_fingerprint(a) != observe.step_fingerprint(b)
    c = {"x": torch.tensor([1.0, 2.0]), "y": torch.tensor([3.0, 4.0])}
    d = {"x": torch.tensor([3.0, 4.0]), "y": torch.tensor([1.0, 2.0])}
    assert observe.step_fingerprint(c) != observe.step_fingerprint(d)


def test_profile_steps_writes_trace(tmp_path):
    def step(t):
        with observe.span("affine"):
            return t * 2 + 1

    x = torch.arange(8.0)
    out = observe.profile_steps(step, 3, str(tmp_path / "tr"), x)
    assert torch.equal(out, x * 2 + 1)
    trace = tmp_path / "tr" / "trace.json"
    assert trace.is_file() and trace.stat().st_size > 0
    names = [e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]]
    assert names.count("dgn.affine") == 3


def _stream(path):
    """Six epochs of a ZINC-like run: one lr step, throughput fields."""
    ms = observe.MetricStream(str(path))
    rng = np.random.default_rng(0)
    for ep in range(6):
        split = {s: {"loss": float(rng.random()), "mae": float(rng.random()),
                     "objective": float(rng.random())}
                 for s in ("train", "val", "test")}
        ms.log("epoch", epoch=ep, lr=1e-3 if ep < 4 else 5e-4,
               seconds=1.0 + 0.1 * ep, edges_per_s=1000.0 + ep,
               edge_padding_efficiency=0.75, **split)
    ms.log("step", loss=0.5)
    ms.close()


def test_report_tool_matches_reference(tmp_path, capsys):
    path = tmp_path / "metrics.jsonl"
    _stream(path)
    rows = treport.load_epochs(str(path))
    assert rows == jreport.load_epochs(str(path)) and len(rows) == 6
    for key in (None, "loss"):
        assert treport.summarize(rows, key) == jreport.summarize(rows, key)
    s = treport.summarize(rows)
    assert s["lr_steps"] == [{"epoch": 4, "lr": 5e-4}]
    assert treport.main([str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == s
    assert "| epoch | train | val | test | lr |" in treport.to_markdown(s)


def test_multiplicity_tool_matches_reference():
    got = tmult.main(["--dataset", "ZINC", "--synthetic_size", "12"])
    want = jmult.main(["--dataset", "ZINC", "--synthetic_size", "12"])
    assert got == want and got["n_graphs"] == 12 + 2 * 16
    path4 = dict(num_nodes=4, src=np.array([0, 1, 1, 2, 2, 3]),
                 dst=np.array([1, 0, 2, 1, 3, 2]),
                 node_feat=np.zeros(4, np.int32))
    star = dict(num_nodes=4, src=np.array([0, 1, 0, 2, 0, 3]),
                dst=np.array([1, 0, 2, 0, 3, 0]),
                node_feat=np.zeros(4, np.int32))
    for norm in ("none", "sym", "walk"):
        for g, frac in ((path4, 1.0), (star, 0.0)):
            r = tmult.multiplicity([GraphData(**g)], tol=1e-3, norm=norm)
            assert r == jmult.multiplicity([JGraphData(**g)], tol=1e-3,
                                           norm=norm)
            if norm == "none":
                assert r["fraction_distinct"] == frac
    graphs = synthetic_zinc(20, seed=4)
    assert tmult.multiplicity(graphs, 1, 3, 1e-2) == \
        jmult.multiplicity(_jax_graphs(graphs), 1, 3, 1e-2)
