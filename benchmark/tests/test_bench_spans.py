"""The program's spans as the benchmark reads them: the gap labels and the
operations per span on hand-made timelines (microseconds), a hand-made
Chrome trace, and each new reader on a hand-made run."""
import importlib.util
import types

import pytest

from benchmark import cells, spans

READERS = {"loader_pack_ms": 2.0, "h2d_ms_per_step": 0.5,
           "h2d_copies_per_step": 30.0, "forward_ms_per_step": 9.0,
           "backward_ms_per_step": 6.0, "optimizer_ms_per_step": 1.5,
           "readback_ms_per_step": 0.25}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name, cells.reader_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_innermost_is_the_span_opened_last():
    at = spans.innermost([("step", 0, 100), ("step.forward", 10, 60),
                          ("model.layer_0", 20, 30), ("gc", 25, 27)])
    assert [at(t) for t in (5, 15, 22, 26, 28, 70, 120)] == [
        "step", "step.forward", "model.layer_0", "gc", "model.layer_0",
        "step", None]


def test_gap_labels_carry_the_program_span():
    bench = [("pack", 0, 40), ("train_step", 40, 90)]
    program = [("loader.pack", 1, 39), ("pack.arrays", 2, 30),
               ("pack.block_layout", 20, 30), ("step", 41, 89),
               ("epoch.readback", 92, 99)]
    gaps = [(18, 26), (5, 9), (31, 37), (90, 100), (100, 110)]
    assert spans.label_gaps(gaps, bench, program) == [
        ["pack/pack.block_layout", pytest.approx(8e-6)],
        ["pack/pack.arrays", pytest.approx(4e-6)],
        ["pack/loader.pack", pytest.approx(6e-6)],
        ["readback/epoch.readback", pytest.approx(10e-6)],
        # no program span open: the label stays devtrace's
        ["readback", pytest.approx(10e-6)]]


def test_every_operation_is_in_a_span_or_the_remainder():
    program = [("step", 0, 100), ("step.forward", 10, 50),
               ("model.layer_0", 20, 30), ("epoch.readback", 110, 120)]
    launches = {1: 5, 2: 22, 3: 25, 4: 45, 5: 115, 6: 105}
    per, rest = spans.ops_by_span([1, 2, 3, 4, 5, 6, 7], launches, program)
    assert per == {"step": 1, "model.layer_0": 2, "step.forward": 1,
                   "epoch.readback": 1}
    # 6 launched between the spans, 7 has no launch call in the trace
    assert rest == 2 and sum(per.values()) + rest == 7


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_chrome_trace_reduction():
    events = [
        _x("user_annotation", "bench.window", 0, 200),
        _x("user_annotation", "bench.pack", 0, 50),
        _x("user_annotation", "dgn.loader.pack", 1, 48),
        _x("user_annotation", "dgn.pack.block_layout", 30, 18),
        _x("user_annotation", "bench.train_step", 50, 100),
        _x("user_annotation", "dgn.step", 51, 98),
        _x("user_annotation", "dgn.step.forward", 52, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 55, 2, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 95, 2, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 160, 2, corr=3),
        _x("kernel", "gemm", 60, 20, corr=1),
        _x("kernel", "reduce", 100, 10, corr=2),
        _x("gpu_memcpy", "Memcpy DtoH", 165, 5, corr=3),
        _x("kernel", "spin_kernel", 190, 30, corr=4),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 70},
    ]
    r = spans.reduce_chrome(events)
    assert r["n_ops"] == 3
    assert r["ops_by_span"] == {"step.forward": 1, "step": 1}
    assert r["ops_outside"] == 1
    # gaps by length: [0, 60] (middle 30), [110, 165] (137.5), [170, 200]
    # (185: outside every span), [80, 100] (90)
    assert [g[0] for g in r["idle_gaps"]] == [
        "pack/pack.block_layout", "train_step/step", "readback",
        "train_step/step.forward"]


def _run(summary=None, trace=True):
    run = types.SimpleNamespace(trace={"steps": 10} if trace else None)
    if summary is not None:
        run.spans = summary
    return run


def _summary(steps=4):
    def sp(ms, count=steps):
        return {"count": count, "ms": ms * steps, "self_ms": ms * steps}
    return {"spans": {"step": sp(20.0), "loader.pack": sp(2.0),
                      "step.h2d": sp(0.5), "step.forward": sp(9.0),
                      "step.backward": sp(6.0),
                      "step.optimizer": sp(1.5, 2 * steps),
                      "epoch.readback": sp(0.25)},
            "counters": {"h2d.copies": 30 * steps},
            "top_level_ms": 90.0, "on_ms": 92.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_new_reader_on_a_hand_made_run(name):
    read = _reader(name)
    assert read(_run(_summary())) == pytest.approx(READERS[name])
    # no traced stretch, or steps without the metric's span or counter:
    # nothing, and no error
    assert read(_run(None, trace=False)) is None
    only_steps = _summary()
    only_steps["spans"] = {"step": only_steps["spans"]["step"]}
    only_steps["counters"] = {}
    assert read(_run(only_steps)) is None


def test_readers_read_the_program_recorder(capsys):
    """Without run.spans the readers take the recorder's summary: here a
    toy epoch recorded on the CPU."""
    import numpy as np
    import torch
    from dgn_tpu_torch import observe
    from dgn_tpu_torch.data.loader import BatchLoader
    from dgn_tpu_torch.data.synthetic import synthetic_zinc
    from dgn_tpu_torch.models import DGNConfig, zinc_model
    from dgn_tpu_torch.ops.scalers import degree_stats
    from dgn_tpu_torch.train.trainer import TrainParams, Trainer
    graphs = synthetic_zinc(16, seed=1)
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    cfg = DGNConfig(hidden_dim=8, out_dim=8, L=1, avg_d=degree_stats(degs))
    model, loss_fn = zinc_model(cfg, torch.Generator().manual_seed(0))
    trainer = Trainer(model, loss_fn, TrainParams(), device="cpu")
    loader = BatchLoader(graphs, 8, layout="mxu", shuffle=True, seed=0)
    observe.reset()
    try:
        with observe.tracing():
            trainer.train_epoch(loader)
        run = _run()
        for name in READERS:
            v = _reader(name)(run)
            if name == "h2d_copies_per_step":
                assert v is None        # nothing changes device on the CPU
            else:
                assert v > 0, name
        assert run.spans["spans"]["step"]["count"] == 2
        assert capsys.readouterr().err.count("benchmark: spans per step") \
            == 1
    finally:
        observe.reset()
