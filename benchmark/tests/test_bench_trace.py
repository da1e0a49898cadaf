"""The trace's reduction on a hand-made timeline (microseconds)."""
import pytest

from benchmark import devtrace


def test_reduce_busy_gaps_and_labels():
    raw = {"device": [("k1", 10, 30), ("k2", 20, 40), ("k1", 70, 80),
                      ("k3", 150, 300)],
           "spans": [("window", 0, 200), ("pack", 0, 15),
                     ("train_step", 15, 90), ("pack", 100, 140)]}
    r = devtrace.reduce(raw)
    assert r["window_s"] == pytest.approx(200e-6)
    # busy: [10, 40] + [70, 80] + [150, 200] (clipped to the window)
    assert r["busy_s"] == pytest.approx(90e-6)
    assert r["n_ops"] == 4
    assert r["kernel_s"]["k1"] == pytest.approx(30e-6)
    assert [n for n, _ in r["device_ops"]] == ["k3", "k1", "k2"]
    # gaps [80, 150] (middle 115: pack), [40, 70] (55: train_step),
    # [0, 10] (5: pack)
    assert r["idle_gaps"] == [["pack", pytest.approx(70e-6)],
                              ["train_step", pytest.approx(30e-6)],
                              ["pack", pytest.approx(10e-6)]]


def test_gap_outside_every_span_is_the_readback():
    raw = {"device": [("k", 0, 10)],
           "spans": [("window", 0, 50), ("train_step", 0, 20)]}
    assert devtrace.reduce(raw)["idle_gaps"] == [
        ["readback", pytest.approx(40e-6)]]


def test_a_trace_without_its_window_span_is_refused():
    with pytest.raises(RuntimeError):
        devtrace.reduce({"device": [], "spans": []})


def test_segment_rates_split_the_window_by_request_times():
    from benchmark import hostload
    starts = [0.0, 1.0, 4.9, 5.0, 9.0, 10.5]
    graphs = [10, 10, 10, 20, 20, 30]
    # two whole segments of 5 s; the last 1.5 s make no segment
    assert hostload.segment_rates(starts, graphs, 11.5) == [6.0, 8.0]


def test_traced_stretch_counts_every_kernel_and_each_micro_batch(
        monkeypatch):
    """The traced stretch of the micro-batched toy on the CPU (the
    profiler's window stood in for): every kernel launch counter's growth
    by kernel name, and one (nodes, edges, graphs) and one block entry
    per micro-batch."""
    import contextlib
    import torch
    from bench_toy import SEED, toy_cell
    from benchmark import bench
    from benchmark.program import CellRun
    from dgn_tpu_torch import observe

    @contextlib.contextmanager
    def profiled(torch_, out):
        yield
        out.update(device=[], spans=[("window", 0.0, 1.0)])

    readings = iter([{"build_pair_adjacency.launches": 10,
                      "segment_extremes_fwd.launches": 3,
                      "segment_extremes_bwd.launches": 5},
                     {"build_pair_adjacency.launches": 14,
                      "segment_extremes_fwd.launches": 11,
                      "segment_extremes_bwd.launches": 5}])
    monkeypatch.setattr(bench.devtrace, "profiled", profiled)
    monkeypatch.setattr(observe, "launch_counts", lambda: next(readings))
    torch.set_num_threads(2)
    prog = CellRun(toy_cell("zinc-block-micro"), SEED, "cpu",
                   log=lambda m: None)
    prog.warm_up()
    tr, stretch = bench.traced_stretch(torch, prog, 0.3)
    assert stretch["launches"] == {"build_pair_adjacency": 4,
                                   "segment_extremes_fwd": 8,
                                   "segment_extremes_bwd": 0}
    assert tr["launches"] == 4
    sizes = stretch["sizes"]
    assert len(sizes) == 2 * tr["steps"] == len(stretch["blocks"])
    # 48 graphs in batches of 15 dealt to 2 micro-batches: 8 + 7, last 2 + 1
    assert {(a[2], b[2]) for a, b in zip(sizes[::2], sizes[1::2])} <= {
        (8, 7), (2, 1)}
    assert [e for _, e, _ in sizes] == [e for e, _ in stretch["blocks"]]
