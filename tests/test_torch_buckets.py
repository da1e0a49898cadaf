"""The port's BucketedLoader (`--n_buckets`) == dgn_tpu's.

The port's versions of tests/test_loader.py:28-78 (every graph packed once
per epoch, better slot efficiency than one bucket on size-skewed data,
eval metrics equal to one bucket's, the block layout), then the same seed
in both packages: every yielded batch equal field for field with == on
both layouts over two epochs, with padding_stats, and the escape repacks
and their count when the buckets' pads are cut below what batches need.
Last, the entry point end to end on the CPU with --data_dir, --cache_dir
and --n_buckets 2.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import real_files
from test_torch_pack import _GB_FIELDS, _PORT_ONLY

from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.data.loader import BucketedLoader as JBucketedLoader

from dgn_tpu_torch import run as trun
from dgn_tpu_torch import spectral as tspectral
from dgn_tpu_torch.data import synthetic as tsyn
from dgn_tpu_torch.data.loader import BatchLoader, BucketedLoader
from dgn_tpu_torch.models import DGNConfig, zinc_model
from dgn_tpu_torch.ops.scalers import degree_stats
from dgn_tpu_torch.train.trainer import TrainParams, Trainer

torch.set_num_threads(1)

ZINC_CONFIG = str(Path(__file__).resolve().parents[1] / "configs"
                  / "molecules_graph_regression_DGN_ZINC.json")


def _skewed_graphs(syn, n=96, seed=11):
    """Half tiny (9-12 nodes), half large (30-37): the worst case for one
    bucket (tests/test_loader.py's graphs)."""
    small = [g for g in syn.synthetic_zinc(n * 6, seed=seed)
             if g.num_nodes <= 12][: n // 2]
    large = [g for g in syn.synthetic_zinc(n * 4, seed=seed + 1)
             if g.num_nodes >= 30][: n // 2]
    assert len(small) == n // 2 and len(large) == n // 2
    return small + large


def _real_nodes(batches) -> int:
    return sum(int(b.node_mask.sum()) for b in batches)


def test_bucketed_covers_each_graph_once_and_packs():
    graphs = _skewed_graphs(tsyn, 64)
    loader = BucketedLoader(graphs, batch_size=16, n_buckets=4, shuffle=True,
                            seed=3)
    batches = list(loader)     # pack_graphs raises on overflow
    assert _real_nodes(batches) == sum(g.num_nodes for g in graphs)
    assert len(batches) == len(loader)


def test_bucketed_padding_beats_single_bucket_on_skewed_sizes():
    graphs = _skewed_graphs(tsyn, 256)      # 4 buckets x 2 batches of 32
    single = BatchLoader(graphs, batch_size=32)
    stats = BucketedLoader(graphs, batch_size=32, n_buckets=4).padding_stats()
    single_eff = (sum(g.num_nodes for g in graphs)
                  / (len(single) * single.n_pad))
    assert stats["node_slot_efficiency"] > single_eff * 1.3, (stats,
                                                              single_eff)
    assert len(set(stats["geometry"])) >= 2


def test_bucketed_eval_metrics_match_single_bucket():
    graphs = _skewed_graphs(tsyn, 64, seed=5)
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    cfg = DGNConfig(hidden_dim=8, out_dim=8, L=1, avg_d=degree_stats(degs),
                    aggregators="mean dir1-dx", scalers="identity")
    model, loss_fn = zinc_model(cfg, torch.Generator().manual_seed(0))
    trainer = Trainer(model, loss_fn, TrainParams(seed=41), task="zinc",
                      device="cpu")
    for layout in ("flat", "mxu"):
        m1 = trainer.evaluate(BatchLoader(graphs, batch_size=16,
                                          layout=layout))
        m2 = trainer.evaluate(BucketedLoader(graphs, batch_size=16,
                                             n_buckets=4, layout=layout))
        # MAE over per-graph scores: exact whatever the batch composition
        assert abs(m1["mae"] - m2["mae"]) < 1e-5, (layout, m1, m2)


def test_bucketed_mxu_layout():
    graphs = _skewed_graphs(tsyn, 64, seed=9)
    loader = BucketedLoader(graphs, batch_size=16, n_buckets=2, layout="mxu")
    assert next(iter(loader)).mxu is not None
    assert _real_nodes(loader) == sum(g.num_nodes for g in graphs)
    # at most len // batch_size buckets, each with a full batch
    assert len(BucketedLoader(graphs, batch_size=16, n_buckets=9).buckets) \
        == 4


# dgn_tpu's BucketedLoader sets each bucket's static metadata of the TPU
# extremes lowering (mxu_ext_caps); the port's layout keeps the defaults
EXT_CAPS = ("ext_passes", "ext_block_chunks")


def _assert_same_batch(jb, tb):
    for name in _GB_FIELDS:
        want, got = getattr(jb, name), getattr(tb, name)
        if want is None:
            assert got is None, name
            continue
        want, got = np.asarray(want), got.numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (jb.mxu is None) == (tb.mxu is None)
    if tb.mxu is None:
        return
    for f in dataclasses.fields(tb.mxu):
        if f.name in _PORT_ONLY + EXT_CAPS:
            continue
        want, got = getattr(jb.mxu, f.name), getattr(tb.mxu, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
        else:
            assert got == want, f.name


def _both(layout, escape=False, **kw):
    """dgn_tpu's and the port's loader on the same graphs and seed; with
    escape every bucket's pads are cut to one 128-slot tile, so every batch
    takes the escape repack."""
    jgs = _skewed_graphs(jsyn, 96, seed=13)
    tgs = _skewed_graphs(tsyn, 96, seed=13)
    j = JBucketedLoader(jgs, layout=layout, **kw)
    t = BucketedLoader(tgs, layout=layout, **kw)
    if escape:
        for loader in (j, t):
            loader.geometry = [(128, 128)] * len(loader.geometry)
    return j, t


@pytest.mark.parametrize("layout", ["flat", "mxu"])
@pytest.mark.parametrize("escape", [False, True], ids=["fit", "escape"])
def test_bucketed_batches_match_reference(layout, escape):
    j, t = _both(layout, escape, batch_size=16, n_buckets=3, shuffle=True,
                 seed=7)
    assert t.padding_stats() == j.padding_stats()
    assert t.pair_pads == j.pair_pads
    n = 0
    for _ in range(2):         # two epochs: the rng carries over
        for jb, tb in zip(j, t, strict=True):
            _assert_same_batch(jb, tb)
            n += 1
    assert n == 2 * len(t) == 2 * len(j)
    assert t.n_escapes == j.n_escapes == (n if escape else 0)


def test_run_with_real_files_cache_and_buckets(tmp_path, monkeypatch,
                                               capsys):
    """The entry point on the CPU from ZINC files in the real layout with
    --cache_dir and --n_buckets 2, twice: the second run solves no
    eigenproblem and reports the same final metrics."""
    data, cache = tmp_path / "data", tmp_path / "cache"
    real_files.write_zinc(str(data), {"train": 64, "val": 16, "test": 16},
                          seed=9)
    argv = ["--config", ZINC_CONFIG, "--epochs", "1", "--batch_size", "16",
            "--device", "cpu",
            "--data_dir", str(data), "--cache_dir", str(cache),
            "--n_buckets", "2", "--out_dir", str(tmp_path / "out")]
    built = []
    prepare = trun.prepare

    def spy(cfg, device="cuda"):
        out = prepare(cfg, device)
        built.append(out[4])
        return out

    monkeypatch.setattr(trun, "prepare", spy)
    cold = trun.run(argv)
    n_files = len(list(cache.glob("*.npy")))
    monkeypatch.setattr(tspectral, "graph_eig", lambda *a, **k: 1 / 0)
    warm = trun.run(argv)
    assert 0 < n_files == len(list(cache.glob("*.npy")))
    for loaders in built:
        assert all(isinstance(ld, BucketedLoader) for ld in loaders.values())
        assert len(loaders["train"].buckets) == 2
    assert cold["final"] == warm["final"]
    assert cold["epochs_run"] == 1 and all(
        math.isfinite(cold["final"][s]["mae"]) for s in ("train", "val",
                                                         "test"))
    assert "(train/val/test = 64/16/16)" in capsys.readouterr().out
