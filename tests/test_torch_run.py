"""The port's entry point: plateau schedule parity, end-to-end CPU runs
(ZINC, and the towers, virtual-node, augmented, edge-feature, per-edge
pretrans, decompose-off and flat-layout paths, and COLLAB link
prediction), device selection, rejected options, a `data` block's
pos_enc_dim, and import isolation from JAX."""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from threadpoolctl import threadpool_limits

from dgn_tpu.train.optim import ReduceLROnPlateau as JPlateau

from dgn_tpu_torch import run as trun
from dgn_tpu_torch.config import load_config
from dgn_tpu_torch.train.optim import ReduceLROnPlateau as TPlateau

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
CONFIG = str(CONFIGS / "molecules_graph_regression_DGN_ZINC.json")
SMALL = ["--config", CONFIG, "--epochs", "1", "--synthetic_size", "32"]
# (config, flags, metric): chip_smoke.py's zinc-towers, pcba-vn,
# cifar10-aug, zinc-edge, zinc-pretrans, hiv-per-edge, zinc-flat and
# hiv-flat paths at a tiny size
NEW_PATHS = {
    "zinc-towers": ("molecules_graph_regression_DGN_ZINC.json",
                    ["--type_net", "towers", "--flip", "True",
                     "--pos_enc_dim", "5", "--synthetic_size", "32"], "mae"),
    "pcba-vn": ("molecules_graph_classification_DGN_PCBA.json",
                ["--virtual_node", "mean", "--synthetic_size", "64",
                 "--batch_size", "32", "--micro_batches", "2"], "ap"),
    "cifar10-aug": ("superpixels_graph_classification_DGN_CIFAR10.json",
                    ["--augmentation", "15", "--distortion", "0.1", "--flip",
                     "True", "--posttrans_layers", "2", "--in_feat_dropout",
                     "0.1", "--synthetic_size", "16"], "acc"),
    "zinc-edge": ("molecules_graph_regression_DGN_ZINC.json",
                  ["--edge_feat", "True", "--synthetic_size", "32"], "mae"),
    "zinc-pretrans": ("molecules_graph_regression_DGN_ZINC.json",
                      ["--edge_feat", "True", "--pretrans_layers", "2",
                       "--posttrans_layers", "2", "--synthetic_size", "32"],
                      "mae"),
    "hiv-per-edge": ("molecules_graph_classification_DGN_HIV.json",
                     ["--decompose", "False", "--synthetic_size", "32"],
                     "rocauc"),
    "zinc-flat": ("molecules_graph_regression_DGN_ZINC.json",
                  ["--layout", "flat", "--synthetic_size", "32"], "mae"),
    "hiv-flat": ("molecules_graph_classification_DGN_HIV.json",
                 ["--layout", "flat", "--synthetic_size", "32"], "rocauc"),
}


@pytest.mark.parametrize("patience", [0, 2])
def test_plateau_matches_reference(patience):
    metrics = [1.0, 0.9, 0.9, 0.89995, 0.95, 0.7, 0.7, 0.7, 0.7, 0.7, 0.69,
               0.7, 0.7, 0.7, 0.7, -0.1, -0.1, -0.2]
    j = JPlateau(lr=1e-3, factor=0.5, patience=patience, min_lr=1e-4)
    t = TPlateau(lr=1e-3, factor=0.5, patience=patience, min_lr=1e-4)
    for m in metrics:
        assert t.step(m) == j.step(m)
        assert (t.best, t.num_bad) == (j.best, j.num_bad)


def test_run_zinc_one_epoch_on_cpu(capsys):
    report = trun.run(SMALL + ["--device", "cpu"])
    assert report["device"] == "cpu" and report["epochs_run"] == 1
    for split in ("train", "val", "test"):
        assert math.isfinite(report["final"][split]["mae"])
    assert "[dgn_tpu_torch] FINAL" in capsys.readouterr().out


def test_run_without_gpu_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(SystemExit, match="--device cpu"):
        trun.run(SMALL)


@pytest.mark.parametrize("flags", [["--n_buckets", "2"],
                                   ["--compute_dtype", "float16"]])
def test_run_rejects_unported_options(flags, monkeypatch):
    """float16 is refused; --n_buckets, refused until the bucketed loader
    was ported, now runs, with a BucketedLoader for every split."""
    if flags[0] != "--n_buckets":
        with pytest.raises(NotImplementedError):
            trun.run(SMALL + ["--device", "cpu"] + flags)
        return
    from dgn_tpu_torch.data.loader import BucketedLoader
    built, prepare = [], trun.prepare
    monkeypatch.setattr(trun, "prepare",
                        lambda *a: built.append(prepare(*a)) or built[-1])
    # batches of 8: 32 train graphs hold two buckets of full batches
    report = trun.run(SMALL + ["--device", "cpu", "--batch_size", "8"]
                      + flags)
    assert report["epochs_run"] == 1 and math.isfinite(
        report["final"]["test"]["mae"])
    loaders = built[0][4]
    assert all(isinstance(ld, BucketedLoader) for ld in loaders.values())
    assert len(loaders["train"].buckets) == 2


def test_run_collab_two_epochs_on_cpu(capsys):
    """COLLAB link prediction end to end: the FINAL line carries the best
    valid Hits@50 and Hits@{10, 50, 100} on test at that epoch, each in
    [0, 1], as dgn_tpu/run.py:217-220 reports them."""
    report = trun.run(["--dataset", "COLLAB", "--synthetic_size", "256",
                       "--epochs", "2", "--device", "cpu"])
    assert report["dataset"] == "COLLAB" and report["device"] == "cpu"
    assert 0.0 <= report["best_val_hits@50"] <= 1.0
    test = report["test_at_best_val"]
    assert set(test) == {"hits@10", "hits@50", "hits@100"}
    assert all(0.0 <= v <= 1.0 for v in test.values())
    out = capsys.readouterr().out
    assert "layout=flat" in out and "[dgn_tpu_torch] FINAL" in out


def test_run_collab_without_gpu_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(SystemExit, match="--device cpu"):
        trun.run(["--dataset", "COLLAB", "--synthetic_size", "128"])


@pytest.mark.parametrize("path", sorted(NEW_PATHS))
def test_run_new_path_one_epoch_on_cpu(path, capsys):
    name, flags, metric = NEW_PATHS[path]
    with threadpool_limits(limits=1, user_api="blas"):   # superpixel eigs
        report = trun.run(["--config", str(CONFIGS / name), "--epochs", "1",
                           "--device", "cpu"] + flags)
    assert report["epochs_run"] == 1 and report["device"] == "cpu"
    for split in ("train", "val", "test"):
        assert math.isfinite(report["final"][split][metric])
        assert math.isfinite(report["final"][split]["loss"])
    out = capsys.readouterr().out
    assert f"final {metric}" in out
    want = "flat" if "--layout" in flags else "mxu"
    assert f"layout={want}" in out


@pytest.mark.parametrize("name,k_eig", [
    ("SBMs_node_clustering_DGN_PATTERN.json", 5),
    ("superpixels_graph_classification_DGN_CIFAR10.json", 7)],
    ids=["sbm", "superpixels"])
def test_data_block_pos_enc_dim_reaches_the_model(name, k_eig, tmp_path):
    """A `data` block's pos_enc_dim builds the model's embedding_pos_enc,
    as dgn_tpu/run.py copies it into the net config (it was dropped
    silently for SBM and superpixels)."""
    raw = json.loads((CONFIGS / name).read_text())
    raw["data"] = {"pos_enc_dim": 9, "synthetic_size": 16}
    config = tmp_path / "config.json"
    config.write_text(json.dumps(raw))
    cfg = load_config(str(config))
    assert cfg.net_params.pos_enc_dim == 0 and cfg.data.pos_enc_dim == 9
    with threadpool_limits(limits=1, user_api="blas"):
        _, model, _, _, _ = trun.prepare(cfg, "cpu")
    assert model.cfg.pos_enc_dim == 9
    assert model.embedding_pos_enc.kernel.shape == (k_eig - 1,
                                                    cfg.net_params.hidden_dim)


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dgn_tpu_torch\n"
        "for m in pkgutil.walk_packages(dgn_tpu_torch.__path__, "
        "'dgn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'dgn_tpu'))\n"
        "print(len(list(pkgutil.walk_packages(dgn_tpu_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
