"""The port's entry point: plateau schedule parity, an end-to-end CPU run, device
selection, rejected options, and import isolation from JAX."""
from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dgn_tpu.train.optim import ReduceLROnPlateau as JPlateau

from dgn_tpu_torch import run as trun
from dgn_tpu_torch.train.optim import ReduceLROnPlateau as TPlateau

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs" / "molecules_graph_regression_DGN_ZINC.json")
SMALL = ["--config", CONFIG, "--epochs", "1", "--synthetic_size", "32"]


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


@pytest.mark.parametrize("flags", [["--layout", "flat"],
                                   ["--micro_batches", "2"],
                                   ["--flip", "true"],
                                   ["--compute_dtype", "bfloat16"],
                                   ["--dataset", "HIV"]])
def test_run_rejects_unported_options(flags):
    with pytest.raises(NotImplementedError):
        trun.run(SMALL + ["--device", "cpu"] + flags)


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
