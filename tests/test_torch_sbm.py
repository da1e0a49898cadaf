"""The SBM (PATTERN) slice of the port == dgn_tpu's, from data to one Adam
step.

Synthetic PATTERN graphs and the synthetic branch of load_sbm, the
class-weighted cross-entropy (with a batch where one class is absent), the
balanced node accuracy, and the PATTERN net (DGN-complex, `mean dir1-dx
dir2-dx`, three scalers, graph norm, batch norm, a per-node MLPReadout head)
at a small size (H=10, L=2, 6 graphs of 60-99 nodes) through
load_jax_params: eval forward, train forward with its loss, every gradient,
the BN running stats and one Adam step against dgn_tpu's Trainer, then the
PATTERN config's entry point on the CPU.

Tolerances, as in tests/test_torch_model.py and for the same reasons (f32
on both sides, different summation orders through L layers): scores rtol
1e-4 / atol 2e-5; loss rtol 1e-5 / atol 1e-6; gradients rtol 1e-3 / atol
1e-5; BN stats rtol 1e-4 / atol 1e-6; parameters after one lr=1e-3 step
rtol 1e-4 / atol 1e-5.  The loss functions alone: 1e-6.  Data and metrics
are exact.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grad_checks import assert_live

from dgn_tpu import graph as jgraph
from dgn_tpu.config import DataParams as JDataParams
from dgn_tpu.data import datasets as jdatasets
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import sbm_model as jsbm
from dgn_tpu.ops.scalers import degree_stats
from dgn_tpu.train import losses as jlosses
from dgn_tpu.train import metrics as jmetrics
from dgn_tpu.train.trainer import TrainParams as JParams
from dgn_tpu.train.trainer import Trainer as JTrainer
from dgn_tpu.train.trainer import TrainState

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import run as trun
from dgn_tpu_torch.config import DataParams as TDataParams
from dgn_tpu_torch.convert import flatten, flax_path, load_jax_params
from dgn_tpu_torch.data import datasets as tdatasets
from dgn_tpu_torch.data import synthetic as tsyn
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.models import sbm_model as tsbm
from dgn_tpu_torch.train import losses as tlosses
from dgn_tpu_torch.train import metrics as tmetrics
from dgn_tpu_torch.train.trainer import TrainParams as TParams
from dgn_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs" / "SBMs_node_clustering_DGN_PATTERN.json")
H, L, LR, WD, N_CLASSES = 10, 2, 1e-3, 1e-8, 2
PATTERN_NET = dict(hidden_dim=H, out_dim=H, L=L, type_net="complex",
                   aggregators="mean dir1-dx dir2-dx",
                   scalers="identity amplification attenuation",
                   graph_norm=True, batch_norm=True, residual=True,
                   dropout=0.0, num_node_types=3)


def _to_port(graphs):
    return [tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs]


def _assert_same_graphs(jgs, tgs):
    assert len(jgs) == len(tgs)
    for jg, tg in zip(jgs, tgs):
        for f in dataclasses.fields(tg):
            want, got = getattr(jg, f.name), getattr(tg, f.name)
            if want is None:
                assert got is None, f.name
            else:
                np.testing.assert_array_equal(np.asarray(got),
                                              np.asarray(want), err_msg=f.name)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("n_classes,norm", [(2, "none"), (6, "sym")],
                         ids=["pattern", "cluster_sym"])
def test_synthetic_sbm_identical(n_classes, norm):
    kw = dict(seed=4, n_classes=n_classes, k_eig=5, norm=norm)
    tgs = tsyn.synthetic_sbm(6, **kw)
    _assert_same_graphs(jsyn.synthetic_sbm(6, **kw), tgs)
    assert all(60 <= g.num_nodes < 100 for g in tgs)
    assert max(int(g.node_labels.max()) for g in tgs) == n_classes - 1


def test_load_sbm_synthetic_matches_reference():
    jds = jdatasets.load_dataset("SBM_PATTERN", JDataParams(synthetic_size=48))
    tds = tdatasets.load_dataset("SBM_PATTERN", TDataParams(synthetic_size=48))
    assert tds.meta == jds.meta == {"n_classes": 2, "num_node_types": 3}
    for split in ("train", "val", "test"):
        _assert_same_graphs(jds.splits[split], tds.splits[split])
    assert [len(tds.splits[s]) for s in ("train", "val", "test")] == [12, 4, 4]


# --------------------------------------------------------- loss and metric

@pytest.mark.parametrize("case", ["both_classes", "class_absent"])
def test_weighted_cross_entropy_sbm_matches_reference(case):
    rng = np.random.default_rng(3)
    n, c = 50, 3
    logits = rng.normal(size=(n, c)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    if case == "class_absent":
        labels[labels == 1] = 2           # class 1 gets weight 0
    mask = rng.random(n) < 0.8
    want = float(jlosses.weighted_cross_entropy_sbm(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), c))
    got = float(tlosses.weighted_cross_entropy_sbm(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(mask), c))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_accuracy_sbm_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(70, 3))
    labels = rng.integers(0, 3, 70)
    assert tmetrics.accuracy_sbm(logits, labels) == \
        jmetrics.accuracy_sbm(logits, labels)
    labels[labels == 2] = 0               # a class absent from the targets
    assert tmetrics.accuracy_sbm(logits, labels) == \
        jmetrics.accuracy_sbm(logits, labels)


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def setup():
    graphs = jsyn.synthetic_sbm(6, seed=7, n_classes=N_CLASSES)
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    kw = dict(PATTERN_NET, avg_d=degree_stats(degs))
    n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(graphs, len(graphs))
    pk = dict(n_pad=n_pad, e_pad=e_pad, g_pad=g_pad, mxu_layout=True)
    jb = jgraph.pack_graphs(graphs, **pk)
    tb = tgraph.pack_graphs(_to_port(graphs), **pk)
    jmodel, jloss = jsbm(JConfig(**kw), N_CLASSES)
    variables = jax.jit(lambda key: jmodel.init(key, jb, deterministic=True))(
        jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(23)
    batch_stats = jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.ndim and
                   np.all(np.asarray(x) == 1) else
                   rng.normal(scale=0.1, size=x.shape)).astype(np.float32),
        variables["batch_stats"])
    return jb, tb, jmodel, jloss, params, batch_stats, TConfig(**kw)


def _port(tcfg, params, batch_stats):
    model, loss = tsbm(tcfg, N_CLASSES, torch.Generator().manual_seed(0))
    load_jax_params(model, params, batch_stats)
    return model, loss


def _assert_tree(got_named, want_flat, rtol, atol):
    got = {flax_path(k): v.detach().numpy() for k, v in got_named}
    assert set(got) == set(want_flat), (set(got) ^ set(want_flat))
    for path, want in want_flat.items():
        np.testing.assert_allclose(got[path], want, rtol=rtol, atol=atol,
                                   err_msg=path)


def test_pattern_forward_loss_grads_bn_match_reference(setup):
    jb, tb, jmodel, jloss, params, batch_stats, tcfg = setup
    model, tloss = _port(tcfg, params, batch_stats)
    nmask = tb.node_mask.numpy()

    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()
    assert got.shape == (tb.num_nodes_padded, N_CLASSES)
    want = np.asarray(jax.jit(lambda p, b: jmodel.apply(
        {"params": p, "batch_stats": b}, jb, deterministic=True))(
            params, batch_stats))
    np.testing.assert_allclose(got[nmask], want[nmask], rtol=1e-4, atol=2e-5)

    def loss_of(p):
        out, mut = jmodel.apply({"params": p, "batch_stats": batch_stats},
                                jb, deterministic=False,
                                mutable=["batch_stats"])
        return jloss(out, jb), (out, mut["batch_stats"])

    (jl, (jscores, new_bs)), jgrads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(params)
    model.train()
    scores = model(tb)
    loss = tloss(scores, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scores.detach().numpy()[nmask],
                               np.asarray(jscores)[nmask],
                               rtol=1e-4, atol=2e-5)
    grads = [(k, p.grad) for k, p in model.named_parameters()]
    want_grads = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    _assert_tree(grads, want_grads, rtol=1e-3, atol=1e-5)
    assert_live(grads, want_grads)
    _assert_tree(model.named_buffers(),
                 flatten(jax.tree_util.tree_map(np.asarray, new_bs)),
                 rtol=1e-4, atol=1e-6)


def test_pattern_adam_step_matches_reference_trainer(setup):
    jb, tb, jmodel, jloss, params, batch_stats, tcfg = setup
    jtrainer = JTrainer(jmodel, jloss, JParams(seed=41, init_lr=LR,
                                               weight_decay=WD),
                        task="sbm", donate=False)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=batch_stats,
                       opt_state=jtrainer.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state2, jl, jscores = jtrainer._train_step(
        state, jb, jax.random.PRNGKey(0), jnp.asarray(LR, jnp.float32))

    model, tloss = _port(tcfg, params, batch_stats)
    trainer = TTrainer(model, tloss, TParams(seed=41, init_lr=LR,
                                             weight_decay=WD),
                       task="sbm", device="cpu")
    loss, scores = trainer.train_step(tb)
    nmask = tb.node_mask.numpy()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scores.numpy()[nmask],
                               np.asarray(jscores)[nmask],
                               rtol=1e-4, atol=2e-5)
    _assert_tree(model.named_parameters(),
                 flatten(jax.tree_util.tree_map(np.asarray, state2.params)),
                 rtol=1e-4, atol=1e-5)
    _assert_tree(model.named_buffers(),
                 flatten(jax.tree_util.tree_map(np.asarray,
                                                state2.batch_stats)),
                 rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------- entry point

def test_run_pattern_one_epoch_on_cpu(capsys):
    report = trun.run(["--config", CONFIG, "--epochs", "1",
                       "--synthetic_size", "48", "--device", "cpu"])
    assert report["epochs_run"] == 1 and report["device"] == "cpu"
    for split in ("train", "val", "test"):
        assert 0.0 <= report["final"][split]["acc"] <= 100.0
        assert math.isfinite(report["final"][split]["loss"])
    assert "final acc" in capsys.readouterr().out
