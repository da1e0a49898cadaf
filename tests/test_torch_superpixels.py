"""The superpixel (CIFAR10) slice of the port == dgn_tpu's, from data to one
Adam step.

Synthetic superpixel graphs (CIFAR10: 140-159 nodes, 5 float features; the
directed kNN graph makes the sym Laplacian non-symmetric, so the eig field
takes the general solver), the synthetic branch of load_superpixels, the
packing of CIFAR10 graphs that span two 128-node blocks, the cross-entropy,
the accuracy, every graph readout kind, and the CIFAR10 net (DGN-simple,
`mean dir1-dx dir2-dx`, identity scaler, graph norm, batch norm, a Linear
node encoder; dropout 0, since the frameworks' random streams differ) at a
small size (H=12, L=2, 4 graphs) through load_jax_params: eval forward,
train forward with its loss, every gradient, the BN running stats and one
Adam step against dgn_tpu's Trainer, the same net's eval forward with each
other graph readout, then the CIFAR10 config's entry point on the CPU.

Tolerances, as in tests/test_torch_model.py: scores rtol 1e-4 / atol 2e-5;
loss rtol 1e-5 / atol 1e-6; gradients rtol 1e-3 / atol 1e-5; BN stats rtol
1e-4 / atol 1e-6; parameters after one lr=1e-3 step rtol 1e-4 / atol 1e-5;
readouts rtol 1e-6 / atol 1e-6 (one f32 reduction each side); the loss
function alone 1e-6.  Data, packing and metrics are exact.
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
from threadpoolctl import threadpool_limits

from grad_checks import assert_live

from dgn_tpu import graph as jgraph
from dgn_tpu.config import DataParams as JDataParams
from dgn_tpu.data import datasets as jdatasets
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import superpixels_model as jsp
from dgn_tpu.models.readout import graph_readout as jreadout
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
from dgn_tpu_torch.models import superpixels_model as tsp
from dgn_tpu_torch.models.readout import graph_readout as treadout
from dgn_tpu_torch.train import losses as tlosses
from dgn_tpu_torch.train import metrics as tmetrics
from dgn_tpu_torch.train.trainer import TrainParams as TParams
from dgn_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs" /
             "superpixels_graph_classification_DGN_CIFAR10.json")
H, L, LR, WD, N_CLASSES, IN_DIM = 12, 2, 1e-3, 3e-6, 10, 5
CIFAR_NET = dict(hidden_dim=H, out_dim=H, L=L, type_net="simple",
                 aggregators="mean dir1-dx dir2-dx", scalers="identity",
                 graph_norm=True, batch_norm=True, residual=True, dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The superpixel eig solves (scipy.linalg.eig on a non-symmetric
    Laplacian) slow down by orders of magnitude when a multi-threaded BLAS
    competes with other processes for the cores: hold BLAS to one thread."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


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


def _cifar(n, seed):
    return jsyn.synthetic_superpixels(n, seed=seed, nodes=150, feat_dim=5)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("coord_eig", [False, True], ids=["eig", "coord_eig"])
def test_synthetic_superpixels_identical(coord_eig):
    kw = dict(seed=2, nodes=150, feat_dim=5, coord_eig=coord_eig)
    tgs = tsyn.synthetic_superpixels(3, **kw)
    _assert_same_graphs(jsyn.synthetic_superpixels(3, **kw), tgs)
    g = tgs[0]
    assert g.num_nodes >= 140 and g.node_feat.shape == (g.num_nodes, 5)
    a = np.zeros((g.num_nodes, g.num_nodes), bool)
    a[g.dst, g.src] = True
    assert (a != a.T).any(), "the kNN graph should be directed"
    assert g.eig.shape[1] == (3 if coord_eig else 7)


def test_load_superpixels_synthetic_matches_reference():
    kw = dict(synthetic_size=20, proportion=0.5)
    jds = jdatasets.load_dataset("MNIST", JDataParams(**kw))
    tds = tdatasets.load_dataset("MNIST", TDataParams(**kw))
    assert tds.meta == jds.meta
    assert tds.meta["in_dim"] == 3 and tds.meta["edge_dim"] == 1
    for split in ("train", "val", "test"):
        _assert_same_graphs(jds.splits[split], tds.splits[split])
    assert [len(tds.splits[s]) for s in ("train", "val", "test")] == [10, 8, 8]


def test_pack_cifar10_multiblock_identical():
    graphs = sorted(_cifar(4, 5), key=lambda g: -g.num_nodes)
    n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(graphs, len(graphs))
    pk = dict(n_pad=n_pad, e_pad=e_pad, g_pad=g_pad, mxu_layout=True,
              n_pairs_pad=jgraph.mxu_pair_pad(graphs, 4, n_pad, e_pad))
    jb = jgraph.pack_graphs(graphs, **pk)
    tb = tgraph.pack_graphs(_to_port(graphs), **pk)
    for f in dataclasses.fields(tb):
        if f.name in ("mxu", "edge_ctx") or getattr(jb, f.name) is None:
            continue
        np.testing.assert_array_equal(getattr(tb, f.name).numpy(),
                                      np.asarray(getattr(jb, f.name)),
                                      err_msg=f.name)
    for name in ("local_src", "local_dst", "chunk_pair", "pair_src",
                 "pair_dst", "pair_covered"):
        np.testing.assert_array_equal(getattr(tb.mxu, name).numpy(),
                                      np.asarray(getattr(jb.mxu, name)),
                                      err_msg=name)
    lay = tb.mxu
    off = (lay.pair_src != lay.pair_dst) & lay.pair_covered
    assert bool(off.any()), "no real off-diagonal pair packed"


# --------------------------------------------------------- loss and metric

def test_cross_entropy_and_accuracy_match_reference():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(40, N_CLASSES)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, 40).astype(np.int32)
    mask = rng.random(40) < 0.7
    want = float(jlosses.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels), jnp.asarray(mask)))
    got = float(tlosses.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tmetrics.accuracy(logits, labels) == \
        jmetrics.accuracy(logits, labels)


# ----------------------------------------------------------------- readout

@pytest.fixture(scope="module")
def readout_batches():
    graphs = _cifar(3, 6) + jsyn.synthetic_superpixels(2, seed=7, nodes=20)
    graphs = sorted(graphs, key=lambda g: -g.num_nodes)
    return (jgraph.pack_graphs(graphs, mxu_layout=True),
            tgraph.pack_graphs(_to_port(graphs), mxu_layout=True))


@pytest.mark.parametrize("kind", ["mean", "sum", "max", "directional",
                                  "directional_abs", "unknown"])
def test_graph_readout_matches_reference(kind, readout_batches):
    jb, tb = readout_batches
    rng = np.random.default_rng(11)
    # negative values too, so a max over padded rows would show
    h = rng.normal(size=(tb.num_nodes_padded, 6)).astype(np.float32) - 3.0
    want = np.asarray(jreadout(jb, jnp.asarray(h), kind))
    got = treadout(tb, torch.from_numpy(h), kind).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def setup():
    graphs = sorted(_cifar(4, 3), key=lambda g: -g.num_nodes)
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    kw = dict(CIFAR_NET, avg_d=degree_stats(degs))
    n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(graphs, len(graphs))
    pk = dict(n_pad=n_pad, e_pad=e_pad, g_pad=g_pad, mxu_layout=True,
              n_pairs_pad=jgraph.mxu_pair_pad(graphs, 4, n_pad, e_pad))
    jb = jgraph.pack_graphs(graphs, **pk)
    tb = tgraph.pack_graphs(_to_port(graphs), **pk)
    jmodel, jloss = jsp(JConfig(**kw), N_CLASSES)
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
    model, loss = tsp(tcfg, N_CLASSES, IN_DIM,
                      torch.Generator().manual_seed(0))
    load_jax_params(model, params, batch_stats)
    return model, loss


def _assert_tree(got_named, want_flat, rtol, atol):
    got = {flax_path(k): v.detach().numpy() for k, v in got_named}
    assert set(got) == set(want_flat), (set(got) ^ set(want_flat))
    for path, want in want_flat.items():
        np.testing.assert_allclose(got[path], want, rtol=rtol, atol=atol,
                                   err_msg=path)


def test_cifar10_forward_loss_grads_bn_match_reference(setup):
    jb, tb, jmodel, jloss, params, batch_stats, tcfg = setup
    model, tloss = _port(tcfg, params, batch_stats)
    assert "embedding_h/kernel" in flatten(params)
    gmask = tb.graph_mask.numpy()

    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()
    want = np.asarray(jax.jit(lambda p, b: jmodel.apply(
        {"params": p, "batch_stats": b}, jb, deterministic=True))(
            params, batch_stats))
    np.testing.assert_allclose(got[gmask], want[gmask], rtol=1e-4, atol=2e-5)

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
    np.testing.assert_allclose(scores.detach().numpy()[gmask],
                               np.asarray(jscores)[gmask],
                               rtol=1e-4, atol=2e-5)
    grads = [(k, p.grad) for k, p in model.named_parameters()]
    want_grads = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    _assert_tree(grads, want_grads, rtol=1e-3, atol=1e-5)
    assert_live(grads, want_grads)
    _assert_tree(model.named_buffers(),
                 flatten(jax.tree_util.tree_map(np.asarray, new_bs)),
                 rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["sum", "max", "directional",
                                  "directional_abs"])
def test_cifar10_forward_with_each_readout_matches_reference(kind, setup):
    """Every graph readout a config may select runs in the model; the
    directional ones double the head's input width."""
    jb, tb, *_, tcfg = setup
    tcfg = dataclasses.replace(tcfg, readout=kind)
    jmodel, _ = jsp(JConfig(**dataclasses.asdict(tcfg)), N_CLASSES)
    variables = jax.jit(lambda key: jmodel.init(key, jb, deterministic=True))(
        jax.random.PRNGKey(5))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model, _ = _port(tcfg, params, jax.tree_util.tree_map(
        np.asarray, variables["batch_stats"]))
    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()
    want = np.asarray(jmodel.apply(variables, jb, deterministic=True))
    gmask = tb.graph_mask.numpy()
    np.testing.assert_allclose(got[gmask], want[gmask], rtol=1e-4, atol=2e-5)


def test_cifar10_adam_step_matches_reference_trainer(setup):
    jb, tb, jmodel, jloss, params, batch_stats, tcfg = setup
    jtrainer = JTrainer(jmodel, jloss, JParams(seed=41, init_lr=LR,
                                               weight_decay=WD),
                        task="superpixels", donate=False)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=batch_stats,
                       opt_state=jtrainer.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state2, jl, jscores = jtrainer._train_step(
        state, jb, jax.random.PRNGKey(0), jnp.asarray(LR, jnp.float32))

    model, tloss = _port(tcfg, params, batch_stats)
    trainer = TTrainer(model, tloss, TParams(seed=41, init_lr=LR,
                                             weight_decay=WD),
                       task="superpixels", device="cpu")
    loss, scores = trainer.train_step(tb)
    gmask = tb.graph_mask.numpy()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scores.numpy()[gmask],
                               np.asarray(jscores)[gmask],
                               rtol=1e-4, atol=2e-5)
    _assert_tree(model.named_parameters(),
                 flatten(jax.tree_util.tree_map(np.asarray, state2.params)),
                 rtol=1e-4, atol=1e-5)
    _assert_tree(model.named_buffers(),
                 flatten(jax.tree_util.tree_map(np.asarray,
                                                state2.batch_stats)),
                 rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------- entry point

def test_run_cifar10_one_epoch_on_cpu(capsys):
    report = trun.run(["--config", CONFIG, "--epochs", "1",
                       "--synthetic_size", "8", "--device", "cpu"])
    assert report["epochs_run"] == 1 and report["device"] == "cpu"
    for split in ("train", "val", "test"):
        assert 0.0 <= report["final"][split]["acc"] <= 100.0
        assert math.isfinite(report["final"][split]["loss"])
    assert "final acc" in capsys.readouterr().out
