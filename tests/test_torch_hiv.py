"""The HIV/PCBA slice of the port == dgn_tpu's, from data to one Adam step.

Synthetic ogbg-molhiv/molpcba graphs (features, eig, labels), the OGB atom
encoder, the HIV net (DGN-simple, `mean max min dir1-dx dir1-av`, identity
scaler, no graph norm, at a small size: H=16, L=2, 12 graphs) through
load_jax_params, the PCBA head with its NaN-masked loss, the OGB metrics,
dropout, the HIV entry point on the CPU and the micro-batch check.

The net runs with dropout 0 where it is compared, because the two
frameworks' random streams differ.  Tolerances, as in
tests/test_torch_model.py and for the same reasons (f32 on both sides,
different summation orders through L layers): scores rtol 1e-4 / atol 2e-5;
loss rtol 1e-5 / atol 1e-6; gradients rtol 1e-3 / atol 1e-5; BN stats
rtol 1e-4 / atol 1e-6; parameters after one lr=1e-3 step rtol 1e-4 /
atol 1e-5.  One exception in that step: without graph norm each layer's
posttrans bias feeds straight into batch norm, so its gradient is zero in
exact arithmetic and rounding noise (about 1e-7) on both sides; Adam's first
step lr * g / (|g| + 1e-8) turns that noise into steps of up to lr in either
direction.  Those entries are held to Adam's bound |step| <= lr instead.
Data, encoder and metrics are exact.
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
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import hiv_model as jhiv
from dgn_tpu.models import pcba_model as jpcba
from dgn_tpu.models.encoders import AtomEncoder as JAtomEncoder
from dgn_tpu.ops.scalers import degree_stats
from dgn_tpu.train import metrics as jmetrics
from dgn_tpu.train.trainer import TrainParams as JParams
from dgn_tpu.train.trainer import Trainer as JTrainer
from dgn_tpu.train.trainer import TrainState

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import run as trun
from dgn_tpu_torch.config import load_config
from dgn_tpu_torch.convert import flatten, flax_path, load_jax_params
from dgn_tpu_torch.data import synthetic as tsyn
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.models import hiv_model as thiv
from dgn_tpu_torch.models import pcba_model as tpcba
from dgn_tpu_torch.models.encoders import AtomEncoder as TAtomEncoder
from dgn_tpu_torch.nn import dropout
from dgn_tpu_torch.train import metrics as tmetrics
from dgn_tpu_torch.train.trainer import TrainParams as TParams
from dgn_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HIV_CONFIG = str(REPO / "configs" / "molecules_graph_classification_DGN_HIV.json")
ZINC_CONFIG = str(REPO / "configs" / "molecules_graph_regression_DGN_ZINC.json")
H, L, LR, WD = 16, 2, 1e-3, 3e-6
HIV_NET = dict(hidden_dim=H, out_dim=H, L=L, type_net="simple",
               aggregators="mean max min dir1-dx dir1-av", scalers="identity",
               graph_norm=False, batch_norm=True, residual=True, dropout=0.0)


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

@pytest.mark.parametrize("n_tasks,nan_frac,k_eig", [(1, 0.0, 4),
                                                    (128, 0.3, 3)],
                         ids=["hiv", "pcba"])
def test_synthetic_ogb_mol_identical(n_tasks, nan_frac, k_eig):
    kw = dict(seed=3, n_tasks=n_tasks, k_eig=k_eig, nan_frac=nan_frac)
    jgs = jsyn.synthetic_ogb_mol(10, **kw)
    tgs = tsyn.synthetic_ogb_mol(10, **kw)
    _assert_same_graphs(jgs, tgs)
    labels = np.stack([g.label for g in tgs])
    assert labels.shape == (10, n_tasks)
    assert np.isnan(labels).any() == (nan_frac > 0)
    np.testing.assert_array_equal(tsyn._score_probe(), jsyn._score_probe())


def test_atom_encoder_matches_reference():
    rng = np.random.default_rng(8)
    # ids beyond each table (and negative ones) are clipped on both sides
    x = rng.integers(-2, 130, size=(40, 9)).astype(np.int32)
    jenc = JAtomEncoder(H)
    params = jenc.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tenc = TAtomEncoder(H, torch.Generator().manual_seed(0))
    load_jax_params(tenc, jax.tree_util.tree_map(np.asarray, params), {})
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(tenc(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-6, atol=1e-6)
    # the port's own init has the reference's xavier-uniform bounds
    for i, table in enumerate(p for _, p in sorted(
            tenc.named_parameters(), key=lambda kv: int(kv[0].split("_")[-1]))):
        d = table.shape[0]
        assert table.abs().max().item() <= math.sqrt(6.0 / (d + H)), i


# ------------------------------------------------------------------ models

def _setup(factory_j, n_tasks, seed):
    graphs = jsyn.synthetic_ogb_mol(12, seed=seed, n_tasks=n_tasks,
                                    nan_frac=0.3 if n_tasks > 1 else 0.0)
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    kw = dict(HIV_NET, avg_d=degree_stats(degs))
    n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(graphs, len(graphs))
    pk = dict(n_pad=n_pad, e_pad=e_pad, g_pad=g_pad, mxu_layout=True)
    jb = jgraph.pack_graphs(graphs, **pk)
    tb = tgraph.pack_graphs(_to_port(graphs), **pk)
    jmodel, jloss = factory_j(JConfig(**kw))
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


@pytest.fixture(scope="module")
def hiv_setup():
    return _setup(jhiv, 1, 5)


def _port(factory, tcfg, params, batch_stats):
    model, loss = factory(tcfg, torch.Generator().manual_seed(0))
    load_jax_params(model, params, batch_stats)
    return model, loss


def _assert_tree(got_named, want_flat, rtol, atol):
    got = {flax_path(k): v.detach().numpy() for k, v in got_named}
    assert set(got) == set(want_flat), (set(got) ^ set(want_flat))
    for path, want in want_flat.items():
        np.testing.assert_allclose(got[path], want, rtol=rtol, atol=atol,
                                   err_msg=path)


def test_hiv_forward_loss_grads_bn_match_reference(hiv_setup):
    jb, tb, jmodel, jloss, params, batch_stats, tcfg = hiv_setup
    model, tloss = _port(thiv, tcfg, params, batch_stats)
    assert sum(v.size for v in flatten(params).values()) == \
        sum(p.numel() for p in model.parameters())
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


def test_hiv_adam_step_matches_reference_trainer(hiv_setup):
    jb, tb, jmodel, jloss, params, batch_stats, tcfg = hiv_setup
    jtrainer = JTrainer(jmodel, jloss, JParams(seed=41, init_lr=LR,
                                               weight_decay=WD),
                        task="hiv", donate=False)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=batch_stats,
                       opt_state=jtrainer.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state2, jl, jscores = jtrainer._train_step(
        state, jb, jax.random.PRNGKey(0), jnp.asarray(LR, jnp.float32))

    model, tloss = _port(thiv, tcfg, params, batch_stats)
    trainer = TTrainer(model, tloss, TParams(seed=41, init_lr=LR,
                                             weight_decay=WD),
                       task="hiv", device="cpu")
    loss, scores = trainer.train_step(tb)
    gmask = tb.graph_mask.numpy()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scores.numpy()[gmask],
                               np.asarray(jscores)[gmask],
                               rtol=1e-4, atol=2e-5)
    new = flatten(jax.tree_util.tree_map(np.asarray, state2.params))
    old = flatten(params)
    noise = [k for k in new if k.endswith("posttrans/bias")]
    assert len(noise) == L
    for k in noise:
        got = dict(model.named_parameters())[k.replace("/", ".")]
        for after in (got.detach().numpy(), new[k]):
            assert np.abs(after - old[k]).max() <= LR * (1 + 1e-6), k
    _assert_tree([(k, p) for k, p in model.named_parameters()
                  if flax_path(k) not in noise],
                 {k: v for k, v in new.items() if k not in noise},
                 rtol=1e-4, atol=1e-5)
    _assert_tree(model.named_buffers(),
                 flatten(jax.tree_util.tree_map(np.asarray,
                                                state2.batch_stats)),
                 rtol=1e-4, atol=1e-6)


def test_pcba_forward_and_masked_loss_match_reference():
    jb, tb, jmodel, jloss, params, batch_stats, tcfg = _setup(jpcba, 128, 6)
    assert np.isnan(tb.labels.numpy()).any()
    model, tloss = _port(tpcba, tcfg, params, batch_stats)
    out, _ = jax.jit(lambda p, b: jmodel.apply(
        {"params": p, "batch_stats": b}, jb, deterministic=False,
        mutable=["batch_stats"]))(params, batch_stats)
    model.train()
    scores = model(tb)
    assert scores.shape == (tb.num_graphs_padded, 128)
    gmask = tb.graph_mask.numpy()
    np.testing.assert_allclose(scores.detach().numpy()[gmask],
                               np.asarray(out)[gmask], rtol=1e-4, atol=2e-5)
    loss = float(tloss(scores, tb).detach())
    assert math.isfinite(loss)
    np.testing.assert_allclose(loss, float(jax.jit(jloss)(out, jb)),
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- metrics

@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_metrics_match_reference(tied):
    rng = np.random.default_rng(12)
    s = rng.normal(size=(60, 5))
    if tied:
        s = np.round(s)
    y = (rng.random((60, 5)) < 0.4).astype(np.float32)
    assert tmetrics.roc_auc(s[:, 0], y[:, 0]) == \
        jmetrics.roc_auc(s[:, 0], y[:, 0])
    assert tmetrics.average_precision(s[:, 1], y[:, 1]) == \
        jmetrics.average_precision(s[:, 1], y[:, 1])
    y[rng.random(y.shape) < 0.3] = np.nan
    y[:, 4] = np.where(np.isnan(y[:, 4]), np.nan, 1.0)   # no negative: skipped
    assert tmetrics.multitask_ap(s, y) == jmetrics.multitask_ap(s, y)
    assert math.isnan(tmetrics.roc_auc(s[:, 0], np.ones(60)))


# ----------------------------------------------------------------- dropout

def test_dropout_semantics():
    x = torch.ones(200, 50)
    rate = 0.3
    a = dropout(x, rate, True, torch.Generator().manual_seed(7))
    b = dropout(x, rate, True, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)                      # same seed, same mask
    kept = (a != 0).float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / x.numel())
    assert abs(kept - (1 - rate)) < 3 * sigma
    assert torch.allclose(a[a != 0], torch.full_like(a[a != 0],
                                                     1 / (1 - rate)))
    assert dropout(x, rate, False, None) is x     # eval: the identity
    with pytest.raises(ValueError):
        dropout(x, rate, True, None)              # no hidden global stream


def test_trainer_dropout_is_seeded():
    """Two trainers with the same seed take the same dropout step."""
    graphs = tsyn.synthetic_ogb_mol(8, seed=2)
    tb = tgraph.pack_graphs(graphs, mxu_layout=True)
    cfg = TConfig(**dict(HIV_NET, dropout=0.3))
    results = []
    for _ in range(2):
        model, loss = thiv(cfg, torch.Generator().manual_seed(0))
        trainer = TTrainer(model, loss, TParams(seed=41), task="hiv",
                           device="cpu")
        results.append(trainer.train_step(tb)[1])
    assert torch.equal(results[0], results[1])
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(tb), model(tb))


# ------------------------------------------------------------- entry point

def test_run_hiv_one_epoch_on_cpu(capsys):
    report = trun.run(["--config", HIV_CONFIG, "--epochs", "1",
                       "--synthetic_size", "64", "--device", "cpu"])
    assert report["epochs_run"] == 1 and report["device"] == "cpu"
    for split in ("train", "val", "test"):
        assert math.isfinite(report["final"][split]["rocauc"])
        assert math.isfinite(report["final"][split]["loss"])
    assert "final rocauc" in capsys.readouterr().out


def test_micro_batches_auto_above_1024_raises():
    """A batch above 1024 graphs resolves to micro-batches, as dgn_tpu's
    run.py does, and runs (tests/test_torch_micro_batch.py); only a count
    that is not a number raises."""
    for mb in ("auto", "1", "3"):
        trun.check_ported(load_config(ZINC_CONFIG, {"batch_size": 2048,
                                                    "micro_batches": mb}))
    assert trun.resolve_micro_batches("auto", 2048) == 2
    assert trun.resolve_micro_batches("auto", 128) == 1
    assert trun.resolve_micro_batches("3", 2048) == 3
    with pytest.raises(ValueError):
        trun.resolve_micro_batches("two", 2048)
