"""COLLAB link prediction of the port == dgn_tpu's.

The same seed gives the same synthetic graph (its eig included), splits and
negatives in both packages, and load_collab the same data and meta;
hits_at_k and link_bce_loss agree.  From dgn_tpu's `init` params (carried
across by load_jax_params: the COLLAB tree maps in both directions), on one
200-node graph packed flat, the eval and train-mode embeddings, the edge
scores, the loss, every gradient and the BN running stats agree for the
same positive and negative edges, and one Adam step agrees with
LinkPredTrainer._train_step: its negatives (and, with augmentation, its
rotation draws) are recomputed here with jax.random from the step's key,
as dgn_tpu's step draws them (link_pred.py:88, 108-109), and handed to the
port.  The JAX programs compile at XLA's lowest CPU optimisation level
(run_jitted).  Then the port alone: negatives never reach a pad node slot,
and a short CPU training run lowers the loss and ranks held-out positives
far above chance.

Tolerances, as tests/test_torch_model.py holds the same quantities: loss,
scores and embeddings rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol
1e-5, BN stats rtol 1e-4 / atol 1e-6, the parameters after one Adam step
rtol 1e-4 / atol 1e-5.  On one graph, graph norm scales every node alike
and batch norm then takes each posttrans bias out again: its gradient is
rounding noise on both sides, and after one Adam step those entries are
held to |step| <= lr (tests/test_torch_hiv.py treats a posttrans bias
without graph norm so).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grad_checks import assert_live

from dgn_tpu.config import DataParams as JDataParams
from dgn_tpu.data import datasets as jdatasets
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.graph import pack_graphs as jpack
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.ops.scalers import degree_stats
from dgn_tpu.train import link_pred as jlp
from dgn_tpu.train import metrics as jmetrics
from dgn_tpu.train.trainer import TrainParams as JParams

from dgn_tpu_torch.config import DataParams as TDataParams
from dgn_tpu_torch.convert import flatten, flax_path, load_jax_params
from dgn_tpu_torch.data import datasets as tdatasets
from dgn_tpu_torch.data import synthetic as tsyn
from dgn_tpu_torch.graph import GraphData as TGraphData
from dgn_tpu_torch.graph import pack_graphs as tpack
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.train import link_pred as tlp
from dgn_tpu_torch.train import metrics as tmetrics
from dgn_tpu_torch.train.trainer import TrainParams as TParams
from test_torch_layers import run_jitted

torch.set_num_threads(1)

STEP = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BN = dict(rtol=1e-4, atol=1e-6)
LR, WD, EDGE_BATCH = 1e-3, 3e-6, 64


def _same_graph(jg, tg):
    for f in dataclasses.fields(tg):
        want, got = getattr(jg, f.name), getattr(tg, f.name)
        if want is None:
            assert got is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=f.name)


def _same_splits(js, ts):
    assert set(js) == set(ts)
    for k in js:
        assert ts[k].dtype == js[k].dtype, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def test_synthetic_collab_identical():
    jg, js = jsyn.synthetic_collab(num_nodes=200, seed=3, avg_deg=6)
    tg, ts = tsyn.synthetic_collab(num_nodes=200, seed=3, avg_deg=6)
    _same_graph(jg, tg)          # the eig too: the same dense eigensolve
    _same_splits(js, ts)


def test_load_collab_identical():
    jg, js, jmeta = jdatasets.load_collab(JDataParams(synthetic_size=64))
    tg, ts, tmeta = tdatasets.load_collab(TDataParams(synthetic_size=64))
    assert tmeta == jmeta == {"in_dim": 8, "num_nodes": 128}
    _same_graph(jg, tg)
    _same_splits(js, ts)


@pytest.mark.parametrize("k", [1, 10, 50, 100])
def test_hits_at_k_identical(k):
    rng = np.random.default_rng(k)
    pos = np.round(rng.normal(size=40), 1)
    neg = np.round(rng.normal(size=60), 1)          # ties with pos
    assert tmetrics.hits_at_k(pos, neg, k) == jmetrics.hits_at_k(pos, neg, k)


def test_link_bce_loss_matches_reference():
    rng = np.random.default_rng(2)
    pos, neg = (rng.normal(scale=4.0, size=33).astype(np.float32)
                for _ in range(2))
    want = jlp.link_bce_loss(jnp.asarray(pos), jnp.asarray(neg))
    got = tlp.link_bce_loss(torch.from_numpy(pos), torch.from_numpy(neg))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@functools.cache
def _setup():
    """dgn_tpu's COLLAB model and trainer on a 200-node graph, its params
    and randomised BN running stats, the flat packs, the net's kwargs."""
    g, splits = jsyn.synthetic_collab(num_nodes=200, seed=3, avg_deg=6)
    kw = dict(hidden_dim=16, out_dim=16, L=2, node_encoder="linear",
              avg_d=degree_stats(np.bincount(g.dst, minlength=g.num_nodes)))
    jmodel = jlp.collab_model(JConfig(**kw))
    jb = jpack([g], g_pad=1)
    tb = tpack([TGraphData(**dataclasses.asdict(g))], g_pad=1)
    jtrainer = jlp.LinkPredTrainer(jmodel, JParams(seed=41, init_lr=LR,
                                                   weight_decay=WD),
                                   edge_batch=EDGE_BATCH)
    variables = run_jitted(
        lambda key: jmodel.init(key, jb, jnp.zeros((4, 2), jnp.int32),
                                method=jlp._init_all),
        jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(23)
    batch_stats = jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, x.shape)
                   if np.all(np.asarray(x) == 1)
                   else rng.normal(scale=0.1, size=x.shape)
                   ).astype(np.float32),
        variables["batch_stats"])
    return g, splits, kw, jmodel, jtrainer, jb, tb, params, batch_stats


def _port_model(kw, params, batch_stats):
    model = tlp.collab_model(TConfig(**kw), 8,
                             torch.Generator().manual_seed(0))
    load_jax_params(model, params, batch_stats)
    return model


def _assert_tree(got_named, want_flat, tol):
    got = {flax_path(k): v for k, v in got_named}
    assert set(got) == set(want_flat), (set(got) ^ set(want_flat))
    for path, want in want_flat.items():
        np.testing.assert_allclose(got[path].detach().numpy(), want,
                                   err_msg=path, **tol)


def test_convert_maps_the_collab_tree():
    _, _, kw, _, _, _, _, params, batch_stats = _setup()
    model = _port_model(kw, params, batch_stats)
    flat = flatten(params)
    assert "predictor/Linear_2/kernel" in flat
    assert flat["predictor/Linear_2/kernel"].shape == (16, 1)
    assert "backbone/embedding_h/kernel" in flat
    assert not any(k.startswith("backbone/MLP_layer") for k in flat)
    assert "backbone/layer_1/batchnorm_h/mean" in flatten(batch_stats)
    assert sum(v.size for v in flat.values()) == \
        sum(p.numel() for p in model.parameters())
    _assert_tree(model.named_parameters(), flat, dict(rtol=0, atol=0))
    _assert_tree(model.named_buffers(), flatten(batch_stats),
                 dict(rtol=0, atol=0))
    for drop in ("predictor", "backbone"):
        with pytest.raises(KeyError):
            load_jax_params(model, {k: v for k, v in params.items()
                                    if k != drop}, batch_stats)
    with pytest.raises(KeyError):
        load_jax_params(model, {**params, "extra": {"bias": np.zeros(1)}},
                        batch_stats)


def _edges(splits, rng_seed, n_real):
    rng = np.random.default_rng(rng_seed)
    pos = splits["train"][rng.permutation(len(splits["train"]))[:EDGE_BATCH]]
    neg = rng.integers(0, n_real, size=pos.shape)
    return pos.astype(np.int32), neg.astype(np.int32)


def test_collab_embeddings_scores_loss_grads_match_reference():
    g, splits, kw, jmodel, _, jb, tb, params, batch_stats = _setup()
    pos, neg = _edges(splits, 5, g.num_nodes)
    variables = {"params": params, "batch_stats": batch_stats}

    def reference(params):
        v = {**variables, "params": params}
        h_eval = jmodel.apply(v, jb, deterministic=True,
                              method=jmodel.embed)

        def loss_of(p):
            w = {**v, "params": p}
            h, mut = jmodel.apply(w, jb, deterministic=False,
                                  mutable=["batch_stats"],
                                  method=jmodel.embed)
            ps = jmodel.apply(w, h, pos[:, 0], pos[:, 1],
                              method=jmodel.predict)
            ns = jmodel.apply(w, h, neg[:, 0], neg[:, 1],
                              method=jmodel.predict)
            return jlp.link_bce_loss(ps, ns), (h, ps, ns, mut)

        return h_eval, jax.value_and_grad(loss_of, has_aux=True)(params)

    h_eval, ((jl, (jh, jps, jns, mut)), jgrads) = run_jitted(reference,
                                                             params)
    model = _port_model(kw, params, batch_stats)
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model.embed(tb).numpy(),
                                   np.asarray(h_eval), **STEP)
    model.train()
    h = model.embed(tb)
    tp, tn = (torch.from_numpy(x).long() for x in (pos, neg))
    ps = model.predict(h, tp[:, 0], tp[:, 1])
    ns = model.predict(h, tn[:, 0], tn[:, 1])
    loss = tlp.link_bce_loss(ps, ns)
    loss.backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **STEP)
    for got, want in ((ps, jps), (ns, jns)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **STEP)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **STEP)
    grads = [(k, p.grad) for k, p in model.named_parameters()]
    want_grads = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    _assert_tree(grads, want_grads, GRAD)
    assert_live(grads, want_grads)
    _assert_tree(model.named_buffers(), flatten(jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"])), BN)


@pytest.mark.parametrize("augmentation", [0.0, 20.0])
def test_collab_adam_step_matches_reference(augmentation):
    g, splits, kw, jmodel, _, jb, tb, params, batch_stats = _setup()
    jtrainer = jlp.LinkPredTrainer(
        jmodel, JParams(seed=41, init_lr=LR, weight_decay=WD,
                        augmentation=augmentation), edge_batch=EDGE_BATCH)
    pos, _ = _edges(splits, 6, g.num_nodes)
    key = jax.random.PRNGKey(11)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": batch_stats}
    new_vars, _, jl = run_jitted(
        jtrainer._train_step.__wrapped__, variables,
        jtrainer.tx.init(variables["params"]), jb, jnp.asarray(pos), key,
        jnp.asarray(LR, jnp.float32))
    # the draws dgn_tpu's step makes from its key
    aug_rng, neg_rng, _ = jax.random.split(key, 3)
    neg = np.array(jax.random.randint(neg_rng, pos.shape, 0, g.num_nodes))
    u = np.array(jax.random.uniform(aug_rng, (g.num_nodes,)))

    model = _port_model(kw, params, batch_stats)
    trainer = tlp.LinkPredTrainer(
        model, TParams(seed=41, init_lr=LR, weight_decay=WD,
                       augmentation=augmentation),
        edge_batch=EDGE_BATCH, device="cpu")
    loss, (ps, ns) = trainer.train_step(
        tb, torch.from_numpy(pos).long(), torch.from_numpy(neg).long(),
        aug=torch.from_numpy(u) if augmentation else None)
    assert ps.shape == ns.shape == (EDGE_BATCH,)
    np.testing.assert_allclose(float(loss), float(jl), **STEP)
    # one graph: graph norm scales every node by the same sqrt(1/200), so
    # batch norm takes each posttrans bias out again and its gradient is
    # rounding noise on both sides, which Adam's first step turns into a
    # step of up to lr either way
    new = flatten(jax.tree_util.tree_map(np.asarray, new_vars["params"]))
    old = flatten(params)
    noise = [k for k in new if k.endswith("posttrans/bias")]
    assert noise
    for k in noise:
        after_port = dict(model.named_parameters())[k.replace("/", ".")]
        for after in (after_port.detach().numpy(), new[k]):
            assert np.abs(after - old[k]).max() <= LR * (1 + 1e-6), k
    _assert_tree([(k, p) for k, p in model.named_parameters()
                  if flax_path(k) not in noise],
                 {k: v for k, v in new.items() if k not in noise}, STEP)
    _assert_tree(model.named_buffers(), flatten(
        jax.tree_util.tree_map(np.asarray, new_vars["batch_stats"])), BN)


def _small_trainer(g, seed, edge_batch, **pk):
    cfg = TConfig(hidden_dim=24, out_dim=24, L=2, type_net="simple",
                  aggregators="mean dir1-dx", scalers="identity",
                  node_encoder="linear",
                  avg_d={"log": 1.5, "lin": 5.0})
    model = tlp.collab_model(cfg, g.node_feat.shape[1],
                             torch.Generator().manual_seed(seed))
    gb = tpack([g], g_pad=1, **pk)
    trainer = tlp.LinkPredTrainer(model, TParams(init_lr=3e-3, seed=seed),
                                  edge_batch=edge_batch, device="cpu")
    return gb, trainer


def test_negatives_never_hit_padding(monkeypatch):
    """Negatives come from the real node slots only (the reference samples
    torch.randint(0, x.size(0)) over real nodes; pad-slot embeddings would
    be trivially separable and inflate Hits@K)."""
    g, splits = tsyn.synthetic_collab(num_nodes=100, seed=5)
    gb, trainer = _small_trainer(g, 1, 64, n_pad=256)    # 156 pad slots
    assert int(gb.real_node_count()) == 100
    seen = []
    randint = torch.randint

    def spy(low, high, size, **kw):
        out = randint(low, high, size, **kw)
        seen.append((high, out))
        return out

    monkeypatch.setattr(torch, "randint", spy)
    trainer.train_epoch(gb, splits["train"], 0)
    assert len(seen) == len(splits["train"]) // 64
    for high, out in seen:
        assert high == 100 and out.shape == (64, 2)
        assert 0 <= int(out.min()) and int(out.max()) < 100


def test_collab_training_lowers_loss_and_ranks_positives():
    g, splits = tsyn.synthetic_collab(num_nodes=200, seed=3, avg_deg=6)
    gb, trainer = _small_trainer(g, 1, 256)
    losses = [trainer.train_epoch(gb, splits["train"], epoch)
              for epoch in range(12)]
    assert losses[-1] < losses[0], losses
    res = trainer.evaluate(gb, splits["valid"], splits["valid_neg"])
    assert set(res) == {"hits@10", "hits@50", "hits@100"}
    assert all(0.0 <= v <= 1.0 for v in res.values())
    assert res["hits@100"] > 0.3, res
