"""The ZINC-canonical model of the port == dgn_tpu's, through one train step.

Shape of the canonical ZINC config (complex layers, `mean dir1-dx dir1-av`,
identity/amplification/attenuation scalers, avg_d from degree_stats, block
layout) at a small size (H=12, L=3, 10 graphs).  dgn_tpu's `init` params and
randomised BN running stats go into the port through load_jax_params; then
the eval forward, the train forward with its loss, every parameter gradient,
the updated BN running stats, and one Adam(+L2) step against dgn_tpu's
Trainer._train_step must agree.

Tolerances, as in tests/test_fullmodel_parity.py:131-177 and for the same
reasons (f32 on both sides, different summation orders through L layers):
scores rtol 1e-4 / atol 2e-5; loss rtol 1e-5 / atol 1e-6; gradients
rtol 1e-3 / atol 1e-5 (BN backward and the 1/(S+EPS) directional
normalisers amplify last-bit differences); BN stats rtol 1e-4 / atol 1e-6;
parameters after one step rtol 1e-4 / atol 1e-5 (1% of one lr=1e-3 Adam
step: near-zero gradients make lr*g/(|g|+eps) sensitive to rounding in g).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grad_checks import assert_live

from dgn_tpu import graph as jgraph
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import pcba_model as jpcba
from dgn_tpu.models import superpixels_model as jsp
from dgn_tpu.models import zinc_model as jzinc
from dgn_tpu.ops.scalers import degree_stats
from dgn_tpu.train.trainer import TrainParams as JParams
from dgn_tpu.train.trainer import Trainer as JTrainer
from dgn_tpu.train.trainer import TrainState

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch.convert import flatten, flax_path, load_jax_params
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.models import pcba_model as tpcba
from dgn_tpu_torch.models import superpixels_model as tsp
from dgn_tpu_torch.models import zinc_model as tzinc
from dgn_tpu_torch.models.dgn_net import edge_context_for
from dgn_tpu_torch.train.trainer import TrainParams as TParams
from dgn_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

H, L, LR, WD = 12, 3, 1e-3, 3e-6


@pytest.fixture(scope="module")
def setup():
    graphs = jsyn.synthetic_zinc(10, seed=5)
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    kw = dict(hidden_dim=H, out_dim=H, L=L, avg_d=degree_stats(degs))
    n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(graphs, len(graphs))
    pk = dict(n_pad=n_pad, e_pad=e_pad, g_pad=g_pad, mxu_layout=True)
    jb = jgraph.pack_graphs(graphs, **pk)
    tb = tgraph.pack_graphs([tgraph.GraphData(**dataclasses.asdict(g))
                             for g in graphs], **pk)
    jmodel, jloss = jzinc(JConfig(**kw))
    variables = jmodel.init(jax.random.PRNGKey(3), jb, deterministic=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(23)
    batch_stats = jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.ndim and
                   np.all(np.asarray(x) == 1) else
                   rng.normal(scale=0.1, size=x.shape)).astype(np.float32),
        variables["batch_stats"])
    return jb, tb, jmodel, jloss, params, batch_stats, TConfig(**kw)


def _port_model(tcfg, params, batch_stats):
    model, loss = tzinc(tcfg, torch.Generator().manual_seed(0))
    load_jax_params(model, params, batch_stats)
    return model, loss


def _assert_tree(got_named, want_flat, rtol, atol):
    got = {flax_path(k): v.detach().numpy() for k, v in got_named}
    assert set(got) == set(want_flat), (set(got) ^ set(want_flat))
    for path, want in want_flat.items():
        np.testing.assert_allclose(got[path], want, rtol=rtol, atol=atol,
                                   err_msg=path)


def test_load_jax_params_covers_every_parameter(setup):
    _, _, _, _, params, batch_stats, tcfg = setup
    model, _ = _port_model(tcfg, params, batch_stats)
    flat = flatten(params)
    assert sum(v.size for v in flat.values()) == \
        sum(p.numel() for p in model.parameters())
    _assert_tree(model.named_parameters(), flat, 0, 0)
    _assert_tree(model.named_buffers(), flatten(batch_stats), 0, 0)
    with pytest.raises(KeyError):
        load_jax_params(model, {k: v for k, v in params.items()
                                if k != "MLP_layer"}, batch_stats)


def _random_trees(jmodel, graphs):
    """Random params and batch_stats of the shapes jmodel.init gives."""
    variables = jax.eval_shape(
        lambda key: jmodel.init(key, jgraph.pack_graphs(
            graphs, mxu_layout=True), deterministic=True),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    return (jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), variables[k])
        for k in ("params", "batch_stats"))


def test_load_jax_params_covers_every_option_of_the_layer_library():
    """Towers (tower_t, mixing) with a 2-layer per-edge pretrans on edge
    features, posttrans_layers 2 (FCLayer_0 and FCLayer_1 side by side),
    the virtual node (fc_layer with its MaskedBatchNorm_0), the positional
    encoding, and the three edge encoders (ZINC's embedding, the
    superpixels' linear, the OGB bond encoder) under complex layers whose
    linear pretrans takes the edge embedding: every parameter and buffer
    maps, in both directions, and a missing one raises."""
    graphs = jsyn.synthetic_zinc(6, seed=5)
    for g in graphs:
        g.pos_enc = g.eig[:, 1:4]
    kw = dict(hidden_dim=10, out_dim=10, L=3, type_net="towers", towers=2,
              posttrans_layers=2, virtual_node="mean", pos_enc_dim=3,
              edge_feat=True, edge_dim=4, pretrans_layers=2)
    params, batch_stats = _random_trees(jzinc(JConfig(**kw))[0], graphs)
    model, _ = tzinc(TConfig(**kw), torch.Generator().manual_seed(0),
                     pos_enc_in=3)
    load_jax_params(model, params, batch_stats)
    flat = flatten(params)
    for path in ("layer_0/tower_1/posttrans/FCLayer_1/kernel",
                 "layer_0/tower_0/pretrans/FCLayer_0/kernel",
                 "layer_0/tower_1/pretrans/FCLayer_1/bias",
                 "layer_2/mixing/bias",
                 "virtual_node_1/fc_layer/MaskedBatchNorm_0/scale",
                 "embedding_pos_enc/kernel", "embedding_e/embedding"):
        assert path in flat, path
    # each tower takes its 5-wide slice of the input and the whole edge
    # embedding
    assert flat["layer_0/tower_0/pretrans/FCLayer_0/kernel"].shape == \
        (2 * 5 + 4, 5)
    assert "virtual_node_1/fc_layer/MaskedBatchNorm_0/var" in \
        flatten(batch_stats)
    _assert_tree(model.named_parameters(), flat, 0, 0)
    _assert_tree(model.named_buffers(), flatten(batch_stats), 0, 0)
    with pytest.raises(KeyError):
        load_jax_params(model, {k: v for k, v in params.items()
                                if k != "virtual_node_0"}, batch_stats)

    edge = dict(hidden_dim=10, out_dim=10, L=2, edge_feat=True, edge_dim=4)
    sp = jsyn.synthetic_superpixels(2, seed=3, nodes=40, feat_dim=5,
                                    n_classes=3)
    cases = [(jsp(JConfig(**edge), 3)[0], sp,
              tsp(TConfig(**edge), 3, 5, torch.Generator(), edge_in=1)[0],
              "embedding_e/kernel"),
             (jpcba(JConfig(**edge))[0],
              jsyn.synthetic_ogb_mol(3, seed=6, n_tasks=128, k_eig=3),
              tpcba(TConfig(**edge), torch.Generator())[0],
              "embedding_e/bond/emb_2")]
    for jmodel, gs, model, path in cases:
        params, batch_stats = _random_trees(jmodel, gs)
        load_jax_params(model, params, batch_stats)
        flat = flatten(params)
        assert path in flat, path
        assert flat["layer_1/pretrans/kernel"].shape == (2 * 10 + 4, 10)
        _assert_tree(model.named_parameters(), flat, 0, 0)
        _assert_tree(model.named_buffers(), flatten(batch_stats), 0, 0)
        with pytest.raises(KeyError):
            load_jax_params(model, {k: v for k, v in params.items()
                                    if k != "embedding_e"}, batch_stats)


def test_flatten_drops_only_the_linear_params_holder():
    """A sole FCLayer_0 of exactly {kernel, bias} is the LinearParams holder
    and goes; a sole FCLayer_0 that holds anything else (the batch_stats of
    a 2-layer MLP with a batch norm in its middle layer) stays."""
    one = np.ones(2, np.float32)
    assert set(flatten({"pretrans": {"FCLayer_0": {"kernel": one,
                                                   "bias": one}}})) == \
        {"pretrans/kernel", "pretrans/bias"}
    assert set(flatten({"posttrans": {"FCLayer_0": {"MaskedBatchNorm_0": {
        "mean": one, "var": one}}}})) == {
            "posttrans/FCLayer_0/MaskedBatchNorm_0/mean",
            "posttrans/FCLayer_0/MaskedBatchNorm_0/var"}


def test_zinc_forward_loss_grads_bn_match_reference(setup):
    jb, tb, jmodel, jloss, params, batch_stats, tcfg = setup
    model, tloss = _port_model(tcfg, params, batch_stats)
    gmask = tb.graph_mask.numpy()

    # ---- eval forward (running-stats BN)
    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()
    want = np.asarray(jmodel.apply({"params": params,
                                    "batch_stats": batch_stats}, jb,
                                   deterministic=True))
    np.testing.assert_allclose(got[gmask], want[gmask], rtol=1e-4, atol=2e-5)

    # ---- train forward + loss + grads + BN running stats
    def loss_of(p):
        out, mut = jmodel.apply({"params": p, "batch_stats": batch_stats},
                                jb, deterministic=False,
                                mutable=["batch_stats"])
        return jloss(out, jb), (out, mut["batch_stats"])

    (jl, (jscores, new_bs)), jgrads = jax.value_and_grad(
        loss_of, has_aux=True)(params)
    model.train()
    scores = model(tb)
    loss = tloss(scores, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=1e-6)
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


def test_zinc_adam_step_matches_reference_trainer(setup):
    jb, tb, jmodel, jloss, params, batch_stats, tcfg = setup
    jtrainer = JTrainer(jmodel, jloss, JParams(seed=41, init_lr=LR,
                                               weight_decay=WD),
                        task="zinc", donate=False)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=batch_stats,
                       opt_state=jtrainer.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state2, jl, jscores = jtrainer._train_step(
        state, jb, jax.random.PRNGKey(0), jnp.asarray(LR, jnp.float32))

    model, tloss = _port_model(tcfg, params, batch_stats)
    trainer = TTrainer(model, tloss, TParams(seed=41, init_lr=LR,
                                             weight_decay=WD), device="cpu")
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


def test_readout_none_returns_node_embeddings(setup):
    """Readout "none" (the link-prediction backbone): no MLP_layer, and the
    forward returns dgn_tpu's node embeddings, in eval and train mode."""
    jb, tb, _, _, params, batch_stats, tcfg = setup
    cfg = dataclasses.replace(tcfg, readout="none")
    jmodel, _ = jzinc(JConfig(**dataclasses.asdict(cfg)))
    jparams = {k: v for k, v in params.items() if k != "MLP_layer"}
    model, _ = tzinc(cfg, torch.Generator().manual_seed(0))
    assert not hasattr(model, "MLP_layer")
    load_jax_params(model, jparams, batch_stats)
    nmask = tb.node_mask.numpy()
    for train in (False, True):
        want = jmodel.apply({"params": jparams, "batch_stats": batch_stats},
                            jb, deterministic=not train,
                            mutable=["batch_stats"] if train else False)
        want = np.asarray(want[0] if train else want)
        model.train(train)
        with torch.no_grad():
            got = model(tb).numpy()
        assert got.shape == (tb.num_nodes_padded, H)
        np.testing.assert_allclose(got[nmask], want[nmask], rtol=1e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("field,value", [("bn_axis", "dp"),
                                         ("compute_dtype", "float16"),
                                         ("compute_dtype", "float8")])
def test_unported_config_raises(field, value):
    """Every option the reference takes is ported.  float16, once refused,
    builds a model whose adjacency blocks are float16 (its parity with
    dgn_tpu is tests/test_torch_fp16.py); a dtype name the reference does
    not run raises ValueError.  The sync batch norm axis: the model builds,
    and only a training forward pass with no mesh bound to sum over raises
    (nn.bind_mesh)."""
    cfg = dataclasses.replace(TConfig(hidden_dim=H, out_dim=H, L=L),
                              **{field: value})
    if value == "float8":
        with pytest.raises(ValueError, match="float16"):
            tzinc(cfg, torch.Generator().manual_seed(0))
        return
    model, _ = tzinc(cfg, torch.Generator().manual_seed(0))
    graphs = [tgraph.GraphData(**dataclasses.asdict(g))
              for g in jsyn.synthetic_zinc(4, seed=1)]
    if field == "compute_dtype":
        gb = tgraph.pack_graphs(graphs, mxu_layout=True)
        assert edge_context_for(gb, cfg).adj.dtype == torch.float16
        model.train()
        assert torch.isfinite(model(gb)).all()
        return
    model.eval()
    model(tgraph.pack_graphs(graphs))
    model.train()
    with pytest.raises(RuntimeError, match="bind_mesh"):
        model(tgraph.pack_graphs(graphs))
