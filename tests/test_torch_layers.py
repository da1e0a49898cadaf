"""The port's layer library == dgn_tpu's: activations, FCLayer and MLP, the
virtual node's broadcast, the towers layer, the virtual node, deeper
posttrans MLPs, positional encodings and input dropout.

Each model case builds dgn_tpu's net at a small size (hidden 10, L=2, 8
graphs), loads its `init` params and randomised BN running stats into the
port through load_jax_params, and compares the eval forward, then the train
forward with its loss, every parameter gradient and the updated BN running
stats, on the same numpy-seeded packed batch.  Dropout is 0 where outputs
are compared (the frameworks' random streams differ).

Tolerances (f32 on both sides, summation orders differ): forward, loss and
gradients rtol 1e-5 / atol 1e-6; BN running stats rtol 1e-4 / atol 1e-6;
the stand-alone modules (activations, FCLayer, MLP, graph_broadcast) rtol
1e-6 / atol 1e-6.  One Adam step of a model with every option here is held
against dgn_tpu's trainer in tests/test_torch_field.py, which also takes
`run_jitted` from here.
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
from dgn_tpu import nn as jnn
from dgn_tpu.config import DataParams as JDataParams
from dgn_tpu.data import datasets as jdatasets
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import pcba_model as jpcba
from dgn_tpu.models import sbm_model as jsbm
from dgn_tpu.models import zinc_model as jzinc
from dgn_tpu.ops import mxu as jmxu
from dgn_tpu.ops.scalers import degree_stats

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import nn as tnn
from dgn_tpu_torch.config import DataParams as TDataParams
from dgn_tpu_torch.convert import flatten, flax_path, load_jax_params
from dgn_tpu_torch.data import datasets as tdatasets
from dgn_tpu_torch.layers.dgn import DGNLayerTower, VirtualNode
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.models import pcba_model as tpcba
from dgn_tpu_torch.models import sbm_model as tsbm
from dgn_tpu_torch.models import zinc_model as tzinc
from dgn_tpu_torch.ops import mxu as tmxu

torch.set_num_threads(1)

H, L = 10, 2
FWD = dict(rtol=1e-5, atol=1e-6)
BN = dict(rtol=1e-4, atol=1e-6)
EXACT = dict(rtol=1e-6, atol=1e-6)
PCBA_NET = dict(type_net="simple", aggregators="mean max min dir1-dx",
                scalers="identity", graph_norm=False)


def _to_port(graphs):
    return [tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs]


def _avg_d(graphs):
    return degree_stats(np.concatenate(
        [np.bincount(g.dst, minlength=g.num_nodes) for g in graphs]))


def _assert_tree(got_named, want_flat, tol):
    got = {flax_path(k): v.detach().numpy() for k, v in got_named}
    assert set(got) == set(want_flat), (set(got) ^ set(want_flat))
    for path, want in want_flat.items():
        np.testing.assert_allclose(got[path], want, err_msg=path, **tol)


def run_jitted(fn, *args):
    """fn(*args) through jax.jit, compiled at XLA's lowest CPU backend
    optimisation level: these programs run once, and compiling them at the
    default level costs more than running them."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def _model_parity(jfactory, tfactory, net, graphs, n_classes=None,
                  pos_enc_in=None):
    """dgn_tpu's net and the port's, from the same params, on one batch:
    eval forward, train forward, loss, gradients and BN running stats.
    Returns the port model."""
    kw = dict(hidden_dim=H, out_dim=H, L=L, avg_d=_avg_d(graphs), **net)
    cls_args = () if n_classes is None else (n_classes,)
    jmodel, jloss = jfactory(JConfig(**kw), *cls_args)
    model, tloss = tfactory(TConfig(**kw), *cls_args,
                            torch.Generator().manual_seed(0),
                            pos_enc_in=pos_enc_in)
    n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(graphs, len(graphs))
    pk = dict(n_pad=n_pad, e_pad=e_pad, g_pad=g_pad, mxu_layout=True)
    jb = jgraph.pack_graphs(graphs, **pk)
    tb = tgraph.pack_graphs(_to_port(graphs), **pk)
    variables = run_jitted(
        lambda key: jmodel.init(key, jb, deterministic=True),
        jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(23)
    batch_stats = jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, x.shape)
                   if np.all(np.asarray(x) == 1)
                   else rng.normal(scale=0.1, size=x.shape)
                   ).astype(np.float32),
        variables["batch_stats"])
    load_jax_params(model, params, batch_stats)

    def both(p):
        evald = jmodel.apply({"params": p, "batch_stats": batch_stats}, jb,
                             deterministic=True)

        def loss_of(q):
            out, mut = jmodel.apply({"params": q, "batch_stats": batch_stats},
                                    jb, deterministic=False,
                                    mutable=["batch_stats"])
            return jloss(out, jb), (out, mut["batch_stats"])

        return evald, jax.value_and_grad(loss_of, has_aux=True)(p)

    want_eval, ((jl, (jscores, new_bs)), jgrads) = run_jitted(both, params)
    # SBM (the one factory with n_classes here) scores nodes
    mask = (tb.node_mask if n_classes else tb.graph_mask).numpy()
    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()
    np.testing.assert_allclose(got[mask], np.asarray(want_eval)[mask], **FWD)
    model.train()
    scores = model(tb)
    loss = tloss(scores, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **FWD)
    np.testing.assert_allclose(scores.detach().numpy()[mask],
                               np.asarray(jscores)[mask], **FWD)
    grads = [(k, p.grad) for k, p in model.named_parameters()]
    want_grads = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    _assert_tree(grads, want_grads, FWD)
    assert_live(grads, want_grads)
    _assert_tree(model.named_buffers(),
                 flatten(jax.tree_util.tree_map(np.asarray, new_bs)), BN)
    return model


# --------------------------------------------------------------- primitives

@pytest.mark.parametrize("name", sorted(jnn.ACTIVATIONS))
def test_activation_matches_reference(name):
    x = np.random.default_rng(1).normal(scale=3.0, size=(7, 6)).astype(
        np.float32)
    jact, tact = jnn.get_activation(name), tnn.get_activation(name.upper())
    if name == "none":
        assert jact is None and tact is None
        return
    np.testing.assert_allclose(tact(torch.from_numpy(x)).numpy(),
                               np.asarray(jact(jnp.asarray(x))), **EXACT)


def test_fc_layer_and_mlp_match_reference():
    """FCLayer (dense -> activation -> masked BN; dropout 0) and a 3-layer
    MLP as the DGN layers build it (ReLU in the middle, no activation at
    the end), train mode: outputs and BN running stats."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(12, 5)).astype(np.float32)
    mask = rng.random(12) < 0.7
    fc = tnn.FCLayer(5, 4, torch.Generator().manual_seed(0), "leakyrelu",
                     b_norm=True)
    mlp = tnn.MLP(5, 6, 3, 3, torch.Generator().manual_seed(0))
    modules = [(jnn.FCLayer(4, activation="leakyrelu", b_norm=True), fc,
                lambda tx: fc(tx, torch.from_numpy(mask))),
               (jnn.MLP(hidden_size=6, out_size=3, layers=3,
                        mid_activation="relu", last_activation="none"),
                mlp, mlp)]
    for jmod, tmod, call in modules:
        variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x),
                              jnp.asarray(mask), deterministic=True)
        load_jax_params(tmod, jax.tree_util.tree_map(
            np.asarray, variables["params"]), jax.tree_util.tree_map(
                np.asarray, variables.get("batch_stats", {})))
        want, mut = jmod.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                               deterministic=False, mutable=["batch_stats"])
        tmod.train()
        got = call(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **EXACT)
        _assert_tree(tmod.named_buffers(), flatten(jax.tree_util.tree_map(
            np.asarray, mut.get("batch_stats", {}))), EXACT)
    assert [n for n, _ in modules[1][1].named_children()] == \
        ["FCLayer_0", "FCLayer_1", "FCLayer_2"]


def test_graph_broadcast_matches_reference():
    graphs = jsyn.synthetic_zinc(9, seed=2)
    jb = jgraph.pack_graphs(graphs, mxu_layout=True)
    tb = tgraph.pack_graphs(_to_port(graphs), mxu_layout=True)
    vg = np.random.default_rng(3).normal(
        size=(tb.num_graphs_padded, 4)).astype(np.float32)
    got = tmxu.graph_broadcast(torch.from_numpy(vg), tb.node_graph,
                               tb.node_mask).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jmxu.graph_broadcast(jnp.asarray(vg), jb.mxu)),
        **EXACT)
    assert not got[~tb.node_mask.numpy()].any()      # pad nodes get zeros
    np.testing.assert_array_equal(
        got[tb.node_mask.numpy()], vg[tb.node_graph.numpy()[
            tb.node_mask.numpy()]])


# ------------------------------------------------------------------- towers

@pytest.mark.parametrize("towers,divide_first,divide_last",
                         [(2, True, False), (5, False, True)],
                         ids=["towers2", "towers5"])
def test_towers_model_matches_reference(towers, divide_first, divide_last):
    """Complex-style towers with `mean max min dir1-dx`, the residual on,
    divide_input on in one layer and off in the other."""
    net = dict(type_net="towers", towers=towers, divide_input=divide_first,
               divide_input_last=divide_last,
               aggregators="mean max min dir1-dx", residual=True)
    model = _model_parity(jzinc, tzinc, net, jsyn.synthetic_zinc(8, seed=5))
    for i, divide in enumerate((divide_first, divide_last)):
        layer = getattr(model, f"layer_{i}")
        assert layer.divide_input == divide and layer.residual
        assert layer.tower_0.pretrans.kernel.shape[1] == \
            (H // towers if divide else H)


def test_towers_reject_widths_they_cannot_split():
    kw = dict(aggregators=("mean",), scalers=("identity",), avg_d={},
              generator=torch.Generator())
    with pytest.raises(ValueError, match="in_dim"):
        DGNLayerTower(12, 10, towers=5, divide_input=True, **kw)
    with pytest.raises(ValueError, match="out_dim"):
        DGNLayerTower(10, 12, towers=5, divide_input=False, **kw)


# ------------------------------------------------------------- virtual node

@pytest.mark.parametrize("vn_type", ["mean", "sum", "logsum"])
def test_virtual_node_matches_reference(vn_type):
    """A 2-layer PCBA-style net (atom encoder, simple layer with max/min,
    no graph norm, BN on) with the virtual node between its layers."""
    graphs = jsyn.synthetic_ogb_mol(8, seed=6, n_tasks=128, k_eig=3,
                                    nan_frac=0.3)
    model = _model_parity(jpcba, tpcba, dict(PCBA_NET, virtual_node=vn_type),
                          graphs)
    assert [n for n, _ in model.named_children()
            if n.startswith("virtual_node")] == ["virtual_node_0"]
    assert model.virtual_node_0.fc_layer.MaskedBatchNorm_0 is not None


def test_virtual_node_rejects_unknown_type():
    with pytest.raises(ValueError, match="vn_type"):
        VirtualNode(H, torch.Generator(), vn_type="max")


# ---------------------------------------------------------------- posttrans

@pytest.mark.parametrize("type_net", ["simple", "complex"])
def test_posttrans_mlp_matches_reference(type_net):
    """posttrans_layers = 2 with three scalers (apply_scalers, then the
    input concat on the complex layer, then the MLP)."""
    net = dict(type_net=type_net, posttrans_layers=2,
               aggregators="mean dir1-dx dir1-av")
    model = _model_parity(jzinc, tzinc, net, jsyn.synthetic_zinc(8, seed=7))
    assert [n for n, _ in model.layer_0.posttrans.named_children()] == \
        ["FCLayer_0", "FCLayer_1"]


# ------------------------------------------------- positional encodings

def test_load_zinc_stores_pos_enc_from_the_loaded_eig():
    kw = dict(synthetic_size=16, pos_enc_dim=3)
    want = jdatasets.load_zinc(JDataParams(**kw))
    got = tdatasets.load_zinc(TDataParams(**kw))
    for split in ("train", "val", "test"):
        for jg, tg in zip(want.splits[split], got.splits[split]):
            np.testing.assert_array_equal(tg.pos_enc, jg.pos_enc)
            np.testing.assert_array_equal(tg.pos_enc, tg.eig[:, 1:4])


@pytest.mark.parametrize("dataset,pos_enc_dim", [("zinc", 3), ("zinc", 8),
                                                 ("sbm", 8)])
def test_pos_enc_matches_reference(dataset, pos_enc_dim):
    """ZINC reads the pos_enc its loader stored; SBM slices the batch's eig.
    At P above k_eig - 1 (ZINC 6, SBM 5) the Linear takes k_eig - 1
    columns."""
    net = dict(type_net="simple", aggregators="mean dir1-dx",
               scalers="identity", pos_enc_dim=pos_enc_dim)
    if dataset == "zinc":
        graphs = jsyn.synthetic_zinc(8, seed=8)
        for g in graphs:
            g.pos_enc = g.eig[:, 1:pos_enc_dim + 1]
        width = graphs[0].pos_enc.shape[1]
        model = _model_parity(jzinc, tzinc, net, graphs, pos_enc_in=width)
    else:
        graphs = jsyn.synthetic_sbm(4, seed=9, n_classes=2, k_eig=5)
        width = min(pos_enc_dim, 4)
        model = _model_parity(jsbm, tsbm, net, graphs, n_classes=2,
                              pos_enc_in=width)
    assert model.embedding_pos_enc.kernel.shape == (width, H)


def test_pos_enc_needs_its_width():
    with pytest.raises(ValueError, match="pos_enc_in"):
        tzinc(TConfig(hidden_dim=H, out_dim=H, L=L, pos_enc_dim=3),
              torch.Generator())


# ------------------------------------------------------- input dropout

def test_in_feat_dropout_is_identity_at_eval_and_masks_at_train():
    """At eval the net equals dgn_tpu's (input dropout off there too).  In
    training, the encoder's output goes through nn.dropout at the config's
    rate with the caller's generator: each entry 0 or scaled by 1/(1-rate),
    the same mask for the same seed."""
    rate = 0.4
    net = dict(type_net="simple", aggregators="mean dir1-dx",
               scalers="identity", in_feat_dropout=rate)
    graphs = jsyn.synthetic_zinc(8, seed=10)
    model = _model_parity(jzinc, tzinc, dict(net, in_feat_dropout=0.0),
                          graphs)
    tb = tgraph.pack_graphs(_to_port(graphs), mxu_layout=True)
    kw = dict(hidden_dim=H, out_dim=H, L=L, avg_d=_avg_d(graphs), **net)
    dropped, _ = tzinc(TConfig(**kw), torch.Generator())
    dropped.load_state_dict(model.state_dict())
    dropped.eval()
    model.eval()
    with torch.no_grad():
        assert torch.equal(dropped(tb), model(tb))

    seen = {}

    def encoder_out(mod, args, out):
        seen["h"] = out.detach()

    def layer_in(mod, args):
        seen["h_in"] = args[1].detach()

    dropped.embedding_h.register_forward_hook(encoder_out)
    dropped.layer_0.register_forward_pre_hook(layer_in)
    dropped.train()
    with torch.no_grad():
        dropped(tb, torch.Generator().manual_seed(5))
    want = tnn.dropout(seen["h"], rate, True,
                       torch.Generator().manual_seed(5))
    assert torch.equal(seen["h_in"], want)
    kept = seen["h_in"] != 0
    torch.testing.assert_close(seen["h_in"][kept],
                               seen["h"][kept] / (1 - rate))
    assert 0 < kept.float().mean().item() < 1
