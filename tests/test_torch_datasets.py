"""The port's real-file readers and eigenvector cache == dgn_tpu's.

Every fixture is written by tests/real_files.py in the reference's raw
layout (docs/DATA.md) under tmp_path, from a seed, at a tiny size; both
packages read it, and every GraphData field (eig included), each split and
the meta must be equal with ==: the readers run the same numpy and scipy
calls on the same arrays, so no tolerance is needed.  Then the slice as a
whole: one train step from a ZINC fixture and one from an HIV fixture, the
port's loaded graphs against dgn_tpu's, from the same weights
(load_jax_params) at H=10, L=2: scores, loss and every gradient at rtol
1e-5 / atol 1e-6 and the BN running stats at rtol 1e-4 / atol 1e-6, the
tolerances of tests/test_torch_layers.py (f32 on both sides, summation
orders differ).
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import real_files
from grad_checks import assert_live
from test_torch_layers import _assert_tree, _avg_d, run_jitted

from dgn_tpu import graph as jgraph
from dgn_tpu import spectral as jspectral
from dgn_tpu.config import DataParams as JDataParams
from dgn_tpu.data import datasets as jdatasets
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import hiv_model as jhiv
from dgn_tpu.models import zinc_model as jzinc

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import spectral as tspectral
from dgn_tpu_torch.config import DataParams as TDataParams
from dgn_tpu_torch.config import config_from_args
from dgn_tpu_torch.convert import flatten, load_jax_params
from dgn_tpu_torch.data import datasets as tdatasets
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.models import hiv_model as thiv
from dgn_tpu_torch.models import zinc_model as tzinc

torch.set_num_threads(1)

SIZES = {"train": 10, "val": 4, "test": 4}
FWD = dict(rtol=1e-5, atol=1e-6)
BN = dict(rtol=1e-4, atol=1e-6)


def _assert_same_graphs(jgs, tgs):
    assert len(jgs) == len(tgs) > 0
    for jg, tg in zip(jgs, tgs):
        for f in dataclasses.fields(tg):
            want, got = getattr(jg, f.name), getattr(tg, f.name)
            if want is None:
                assert got is None, f.name
                continue
            want, got = np.asarray(want), np.asarray(got)
            assert got.dtype == want.dtype and got.shape == want.shape, (
                f.name, got.dtype, want.dtype, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=f.name)


def _load_both(name, **dp):
    """dgn_tpu's and the port's DatasetSplits of one dataset; BLAS on one
    thread (the superpixel eigensolves)."""
    with threadpool_limits(limits=1, user_api="blas"):
        return (jdatasets.load_dataset(name, JDataParams(**dp)),
                tdatasets.load_dataset(name, TDataParams(**dp)))


def _assert_same_splits(j, t):
    for split in ("train", "val", "test"):
        _assert_same_graphs(j.splits[split], t.splits[split])
    assert j.meta == t.meta


# --------------------------------------------------------------------- ZINC

@pytest.mark.parametrize("index,label_key", [
    (True, "logP_SA_cycle_normalized"), (False, "logP_SA_cycle_normalized"),
    (True, "logP_SASA_cycle_normalized"),
    (False, "logP_SASA_cycle_normalized")])
def test_zinc_reader_matches_reference(tmp_path, index, label_key):
    real_files.write_zinc(str(tmp_path), SIZES, seed=1, index=index,
                          label_key=label_key)
    j, t = _load_both("ZINC", data_dir=str(tmp_path), pos_enc_dim=3)
    _assert_same_splits(j, t)
    assert [len(t.splits[s]) for s in SIZES] == list(SIZES.values())
    g = t.train[0]
    assert g.edge_feat.min() >= 1 and g.pos_enc.shape == (g.num_nodes, 3)
    np.testing.assert_array_equal(g.pos_enc, g.eig[:, 1:4])


# ---------------------------------------------------------------------- SBM

@pytest.mark.parametrize("records", ["dict", "plain"])
def test_sbm_reader_matches_reference(tmp_path, records):
    """Plain dict records, and records of a dict subclass whose module
    cannot be imported (the lenient unpickler's stand-in class)."""
    real_files.write_sbm(str(tmp_path), "SBM_PATTERN", SIZES, seed=2,
                         records=records, nodes=50)
    _assert_same_splits(*_load_both("SBM_PATTERN", data_dir=str(tmp_path)))


@pytest.mark.parametrize("records", ["dotdict", "attr"])
def test_sbm_reader_reads_records_with_attributes(tmp_path, records):
    """benchmarking-gnns' DotDict (its __dict__ is itself) and attribute-only
    records, of a module that cannot be imported, pickle their fields as
    instance state, which dgn_tpu's stand-in class cannot take (its
    __getattr__ raises KeyError for '__setstate__').  The port reads them
    to the same graphs dgn_tpu reads from plain dict records of the same
    seed."""
    real_files.write_sbm(str(tmp_path / "state"), "SBM_PATTERN", SIZES,
                         seed=2, records=records, nodes=50)
    real_files.write_sbm(str(tmp_path / "dict"), "SBM_PATTERN", SIZES,
                         seed=2, records="dict", nodes=50)
    want = jdatasets.load_dataset("SBM_PATTERN", JDataParams(
        data_dir=str(tmp_path / "dict")))
    got = tdatasets.load_dataset("SBM_PATTERN", TDataParams(
        data_dir=str(tmp_path / "state")))
    _assert_same_splits(want, got)


# -------------------------------------------------------------- superpixels

# node counts per image: the n <= 9 branch of the k-NN (and n <= 8, the
# sigma fallback), its boundary at 10, and full-size images
SP_NODES = {"MNIST": [75, 70, 9, 5, 10, 68, 80, 72, 74, 66, 75, 71],
            "CIFAR10": [150, 140, 9, 4, 10, 149, 120, 130, 100, 110, 145,
                        150]}


@pytest.mark.parametrize("name", ["MNIST", "CIFAR10"])
@pytest.mark.parametrize("coord_eig", [False, True])
def test_superpixel_reader_matches_reference(tmp_path, name, coord_eig):
    nodes = SP_NODES[name]
    real_files.write_superpixels(str(tmp_path), name,
                                 {"train": nodes, "test": nodes[:4]}, seed=3)
    j, t = _load_both(name, data_dir=str(tmp_path), coord_eig=coord_eig,
                      proportion=0.9)
    _assert_same_splits(j, t)
    # val is the last len // 10 train graphs; proportion cuts train after
    assert len(t.val) == 1 and len(t.train) == int(11 * 0.9)
    if coord_eig:
        return
    # _sort_eig swaps eig columns 1 and 2 on some graphs and not on others
    # (solved again on one BLAS thread, as the readers solved them: the
    # non-symmetric solver's signs may change with the thread count)
    swapped = []
    for g in t.train + t.val + t.test:
        with threadpool_limits(limits=1, user_api="blas"):
            e = tspectral.graph_eig(g.num_nodes, g.src, g.dst, 7, "sym")
        if not np.array_equal(e, g.eig):
            np.testing.assert_array_equal(g.eig[:, [0, 2, 1, 3, 4, 5, 6]], e)
            swapped.append(g.num_nodes)
    assert 0 < len(swapped) < len(t.train + t.val + t.test), swapped


# ----------------------------------------------------------------- OGB raw

@pytest.mark.parametrize("name,gz,edge_feat", [
    ("HIV", True, True), ("HIV", False, False), ("PCBA", False, True),
    ("PCBA", True, False)])
def test_ogb_reader_matches_reference(tmp_path, name, gz, edge_feat):
    split_idx = real_files.write_ogb(str(tmp_path), name, 40, seed=4, gz=gz,
                                     edge_feat=edge_feat)
    j, t = _load_both(name, data_dir=str(tmp_path))
    _assert_same_splits(j, t)
    graphs = t.train + t.val + t.test
    # graphs of 5 nodes or fewer are dropped (every tenth one here)
    assert min(g.num_nodes for g in graphs) > 5
    assert len(graphs) == 40 - 4
    assert len(t.train) == sum(i % 10 != 0 for i in split_idx["train"])
    assert all((g.edge_feat is not None) == edge_feat for g in graphs)
    labels = np.stack([g.label for g in graphs])
    assert labels.shape[1] == (1 if name == "HIV" else 128)
    assert np.isnan(labels).any() == (name == "PCBA")


# -------------------------------------------------------------- ogbl-collab

@pytest.mark.parametrize("split_format", ["pt", "csv"])
def test_collab_reader_matches_reference(tmp_path, split_format):
    real_files.write_collab(str(tmp_path), 120, seed=5,
                            split_format=split_format, feat_dim=16)
    jg, js, jm = jdatasets.load_collab(JDataParams(data_dir=str(tmp_path)))
    tg, ts, tm = tdatasets.load_collab(TDataParams(data_dir=str(tmp_path)))
    _assert_same_graphs([jg], [tg])
    assert jm == tm == {"in_dim": 16, "num_nodes": 120}
    assert set(js) == set(ts) == {"train", "valid", "valid_neg", "test",
                                  "test_neg"}
    for k in js:
        assert ts[k].dtype == js[k].dtype == np.int32, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    # the message-passing graph is the train positives, both directions
    assert tg.num_edges == 2 * len(ts["train"])


def test_unknown_dataset_raises_value_error():
    for load, dp in ((jdatasets.load_dataset, JDataParams()),
                     (tdatasets.load_dataset, TDataParams())):
        with pytest.raises(ValueError, match="unknown dataset"):
            load("QM9", dp)


# ------------------------------------------------------------ the eig cache

def _graphs():
    rng = np.random.default_rng(6)
    out = []
    for n in (12, 30, 3):
        src, dst = np.nonzero(np.triu(rng.random((n, n)) < 0.3, k=1))
        out.append((n, np.concatenate([src, dst]).astype(np.int32),
                    np.concatenate([dst, src]).astype(np.int32)))
    return out


@pytest.mark.parametrize("k,norm", [(6, "none"), (7, "sym"), (3, "walk")])
def test_eig_cache_keys_match_reference(k, norm):
    for n, src, dst in _graphs():
        assert tspectral.EigCache._key(n, src, dst, k, norm) == \
            jspectral.EigCache._key(n, src, dst, k, norm)
    assert tspectral.batch_eig_cache_path("c", "ZINC", norm, k) == \
        jspectral.batch_eig_cache_path("c", "ZINC", norm, k)


def _no_solve(*args, **kwargs):
    raise AssertionError("an eigenproblem was solved")


@pytest.mark.parametrize("writer", ["dgn_tpu", "port"])
def test_eig_cache_directory_is_shared_without_a_solve(tmp_path, writer,
                                                       monkeypatch):
    """A cache directory one package wrote is read by the other with its
    solver patched to raise."""
    write, read = ((jspectral, tspectral) if writer == "dgn_tpu"
                   else (tspectral, jspectral))
    want = [write.EigCache(str(tmp_path)).get(n, s, d, 6, "sym")
            for n, s, d in _graphs()]
    assert len(list(tmp_path.glob("*.npy"))) == len(want)
    monkeypatch.setattr(read, "graph_eig", _no_solve)
    cache = read.EigCache(str(tmp_path))
    for (n, s, d), w in zip(_graphs(), want):
        got = cache.get(n, s, d, 6, "sym")
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)
    assert not list(tmp_path.glob("*.tmp"))


def test_eig_cache_without_directory_solves(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cache = tspectral.EigCache(None)
    for n, s, d in _graphs():
        np.testing.assert_array_equal(cache.get(n, s, d, 4),
                                      jspectral.graph_eig(n, s, d, 4))
    assert not list(tmp_path.iterdir())
    graphs = [tgraph.GraphData(num_nodes=n, src=s, dst=d,
                               node_feat=np.zeros(n, np.int32))
              for n, s, d in _graphs()]
    tspectral.add_eig(graphs, 5, "sym")
    for g in graphs:
        np.testing.assert_array_equal(
            g.eig, jspectral.graph_eig(g.num_nodes, g.src, g.dst, 5, "sym"))


def test_reader_with_cache_dir_solves_once(tmp_path, monkeypatch):
    """--cache_dir: the first read fills the cache, a second read solves
    nothing and gives the same eig, == (the ZINC reader here)."""
    real_files.write_zinc(str(tmp_path / "data"), SIZES, seed=7)
    cfg, _ = config_from_args(["--dataset", "ZINC", "--data_dir",
                               str(tmp_path / "data"), "--cache_dir",
                               str(tmp_path / "cache")])
    assert cfg.data.cache_dir == str(tmp_path / "cache")
    cold = tdatasets.load_dataset("ZINC", cfg.data)
    n_files = len(list((tmp_path / "cache").glob("*.npy")))
    assert 0 < n_files <= sum(SIZES.values())
    monkeypatch.setattr(tspectral, "graph_eig", _no_solve)
    warm = tdatasets.load_dataset("ZINC", cfg.data)
    _assert_same_splits(cold, warm)
    assert len(list((tmp_path / "cache").glob("*.npy"))) == n_files


# ---------------------------------------------------- one step, end to end

H, L = 10, 2
NETS = {
    "ZINC": (jzinc, tzinc, dict(type_net="complex",
                                aggregators="mean dir1-dx dir1-av",
                                scalers="identity amplification attenuation")),
    "HIV": (jhiv, thiv, dict(type_net="simple",
                             aggregators="mean max min dir1-dx dir1-av",
                             scalers="identity", graph_norm=False,
                             dropout=0.0)),
}


@pytest.mark.parametrize("name", ["ZINC", "HIV"])
def test_train_step_from_real_files_matches_reference(tmp_path, name):
    """Each package's reader, block-layout pack and net on the first 8 train
    graphs of a fixture, from dgn_tpu's init weights: eval forward, train
    scores, loss, gradients and BN running stats."""
    if name == "ZINC":
        real_files.write_zinc(str(tmp_path), SIZES, seed=8)
    else:
        real_files.write_ogb(str(tmp_path), "HIV", 16, seed=8)
    j, t = _load_both(name, data_dir=str(tmp_path))
    jgs, tgs = j.train[:8], t.train[:8]
    jfactory, tfactory, net = NETS[name]
    kw = dict(hidden_dim=H, out_dim=H, L=L, avg_d=_avg_d(jgs), **net)
    jmodel, jloss = jfactory(JConfig(**kw))
    model, tloss = tfactory(TConfig(**kw), torch.Generator().manual_seed(0))
    jgs = sorted(jgs, key=lambda g: -g.num_nodes)
    tgs = sorted(tgs, key=lambda g: -g.num_nodes)
    n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(jgs, len(jgs))
    pk = dict(n_pad=n_pad, e_pad=e_pad, g_pad=g_pad, mxu_layout=True)
    jb, tb = jgraph.pack_graphs(jgs, **pk), tgraph.pack_graphs(tgs, **pk)
    variables = run_jitted(lambda key: jmodel.init(key, jb,
                                                   deterministic=True),
                           jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    batch_stats = jax.tree_util.tree_map(np.asarray,
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
    mask = tb.graph_mask.numpy()
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
