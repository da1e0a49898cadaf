"""Micro-batching in the port == dgn_tpu's, and == the full-batch step.

BatchLoader(micro_batches=K) deals each size-sorted batch round-robin into K
packed micro-batches at one shared geometry (also after an overflow
escape), with the same arrays as dgn_tpu's loader.  Trainer.train_step on
that list takes K forward/backward passes and one Adam step: with batch norm
off it equals the port's full-batch step and dgn_tpu's micro-batched step
(ZINC and PCBA, K=4; loss rtol 2e-6, parameters rtol 2e-5 / atol 2e-6, as
in tests/test_micro_batch.py).  The PCBA config's batch of 2048 resolves to
2 micro-batches and trains one epoch on the CPU (at batch 64, 2 micro-
batches); every shipped config gets past `prepare` with default flags, and
without a GPU refuses to run unless asked for the CPU.
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

from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.data.loader import BatchLoader as JBatchLoader
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import pcba_model as jpcba
from dgn_tpu.models import zinc_model as jzinc
from dgn_tpu.ops.scalers import degree_stats
from dgn_tpu.train.trainer import TrainParams as JParams
from dgn_tpu.train.trainer import Trainer as JTrainer
from dgn_tpu.train.trainer import TrainState

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import run as trun
from dgn_tpu_torch.config import load_config
from dgn_tpu_torch.convert import flatten, flax_path, load_jax_params
from dgn_tpu_torch.data.loader import BatchLoader as TBatchLoader
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.models import pcba_model as tpcba
from dgn_tpu_torch.models import zinc_model as tzinc
from dgn_tpu_torch.train.trainer import TrainParams as TParams
from dgn_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p) for p in (REPO / "configs").glob("*.json"))
PCBA_CONFIG = str(REPO / "configs" /
                  "molecules_graph_classification_DGN_PCBA.json")
K, LR = 4, 1e-3
_GB_FIELDS = [f.name for f in dataclasses.fields(tgraph.GraphBatch)
              if f.name not in ("mxu", "edge_ctx")]


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The CIFAR10 config's superpixel eig solves (scipy.linalg.eig on a
    non-symmetric Laplacian) slow down by orders of magnitude when a
    multi-threaded BLAS competes with other processes for the cores: hold
    BLAS to one thread."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _to_port(graphs):
    return [tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs]


def _geometry(gb):
    return (gb.num_nodes_padded, gb.num_edges_padded, gb.num_graphs_padded,
            gb.mxu.n_pairs)


def _assert_same_micros(jbs, tbs):
    assert isinstance(tbs, list) and len(tbs) == len(jbs)
    for jb, tb in zip(jbs, tbs):
        for name in _GB_FIELDS:
            want = getattr(jb, name)
            if want is None:
                assert getattr(tb, name) is None, name
                continue
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(want), err_msg=name)
        assert _geometry(tb) == (jb.num_nodes_padded, jb.num_edges_padded,
                                 jb.num_graphs_padded, jb.mxu.n_pairs)
    assert len({_geometry(tb) for tb in tbs}) == 1


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("shuffle", [True, False], ids=["train", "eval"])
def test_micro_loader_matches_reference(shuffle):
    graphs = jsyn.synthetic_zinc(70, seed=13)
    kw = dict(batch_size=32, shuffle=shuffle, seed=5, geometry="typical",
              micro_batches=K)
    jl = JBatchLoader(graphs, layout="mxu", **kw)
    tl = TBatchLoader(_to_port(graphs), layout="mxu", **kw)
    assert (tl.n_pad, tl.e_pad, tl.g_pad, tl.pair_pad) == \
        (jl.n_pad, jl.e_pad, jl.g_pad, jl.pair_pad)
    assert len(tl) == len(jl) == 3
    for _ in range(2):          # two epochs: the rng stream advances alike
        for jbs, tbs in zip(jl, tl):
            _assert_same_micros(jbs, tbs)
    # the last super-batch of 6 graphs still deals into K micro-batches
    assert sum(int(g.graph_mask.sum()) for g in tbs) == 6


def test_micro_loader_escape_shares_one_geometry():
    """An overflow repacks every micro-batch of the super-batch at one
    shared coarse geometry, as dgn_tpu's loader does."""
    graphs = jsyn.synthetic_zinc(32, seed=3)
    jl = JBatchLoader(graphs, 32, layout="mxu", micro_batches=K)
    tl = TBatchLoader(_to_port(graphs), 32, layout="mxu", micro_batches=K)
    jl.n_pad = tl.n_pad = 128          # too small for any micro-batch
    jbs, tbs = next(iter(jl)), next(iter(tl))
    assert tl.n_escapes == jl.n_escapes == 1
    _assert_same_micros(jbs, tbs)
    assert _geometry(tbs[0])[0] > 128


# -------------------------------------------------------------------- step

def _avg_d(graphs):
    return degree_stats(np.concatenate(
        [np.bincount(g.dst, minlength=g.num_nodes) for g in graphs]))


def _task(task):
    """(graphs, jax factory, port factory, net kwargs) at batch norm off."""
    if task == "zinc":
        graphs = jsyn.synthetic_zinc(48, seed=21)
        net = dict(hidden_dim=10, out_dim=10, L=2, batch_norm=False)
        return graphs, jzinc, tzinc, dict(net, avg_d=_avg_d(graphs))
    graphs = jsyn.synthetic_ogb_mol(48, seed=22, n_tasks=128, k_eig=3,
                                    nan_frac=0.4)
    net = dict(hidden_dim=10, out_dim=10, L=2, type_net="simple",
               aggregators="mean max min dir1-dx dir1-av", scalers="identity",
               batch_norm=False, graph_norm=False)
    return graphs, jpcba, tpcba, dict(net, avg_d=_avg_d(graphs))


def _init_state(jtrainer, jmodel, gb):
    """dgn_tpu's Trainer.init_state, with the init jitted (eager flax init
    takes seconds)."""
    variables = jax.jit(lambda key: jmodel.init(key, gb, deterministic=True))(
        jax.random.PRNGKey(41))
    return TrainState(params=variables["params"],
                      batch_stats=variables.get("batch_stats", {}),
                      opt_state=jtrainer.tx.init(variables["params"]),
                      step=jnp.zeros((), jnp.int32))


def _assert_params(model, want_flat, rtol=2e-5, atol=2e-6):
    got = {flax_path(k): p.detach().numpy()
           for k, p in model.named_parameters()}
    assert set(got) == set(want_flat)
    for path, want in want_flat.items():
        np.testing.assert_allclose(got[path], want, rtol=rtol, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("task", ["zinc", "pcba"])
def test_micro_step_equals_full_step_and_reference(task):
    graphs, jfactory, tfactory, net = _task(task)
    jmodel, jloss = jfactory(JConfig(**net))
    jtrainer = JTrainer(jmodel, jloss, JParams(seed=41, init_lr=LR),
                        task=task, donate=False)
    jfull = next(iter(JBatchLoader(graphs, 48, layout="mxu")))
    jmicros = next(iter(JBatchLoader(graphs, 48, layout="mxu",
                                     micro_batches=K)))
    state = _init_state(jtrainer, jmodel, jfull)
    jstate, jloss_micro, _ = jtrainer._train_step(
        state, jmicros, jax.random.PRNGKey(7), jnp.asarray(LR, jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, state.params)

    tgs = _to_port(graphs)
    tfull = next(iter(TBatchLoader(tgs, 48, layout="mxu")))
    tmicros = next(iter(TBatchLoader(tgs, 48, layout="mxu",
                                      micro_batches=K)))
    assert isinstance(tmicros, list) and len(tmicros) == K
    assert sum(int(g.graph_mask.sum()) for g in tmicros) == len(graphs)
    steps = {}
    for name, batch in (("full", tfull), ("micro", tmicros)):
        model, loss_fn = tfactory(TConfig(**net),
                                  torch.Generator().manual_seed(0))
        load_jax_params(model, params, {})
        trainer = TTrainer(model, loss_fn, TParams(seed=41, init_lr=LR),
                           task=task, device="cpu")
        loss, scores = trainer.train_step(batch)
        steps[name] = (float(loss), model, scores)
    assert isinstance(steps["micro"][2], list) and len(steps["micro"][2]) == K
    np.testing.assert_allclose(steps["micro"][0], steps["full"][0],
                               rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(steps["micro"][0], float(jloss_micro),
                               rtol=2e-6, atol=2e-7)
    full_params = {flax_path(k): p.detach().numpy()
                   for k, p in steps["full"][1].named_parameters()}
    _assert_params(steps["micro"][1], full_params)
    _assert_params(steps["micro"][1],
                   flatten(jax.tree_util.tree_map(np.asarray, jstate.params)))


def test_micro_step_updates_bn_running_stats_per_micro_batch():
    """Batch norm on: each micro-batch normalises by its own statistics and
    the running stats take K updates, as dgn_tpu's micro-batched step does."""
    graphs = jsyn.synthetic_zinc(24, seed=4)
    net = dict(hidden_dim=8, out_dim=8, L=2, avg_d=_avg_d(graphs))
    jmodel, jloss = jzinc(JConfig(**net))
    jtrainer = JTrainer(jmodel, jloss, JParams(seed=41, init_lr=LR),
                        task="zinc", donate=False)
    jmicros = next(iter(JBatchLoader(graphs, 24, layout="mxu",
                                     micro_batches=3)))
    state = _init_state(jtrainer, jmodel, jmicros[0])
    jstate, jl, _ = jtrainer._train_step(
        state, jmicros, jax.random.PRNGKey(7), jnp.asarray(LR, jnp.float32))
    model, loss_fn = tzinc(TConfig(**net), torch.Generator().manual_seed(0))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, state.params),
                    jax.tree_util.tree_map(np.asarray, state.batch_stats))
    trainer = TTrainer(model, loss_fn, TParams(seed=41, init_lr=LR),
                       task="zinc", device="cpu")
    loss, _ = trainer.train_step(next(iter(TBatchLoader(
        _to_port(graphs), 24, layout="mxu", micro_batches=3))))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    want = flatten(jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    got = {flax_path(k): v.numpy() for k, v in model.named_buffers()}
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                   atol=1e-6, err_msg=path)


# ------------------------------------------------------------- entry point

@pytest.mark.parametrize("config", CONFIGS, ids=lambda p: Path(p).stem)
def test_every_config_gets_past_prepare(config):
    # the smallest size: superpixel splits keep at least 8 graphs each
    cfg = load_config(config, {"synthetic_size": 8})
    _, model, _, trainer, loaders = trun.prepare(cfg, "cpu")
    mb = trun.resolve_micro_batches("auto", cfg.params.batch_size)
    assert all(ld.micro_batches == mb for ld in loaders.values())
    assert trainer.task == cfg.task


@pytest.mark.parametrize("config", CONFIGS, ids=lambda p: Path(p).stem)
def test_every_config_refuses_cpu_fallback(config):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(SystemExit, match="--device cpu"):
        trun.run(["--config", config, "--synthetic_size", "24"])


def test_run_pcba_micro_batched_one_epoch_on_cpu(capsys):
    cfg = load_config(PCBA_CONFIG)
    assert trun.resolve_micro_batches(cfg.data.micro_batches,
                                      cfg.params.batch_size) == 2
    report = trun.run(["--config", PCBA_CONFIG, "--epochs", "1",
                       "--synthetic_size", "96", "--batch_size", "64",
                       "--micro_batches", "2", "--device", "cpu"])
    assert report["epochs_run"] == 1 and report["device"] == "cpu"
    for split in ("train", "val", "test"):
        assert math.isfinite(report["final"][split]["ap"])
        assert math.isfinite(report["final"][split]["loss"])
    assert "final ap" in capsys.readouterr().out
