"""The port's edge parallelism (dgn_tpu_torch/parallel/halo.py) == dgn_tpu's.

  * partition_batch, flat and block layout, at 2 and 4 shards: every
    array of every shard (its HaloSpec and its edge-partitioned
    MXULayout included) == dgn_tpu's stacked batch, field by listed field;
    the port-only adjacency walk arrays against arrays derived from
    chunk_pair.
  * Three gloo ranks spawned on the CPU (tests/test_torch_halo_ranks.py,
    which imports no JAX), so that halos hold rows of two owners:
      - the boundary-only exchange equals the all-gather fallback, rows
        and the gradients flowing back;
      - per net (ZINC complex on both layouts, HIV simple with max/min,
        towers, the virtual node, var/std, SBM node-level): the ep eval
        forward and loss against dgn_tpu's EdgeParallelTrainer on 3 of
        the 8 virtual CPU devices and against the port's one-process
        forward; the ep train step's loss and the gradients Adam takes
        (summed over the ranks) against jax.value_and_grad of dgn_tpu's
        shard-mapped loss (tests/test_halo.py:80-114) and against the
        port's one-process step, each parameter's gradient non-zero
        (ROADMAP C7).  A max readout runs too, against the one-process
        step alone: dgn_tpu cannot differentiate its pmax.
      - a planted fault, the exchange without its reverse backward, keeps
        the loss and fails both gradient checks;
      - PartitionedLoader epoch metrics against dgn_tpu's; each rank's
        collectives and metrics (HIV, and SBM's node-level view) against
        a loop that reads every step back at once, and no edges/s in what
        a rank reports.
  * The entry point: `--n_devices 2 --partition ep --device cpu` trains
    one epoch of a tiny config.
Tolerances are tests/test_halo.py's: scores rtol / atol 2e-5, the loss
rtol 1e-5, gradients rtol 5e-4 / atol 1e-5.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_halo_ranks
from test_torch_layers import run_jitted

from dgn_tpu import graph as jgraph
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import hiv_model as jhiv
from dgn_tpu.models import sbm_model as jsbm
from dgn_tpu.models import zinc_model as jzinc
from dgn_tpu.ops.scalers import degree_stats
from dgn_tpu.parallel import make_mesh as jmake_mesh
from dgn_tpu.parallel.halo import EdgeParallelTrainer as JEdgeParallelTrainer
from dgn_tpu.parallel.halo import PartitionedLoader as JPartitionedLoader
from dgn_tpu.parallel.halo import partition_batch as jpartition_batch
from dgn_tpu.train.trainer import TrainParams as JParams

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import run as trun
from dgn_tpu_torch.convert import flatten, flax_paths
from dgn_tpu_torch.ops.mxu import MXULayout
from dgn_tpu_torch.parallel import launch, partition_batch, partition_shards
from dgn_tpu_torch.train.trainer import TrainParams, Trainer

torch.set_num_threads(1)

P = 3
SCORES = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 1e-5
GRADS = dict(rtol=5e-4, atol=1e-5)
TRAIN = dict(seed=41, batch_size=8, init_lr=1e-3, print_epoch_interval=100)
SPAWN_TIMEOUT = 240

# GraphBatch, HaloSpec and MXULayout fields held with ==; the port's
# dataclasses must hold exactly these (plus the port's own), so a field
# left out of the port or of this list fails here
BATCH_FIELDS = ("node_feat", "node_mask", "node_graph", "eig", "in_degree",
                "snorm_n", "src", "dst", "edge_mask", "edge_feat", "snorm_e",
                "graph_mask", "n_nodes", "n_edges", "labels", "node_labels",
                "pos_enc")
BATCH_OWN = ("mxu", "halo", "edge_ctx")
HALO_FIELDS = ("halo_shard", "halo_local", "send_idx", "recv_perm",
               "n_local", "axis")
HALO_PORT_ONLY = ("group",)
MXU_FIELDS = ("local_src", "local_dst", "edge_chunk_src", "edge_chunk_dst",
              "local_graph", "node_chunk_graph", "n_node_blocks",
              "n_graph_blocks", "chunk_pair", "pair_src", "pair_dst",
              "n_pairs", "pair_chunk_order", "pair_sorted_ids",
              "pair_covered", "ext_passes", "ext_block_chunks",
              "n_pairs_int", "n_own_blocks")
MXU_PORT_ONLY = ("pair_real_chunk_order", "pair_chunk_start")


def _avg_d(graphs):
    return degree_stats(np.concatenate(
        [np.bincount(g.dst, minlength=g.num_nodes) for g in graphs]))


def _port_graphs(graphs):
    return [tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs]


def _same(got, want, name):
    if want is None:
        assert got is None, name
        return
    if isinstance(got, torch.Tensor):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    else:
        assert got == want, name


def _assert_shard(jpb, p, tb):
    """The port's shard tb == shard p of dgn_tpu's stacked batch jpb."""
    assert {f.name for f in dataclasses.fields(tb)} == set(
        BATCH_FIELDS + BATCH_OWN)
    for name in BATCH_FIELDS:
        want = getattr(jpb, name)
        _same(getattr(tb, name), None if want is None else want[p], name)
    assert {f.name for f in dataclasses.fields(tb.halo)} == set(
        HALO_FIELDS + HALO_PORT_ONLY)
    for name in HALO_FIELDS:
        want = getattr(jpb.halo, name)
        _same(getattr(tb.halo, name),
              want[p] if hasattr(want, "shape") else want, f"halo.{name}")
    assert (tb.mxu is None) == (jpb.mxu is None)
    if tb.mxu is None:
        return
    assert {f.name for f in dataclasses.fields(MXULayout)} == set(
        MXU_FIELDS + MXU_PORT_ONLY)
    for name in MXU_FIELDS:
        want = getattr(jpb.mxu, name)
        _same(getattr(tb.mxu, name),
              want[p] if hasattr(want, "shape") else want, f"mxu.{name}")
    # the adjacency kernel's walk, from chunk_pair and the edge mask
    lay = tb.mxu
    chunk_pair = lay.chunk_pair.numpy()
    real = tb.edge_mask.numpy().reshape(-1, 128).any(axis=1)
    order = np.argsort(chunk_pair, kind="stable")
    want_order = np.concatenate([order[real[order]], order[~real[order]]])
    np.testing.assert_array_equal(lay.pair_real_chunk_order.numpy(),
                                  want_order)
    counts = np.bincount(chunk_pair[real], minlength=lay.n_pairs)
    np.testing.assert_array_equal(lay.pair_chunk_start.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("layout", ["flat", "mxu"])
def test_partition_matches_reference(layout, n_shards):
    """ZINC molecules and SBM graphs over 128 nodes (off-diagonal pairs),
    with edge features and node labels: every shard == dgn_tpu's."""
    for graphs, g_pad in ((jsyn.synthetic_zinc(24, seed=3), 32),
                          (jsyn.synthetic_sbm(3, seed=2, n_classes=2,
                                              nodes=150), None)):
        jpb = jpartition_batch(graphs, n_shards, g_pad=g_pad, layout=layout)
        shards = partition_shards(_port_graphs(graphs), n_shards,
                                  g_pad=g_pad, layout=layout)
        assert len(shards) == n_shards
        for p, tb in enumerate(shards):
            _assert_shard(jpb, p, tb)
        one = partition_batch(_port_graphs(graphs), n_shards, n_shards - 1,
                              g_pad=g_pad, layout=layout)
        _assert_shard(jpb, n_shards - 1, one)
        if layout == "mxu":
            assert shards[0].mxu.n_pairs_int is not None
            assert shards[0].mxu.local_graph is None


# ------------------------------------------------------------ the nets

def _zinc(n, seed):
    return jsyn.synthetic_zinc(n, seed=seed)


def _hiv(n, seed):
    return jsyn.synthetic_ogb_mol(n, seed=seed, n_tasks=1, k_eig=3)


def _sbm(n, seed):
    return jsyn.synthetic_sbm(n, seed=seed, n_classes=2, nodes=40)


ZINC_NET = dict(hidden_dim=12, out_dim=16, L=2, type_net="complex",
                aggregators="mean dir1-dx dir1-av",
                scalers="identity amplification attenuation", dropout=0.0)
# (jax factory, graphs, net, layout, task): out_dim 16 keeps the readout
# MLP alive at these initial weights (tests/test_torch_parallel.py NETS)
CASES = {
    "zinc-flat": (jzinc, (_zinc, 10, 11), ZINC_NET, "flat", "zinc"),
    "zinc-mxu": (jzinc, (_zinc, 10, 11), ZINC_NET, "mxu", "zinc"),
    "hiv-maxmin": (jhiv, (_hiv, 8, 12), dict(
        ZINC_NET, type_net="simple",
        aggregators="mean max min dir1-dx dir1-av"), "mxu", "hiv"),
    "towers": (jzinc, (_zinc, 10, 13), dict(ZINC_NET, type_net="towers",
                                            towers=2), "mxu", "zinc"),
    "virtual-node": (jzinc, (_zinc, 10, 14), dict(
        ZINC_NET, virtual_node="mean"), "mxu", "zinc"),
    "var-std": (jzinc, (_zinc, 10, 15), dict(
        ZINC_NET, aggregators="mean var std dir1-dx"), "mxu", "zinc"),
    "sbm-node": (jsbm, (_sbm, 4, 5), dict(
        ZINC_NET, type_net="simple", aggregators="mean dir1-dx",
        scalers="identity", readout="node", out_dim=12), "mxu", "sbm"),
    # dgn_tpu's pmax has no differentiation rule: forward only there
    "readout-max": (jzinc, (_zinc, 10, 16), dict(ZINC_NET, readout="max"),
                    "flat", "zinc"),
}
N_CLASSES = 2


def _jax_model(case, graphs, bn_axis=None):
    jfactory, _, net, _, task = CASES[case]
    cfg = JConfig(**net, avg_d=_avg_d(graphs), bn_axis=bn_axis)
    return jfactory(cfg, N_CLASSES) if task == "sbm" else jfactory(cfg)


def _init(case, graphs=None, seed=7):
    """(graphs, dgn_tpu's weights) of a case: init on the one-process
    batch."""
    _, (make, n, gseed), *_ = CASES[case]
    graphs = make(n, gseed) if graphs is None else graphs
    model, _ = _jax_model(case, graphs)
    gb = jgraph.pack_graphs(graphs, g_pad=len(graphs))
    return graphs, run_jitted(lambda k: model.init(k, gb, deterministic=True),
                              jax.random.PRNGKey(seed))


def _reference(case, graphs, variables):
    """dgn_tpu's side of a case: its 3-device EdgeParallelTrainer's eval
    scores and loss, and its shard-mapped train loss, scores and
    gradients (jax.value_and_grad, tests/test_halo.py:80-114)."""
    _, _, net, layout, task = CASES[case]
    _, loss_fn = _jax_model(case, graphs)
    model_ep, _ = _jax_model(case, graphs, "ep")
    pb = jpartition_batch(graphs, P, g_pad=len(graphs), layout=layout)
    node = task == "sbm"
    trainer = JEdgeParallelTrainer(model_ep, loss_fn, JParams(),
                                   jmake_mesh(P, ("ep",)), task=task,
                                   node_level=node)
    params, bs = variables["params"], variables.get("batch_stats", {})

    def flat(scores):
        return scores.reshape((-1,) + scores.shape[2:]) if node else scores

    def evaluate(p_):
        scores, _ = trainer._fwd_eval(p_, bs, pb)
        scores = flat(scores)
        return scores, loss_fn(scores, trainer._loss_gb(pb))

    eval_scores, eval_loss = run_jitted(evaluate, params)
    out = dict(eval_scores=np.asarray(eval_scores),
               eval_loss=float(eval_loss))
    if net.get("readout") == "max":
        return out

    def loss_of(p_):
        scores, _ = trainer._fwd_train(p_, bs, pb, jax.random.PRNGKey(2))
        scores = flat(scores)
        return loss_fn(scores, trainer._loss_gb(pb)), scores

    (loss, scores), grads = run_jitted(
        jax.value_and_grad(loss_of, has_aux=True), params)
    out.update(loss=float(loss), scores=np.asarray(scores),
               grads=flatten(jax.tree_util.tree_map(np.asarray, grads)))
    return out


def _job(case, graphs, variables, **extra):
    _, _, net, layout, task = CASES[case]
    return dict(kind="step", task=task, n_classes=N_CLASSES,
                net=dict(net, avg_d=_avg_d(graphs)),
                params=jax.tree_util.tree_map(np.asarray,
                                              variables["params"]),
                batch_stats=jax.tree_util.tree_map(
                    np.asarray, variables.get("batch_stats", {})),
                train=TRAIN, graphs=_port_graphs(graphs),
                g_pad=len(graphs), layout=layout, **extra)


EPOCH_GRAPHS = 20


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job through the port's 3 gloo ranks in one spawn, while
    dgn_tpu's side runs here: {name: (dgn_tpu's, [each rank's], job)}."""
    inits = {case: _init(case) for case in CASES}
    epoch_init = _init("hiv-maxmin", _hiv(EPOCH_GRAPHS, 17), seed=9)
    jobs = {case: _job(case, *inits[case]) for case in CASES}
    jobs["fault"] = dict(jobs["zinc-mxu"], fault=True)
    for layout in ("flat", "mxu"):
        jobs[f"exchange-{layout}"] = dict(
            kind="exchange", layout=layout,
            graphs=_port_graphs(jsyn.synthetic_zinc(24, seed=7)))
    jobs["epoch"] = dict(_job("hiv-maxmin", *epoch_init), kind="epoch",
                         batch_size=8)
    jobs["epoch-sbm"] = dict(_job("sbm-node", *inits["sbm-node"]),
                             kind="epoch", batch_size=2)
    names = list(jobs)
    ranks = []
    thread = threading.Thread(target=lambda: ranks.append(launch.spawn(
        test_torch_halo_ranks.run_jobs, P, ([jobs[k] for k in names],),
        timeout=SPAWN_TIMEOUT,
        rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))))
    thread.start()
    try:
        refs = {case: _reference(case, *inits[case]) for case in CASES}
        refs["fault"] = refs["zinc-mxu"]
        refs["epoch"] = _reference_epoch(*epoch_init)
    finally:
        thread.join()
    if not ranks:
        pytest.fail("the ranks failed (their tracebacks are above)")
    return {name: (refs.get(name), [r[i] for r in ranks[0]], jobs[name])
            for i, name in enumerate(names)}


def _reference_epoch(graphs, variables):
    """dgn_tpu's train_epoch (shuffled) and evaluate over its
    PartitionedLoader on 3 devices, from the same weights."""
    from dgn_tpu.train.trainer import TrainState
    model_ep, loss_fn = _jax_model("hiv-maxmin", graphs, "ep")
    trainer = JEdgeParallelTrainer(model_ep, loss_fn, JParams(**TRAIN),
                                   jmake_mesh(P, ("ep",)), task="hiv")
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=trainer.tx.init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))

    def loader(shuffle):
        return JPartitionedLoader(graphs, batch_size=8, n_shards=P,
                                  shuffle=shuffle, seed=TRAIN["seed"],
                                  layout="mxu")

    state, train = trainer.train_epoch(state, loader(True), 0)
    return dict(train=train, eval=trainer.evaluate(state, loader(False)))


def _one_process(job):
    """The port's one-process side (bn_axis None) on the job's graphs packed
    flat in their order: eval scores and loss, then one train step's loss,
    scores and gradients."""
    model, loss_fn = test_torch_halo_ranks.build(job, bn_axis=None)
    trainer = Trainer(model, loss_fn, TrainParams(**job["train"]),
                      task=job["task"], device="cpu")
    gb = tgraph.pack_graphs(job["graphs"], g_pad=job["g_pad"])
    eval_scores, eval_loss = trainer.eval_step(gb)
    grads = test_torch_halo_ranks.keep_grads(trainer)
    loss, scores = trainer.train_step(gb)
    return dict(eval_scores=eval_scores.numpy(), eval_loss=float(eval_loss),
                loss=float(loss), scores=scores.numpy(), grads=grads,
                node_mask=gb.node_mask.numpy())


def _ep_real(job, scores):
    """The real rows of an ep result: graph-level scores as they are,
    node-level the own real rows of every rank in rank order (= the
    one-process node order)."""
    if job["task"] != "sbm":
        return scores
    shards = partition_shards(job["graphs"], P, g_pad=job["g_pad"],
                              layout=job["layout"])
    return scores[np.concatenate([s.node_mask.numpy() for s in shards])]


def _assert_grads(got, want, tol=GRADS):
    paths = flax_paths(got)
    assert set(paths.values()) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value, want[paths[name]], err_msg=name,
                                   **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_ep_forward_matches_reference_and_one_process(runs, case):
    """The eval forward (running statistics) of the 3-rank net: dgn_tpu's
    scores and loss, the port's one-process ones, every rank alike."""
    ref, ranks, job = runs[case]
    r0 = ranks[0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["eval_scores"], r0["eval_scores"])
    np.testing.assert_allclose(r0["eval_scores"], ref["eval_scores"],
                               **SCORES)
    np.testing.assert_allclose(r0["eval_loss"], ref["eval_loss"],
                               rtol=LOSS_RTOL)
    one = _one_process(job)
    want = one["eval_scores"]
    if job["task"] == "sbm":
        want = want[one["node_mask"]]
    np.testing.assert_allclose(_ep_real(job, r0["eval_scores"]), want,
                               **SCORES)
    np.testing.assert_allclose(r0["eval_loss"], one["eval_loss"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_ep_gradients_match_reference_and_one_process(runs, case):
    """One train step: the loss and the gradients Adam takes, the same on
    every rank, against jax.value_and_grad of dgn_tpu's shard-mapped loss
    and against the port's one-process step; no parameter's gradient is
    zero (ROADMAP C7)."""
    ref, ranks, job = runs[case]
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["loss"] == r0["loss"]
        for k in r0["grads"]:
            np.testing.assert_array_equal(r["grads"][k], r0["grads"][k],
                                          err_msg=k)
    if "grads" in ref:
        np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r0["scores"], ref["scores"], **SCORES)
        _assert_grads(r0["grads"], ref["grads"])
        assert [k for k, g in ref["grads"].items() if not np.any(g)] == []
    one = _one_process(job)
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=LOSS_RTOL)
    # every parameter, biases included, has a live gradient here
    assert [k for k, g in one["grads"].items() if not np.any(g)] == []
    assert [k for k, g in r0["grads"].items() if not np.any(g)] == []
    for k, v in one["grads"].items():
        np.testing.assert_allclose(r0["grads"][k], v, err_msg=k, **GRADS)


def test_missing_exchange_backward_fails_the_gradient_checks(runs):
    """The planted fault: zinc-mxu's step with the halo exchange's backward
    kept on the reading rank.  Its forward is sound (the same loss), its
    gradients miss the cross-rank terms, and both gradient comparisons
    reject them."""
    ref, ranks, job = runs["fault"]
    r0 = ranks[0]
    np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=LOSS_RTOL)
    with pytest.raises(AssertionError):
        _assert_grads(r0["grads"], ref["grads"])
    one = _one_process(job)
    with pytest.raises(AssertionError):
        for k, v in one["grads"].items():
            np.testing.assert_allclose(r0["grads"][k], v, err_msg=k,
                                       **GRADS)


@pytest.mark.parametrize("layout", ["flat", "mxu"])
def test_halo_exchange_equals_the_all_gather(runs, layout):
    """On 3 ranks, halos that hold rows of two owners: the boundary-only
    all-to-all fetches what the all-gather fallback fetches, and the
    gradients both send back to the owners' rows are the same; its
    traffic (P x S rows) is below the all-gather's (P x n_local)."""
    _, ranks, _ = runs[f"exchange-{layout}"]
    assert max(len(r["owners"]) for r in ranks) >= 2
    for r in ranks:
        (y_plan, g_plan), (y_all, g_all) = (r["rows"]["plan"],
                                            r["rows"]["gather"])
        np.testing.assert_array_equal(y_plan, y_all)
        np.testing.assert_allclose(g_plan, g_all, rtol=1e-6, atol=1e-6)
        assert r["s_max"] < r["n_local"]


def test_partitioned_epoch_matches_reference(runs):
    """train_epoch (shuffled PartitionedLoader) and evaluate: the HIV
    ROC-AUC and loss from every batch, against dgn_tpu's, on every rank."""
    ref, ranks, _ = runs["epoch"]
    for split in ("train", "eval"):
        for r in ranks[1:]:
            assert r[split] == ranks[0][split]
        assert set(ranks[0][split]) == set(ref[split])
        for k, want in ref[split].items():
            np.testing.assert_allclose(ranks[0][split][k], want, err_msg=k,
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["epoch", "epoch-sbm"])
def test_epoch_issues_the_collectives_of_a_serial_loop(runs, name):
    """train_epoch reads step n back after batch n+1's pack: on each rank
    the collectives it issues (name, op, the tensor sent) and the
    metrics, in training and in evaluation, equal those of a loop that
    reads every step back at once (test_torch_parallel_ranks.serial_epoch),
    for HIV and for SBM's node-level view; no rank reports edges/s."""
    _, ranks, _ = runs[name]
    for r in ranks:
        for split in ("train", "eval"):
            assert r["piped", split] == r["serial", split]
            calls = r["piped", split, "calls"]
            assert calls and calls == r["serial", split, "calls"]
        assert not {"edges_per_s", "edge_padding_efficiency"} \
            & set(r["throughput"])


TINY = ["--dataset", "ZINC", "--batch_size", "8", "--hidden_dim", "12",
        "--out_dim", "12", "--L", "2", "--synthetic_size", "20",
        "--epochs", "1"]


def test_entry_point_trains_edge_partitioned(tmp_path):
    report = trun.run(TINY + ["--n_devices", "2", "--partition", "ep",
                              "--device", "cpu", "--out_dir", str(tmp_path)])
    assert report["n_devices"] == 2 and report["epochs_run"] == 1
    assert all(math.isfinite(v) for split in report["final"].values()
               for v in split.values())
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1
    assert "train" in json.loads(lines[0])
    assert "edges_per_s" not in json.loads(lines[0])
