"""The port's data parallelism (dgn_tpu_torch/parallel) == dgn_tpu's.

  * The 2-rank step: two gloo ranks spawned on the CPU
    (tests/test_torch_parallel_ranks.py, which imports no JAX) run
    DataParallelTrainer's step on their shards of one super-batch; dgn_tpu's
    DataParallelTrainer runs the same super-batch on 2 of the 8 virtual
    devices in this process, from the same weights.  ZINC (complex,
    graph norm) and a simple max/min net on HIV-like molecules, on both
    layouts, dropout and augmentation off.  Held: the loss (1e-5), the
    gradients Adam takes (averaged over the ranks; dgn_tpu's are jax.grad
    of its step's loss, pmean over 'dp'), the weights after one Adam step
    and the sync batch norm's running buffers (rtol 2e-4 / atol 1e-5,
    tests/test_parallel.py:25-72's tolerances), the two ranks' weights and
    gradients equal, the gathered scores, labels and masks (dgn_tpu's
    _flatten_stacked), and the port's one-process step on the concatenated
    batch (bn_axis None) at the same tolerances.
  * A planted fault: sync batch norm's all-reduce without its summed
    backward gives the same loss, and both gradient comparisons reject
    its gradients.
  * The ragged super-batch: uneven shards (3 and 2 graphs) and a ghost
    shard, each against dgn_tpu; the loss is the mean of the shards'
    batch means, which departs from the one-device loss on the same
    graphs (ROADMAP C4): pinned here.
  * An epoch: train_epoch and evaluate over shuffled and fixed loaders
    (HIV ROC-AUC from every shard's scores) against dgn_tpu's; each rank's
    collectives and metrics against a loop that gathers every step at
    once, and no edges/s in what a rank reports.
  * StackedLoader's shards and escapes == dgn_tpu's, host only (tests/
    test_parallel.py:120-141's case), and shard_fits == pack_graphs.
  * The entry point with --n_devices 2 --device cpu, --n_devices 2
    without the GPUs (under dp and ep), and the --multihost wiring with
    init_process_group patched (tests/test_parallel.py:143-196).
All the 2-rank jobs run in one spawn (a module fixture) with a deadline.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks
from test_torch_buckets import _assert_same_batch
from test_torch_layers import run_jitted

from dgn_tpu import graph as jgraph
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import hiv_model as jhiv
from dgn_tpu.models import zinc_model as jzinc
from dgn_tpu.ops.scalers import degree_stats
from dgn_tpu.parallel import DataParallelTrainer as JDataParallelTrainer
from dgn_tpu.parallel import StackedLoader as JStackedLoader
from dgn_tpu.parallel import make_mesh as jmake_mesh
from dgn_tpu.parallel.dp import _flatten_stacked
from dgn_tpu.train.trainer import TrainParams as JParams
from dgn_tpu.train.trainer import TrainState

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import run as trun
from dgn_tpu_torch.convert import flatten, flax_paths
from dgn_tpu_torch.parallel import StackedLoader
from dgn_tpu_torch.parallel import launch
from dgn_tpu_torch.parallel import mesh as tmesh
from dgn_tpu_torch.parallel.dp import shard_fits
from dgn_tpu_torch.train.trainer import TrainParams, Trainer

torch.set_num_threads(1)

D = 2
LOSS_ATOL = 1e-5
STEP = dict(rtol=2e-4, atol=1e-5)
METRIC = dict(rtol=1e-4, atol=1e-6)
TRAIN = dict(seed=41, batch_size=8, init_lr=1e-3, weight_decay=3e-6,
             print_epoch_interval=100)
SPAWN_TIMEOUT = 240


def _avg_d(graphs):
    return degree_stats(np.concatenate(
        [np.bincount(g.dst, minlength=g.num_nodes) for g in graphs]))


def _port_graphs(graphs):
    return [tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs]


def _zinc(n, seed):
    return jsyn.synthetic_zinc(n, seed=seed)


def _hiv(n, seed):
    return jsyn.synthetic_ogb_mol(n, seed=seed, n_tasks=1, k_eig=3)


# out_dim 16: at out_dim 12 the readout MLP (12 -> 6 -> 3 -> 1) of these
# initial weights is dead (every ReLU of its last hidden layer off on every
# graph), and no gradient but the final bias's reaches a parameter
NETS = {
    "zinc": (jzinc, _zinc, dict(hidden_dim=12, out_dim=16, L=2,
                                aggregators="mean dir1-dx dir1-av",
                                scalers="identity amplification "
                                "attenuation", dropout=0.0)),
    "maxmin": (jhiv, _hiv, dict(hidden_dim=12, out_dim=16, L=2,
                                type_net="simple",
                                aggregators="mean max min dir1-dx",
                                scalers="identity", dropout=0.0)),
}
TASK = {"zinc": "zinc", "maxmin": "hiv"}
# (net, layout, graphs, seed, per-device batch, super-batch index)
CASES = {
    "zinc-mxu": ("zinc", "mxu", 8, 11, 4, 0),
    "zinc-flat": ("zinc", "flat", 8, 11, 4, 0),
    "maxmin-mxu": ("maxmin", "mxu", 8, 12, 4, 0),
    "maxmin-flat": ("maxmin", "flat", 8, 12, 4, 0),
    "ragged-uneven": ("zinc", "mxu", 13, 5, 4, 1),
    "ragged-ghost": ("zinc", "mxu", 9, 5, 4, 1),
}
EPOCH = ("maxmin", "mxu", 24, 14, 4)


def _opt0(jitted):
    """jitted, compiled at XLA's lowest CPU optimisation level per
    argument shape (these programs run a few times at most)."""
    cache = {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(
                {"xla_backend_optimization_level": 0})
        return cache[key](*args)
    return call


def _geometry(graphs, per_device, layout):
    if layout == "mxu":
        return jgraph.mxu_bucket_sizes(graphs, per_device)[:2]
    return jgraph.bucket_sizes_for(graphs, per_device)


_INIT = {}


def _reference(net_key, layout, graphs, per_device, n_pad, e_pad):
    """dgn_tpu's 2-device trainer, loader and initial state (the
    parameters depend on the net alone: one init per net)."""
    jfactory, _, net = NETS[net_key]
    mesh = jmake_mesh(D, ("dp",))
    model, loss = jfactory(JConfig(**net, avg_d=_avg_d(graphs),
                                   bn_axis="dp"))
    trainer = JDataParallelTrainer(model, loss, JParams(**TRAIN), mesh,
                                   task=TASK[net_key])
    trainer._train_step = _opt0(trainer._train_step)
    trainer._eval_step = _opt0(trainer._eval_step)

    def loader(shuffle=False):
        return JStackedLoader(graphs, per_device_batch=per_device,
                              n_shards=D, mesh=mesh, shuffle=shuffle,
                              seed=TRAIN["seed"], n_pad=n_pad, e_pad=e_pad,
                              layout=layout)

    if net_key not in _INIT:
        first = jax.tree_util.tree_map(lambda x: x[0], next(iter(loader())))
        _INIT[net_key] = run_jitted(
            lambda key: model.init(key, first, deterministic=True),
            jax.random.PRNGKey(TRAIN["seed"]))
    variables = _INIT[net_key]
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=trainer.tx.init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    return trainer, loader, state


def _job(kind, net_key, layout, graphs, per_device, n_pad, e_pad, state,
         **extra):
    _, _, net = NETS[net_key]
    return dict(kind=kind, task=TASK[net_key],
                net=dict(net, avg_d=_avg_d(graphs)),
                params=jax.tree_util.tree_map(np.asarray, state.params),
                batch_stats=jax.tree_util.tree_map(np.asarray,
                                                   state.batch_stats),
                train=TRAIN, graphs=_port_graphs(graphs),
                per_device=per_device, n_pad=n_pad, e_pad=e_pad,
                layout=layout, **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through dgn_tpu here and through the port's 2 ranks in
    one spawn: {case: (dgn_tpu's results, rank 0's, rank 1's, job)}."""
    jobs, refs = [], {}
    names = list(CASES) + ["epoch"]
    for name in names:
        net_key, layout, n, seed, per_device, *index = CASES.get(name, EPOCH)
        graphs = NETS[net_key][1](n, seed)
        n_pad, e_pad = _geometry(graphs, per_device, layout)
        refs[name] = _reference(net_key, layout, graphs, per_device, n_pad,
                                e_pad)
        jobs.append(_job("step" if index else "epoch", net_key, layout,
                         graphs, per_device, n_pad, e_pad, refs[name][2],
                         **dict(batch=index[0]) if index else {}))
    # the planted fault: zinc-mxu's step with sync batch norm's all-reduce
    # swapped for one without the summed backward
    jobs.append(dict(jobs[names.index("zinc-mxu")], fault=True))
    # the ranks run while dgn_tpu's steps run here
    ranks = []
    thread = threading.Thread(target=lambda: ranks.append(launch.spawn(
        test_torch_parallel_ranks.run_jobs, D, (jobs,),
        timeout=SPAWN_TIMEOUT,
        rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))))
    thread.start()
    try:
        lr = jnp.asarray(TRAIN["init_lr"], jnp.float32)
        for name in CASES:
            trainer, loader, state = refs[name]
            gb = list(loader())[CASES[name][-1]]
            rngs = jax.random.split(jax.random.PRNGKey(0), D)
            new, loss, scores = trainer._train_step(state, gb, rngs, lr)
            refs[name] = dict(loss=float(loss), state=new, gb=gb,
                              scores=np.asarray(scores),
                              grads=_reference_grads(trainer, state, gb))
        trainer, loader, state = refs["epoch"]
        state, train_m = trainer.train_epoch(state, loader(True), 0)
        refs["epoch"] = dict(train=train_m,
                             eval=trainer.evaluate(state, loader()),
                             state=state)
    finally:
        thread.join()
    if not ranks:
        pytest.fail("the ranks failed (their tracebacks are above)")
    ranks = ranks[0]
    out = {name: (refs[name], ranks[0][i], ranks[1][i], jobs[i])
           for i, name in enumerate(names)}
    out["fault"] = (refs["zinc-mxu"], ranks[0][-1], ranks[1][-1], jobs[-1])
    return out


def _reference_grads(trainer, state, gb):
    """dgn_tpu's 2-device gradients of the step, the ones its Adam step
    takes: jax.grad of DataParallelTrainer's train_core loss on each
    device's shard, pmean over 'dp' (augmentation and dropout off).  Under
    shard_map the gradient of a replicated input is already summed over
    the devices, so the pmean after it changes nothing: these are D times
    the gradients of the mean loss (ROADMAP C6)."""
    def core(params, gb):
        gb = jax.tree_util.tree_map(lambda x: x[0], gb)

        def loss_of(p):
            scores, _ = trainer._apply(
                p, state.batch_stats, gb, deterministic=False,
                rngs={"dropout": jax.random.PRNGKey(0)}, mutable=True)
            return trainer.loss_fn(scores, gb)
        return jax.lax.pmean(jax.grad(loss_of)(params), "dp")

    grads = _opt0(jax.jit(shard_map(core, mesh=trainer.mesh,
                                    in_specs=(P(), P("dp")),
                                    out_specs=P())))(state.params, gb)
    return jax.tree_util.tree_map(np.asarray, grads)


def _assert_state(got, want_state, tol, grads=None):
    """The port's state_dict (numpy) against dgn_tpu's params and
    batch_stats.  With the step's gradients given, a parameter whose
    gradient is zero up to rounding (at most 1e-6 of the largest; a bias
    that a batch norm cancels, when one graph is real) is held to 2 lr
    instead: Adam turns rounding noise into a step of up to lr in the
    noise's direction, on each side; its gradient is held by
    _assert_grads."""
    want = {**flatten(jax.tree_util.tree_map(np.asarray, want_state.params)),
            **flatten(jax.tree_util.tree_map(np.asarray,
                                             want_state.batch_stats))}
    paths = flax_paths(got)
    assert set(paths.values()) == set(want)
    noise = set()
    if grads is not None:
        top = max(np.abs(g).max() for g in grads.values())
        noise = {k for k, g in grads.items() if np.abs(g).max() <= 1e-6 * top}
    for name, value in got.items():
        bound = dict(rtol=0, atol=2 * TRAIN["init_lr"]) \
            if name in noise else tol
        np.testing.assert_allclose(value, want[paths[name]], err_msg=name,
                                   **bound)


def _assert_grads(got, want_tree, tol):
    """The port's {parameter name: gradient} against dgn_tpu's gradient
    tree (flax paths)."""
    want = flatten(want_tree)
    paths = flax_paths(got)
    assert set(paths.values()) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value, want[paths[name]], err_msg=name,
                                   **tol)


def test_step_sums_the_gradients_as_the_reference_does(runs):
    """Pins ROADMAP C6: dgn_tpu's 2-device step, and the port's, apply D
    times the one-process gradient on the concatenated batch, so after one
    Adam step their weights part from the one-process step's wherever the
    L2 weight decay and the gradient nearly cancel (or Adam's eps matters),
    and agree with the one-process step whose gradients are scaled by D."""
    ref, r0, _, job = runs["zinc-mxu"]
    graphs = _super_batch_graphs(job)
    _, state, grads = _single_process(job, graphs)
    _assert_grads({k: D * v for k, v in grads.items()}, ref["grads"], STEP)
    _assert_grads(r0["grads"], ref["grads"], STEP)
    with pytest.raises(AssertionError):
        _assert_state(state, ref["state"], STEP)
    _, state, _ = _single_process(job, graphs, grad_scale=D)
    _assert_state(state, ref["state"], STEP)


def _single_process(job, graphs, grad_scale=1):
    """The port's one-process step (bn_axis None) on one batch of these
    graphs, from the job's weights, its gradients times grad_scale before
    Adam (D: what a D-rank step applies, ROADMAP C6): loss, state_dict
    after the step and the gradients the step applied."""
    model, loss_fn = test_torch_parallel_ranks.build(job, bn_axis=None)
    trainer = Trainer(model, loss_fn, TrainParams(**job["train"]),
                      task=job["task"], device="cpu")
    trainer._reduce_grads = lambda: [p.grad.mul_(grad_scale)
                                     for p in model.parameters()]
    grads = test_torch_parallel_ranks.keep_grads(trainer)
    mxu = job["layout"] == "mxu"
    if mxu:
        graphs = sorted(graphs, key=lambda g: -g.num_nodes)
    gb = tgraph.pack_graphs(graphs, mxu_layout=mxu)
    loss, scores = trainer.train_step(gb)
    return float(loss), {k: v.detach().numpy()
                         for k, v in model.state_dict().items()}, grads


def _one_process_scores(job, graphs):
    """The port's one-process training-mode scores (bn_axis None) of these
    graphs packed as one batch, from the job's weights, in their order."""
    model, _ = test_torch_parallel_ranks.build(job, bn_axis=None)
    order = (sorted(range(len(graphs)), key=lambda i: -graphs[i].num_nodes)
             if job["layout"] == "mxu" else list(range(len(graphs))))
    gb = tgraph.pack_graphs([graphs[i] for i in order],
                            mxu_layout=job["layout"] == "mxu")
    with torch.no_grad():
        scores = model.train()(gb, None)[gb.graph_mask].numpy().ravel()
    out = np.empty_like(scores)
    out[order] = scores
    return out


def _super_batch_graphs(job):
    """The real graphs of the job's super-batch, every shard's."""
    loader = StackedLoader(job["graphs"], job["per_device"], D,
                           layout=job["layout"])
    for i, (shards, _) in enumerate(loader.super_batches()):
        if i == job["batch"]:
            return [g for gs, ghost in shards if not ghost for g in gs]


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if not c.startswith("ragged")))
def test_two_rank_step_matches_reference_and_one_process(runs, case):
    ref, r0, r1, job = runs[case]
    assert abs(r0["loss"] - ref["loss"]) < LOSS_ATOL, (r0["loss"],
                                                       ref["loss"])
    assert r0["loss"] == r1["loss"]
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k],
                                      err_msg=k)
    _assert_state(r0["state"], ref["state"], STEP)
    # the gathered super-batch: dgn_tpu's stacked batch, flattened
    flat = _flatten_stacked(ref["gb"])
    for k, v in r0["view"].items():
        np.testing.assert_array_equal(v, np.asarray(getattr(flat, k)),
                                      err_msg=k)
    mask = r0["view"]["graph_mask"]
    np.testing.assert_allclose(r0["scores"][mask],
                               _flatten_stacked(ref["scores"])[mask], **STEP)
    # the gradients Adam took, the same on both ranks: dgn_tpu's 2-device
    # ones, summed over the devices (ROADMAP C6)
    _assert_grads(r0["grads"], ref["grads"], STEP)
    for k in r0["grads"]:
        np.testing.assert_array_equal(r0["grads"][k], r1["grads"][k],
                                      err_msg=k)
    # the port's one-process step on the concatenated batch, its gradients
    # times D as the 2-rank step's are
    loss, state, grads = _single_process(job, _super_batch_graphs(job),
                                         grad_scale=D)
    # every kernel and embedding has a gradient: nothing above is vacuous
    assert [k for k, g in grads.items()
            if not k.endswith("bias") and not np.any(g)] == []
    assert abs(r0["loss"] - loss) < LOSS_ATOL, (r0["loss"], loss)
    for k, v in state.items():
        np.testing.assert_allclose(r0["state"][k], v, err_msg=k, **STEP)
    for k, v in grads.items():
        np.testing.assert_allclose(r0["grads"][k], v, err_msg=k, **STEP)


def test_missing_cross_rank_backward_fails_the_gradient_checks(runs):
    """The planted fault the gradient checks are for: zinc-mxu's 2-rank
    step with sync batch norm's all-reduce swapped for a bare all_reduce
    whose backward keeps this rank's cotangent alone.  Its forward is
    sound (the same loss), its gradients miss the other ranks' batch-norm
    terms, and both gradient comparisons above reject them."""
    ref, r0, _, job = runs["fault"]
    assert abs(r0["loss"] - ref["loss"]) < LOSS_ATOL, (r0["loss"],
                                                       ref["loss"])
    with pytest.raises(AssertionError):
        _assert_grads(r0["grads"], ref["grads"], STEP)
    _, _, grads = _single_process(job, _super_batch_graphs(job),
                                  grad_scale=D)
    names = sorted(grads)
    diff = np.sqrt(sum(((r0["grads"][k] - grads[k]) ** 2).sum()
                       for k in names))
    norm = np.sqrt(sum((grads[k] ** 2).sum() for k in names))
    assert diff > 1e-2 * norm, diff / norm
    with pytest.raises(AssertionError):
        for k in names:
            np.testing.assert_allclose(r0["grads"][k], grads[k], err_msg=k,
                                       **STEP)


@pytest.mark.parametrize("case", ["ragged-uneven", "ragged-ghost"])
def test_ragged_super_batch_keeps_the_mean_of_shard_means(runs, case):
    """Shards of 3 and 2 graphs, or 1 graph and a ghost: the port's step
    equals dgn_tpu's, and its loss is the mean of the shards' batch-mean
    losses (a ghost's 0 included), not the one-device mean."""
    ref, r0, r1, job = runs[case]
    assert abs(r0["loss"] - ref["loss"]) < LOSS_ATOL, (r0["loss"],
                                                       ref["loss"])
    assert r0["loss"] == r1["loss"]
    _assert_grads(r0["grads"], ref["grads"], STEP)
    _assert_state(r0["state"], ref["state"], STEP, grads=r0["grads"])
    loader = StackedLoader(job["graphs"], job["per_device"], D,
                           layout=job["layout"])
    shards, _ = list(loader.super_batches())[job["batch"]]
    sizes = [0 if ghost else len(gs) for gs, ghost in shards]
    assert sizes == ([3, 2] if case == "ragged-uneven" else [1, 0])
    # each graph's L1 loss from the one-process forward on the concatenated
    # batch, whose batch norm takes the super-batch's statistics as sync
    # batch norm does; the shards' means of them, a ghost's 0 included
    graphs = _super_batch_graphs(job)
    losses = np.abs(_one_process_scores(job, graphs)
                    - np.array([g.label[0] for g in graphs]))
    bounds = np.cumsum([0] + sizes)
    per_shard = [losses[a:b].mean() if b > a else 0.0
                 for a, b in zip(bounds[:-1], bounds[1:])]
    one_device = _single_process(job, graphs)[0]
    np.testing.assert_allclose(r0["loss"], np.mean(per_shard), rtol=1e-5)
    if case == "ragged-ghost":
        np.testing.assert_allclose(r0["loss"], one_device / 2, rtol=1e-5)
    else:
        assert abs(r0["loss"] - one_device) > 1e-4 * abs(one_device)


def test_epoch_metrics_from_every_shard_match_reference(runs):
    ref, r0, r1, _ = runs["epoch"]
    for split in ("train", "eval"):
        assert r0[split] == r1[split]
        assert set(r0[split]) == set(ref[split]) == {"loss", "rocauc",
                                                     "objective"}
        for k, want in ref[split].items():
            np.testing.assert_allclose(r0[split][k], want, err_msg=k,
                                       **METRIC)
    _assert_state(r0["state"], ref["state"], STEP)


def test_epoch_issues_the_collectives_of_a_serial_loop(runs):
    """train_epoch gathers step n's shards after batch n+1's pack: on each
    rank the collectives it issues (name, op, the tensor sent) and the
    metrics, in training and in evaluation, equal those of a loop that
    gathers every step at once (test_torch_parallel_ranks.serial_epoch),
    one all-gather a batch; no rank reports edges/s."""
    _, r0, r1, job = runs["epoch"]
    n_batches = -(-len(job["graphs"]) // (job["per_device"] * D))
    for r in (r0, r1):
        for split in ("train", "eval"):
            assert r["piped", split] == r["serial", split]
            calls = r["piped", split, "calls"]
            assert calls == r["serial", split, "calls"]
            assert [c[0] for c in calls].count("all_gather") == n_batches
        assert not {"edges_per_s", "edge_padding_efficiency"} \
            & set(r["throughput"])


# ------------------------------------------------------- StackedLoader

@pytest.mark.parametrize("layout", ["mxu", "flat"])
def test_stacked_loader_shards_and_escapes_match_reference(layout):
    """SBM-sized graphs at pads deliberately too small
    (tests/test_parallel.py:120-141): the same shards on every rank as
    dgn_tpu's stacked batch, field for field, over two shuffled epochs,
    and the same escapes."""
    graphs = jsyn.synthetic_sbm(64, seed=3, n_classes=2, nodes=80)
    kw = dict(per_device_batch=8, n_shards=4, shuffle=True, seed=11,
              layout=layout, n_pad=256 if layout == "mxu" else 400,
              e_pad=512 if layout == "mxu" else 4000)
    ref = JStackedLoader(graphs, **kw)
    tgs = _port_graphs(graphs)
    ours = [StackedLoader(tgs, rank=r, **kw) for r in range(4)]
    n = 0
    for _ in range(2):
        for stacked, *shards in zip(ref, *ours, strict=True):
            for r, tb in enumerate(shards):
                _assert_same_batch(jax.tree_util.tree_map(
                    lambda x: x[r], stacked), tb)
            n += 1
    assert n == 2 * len(ref) == 4
    assert ref.n_escapes > 0
    assert all(o.n_escapes == ref.n_escapes for o in ours)


def test_shard_fits_is_what_pack_graphs_accepts():
    """shard_fits decides from the graphs alone what packing would do:
    for random shards at random pads, True exactly when pack_graphs
    packs them without raising."""
    rng = np.random.default_rng(5)
    pools = (_port_graphs(jsyn.synthetic_zinc(40, seed=9)),
             _port_graphs(jsyn.synthetic_sbm(8, seed=2, n_classes=2,
                                             nodes=140)))
    seen = set()
    for i in range(60):
        graphs = pools[i % 2]     # molecules, and graphs over 128 nodes
        gs = [graphs[i] for i in rng.choice(len(graphs),
                                            int(rng.integers(1, 7)),
                                            replace=False)]
        layout = "mxu" if rng.random() < 0.7 else "flat"
        if layout == "mxu":
            gs = sorted(gs, key=lambda g: -g.num_nodes)
            n_used, e_used = tgraph.pack_requirements(gs, mxu_layout=True)
            n_pad = 128 * int(rng.integers(max(n_used // 128 - 1, 1),
                                           n_used // 128 + 2))
            e_pad = 128 * int(rng.integers(max(e_used // 128 - 1, 1),
                                           e_used // 128 + 2))
            pair_pad = int(rng.integers(1, 8))
        else:
            n_pad = int(sum(g.num_nodes for g in gs) + rng.integers(-3, 3))
            e_pad = int(sum(g.num_edges for g in gs) + rng.integers(-3, 3))
            pair_pad = None
        try:
            tgraph.pack_graphs(gs, n_pad=n_pad, e_pad=e_pad,
                               mxu_layout=layout == "mxu",
                               n_pairs_pad=pair_pad)
            packs = True
        except ValueError:
            packs = False
        assert shard_fits(gs, layout, n_pad, e_pad, pair_pad) == packs
        seen.add((layout, packs))
    assert seen == {("mxu", True), ("mxu", False), ("flat", True),
                    ("flat", False)}


@pytest.mark.parametrize("mode", ["fail", "hang"])
def test_spawn_reports_a_failing_rank_and_ends_a_hung_one(tmp_path, mode):
    """A rank that raises fails the call with its traceback; a rank past
    the deadline fails it too, and no rank outlives the call."""
    import multiprocessing
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="on purpose" if mode == "fail"
                       else "timed out after 10 s with ranks \\[1\\]"):
        launch.spawn(test_torch_parallel_ranks.fail_or_hang, 2, (mode,),
                     timeout=10, rendezvous_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()


# ---------------------------------------------------------- entry point

TINY = ["--dataset", "ZINC", "--batch_size", "8", "--hidden_dim", "12",
        "--out_dim", "12", "--L", "2", "--synthetic_size", "20",
        "--epochs", "1"]


def test_entry_point_trains_on_two_gloo_ranks(tmp_path):
    report = trun.run(TINY + ["--n_devices", "2", "--device", "cpu",
                              "--out_dir", str(tmp_path)])
    assert report["n_devices"] == 2 and report["epochs_run"] == 1
    assert all(math.isfinite(v) for split in report["final"].values()
               for v in split.values())
    # rank 0 alone writes the metric stream, without a rank's edges/s
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1
    assert "train" in json.loads(lines[0])
    assert "edges_per_s" not in json.loads(lines[0])


def test_entry_point_refuses_what_it_cannot_run(monkeypatch):
    """Fewer GPUs than ranks is an error under either partition, never a
    fall-back to the CPU (--partition ep runs: tests/test_torch_halo.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for partition in ("dp", "ep"):
        with pytest.raises(SystemExit, match="--n_devices 2 needs 2 GPUs, "
                           "but 1 are visible"):
            trun.run(TINY + ["--n_devices", "2", "--device", "cuda",
                             "--partition", partition])


def test_init_multihost_wires_init_process_group(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    assert tmesh.init_multihost("10.0.0.1:8476", 4, 2, device="cpu") \
        == (2, 4)
    assert tmesh.init_multihost(device="cuda") == (0, 1)
    assert calls == [
        {"backend": "gloo", "init_method": "tcp://10.0.0.1:8476",
         "world_size": 4, "rank": 2},
        {"backend": "nccl", "init_method": "env://"}]


def test_run_multihost_flag(monkeypatch):
    """`run --multihost` joins through init_multihost before anything else
    and trains as one rank of a mesh of the world's size on its local
    device."""
    seen = {}

    def fake_init(addr=None, nproc=None, pid=None, device="cuda"):
        seen["init"] = (addr, nproc, pid, device)
        return 1, 3

    def fake_mesh(n, device):
        seen["mesh"] = (n, str(device))
        return "mesh"

    def fake_rank(cfg, args, mesh):
        seen["rank"] = mesh
        return {"ok": True}

    monkeypatch.setattr(tmesh, "init_multihost", fake_init)
    monkeypatch.setattr(tmesh, "make_mesh", fake_mesh)
    monkeypatch.setattr(trun, "_run_rank", fake_rank)
    assert trun.run(TINY + ["--multihost", "--coordinator_address", "h:1",
                            "--num_processes", "3", "--process_id", "1",
                            "--device", "cpu"]) == {"ok": True}
    assert seen == {"init": ("h:1", 3, 1, "cpu"), "mesh": (3, "cpu"),
                    "rank": "mesh"}
    with pytest.raises(SystemExit, match="--n_devices 2 but the multihost "
                       "world has 3"):
        trun.run(TINY + ["--multihost", "--n_devices", "2", "--device",
                         "cpu"])
