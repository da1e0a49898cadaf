"""Edge features, the per-edge message path and the softmax aggregator
families of the port == dgn_tpu's.

The same numpy inputs, made from a seed, go through dgn_tpu and the port:
segment_softmax (empty destinations and pad edges included); the
decomposed aggregators with the edge term c, with and without the node
term q, and with neither (q alone is tests/test_torch_aggregators.py's
case; var/std with c take the scatter branch, as in dgn_tpu); the per-edge
aggregators; and six nets from dgn_tpu's `init` params (carried across by
load_jax_params) through the eval forward, the train forward with its loss,
every gradient, the BN running stats and one Adam step against dgn_tpu's
Trainer._train_step_impl.  The JAX programs compile at XLA's lowest CPU
optimisation level (run_jitted).  Dropout is 0 (the frameworks' random
streams differ).  Last, the trainer's eval-context cache on a per-edge net.
Each aggregator's references come from one dgn_tpu edge context per name;
max/min compile theirs (`_run_reference` says why).

Tolerances (f32 on both sides, summation orders differ): outputs rtol 1e-5
/ atol 1e-6; aggregator gradients atol 1e-6, 1e-5 for std (its factor
1/(2 sqrt(var + 1e-8)) amplifies rounding at in-degree-1 nodes, see
tests/test_torch_aggregators.py); model gradients rtol 1e-3 / atol 1e-5 and
BN stats rtol 1e-4 / atol 1e-6, as tests/test_torch_model.py holds them;
model loss, scores and the parameters after one Adam step rtol 1e-4 / atol
1e-5.  Without graph norm a layer's posttrans bias feeds straight into
batch norm: its gradient is rounding noise on both sides, which Adam's first
step turns into a step of up to lr either way, so those entries are held to
|step| <= lr (tests/test_torch_hiv.py).

Ties.  max/min pick one edge's message; the per-edge messages h[src] of the
HIV net come out of XLA and torch with different last bits, so a near-tie
may resolve to a different edge on each side, and a gradient hop between
two edges is a knife-edge, not an error (tests/test_decomposed.py:58-66).
The per-edge HIV case checks that its scores and loss agree at the model
tolerance first; its gradients are held at the model tolerance too, which
the 12-graph batch here meets, so no extra allowance is taken.
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

from dgn_tpu import graph as jgraph
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import hiv_model as jhiv
from dgn_tpu.models import pcba_model as jpcba
from dgn_tpu.models import superpixels_model as jsp
from dgn_tpu.models import zinc_model as jzinc
from dgn_tpu.ops import aggregators as jagg
from dgn_tpu.ops import segment as jseg
from dgn_tpu.ops.scalers import degree_stats
from dgn_tpu.train.trainer import TrainParams as JParams
from dgn_tpu.train.trainer import Trainer as JTrainer
from dgn_tpu.train.trainer import TrainState

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch.convert import flatten, flax_path, load_jax_params
from dgn_tpu_torch.data.loader import BatchLoader as TBatchLoader
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.models import hiv_model as thiv
from dgn_tpu_torch.models import pcba_model as tpcba
from dgn_tpu_torch.models import superpixels_model as tsp
from dgn_tpu_torch.models import zinc_model as tzinc
from dgn_tpu_torch.ops import aggregators as tagg
from dgn_tpu_torch.ops import segment as tseg
from dgn_tpu_torch.train.trainer import TrainParams as TParams
from dgn_tpu_torch.train.trainer import Trainer as TTrainer
from test_torch_layers import run_jitted

torch.set_num_threads(1)

NAMES = ["mean", "sum", "max", "min", "var", "std", "dir1-av", "dir1-dx",
         "dir1-dx-no-abs", "dir1-dx-balanced", "dir1-0.1", "dir1-neg-0.1"]
F = 6
OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-3, atol=1e-5)
BN = dict(rtol=1e-4, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-5)
LR, WD = 1e-3, 3e-6


def _to_port(graphs):
    return [tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs]


def _pack(graphs):
    n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(graphs, len(graphs))
    kw = dict(n_pad=n_pad, e_pad=e_pad, g_pad=g_pad, mxu_layout=True,
              n_pairs_pad=jgraph.mxu_pair_pad(graphs, len(graphs), n_pad,
                                              e_pad))
    return (jgraph.pack_graphs(graphs, **kw),
            tgraph.pack_graphs(_to_port(graphs), **kw))


def _zinc_graphs(n, seed):
    """ZINC molecules, the first with one isolated node appended: a real
    node without an incoming edge (softmax weights sum to 0 there)."""
    graphs = jsyn.synthetic_zinc(n, seed=seed)
    g = graphs[0]
    graphs[0] = dataclasses.replace(
        g, num_nodes=g.num_nodes + 1,
        node_feat=np.concatenate([g.node_feat, g.node_feat[:1]]),
        eig=np.concatenate([g.eig, g.eig[-1:] + 0.25]))
    return graphs


@functools.cache
def _batches():
    return _pack(_zinc_graphs(10, seed=5))


# ----------------------------------------------------------- (a) softmax

@pytest.mark.parametrize("width", [None, 3], ids=["vector", "matrix"])
def test_segment_softmax_matches_reference(width):
    rng = np.random.default_rng(4)
    e, n = 60, 13
    dst = rng.integers(0, n - 3, size=e).astype(np.int32)   # 3 empty rows
    dst[:4] = 5                                              # a crowded one
    mask = rng.random(e) < 0.8
    dst[-1], mask[-1] = 0, False       # node 0: a pad edge only
    mask[dst == 0] = False
    shape = (e,) if width is None else (e, width)
    logits = (rng.normal(size=shape) * 30.0).astype(np.float32)
    want = np.asarray(jseg.segment_softmax(
        jnp.asarray(logits), jnp.asarray(dst), n, jnp.asarray(mask),
        indices_are_sorted=False))
    got = tseg.segment_softmax(torch.from_numpy(logits),
                               torch.from_numpy(dst), n,
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **OUT)
    assert not got[~mask].any()
    sums = np.zeros((n,) + shape[1:], np.float32)
    np.add.at(sums, dst, got)
    has = np.bincount(dst[mask], minlength=n) > 0
    np.testing.assert_allclose(sums[has], 1.0, rtol=1e-5)
    assert not sums[~has].any()


# ------------------------------------------- (b) decomposed, edge features

def _grads_close(label, tensors, want_grads, name):
    atol = 1e-5 if name == "std" else 1e-6
    for tag, t, w in zip(label, tensors, want_grads):
        # an input the aggregator does not read gets no torch gradient
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol, err_msg=f"grad wrt {tag}")


# q alone is tests/test_torch_aggregators.py's case, for every name
TERMS = ("c", "q+c", "none")


def _run_reference(name, fn, *args):
    """dgn_tpu's side of an aggregator case.  max/min compile (run_jitted):
    their lowering is some 200 operations, which cost more one by one.  The
    others run op by op, as torch does: var/std's E[x^2] - E[x]^2 cancels,
    and a compiled program's fused order moves it by 1e-6."""
    if name in ("max", "min"):
        return run_jitted(fn, *args)
    return fn(*args)


@functools.cache
def _decomposed_reference(name):
    """The numpy inputs (g, q, h_in, c, cotangent) and dgn_tpu's output and
    gradients for every TERMS variant of `name`, from one edge context."""
    jb, tb = _batches()
    rng = np.random.default_rng(17)
    n, e = tb.num_nodes_padded, tb.num_edges_padded
    ins = tuple(rng.normal(size=(n, F)).astype(np.float32) for _ in range(3))
    ins += (rng.normal(size=(e, F)).astype(np.float32),
            rng.normal(size=(n, F)).astype(np.float32))

    def jax_fn(g_, q_, h_, c_, ct_):
        ctx = jagg.build_edge_context(jb.eig, jb.src, jb.dst, jb.edge_mask,
                                      jb.in_degree, names=[name],
                                      need_norms=False, mxu_layout=jb.mxu,
                                      decomposed=True)
        out = {}
        for terms in TERMS:
            def agg(g_, q_, h_, c_, terms=terms):
                return jagg.aggregate_decomposed(
                    [name], ctx, g_, q_ if "q" in terms else None, h_,
                    c_edge=c_ if "c" in terms else None, layout=jb.mxu)
            want, vjp = jax.vjp(agg, g_, q_, h_, c_)
            out[terms] = (want, vjp(ct_))
        return out

    want = _run_reference(name, jax_fn, *map(jnp.asarray, ins))
    return ins, jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("terms", TERMS)
@pytest.mark.parametrize("name", NAMES)
def test_aggregate_decomposed_with_edge_term_matches_reference(name, terms):
    _, tb = _batches()
    (g, q, h_in, c, ct), refs = _decomposed_reference(name)
    want, want_grads = refs[terms]
    use_q, use_c = "q" in terms, "c" in terms
    ctx = tagg.build_edge_context(tb.eig, tb.src, tb.dst, tb.edge_mask,
                                  tb.in_degree, names=[name],
                                  mxu_layout=tb.mxu)
    tg, tq, th, tc = (torch.tensor(x, requires_grad=True)
                      for x in (g, q, h_in, c))
    got = tagg.aggregate_decomposed([name], ctx, tg, tq if use_q else None,
                                    th, c_edge=tc if use_c else None,
                                    layout=tb.mxu)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want,
                               err_msg="forward", **OUT)
    _grads_close("gqhc", (tg, tq, th, tc), want_grads, name)
    if name.startswith("dir1-") and name.endswith("0.1"):
        # softmax weights sum to 1 at a node with an edge, 0 without one:
        # a node without an edge gets 0 + 0 * q
        deg = tb.in_degree.numpy()
        assert not got.detach().numpy()[deg == 0].any()


# -------------------------------------------------------- (c) per-edge

@pytest.mark.parametrize("name", NAMES)
def test_aggregate_per_edge_matches_reference(name):
    jb, tb = _batches()
    rng = np.random.default_rng(19)
    n, e = tb.num_nodes_padded, tb.num_edges_padded
    msg = rng.normal(size=(e, F)).astype(np.float32)
    h_in, ct = (rng.normal(size=(n, F)).astype(np.float32) for _ in range(2))

    def jax_fn(m_, h_, ct_):
        ctx = jagg.build_edge_context(jb.eig, jb.src, jb.dst, jb.edge_mask,
                                      jb.in_degree, names=[name],
                                      need_norms=False, mxu_layout=jb.mxu,
                                      decomposed=False)
        want, vjp = jax.vjp(
            lambda m, h: jagg.aggregate([name], ctx, m, h, layout=jb.mxu),
            m_, h_)
        return want, vjp(ct_)

    want, want_grads = _run_reference(name, jax_fn,
                                      *map(jnp.asarray, (msg, h_in, ct)))
    ctx = tagg.build_edge_context(tb.eig, tb.src, tb.dst, tb.edge_mask,
                                  tb.in_degree, names=[name],
                                  mxu_layout=tb.mxu, decomposed=False)
    assert ctx.adj is None and ctx.fam_w is None and not ctx.decomposed
    tm, th = (torch.tensor(x, requires_grad=True) for x in (msg, h_in))
    got = tagg.aggregate([name], ctx, tm, th, layout=tb.mxu)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg="forward", **OUT)
    _grads_close("mh", (tm, th), want_grads, name)
    assert not tm.grad.numpy()[~tb.edge_mask.numpy()].any(), \
        "a pad edge's message reached an aggregate"


# ---------------------------------------------------------- (d) models

def _avg_d(graphs):
    return degree_stats(np.concatenate(
        [np.bincount(g.dst, minlength=g.num_nodes) for g in graphs]))


def _assert_tree(got_named, want_flat, tol, skip=()):
    got = {flax_path(k): v for k, v in got_named}
    assert set(got) == set(want_flat), (set(got) ^ set(want_flat))
    for path, want in want_flat.items():
        if path in skip:
            continue
        v = got[path]
        v = np.zeros_like(want) if v is None else v.detach().numpy()
        np.testing.assert_allclose(v, want, err_msg=path, **tol)


H12 = dict(hidden_dim=12, out_dim=12, L=2)
ZINC_EDGE = dict(H12, edge_feat=True, edge_dim=12)
MODELS = {
    "zinc-edge": ("zinc", ZINC_EDGE),
    "zinc-pretrans": ("zinc", dict(ZINC_EDGE, pretrans_layers=2,
                                   posttrans_layers=2)),
    "towers-pretrans": ("zinc", dict(ZINC_EDGE, type_net="towers", towers=2,
                                     pretrans_layers=2,
                                     aggregators="mean dir1-dx")),
    "hiv-per-edge": ("hiv", dict(H12, type_net="simple", decompose=False,
                                 aggregators="mean max min dir1-dx dir1-av",
                                 scalers="identity", graph_norm=False)),
    "superpixels-edge": ("superpixels", dict(
        H12, edge_feat=True, edge_dim=12,
        aggregators="mean std dir1-dx dir1-0.1")),
    "pcba-bond": ("pcba", dict(H12, edge_feat=True, edge_dim=8,
                               aggregators="mean max min dir1-dx-balanced "
                               "dir1-neg-0.1", scalers="identity",
                               graph_norm=False)),
}
N_CLASSES = 3


def _task(task):
    """(graphs, dgn_tpu factory, port factory taking (cfg, generator))."""
    if task == "zinc":
        return _zinc_graphs(10, seed=8), jzinc, tzinc
    if task in ("hiv", "pcba"):
        tasks = 1 if task == "hiv" else 128
        graphs = jsyn.synthetic_ogb_mol(12, seed=6, n_tasks=tasks, k_eig=3,
                                        nan_frac=0.3 if tasks > 1 else 0.0)
        return graphs, (jhiv if task == "hiv" else jpcba), \
            (thiv if task == "hiv" else tpcba)
    graphs = jsyn.synthetic_superpixels(4, seed=3, nodes=60, feat_dim=5,
                                        n_classes=N_CLASSES)
    graphs = sorted(graphs, key=lambda g: -g.num_nodes)
    return (graphs, lambda cfg: jsp(cfg, N_CLASSES),
            lambda cfg, gen: tsp(cfg, N_CLASSES, 5, gen, edge_in=1))


class _GradsTrainer(JTrainer):
    """dgn_tpu's Trainer, keeping the gradients its train step computes."""

    def _grads_of(self, *args):
        out = super()._grads_of(*args)
        self.grads = out[1]
        return out


@pytest.mark.parametrize("case", sorted(MODELS))
def test_model_forward_grads_and_adam_step_match_reference(case):
    task, net = MODELS[case]
    graphs, jfactory, tfactory = _task(task)
    kw = dict(net, avg_d=_avg_d(graphs))
    jmodel, jloss = jfactory(JConfig(**kw))
    model, tloss = tfactory(TConfig(**kw), torch.Generator().manual_seed(0))
    jb, tb = _pack(graphs)
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
    assert sum(v.size for v in flatten(params).values()) == \
        sum(p.numel() for p in model.parameters())

    # dgn_tpu's eval forward and one Adam(+L2) step from the same start in
    # one program; the step's own gradients come out of _grads_of
    jtrainer = _GradsTrainer(jmodel, jloss, JParams(seed=41, init_lr=LR,
                                                    weight_decay=WD),
                             task=task, donate=False)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=batch_stats,
                       opt_state=jtrainer.tx.init(params),
                       step=jnp.zeros((), jnp.int32))

    def reference(state, rng, lr):
        evald = jmodel.apply({"params": state.params,
                              "batch_stats": batch_stats}, jb,
                             deterministic=True)
        stepped = jtrainer._train_step_impl(state, jb, rng, lr)
        return evald, stepped, jtrainer.grads

    want_eval, (state2, jl, jscores), jgrads = run_jitted(
        reference, state, jax.random.PRNGKey(0), jnp.asarray(LR, jnp.float32))
    new_bs = flatten(jax.tree_util.tree_map(np.asarray, state2.batch_stats))
    mask = tb.graph_mask.numpy()
    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()
    np.testing.assert_allclose(got[mask], np.asarray(want_eval)[mask], **STEP)
    model.train()
    scores = model(tb)
    loss = tloss(scores, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **STEP)
    np.testing.assert_allclose(scores.detach().numpy()[mask],
                               np.asarray(jscores)[mask], **STEP)
    grads = [(k, p.grad) for k, p in model.named_parameters()]
    want_grads = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    _assert_tree(grads, want_grads, GRAD)
    assert_live(grads, want_grads)
    _assert_tree(model.named_buffers(), new_bs, BN)

    # the port's Adam(+L2) step from the same start
    model, tloss = tfactory(TConfig(**kw), torch.Generator().manual_seed(0))
    load_jax_params(model, params, batch_stats)
    trainer = TTrainer(model, tloss, TParams(seed=41, init_lr=LR,
                                             weight_decay=WD),
                       task=task, device="cpu")
    loss, scores = trainer.train_step(tb)
    np.testing.assert_allclose(float(loss), float(jl), **STEP)
    np.testing.assert_allclose(scores.numpy()[mask],
                               np.asarray(jscores)[mask], **STEP)
    new = flatten(jax.tree_util.tree_map(np.asarray, state2.params))
    old = flatten(params)
    noise = [k for k in new if k.endswith("posttrans/bias")
             and not kw.get("graph_norm", True)]
    for k in noise:
        got = dict(model.named_parameters())[k.replace("/", ".")]
        for after in (got.detach().numpy(), new[k]):
            assert np.abs(after - old[k]).max() <= LR * (1 + 1e-6), k
    _assert_tree(model.named_parameters(), new, STEP, skip=noise)
    _assert_tree(model.named_buffers(), new_bs, STEP)


# --------------------------------------------------- (e) eval context cache

def test_eval_cache_keeps_a_per_edge_context():
    """A per-edge net's cached eval context holds no weight families and no
    adjacency, is reused for the same batch, and gives the scores of a
    forward pass that builds its own."""
    graphs = _to_port(_zinc_graphs(8, seed=9))
    cfg = TConfig(**dict(ZINC_EDGE, avg_d=_avg_d(graphs), pretrans_layers=2))
    model, loss_fn = tzinc(cfg, torch.Generator().manual_seed(0))
    trainer = TTrainer(model, loss_fn, TParams(seed=41), task="zinc",
                       device="cpu")
    loader = TBatchLoader(graphs, 4, layout="mxu", cache=True)
    trainer.train_step(next(iter(TBatchLoader(graphs, 8, layout="mxu"))))
    first = trainer.evaluate(loader)
    for gb in loader:
        hit = trainer.with_edge_context(gb)
        ctx = hit.edge_ctx
        assert not ctx.decomposed and ctx.adj is None and ctx.adj_keys == ()
        assert trainer.with_edge_context(gb) is hit
        model.eval()
        with torch.no_grad():
            np.testing.assert_array_equal(model(hit).numpy(),
                                          model(gb).numpy())
    assert trainer.evaluate(loader) == first
