"""The flat layout of the port == dgn_tpu's.

The same numpy inputs, made from a seed, go through dgn_tpu and the port
on the flat layout (graphs back to back, real edges sorted by (dst, src),
pad edges last at the ghost node): the packed arrays, compared with ==
(ZINC with edge features and a positional encoding, HIV, and a pack with
pad nodes and pad edges); the geometry helpers and the flat loader; every
segment op, forward and gradient, on data with ties; every aggregator
through `aggregate` (per-edge) and `aggregate_decomposed` (with and without
the edge term c); the virtual node and every readout; and four nets from
dgn_tpu's `init` params (load_jax_params) through the eval forward, the
train forward with its loss, every gradient, the BN running stats and one
Adam step against dgn_tpu's Trainer._train_step_impl, the ZINC and HIV
nets also against the port's own block-layout output on the same graphs.
The JAX programs of the nets and of max/min compile at XLA's lowest CPU
optimisation level (run_jitted).  Dropout is 0.

Tolerances, as tests/test_torch_edge.py holds the same quantities and for
the same reasons (f32 on both sides, summation orders differ): segment ops,
aggregators, readouts and the virtual node rtol 1e-5 / atol 1e-6, the std
gradient atol 1e-5; model gradients rtol 1e-3 / atol 1e-5, BN stats rtol
1e-4 / atol 1e-6, model loss, scores and the parameters after one Adam step
rtol 1e-4 / atol 1e-5 (flat against block too: their sums run in other
orders).  A posttrans bias that feeds straight into batch norm (no graph
norm), and the virtual node's fc_layer bias (ReLU, then batch norm over the
graphs), get gradients of rounding noise on both sides, which Adam's first
step turns into a step of up to lr either way; after one Adam step those
entries are held to |step| <= lr (tests/test_torch_hiv.py).
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
from dgn_tpu import run as jrun
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.data.loader import BatchLoader as JBatchLoader
from dgn_tpu.layers.dgn import VirtualNode as JVirtualNode
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import hiv_model as jhiv
from dgn_tpu.models import pcba_model as jpcba
from dgn_tpu.models import zinc_model as jzinc
from dgn_tpu.models.readout import graph_readout as jreadout
from dgn_tpu.ops import aggregators as jagg
from dgn_tpu.ops import segment as jseg
from dgn_tpu.ops.scalers import degree_stats
from dgn_tpu.train.trainer import TrainParams as JParams
from dgn_tpu.train.trainer import Trainer as JTrainer
from dgn_tpu.train.trainer import TrainState

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import run as trun
from dgn_tpu_torch.convert import flatten, flax_path, load_jax_params
from dgn_tpu_torch.data.loader import BatchLoader as TBatchLoader
from dgn_tpu_torch.layers.dgn import DGNLayerComplex
from dgn_tpu_torch.layers.dgn import VirtualNode as TVirtualNode
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.models import hiv_model as thiv
from dgn_tpu_torch.models import pcba_model as tpcba
from dgn_tpu_torch.models import zinc_model as tzinc
from dgn_tpu_torch.models.dgn_net import edge_context_for
from dgn_tpu_torch.models.readout import graph_readout as treadout
from dgn_tpu_torch.ops import adjacency as tadjacency
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
_GB_FIELDS = [f.name for f in dataclasses.fields(tgraph.GraphBatch)
              if f.name not in ("mxu", "edge_ctx")]


def _to_port(graphs):
    return [tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs]


def _assert_same_batch(jb, tb):
    assert jb.mxu is None and tb.mxu is None
    for name in _GB_FIELDS:
        want, got = getattr(jb, name), getattr(tb, name)
        if want is None:
            assert got is None, name
            continue
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _flat_pads(graphs):
    """Worst-case flat pads plus one more graph slot: pad nodes (the ghost
    node among them), pad edges and a pad graph."""
    n_pad, e_pad = jgraph.bucket_sizes_for(graphs, len(graphs))
    return dict(n_pad=n_pad, e_pad=e_pad, g_pad=len(graphs) + 1)


def _zinc_graphs(n, seed, pos_enc=False):
    """ZINC molecules (integer bond types), the first with one isolated
    node appended: a real node without an incoming edge."""
    graphs = jsyn.synthetic_zinc(n, seed=seed)
    g = graphs[0]
    graphs[0] = dataclasses.replace(
        g, num_nodes=g.num_nodes + 1,
        node_feat=np.concatenate([g.node_feat, g.node_feat[:1]]),
        eig=np.concatenate([g.eig, g.eig[-1:] + 0.25]))
    if pos_enc:
        for g in graphs:
            g.pos_enc = g.eig[:, 1:4]
    return graphs


@functools.cache
def _batches():
    graphs = _zinc_graphs(10, seed=5)
    pads = _flat_pads(graphs)
    return (jgraph.pack_graphs(graphs, **pads),
            tgraph.pack_graphs(_to_port(graphs), **pads))


# ------------------------------------------------------------ (a) packing

@pytest.mark.parametrize("case", ["zinc-edge-pos-enc", "hiv", "pad-edges"])
def test_flat_pack_identical(case):
    if case == "hiv":
        graphs = jsyn.synthetic_ogb_mol(12, seed=6, n_tasks=1, k_eig=4)
    else:
        graphs = _zinc_graphs(12, seed=7, pos_enc=case != "pad-edges")
    kw = _flat_pads(graphs) if case == "pad-edges" else {}
    jb = jgraph.pack_graphs(graphs, **kw)
    tb = tgraph.pack_graphs(_to_port(graphs), **kw)
    _assert_same_batch(jb, tb)
    mask = tb.edge_mask.numpy()
    dst = tb.dst.numpy()
    assert np.all(np.diff(dst) >= 0), "dst is not sorted"
    assert tb.edge_feat is not None and tb.edge_feat.shape[0] == len(mask)
    if case == "pad-edges":
        assert not mask.all() and not tb.node_mask.numpy().all()
        assert (dst[~mask] == tb.num_nodes_padded - 1).all()
        assert int(tb.real_node_count()) == sum(g.num_nodes for g in graphs)
        assert int(tb.real_edge_count()) == int(mask.sum())
    else:
        # exact pads: no pad node and no pad edge
        assert mask.all() and tb.node_mask.numpy().all()


def test_flat_geometry_helpers_identical():
    graphs = jsyn.synthetic_zinc(64, seed=9)
    tgs = _to_port(graphs)
    assert tgraph.bucket_sizes_for(tgs, 16) == \
        jgraph.bucket_sizes_for(graphs, 16)
    assert tgraph.typical_bucket_sizes(tgs, 16, seed=4) == \
        jgraph.typical_bucket_sizes(graphs, 16, seed=4)
    assert tgraph.pack_requirements(tgs[:16]) == \
        jgraph.pack_requirements(graphs[:16])
    for layout in ("flat", "mxu"):
        assert trun.pad_geometry(tgs, 16, layout) == \
            jrun.pad_geometry(graphs, 16, layout)
    assert trun.resolve_layout("auto") == jrun.resolve_layout("auto") == "mxu"
    assert trun.resolve_layout("flat") == "flat"


@pytest.mark.parametrize("shuffle,micro", [(True, 1), (False, 1), (True, 2)],
                         ids=["train", "eval", "train-micro"])
def test_flat_loader_same_batches(shuffle, micro):
    graphs = jsyn.synthetic_zinc(40, seed=13)
    kw = dict(batch_size=16, shuffle=shuffle, seed=5, geometry="typical",
              micro_batches=micro)
    jl = JBatchLoader(graphs, layout="flat", **kw)
    tl = TBatchLoader(_to_port(graphs), **kw)
    assert tl.layout == "flat" and tl.pair_pad is None
    assert (tl.n_pad, tl.e_pad, tl.g_pad) == (jl.n_pad, jl.e_pad, jl.g_pad)
    for _ in range(2):          # two epochs: the rng stream advances alike
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == len(tl)
        for jb, tb in zip(jbs, tbs):
            for j, t in (zip(jb, tb) if micro > 1 else [(jb, tb)]):
                _assert_same_batch(j, t)


# -------------------------------------------------------- (b) segment ops

SEGMENT_OPS = ("sum", "mean", "mean-degree", "max", "min", "extremes",
               "var", "std")


def _segment_inputs():
    """60 edges into 13 destinations, unsorted, 3 without an edge, one with
    a pad edge only; values on a half-integer grid, so ties are common."""
    rng = np.random.default_rng(4)
    e, n = 60, 13
    dst = rng.integers(0, n - 3, size=e).astype(np.int32)
    mask = rng.random(e) < 0.8
    dst[-1], mask[-1] = 0, False
    mask[dst == 0] = False
    data = (np.round(rng.normal(size=(e, 3)) * 2.0) / 2.0).astype(np.float32)
    ct = rng.normal(size=(2, n, 3)).astype(np.float32)
    return data, dst, mask, n, ct


@pytest.mark.parametrize("op", SEGMENT_OPS)
def test_segment_op_matches_reference(op):
    data, dst, mask, n, ct = _segment_inputs()
    degree = np.bincount(dst[mask], minlength=n).astype(np.int32)

    def call(mod, x, ids, m, deg, **kw):
        name = "mean" if op == "mean-degree" else op
        fn = getattr(mod, f"segment_{name}")
        if op in ("mean-degree", "var", "std"):
            return fn(x, ids, n, m, deg, **kw)
        return fn(x, ids, n, m, **kw)

    def jax_fn(x):
        out = call(jseg, x, jnp.asarray(dst), jnp.asarray(mask),
                   jnp.asarray(degree), indices_are_sorted=False)
        return out if op == "extremes" else (out,)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(data))
    cts = tuple(jnp.asarray(c) for c in ct[:len(want)])
    (want_grad,) = vjp(cts)
    x = torch.tensor(data, requires_grad=True)
    got = call(tseg, x, torch.from_numpy(dst), torch.from_numpy(mask),
               torch.from_numpy(degree))
    got = got if op == "extremes" else (got,)
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, ct)).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **OUT)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-5 if op == "std" else 1e-6)
    assert not x.grad.numpy()[~mask].any(), "a pad edge got a gradient"
    empty = np.bincount(dst[mask], minlength=n) == 0
    for g in got:           # std is sqrt(0 + EPS) there, as in dgn_tpu
        assert np.all(g.detach().numpy()[empty]
                      == (np.sqrt(np.float32(1e-8)) if op == "std" else 0))
    if op in ("max", "min", "extremes"):
        # ties split the gradient equally: each destination's cotangent is
        # spent exactly once per reduction
        per_dst = np.zeros((n, 3), np.float32)
        np.add.at(per_dst, dst, x.grad.numpy())
        spent = sum(c for c in ct[:len(got)])
        np.testing.assert_allclose(per_dst[~empty], spent[~empty], **OUT)


# --------------------------------------------------------- (c) aggregators

def _grads_close(label, tensors, want_grads, name):
    atol = 1e-5 if name == "std" else 1e-6
    for tag, t, w in zip(label, tensors, want_grads):
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol, err_msg=f"grad wrt {tag}")


def _run_reference(name, fn, *args):
    """max/min compile (run_jitted); the rest run op by op, as torch does
    (a compiled var/std moves E[x^2] - E[x]^2 by 1e-6)."""
    if name in ("max", "min"):
        return run_jitted(fn, *args)
    return fn(*args)


@pytest.mark.parametrize("name", NAMES)
def test_flat_aggregate_per_edge_matches_reference(name):
    jb, tb = _batches()
    rng = np.random.default_rng(19)
    n, e = tb.num_nodes_padded, tb.num_edges_padded
    msg = rng.normal(size=(e, F)).astype(np.float32)
    h_in, ct = (rng.normal(size=(n, F)).astype(np.float32) for _ in range(2))

    def jax_fn(m_, h_, ct_):
        ctx = jagg.build_edge_context(jb.eig, jb.src, jb.dst, jb.edge_mask,
                                      jb.in_degree, names=[name],
                                      need_norms=True)
        want, vjp = jax.vjp(
            lambda m, h: jagg.aggregate([name], ctx, m, h), m_, h_)
        return want, vjp(ct_)

    want, want_grads = _run_reference(name, jax_fn,
                                      *map(jnp.asarray, (msg, h_in, ct)))
    ctx = tagg.build_edge_context(tb.eig, tb.src, tb.dst, tb.edge_mask,
                                  tb.in_degree, names=[name],
                                  decomposed=False, need_norms=True)
    assert ctx.adj is None and not ctx.decomposed
    if name.startswith("dir1-dx-b"):
        assert ctx.pos_sum is not None and ctx.abs_sum is None
    elif name.startswith("dir"):
        assert ctx.abs_sum is not None and ctx.pos_sum is None
    tm, th = (torch.tensor(x, requires_grad=True) for x in (msg, h_in))
    got = tagg.aggregate([name], ctx, tm, th)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg="forward", **OUT)
    _grads_close("mh", (tm, th), want_grads, name)
    assert not tm.grad.numpy()[~tb.edge_mask.numpy()].any(), \
        "a pad edge's message reached an aggregate"


TERMS = ("q", "q+c")


@functools.cache
def _decomposed_reference(name):
    jb, tb = _batches()
    rng = np.random.default_rng(17)
    n, e = tb.num_nodes_padded, tb.num_edges_padded
    ins = tuple(rng.normal(size=(n, F)).astype(np.float32) for _ in range(3))
    ins += (rng.normal(size=(e, F)).astype(np.float32),
            rng.normal(size=(n, F)).astype(np.float32))

    def jax_fn(g_, q_, h_, c_, ct_):
        ctx = jagg.build_edge_context(jb.eig, jb.src, jb.dst, jb.edge_mask,
                                      jb.in_degree, names=[name],
                                      need_norms=False, decomposed=True)
        out = {}
        for terms in TERMS:
            def agg(g_, q_, h_, c_, terms=terms):
                return jagg.aggregate_decomposed(
                    [name], ctx, g_, q_, h_,
                    c_edge=c_ if "c" in terms else None)
            want, vjp = jax.vjp(agg, g_, q_, h_, c_)
            out[terms] = (want, vjp(ct_))
        return out

    want = _run_reference(name, jax_fn, *map(jnp.asarray, ins))
    return ins, jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("terms", TERMS)
@pytest.mark.parametrize("name", NAMES)
def test_flat_aggregate_decomposed_matches_reference(name, terms):
    _, tb = _batches()
    (g, q, h_in, c, ct), refs = _decomposed_reference(name)
    want, want_grads = refs[terms]
    builds = tadjacency.build_pair_adjacency.launches
    ctx = tagg.build_edge_context(tb.eig, tb.src, tb.dst, tb.edge_mask,
                                  tb.in_degree, names=[name])
    assert ctx.decomposed and ctx.adj is None
    assert tadjacency.build_pair_adjacency.launches == builds
    tg, tq, th, tc = (torch.tensor(x, requires_grad=True)
                      for x in (g, q, h_in, c))
    got = tagg.aggregate_decomposed([name], ctx, tg, tq, th,
                                    c_edge=tc if "c" in terms else None)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want,
                               err_msg="forward", **OUT)
    _grads_close("gqhc", (tg, tq, th, tc), want_grads, name)


# ---------------------------------------------- (d) readouts, virtual node

@pytest.mark.parametrize("kind", ["mean", "sum", "max", "directional",
                                  "directional_abs"])
def test_flat_readout_matches_reference(kind):
    jb, tb = _batches()
    rng = np.random.default_rng(21)
    h = (np.round(rng.normal(size=(tb.num_nodes_padded, F)) * 2.0)
         / 2.0).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jreadout(jb, x, kind), jnp.asarray(h))
    ct = rng.normal(size=want.shape).astype(np.float32)
    (want_grad,) = vjp(jnp.asarray(ct))
    x = torch.tensor(h, requires_grad=True)
    got = treadout(tb, x, kind)
    got.backward(torch.from_numpy(ct))
    gmask = tb.graph_mask.numpy()
    np.testing.assert_allclose(got.detach().numpy()[gmask],
                               np.asarray(want)[gmask], **OUT)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **OUT)


@pytest.mark.parametrize("vn_type", ["mean", "sum", "logsum"])
def test_flat_virtual_node_matches_reference(vn_type):
    """The virtual node in training mode (its FCLayer's batch norm over the
    real graphs): the new graph state, the new node features on every node
    slot, both gradients and the BN running stats."""
    jb, tb = _batches()
    rng = np.random.default_rng(23)
    h = rng.normal(size=(tb.num_nodes_padded, F)).astype(np.float32)
    vn = rng.normal(size=(tb.num_graphs_padded, F)).astype(np.float32)
    cts = [rng.normal(size=x.shape).astype(np.float32) for x in (vn, h)]
    jmod = JVirtualNode(dim=F, batch_norm=True, vn_type=vn_type)
    variables = jmod.init(jax.random.PRNGKey(1), jb, jnp.asarray(h),
                          jnp.asarray(vn), deterministic=True)

    def jax_fn(h_, vn_):
        out, mut = jmod.apply(variables, jb, h_, vn_, deterministic=False,
                              mutable=["batch_stats"])
        return out, mut["batch_stats"]

    want, vjp, new_bs = jax.vjp(jax_fn, jnp.asarray(h), jnp.asarray(vn),
                                has_aux=True)
    want_grads = vjp(tuple(jnp.asarray(c) for c in cts))
    mod = TVirtualNode(F, torch.Generator(), batch_norm=True, vn_type=vn_type)
    load_jax_params(mod, jax.tree_util.tree_map(np.asarray,
                                                variables["params"]),
                    jax.tree_util.tree_map(np.asarray,
                                           variables["batch_stats"]))
    th, tv = (torch.tensor(x, requires_grad=True) for x in (h, vn))
    mod.train()
    got = mod(tb, th, tv)
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cts)).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **OUT)
    for t, w in zip((th, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **OUT)
    got_bs = {flax_path(k): v.numpy() for k, v in mod.named_buffers()}
    for path, w in flatten(jax.tree_util.tree_map(np.asarray,
                                                  new_bs)).items():
        np.testing.assert_allclose(got_bs[path], w, err_msg=path, **BN)


def test_flat_layer_builds_its_own_context():
    """A layer on a flat batch without a context builds dgn_tpu's
    stand-alone one: per-edge with the normalizers for a 2-layer pretrans,
    decomposed for a linear one; each equals the output with the model's
    context attached."""
    _, tb = _batches()
    h = torch.from_numpy(np.random.default_rng(3).normal(
        size=(tb.num_nodes_padded, F)).astype(np.float32))
    names = ("mean", "max", "dir1-dx", "dir1-av")
    for pretrans in (1, 2):
        layer = DGNLayerComplex(F, F, names, ("identity",), {},
                                torch.Generator().manual_seed(0),
                                pretrans_layers=pretrans)
        layer.eval()
        cfg = TConfig(aggregators=" ".join(names),
                      pretrans_layers=pretrans)
        with torch.no_grad():
            alone = layer(tb, h)
            attached = layer(dataclasses.replace(
                tb, edge_ctx=edge_context_for(tb, cfg)), h)
        np.testing.assert_array_equal(alone.numpy(), attached.numpy())


# ---------------------------------------------------------------- (e) nets

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
HIV_NET = dict(H12, type_net="simple", scalers="identity", graph_norm=False,
               aggregators="mean max min dir1-dx dir1-av")
MODELS = {
    "zinc": ("zinc", H12),
    "hiv": ("hiv", HIV_NET),
    "pcba-vn": ("pcba", dict(HIV_NET, aggregators="mean max min dir1-dx",
                             virtual_node="mean")),
    "zinc-per-edge": ("zinc", dict(H12, decompose=False, edge_feat=True,
                                   edge_dim=12,
                                   aggregators="mean dir1-dx dir1-av "
                                   "dir1-dx-balanced")),
}


def _task(task):
    if task == "zinc":
        return _zinc_graphs(10, seed=8), jzinc, tzinc
    tasks = 1 if task == "hiv" else 128
    graphs = jsyn.synthetic_ogb_mol(12, seed=6, n_tasks=tasks, k_eig=3,
                                    nan_frac=0.3 if tasks > 1 else 0.0)
    return graphs, (jhiv if task == "hiv" else jpcba), \
        (thiv if task == "hiv" else tpcba)


class _GradsTrainer(JTrainer):
    """dgn_tpu's Trainer, keeping the gradients its train step computes."""

    def _grads_of(self, *args):
        out = super()._grads_of(*args)
        self.grads = out[1]
        return out


@pytest.mark.parametrize("case", sorted(MODELS))
def test_flat_model_matches_reference_and_block_layout(case):
    task, net = MODELS[case]
    graphs, jfactory, tfactory = _task(task)
    kw = dict(net, avg_d=_avg_d(graphs))
    jmodel, jloss = jfactory(JConfig(**kw))
    pads = _flat_pads(graphs)
    jb = jgraph.pack_graphs(graphs, **pads)
    tb = tgraph.pack_graphs(_to_port(graphs), **pads)
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

    def port_model():
        model, tloss = tfactory(TConfig(**kw),
                                torch.Generator().manual_seed(0))
        load_jax_params(model, params, batch_stats)
        return model, tloss

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

    model, tloss = port_model()
    builds = tadjacency.build_pair_adjacency.launches
    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()
    np.testing.assert_allclose(got[mask], np.asarray(want_eval)[mask], **STEP)
    model.train()
    scores = model(tb)
    loss = tloss(scores, tb)
    loss.backward()
    assert tadjacency.build_pair_adjacency.launches == builds
    np.testing.assert_allclose(float(loss.detach()), float(jl), **STEP)
    np.testing.assert_allclose(scores.detach().numpy()[mask],
                               np.asarray(jscores)[mask], **STEP)
    grads = [(k, p.grad) for k, p in model.named_parameters()]
    want_grads = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    _assert_tree(grads, want_grads, GRAD)
    assert_live(grads, want_grads)
    _assert_tree(model.named_buffers(), new_bs, BN)

    if case in ("zinc", "hiv"):
        # the port's block layout on the same graphs, in the same order,
        # with the same weights
        n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(graphs, len(graphs))
        bb = tgraph.pack_graphs(_to_port(graphs), n_pad=n_pad, e_pad=e_pad,
                                g_pad=g_pad, mxu_layout=True)
        bmask = bb.graph_mask.numpy()
        block, bloss = port_model()
        block.eval()
        with torch.no_grad():
            np.testing.assert_allclose(block(bb).numpy()[bmask], got[mask],
                                       **STEP)
        block.train()
        bscores = block(bb)
        np.testing.assert_allclose(float(bloss(bscores, bb).detach()),
                                   float(loss.detach()), **STEP)
        np.testing.assert_allclose(bscores.detach().numpy()[bmask],
                                   scores.detach().numpy()[mask], **STEP)

    # the port's Adam(+L2) step from the same start
    model, tloss = port_model()
    trainer = TTrainer(model, tloss, TParams(seed=41, init_lr=LR,
                                             weight_decay=WD),
                       task=task, device="cpu")
    loss, scores = trainer.train_step(tb)
    np.testing.assert_allclose(float(loss), float(jl), **STEP)
    np.testing.assert_allclose(scores.numpy()[mask],
                               np.asarray(jscores)[mask], **STEP)
    new = flatten(jax.tree_util.tree_map(np.asarray, state2.params))
    old = flatten(params)
    # biases whose gradient is rounding noise: a posttrans bias straight
    # into batch norm (no graph norm), and the virtual node's fc_layer bias
    # (dense -> ReLU -> batch norm over the graphs: in a column the ReLU
    # passes for every graph, batch norm takes the bias out again)
    noise = [k for k in new
             if (k.endswith("posttrans/bias") and not kw.get("graph_norm",
                                                              True))
             or k.endswith("fc_layer/bias")]
    for k in noise:
        after_port = dict(model.named_parameters())[k.replace("/", ".")]
        for after in (after_port.detach().numpy(), new[k]):
            assert np.abs(after - old[k]).max() <= LR * (1 + 1e-6), k
    _assert_tree(model.named_parameters(), new, STEP, skip=noise)
    _assert_tree(model.named_buffers(), new_bs, STEP)
