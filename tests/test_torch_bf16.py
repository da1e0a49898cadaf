"""compute_dtype="bfloat16" in the port == dgn_tpu's, from the rounding
primitives to one Adam step.

dgn_tpu rounds the block layout's products to bfloat16 operands with
float32 accumulation and a float32 result, forward and backward
(dgn_tpu/ops/mxu.py:364-450).  The same numpy inputs, made from a seed, go
through dgn_tpu and the port:
  (a) the primitives: pair_adj_matmul (the same bfloat16 blocks on both
      sides), block_scatter_sum, weighted_segment_sums and the gather of
      rows at src, forward and VJP;
  (b) aggregate_decomposed over a bfloat16 edge context, forward and VJP;
  (c) four nets (the ZINC complex net, the HIV simple net, towers, and the
      complex net with decompose=False) from dgn_tpu's `init` params: eval
      forward, train forward and loss, every gradient and one Adam step,
      both packages in bfloat16; and each port output held much closer to
      dgn_tpu's bfloat16 output than to its float32 one;
  (d) the flat layout, which rounds nothing in either package, bit for bit
      equal under bfloat16 and float32; the adjacency blocks' dtype; and
      the entry point on the CPU.
The JAX programs of (b) with max/min and of (c) compile at XLA's lowest CPU
optimisation level (run_jitted).  Dropout is 0.  Each check is a function
of the compute dtype's name, which tests/test_torch_fp16.py calls with
"float16" at float16's tolerances.

Tolerances.  (a) and (b): rtol 1e-5 / atol 1e-6.  Every rounding there
sees the same float32 input on both sides, and a product of two bfloat16
values is exact in float32, so only the order of the float32 sums
differs.  (c): rtol 2e-2 on scores, loss and Adam's step, and gradients
within 2e-2 of each leaf's largest entry.  Layer 2 rounds values that
layer 1 computed in two frameworks, and values that differ in their last
float32 bit can round to neighbouring bfloat16 values (2^-8 apart, 0.4 %);
a whole net then moves by a few such steps, and dgn_tpu's CPU build of
the blocks sums bfloat16 chunks where the port sums in float32 and rounds
once.  So (c) also requires max |port - dgn_tpu bf16| <= 0.5 * max
|dgn_tpu bf16 - dgn_tpu f32| on the eval scores, which a port that ignored
the flag would fail, and prints the ratio.  The posttrans biases that feed
batch norm without graph norm get rounding-noise gradients, which Adam's
first step turns into steps of up to lr either way: held to |step| <= lr,
as in tests/test_torch_hiv.py.  The same holds, in bfloat16, for every
entry whose gradient is within the gradient tolerance of zero: Adam's first
step is lr * sign(g) there, and the sign is noise.  Every other entry of
the step is held at rtol 2e-2.
"""
from __future__ import annotations

import dataclasses
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
from dgn_tpu.models import sbm_model as jsbm
from dgn_tpu.models import zinc_model as jzinc
from dgn_tpu.ops import aggregators as jagg
from dgn_tpu.ops import mxu as jmxu
from dgn_tpu.train.trainer import TrainParams as JParams
from dgn_tpu.train.trainer import TrainState

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import run as trun
from dgn_tpu_torch.convert import flatten, load_jax_params
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.models import hiv_model as thiv
from dgn_tpu_torch.models import sbm_model as tsbm
from dgn_tpu_torch.models import zinc_model as tzinc
from dgn_tpu_torch.models.dgn_net import edge_context_for
from dgn_tpu_torch.ops import aggregators as tagg
from dgn_tpu_torch.ops import mxu as tmxu
from dgn_tpu_torch.train.trainer import TrainParams as TParams
from dgn_tpu_torch.train.trainer import Trainer as TTrainer
from test_torch_edge import _GradsTrainer, _assert_tree, _avg_d, _pack
from test_torch_layers import run_jitted

torch.set_num_threads(1)

BF = torch.bfloat16
EXACT = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=2e-2, atol=1e-6)
GRAD_REL = 2e-2
# (c)'s bounds: scores, loss and Adam's step at rtol, gradients within
# grad_rel of each leaf's largest entry, and max |port - dgn_tpu| at most
# gap_ratio of max |dgn_tpu low precision - dgn_tpu f32| on the scores
BF16_MODEL_TOL = dict(rtol=MODEL["rtol"], grad_rel=GRAD_REL, gap_ratio=0.5)
LR, WD = 1e-3, 3e-6
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _rounded(x: np.ndarray, cd: str) -> np.ndarray:
    """x rounded to the dtype named cd, as float32."""
    return torch.from_numpy(x).to(getattr(torch, cd)).float().numpy()


def _batches(seed=5, n=10):
    return _pack(jsyn.synthetic_zinc(n, seed=seed))


# ------------------------------------------------------------ (a) primitives

def test_pair_adj_matmul_matches_reference():
    check_pair_adj_matmul("bfloat16")


def check_pair_adj_matmul(cd: str):
    rng = np.random.default_rng(1)
    p, k, t, f = 3, 2, 128, 5
    w = _rounded((rng.normal(size=(p, k, t, t))
                  * (rng.random((p, k, t, t)) < 0.05)).astype(np.float32), cd)
    gp = rng.normal(size=(p, t, f)).astype(np.float32)
    ct = rng.normal(size=(p, k, t, f)).astype(np.float32)
    jw = jnp.asarray(w, cd)
    want, vjp = jax.vjp(
        lambda g: jmxu.pair_adj_matmul(jw, g, cd), jnp.asarray(gp))
    (want_d,) = vjp(jnp.asarray(ct))
    tgp = torch.tensor(gp, requires_grad=True)
    tcd = getattr(torch, cd)
    got = tmxu.pair_adj_matmul(torch.from_numpy(w).to(tcd), tgp, tcd)
    got.backward(torch.from_numpy(ct))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **EXACT)
    np.testing.assert_allclose(tgp.grad.numpy(), np.asarray(want_d), **EXACT)
    # the flag is live: float32 operands give another product
    f32 = tmxu.pair_adj_matmul(torch.from_numpy(w), torch.from_numpy(gp))
    assert (f32 - got.detach()).abs().max() > 1e-4


ROUNDING_OPS = ["block_scatter_sum", "weighted_segment_sums", "gather"]


@pytest.mark.parametrize("op", ROUNDING_OPS)
def test_rounding_primitive_matches_reference(op):
    check_rounding_primitive(op, "bfloat16")


def check_rounding_primitive(op: str, cd: str):
    tcd = getattr(torch, cd)
    jb, tb = _batches()
    lay, jlay = tb.mxu, jb.mxu
    rng = np.random.default_rng(3)
    n, e, f = tb.num_nodes_padded, tb.num_edges_padded, 6
    mask = tb.edge_mask.numpy()
    if op == "gather":
        x = rng.normal(size=(n, f)).astype(np.float32)
        ct = rng.normal(size=(e, f)).astype(np.float32)

        def jfn(x_):
            return jmxu.gather_src(x_, jlay, cd)

        def tfn(x_, dt=tcd):
            return tmxu.gather(x_, tb.src, dt)
    elif op == "block_scatter_sum":
        x = (rng.normal(size=(e, f)) * mask[:, None]).astype(np.float32)
        ct = rng.normal(size=(n, f)).astype(np.float32)

        def jfn(x_):
            return jmxu.block_scatter_sum(x_, jlay.local_dst,
                                          jlay.edge_chunk_dst,
                                          jlay.n_node_blocks,
                                          compute_dtype=cd)

        def tfn(x_, dt=tcd):
            return tmxu.block_scatter_sum(x_, lay.local_dst,
                                          lay.edge_chunk_dst,
                                          lay.n_node_blocks, dt)
    else:
        x = rng.normal(size=(e, f)).astype(np.float32)
        wts = (rng.normal(size=(3, e)) * mask).astype(np.float32)
        ct = rng.normal(size=(n, 2 * f + 3)).astype(np.float32)

        def jfn(x_):
            s, tot = jmxu.weighted_segment_sums(
                x_, jnp.asarray(wts), jlay, n, n_full=2,
                compute_dtype=cd)
            return jnp.concatenate([s[0], s[1], tot.T], axis=1)

        def tfn(x_, dt=tcd):
            s, tot = tmxu.weighted_segment_sums(
                x_, torch.from_numpy(wts), lay, n, 2, compute_dtype=dt)
            return torch.cat([s[0], s[1], tot.T], dim=1)
    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    (want_d,) = vjp(jnp.asarray(ct))
    tx = torch.tensor(x, requires_grad=True)
    got = tfn(tx)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg="forward", **EXACT)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_d),
                               err_msg="vjp", **EXACT)
    # the values and the cotangent were rounded
    tx32 = torch.tensor(x, requires_grad=True)
    f32 = tfn(tx32, None)
    f32.backward(torch.from_numpy(ct))
    assert np.abs(f32.detach().numpy() - got.detach().numpy()).max() > 1e-5
    assert np.abs(tx32.grad.numpy() - tx.grad.numpy()).max() > 1e-5


# ---------------------------------------------- (b) decomposed aggregators

AGG_CASES = {
    "complex": ("mean dir1-dx dir1-av", "q"),
    "extremes": ("mean max min dir1-dx dir1-av", "none"),
    "var-std": ("mean var std", "q"),
    "edge-term": ("mean dir1-dx dir1-av", "q+c"),
    "edge-term-std": ("mean std", "q+c"),
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_decomposed_matches_reference(case):
    check_aggregate_decomposed(case, "bfloat16")


def check_aggregate_decomposed(case: str, cd: str, pad_cotangent=True):
    """(b) for one case of AGG_CASES; pad_cotangent False zeroes the
    cotangent on pad nodes, as the models' masks do."""
    tcd = getattr(torch, cd)
    names, terms = AGG_CASES[case]
    names = names.split()
    jb, tb = _batches()
    rng = np.random.default_rng(17)
    n, e, f = tb.num_nodes_padded, tb.num_edges_padded, 6
    g, q, h_in = (rng.normal(size=(n, f)).astype(np.float32)
                  for _ in range(3))
    c = rng.normal(size=(e, f)).astype(np.float32)
    ct = rng.normal(size=(n, len(names) * f)).astype(np.float32)
    if not pad_cotangent:
        ct *= tb.node_mask.numpy()[:, None]
    use_q, use_c = "q" in terms, "c" in terms

    def jax_fn(g_, q_, h_, c_, ct_):
        ctx = jagg.build_edge_context(jb.eig, jb.src, jb.dst, jb.edge_mask,
                                      jb.in_degree, names=names,
                                      need_norms=False, mxu_layout=jb.mxu,
                                      decomposed=True, adj_dtype=cd)
        want, vjp = jax.vjp(
            lambda g_, q_, h_, c_: jagg.aggregate_decomposed(
                names, ctx, g_, q_ if use_q else None, h_,
                c_edge=c_ if use_c else None, layout=jb.mxu,
                compute_dtype=cd), g_, q_, h_, c_)
        return want, vjp(ct_)

    args = tuple(map(jnp.asarray, (g, q, h_in, c, ct)))
    want, want_d = (run_jitted(jax_fn, *args) if "max" in names
                    else jax_fn(*args))
    ctx = tagg.build_edge_context(tb.eig, tb.src, tb.dst, tb.edge_mask,
                                  tb.in_degree, names, mxu_layout=tb.mxu,
                                  adj_dtype=tcd)
    assert ctx.adj.dtype == tcd
    tg, tq, th, tc = (torch.tensor(x, requires_grad=True)
                      for x in (g, q, h_in, c))
    got = tagg.aggregate_decomposed(names, ctx, tg, tq if use_q else None,
                                    th, c_edge=tc if use_c else None,
                                    layout=tb.mxu, compute_dtype=tcd)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg="forward", **EXACT)
    for tag, t, w in zip("gqhc", (tg, tq, th, tc), want_d):
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(grad.numpy(), np.asarray(w),
                                   err_msg=f"grad wrt {tag}", **EXACT)


# ------------------------------------------------------------- (c) models

H12 = dict(hidden_dim=12, out_dim=12, L=2)
HIV_NET = dict(H12, type_net="simple",
               aggregators="mean max min dir1-dx dir1-av",
               scalers="identity", graph_norm=False)
NETS = {
    "zinc-complex": ("zinc", H12),
    "hiv-simple": ("hiv", HIV_NET),
    "zinc-towers": ("zinc", dict(H12, type_net="towers", towers=2)),
    "zinc-per-edge": ("zinc", dict(H12, decompose=False,
                                   aggregators="mean max dir1-dx dir1-av")),
}


def _task(task):
    """(graphs, dgn_tpu's factory, the port's factory) of a task."""
    if task == "zinc":
        return jsyn.synthetic_zinc(10, seed=8), jzinc, tzinc
    if task == "sbm":
        return (jsyn.synthetic_sbm(6, seed=7, n_classes=2),
                lambda cfg: jsbm(cfg, 2),
                lambda cfg, gen: tsbm(cfg, 2, gen))
    return (jsyn.synthetic_ogb_mol(12, seed=6, n_tasks=1, k_eig=3), jhiv,
            thiv)


def _scaled_params(params, rng):
    """dgn_tpu's init tree with every matrix redrawn as normal /
    sqrt(fan-in), so activations stay of order 1; vectors (biases, batch
    norm scales) keep their init.  At the reference's own init (xavier
    with gain 1/fan-in) the aggregates reach the outputs damped by about
    1/100, and a 16-bit rounding of them falls below float32's noise."""
    def draw(x):
        x = np.asarray(x)
        if x.ndim != 2:
            return x
        return (rng.normal(size=x.shape) / np.sqrt(x.shape[0])).astype(
            np.float32)
    return jax.tree_util.tree_map(draw, params)


def _grads_close(got_named, want_flat, noise, grad_rel=GRAD_REL):
    """Each leaf within grad_rel of its largest entry; a noise leaf (a
    posttrans bias that feeds batch norm) near zero on both sides."""
    got = {k.replace(".", "/"): v.grad for k, v in got_named}
    assert set(got) == set(want_flat)
    top = max(np.abs(w).max() for w in want_flat.values())
    for path, want in want_flat.items():
        v = np.zeros_like(want) if got[path] is None \
            else got[path].numpy()
        if path in noise:
            assert max(np.abs(v).max(), np.abs(want).max()) \
                <= grad_rel * top, path
            continue
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(v, want, rtol=0, atol=grad_rel * scale,
                                   err_msg=path)


@pytest.mark.parametrize("case", sorted(NETS))
def test_model_bf16_matches_reference(case):
    check_model(case, *NETS[case], "bfloat16", **BF16_MODEL_TOL)


def check_model(case: str, task: str, net: dict, cd: str, rtol: float,
                grad_rel: float, gap_ratio: float):
    """(c) for one net of a task in the compute dtype named cd; scores
    compare on real graphs, or real nodes for SBM."""
    model_tol = dict(rtol=rtol, atol=MODEL["atol"])
    graphs, jfactory, tfactory = _task(task)
    kw = dict(net, avg_d=_avg_d(graphs))
    jmodel, jloss = jfactory(JConfig(**kw, compute_dtype=cd))
    jmodel32, jloss32 = jfactory(JConfig(**kw))
    jb, tb = _pack(graphs)
    variables = run_jitted(
        lambda key: jmodel.init(key, jb, deterministic=True),
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(23)
    params = _scaled_params(variables["params"], rng)
    batch_stats = jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, x.shape)
                   if np.all(np.asarray(x) == 1)
                   else rng.normal(scale=0.1, size=x.shape)
                   ).astype(np.float32),
        variables["batch_stats"])
    jtrainer = _GradsTrainer(jmodel, jloss, JParams(seed=41, init_lr=LR,
                                                    weight_decay=WD),
                             task=task, donate=False)
    jtrainer32 = _GradsTrainer(jmodel32, jloss32, JParams(
        seed=41, init_lr=LR, weight_decay=WD), task=task, donate=False)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=batch_stats,
                       opt_state=jtrainer.tx.init(params),
                       step=jnp.zeros((), jnp.int32))

    def reference(state, rng_, lr):
        v = {"params": state.params, "batch_stats": batch_stats}
        evald = jmodel.apply(v, jb, deterministic=True)
        evald32 = jmodel32.apply(v, jb, deterministic=True)
        stepped = jtrainer._train_step_impl(state, jb, rng_, lr)
        jtrainer32._train_step_impl(state, jb, rng_, lr)
        return evald, evald32, stepped, jtrainer.grads, jtrainer32.grads

    want_eval, want32, (state2, jl, jscores), jgrads, jgrads32 = run_jitted(
        reference, state, jax.random.PRNGKey(0), jnp.asarray(LR, jnp.float32))
    mask = (tb.node_mask if task == "sbm" else tb.graph_mask).numpy()
    want_eval, want32 = np.asarray(want_eval)[mask], np.asarray(want32)[mask]

    def port_model():
        m, loss = tfactory(TConfig(**kw, compute_dtype=cd),
                           torch.Generator().manual_seed(0))
        load_jax_params(m, params, batch_stats)
        return m, loss

    model, tloss = port_model()
    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()[mask]
    np.testing.assert_allclose(got, want_eval, **model_tol)
    assert np.ptp(want_eval) > 1e-3, "the net scores every graph alike"
    gap, gap32 = np.abs(got - want_eval).max(), np.abs(want_eval
                                                       - want32).max()
    print(f"{case}: max |port - dgn_tpu| in {cd} {gap:.3g}, dgn_tpu {cd} vs "
          f"f32 {gap32:.3g}, ratio {gap / gap32:.3g}")
    assert gap <= gap_ratio * gap32
    model.train()
    scores = model(tb)
    loss = tloss(scores, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **model_tol)
    np.testing.assert_allclose(scores.detach().numpy()[mask],
                               np.asarray(jscores)[mask], **model_tol)
    noise = [k for k in flatten(params) if k.endswith("posttrans/bias")
             and not kw.get("graph_norm", True)]
    want_grads = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    _grads_close(model.named_parameters(), want_grads, noise, grad_rel)
    assert_live([(k, p.grad) for k, p in model.named_parameters()],
                want_grads)
    # the gradients too sit much closer to dgn_tpu's in cd than in f32
    want32_grads = flatten(jax.tree_util.tree_map(np.asarray, jgrads32))
    got_grads = {k.replace(".", "/"): p.grad.numpy()
                 for k, p in model.named_parameters()}
    keys = [k for k in want_grads if k not in noise]
    ggap, ggap32 = (np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in keys))
                    for a, b in ((got_grads, want_grads),
                                 (want_grads, want32_grads)))
    print(f"{case}: |grad port - dgn_tpu| in {cd} {ggap:.3g}, dgn_tpu {cd} "
          f"vs f32 {ggap32:.3g}, ratio {ggap / ggap32:.3g}")
    assert ggap <= gap_ratio * ggap32

    # one Adam(+L2) step from the same start
    model, tloss = port_model()
    trainer = TTrainer(model, tloss, TParams(seed=41, init_lr=LR,
                                             weight_decay=WD),
                       task=task, device="cpu")
    trainer.train_step(tb)
    new = flatten(jax.tree_util.tree_map(np.asarray, state2.params))
    old = flatten(params)
    grads = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    for k in new:
        step = named[k.replace("/", ".")].detach().numpy() - old[k]
        want = new[k] - old[k]
        g = np.abs(grads[k])
        # Adam's first step is about lr * sign(g): where g is noise (the
        # posttrans biases that feed batch norm without graph norm, and
        # entries within the gradient tolerance of zero) so is the sign
        sure = np.zeros_like(g, bool) if k in noise \
            else g > grad_rel * max(g.max(), 1e-12)
        assert np.abs(step).max() <= LR * (1 + 1e-6) + WD, k
        np.testing.assert_allclose(step[sure], want[sure],
                                   rtol=rtol, atol=1e-9, err_msg=k)
    _assert_tree(model.named_buffers(), flatten(jax.tree_util.tree_map(
        np.asarray, state2.batch_stats)), dict(rtol=rtol, atol=1e-5))


# --------------------------------------- (d) flat layout, blocks, run

FLAT_CASES = ["zinc-complex", "hiv-simple", "zinc-per-edge"]


@pytest.mark.parametrize("case", FLAT_CASES)
def test_flat_layout_ignores_compute_dtype_bit_for_bit(case):
    check_flat_layout(case, "bfloat16")


def check_flat_layout(case: str, cd: str):
    task, net = NETS[case]
    graphs, _, tfactory = _task(task)
    graphs = [tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs]
    gb = tgraph.pack_graphs(graphs)
    kw = dict(net, avg_d=_avg_d(graphs))
    out = []
    for dt in (None, cd):
        model, loss_fn = tfactory(TConfig(**kw, compute_dtype=dt),
                                  torch.Generator().manual_seed(0))
        model.train()
        scores = model(gb)
        loss = loss_fn(scores, gb)
        loss.backward()
        out.append((scores.detach(), loss.detach(),
                    [p.grad for p in model.parameters()]))
    (s0, l0, g0), (s1, l1, g1) = out
    assert torch.equal(s0, s1) and torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_adjacency_blocks_follow_compute_dtype():
    """The model's edge context and the trainer's eval cache build the
    blocks in the compute dtype (bfloat16, float16), in float32 without
    it."""
    graphs = [tgraph.GraphData(**dataclasses.asdict(g))
              for g in jsyn.synthetic_zinc(6, seed=2)]
    _, tb = _pack(jsyn.synthetic_zinc(6, seed=2))
    for cd, dt in ((None, torch.float32), ("float32", torch.float32),
                   ("bfloat16", BF), ("float16", torch.float16)):
        cfg = TConfig(**H12, avg_d=_avg_d(graphs), compute_dtype=cd)
        assert edge_context_for(tb, cfg).adj.dtype == dt
        model, loss_fn = tzinc(cfg, torch.Generator().manual_seed(0))
        trainer = TTrainer(model, loss_fn, TParams(), device="cpu")
        assert trainer.with_edge_context(tb).edge_ctx.adj.dtype == dt


@pytest.mark.parametrize("config,metric", [
    ("molecules_graph_regression_DGN_ZINC.json", "mae"),
    ("molecules_graph_classification_DGN_HIV.json", "rocauc")])
def test_run_bf16_on_cpu(config, metric, tmp_path):
    check_run(config, metric, "bfloat16", tmp_path)


def check_run(config: str, metric: str, cd: str, tmp_path):
    report = trun.run(["--config", str(CONFIGS / config), "--epochs",
                       "1", "--synthetic_size", "32", "--compute_dtype",
                       cd, "--device", "cpu", "--out_dir", str(tmp_path)])
    assert report["epochs_run"] == 1
    for split in ("train", "val", "test"):
        assert np.isfinite(report["final"][split][metric])
