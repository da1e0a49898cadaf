"""compute_dtype="float16" in the port == dgn_tpu's, from the rounding
primitives to the entry point.

dgn_tpu runs float16 as it runs bfloat16 (dgn_tpu/ops/mxu.py:364-497): the
adjacency blocks are built in float16, and every block-layout product,
gather and scatter takes float16-rounded operands with float32
accumulation and a float32 result, forward and backward.  The same numpy
inputs, made from a seed, go through both packages; the checks are
tests/test_torch_bf16.py's, called with "float16":
  (a) the float32 -> float16 rounding, bit for bit, at a subnormal (1e-6),
      the smallest subnormal's neighbourhood (7e-8, and 2.98e-8 -> 0), the
      largest value (65504) and past it (65520 -> inf);
  (b) the primitives (pair_adj_matmul, block_scatter_sum,
      weighted_segment_sums, the gather of rows at src), forward and VJP;
  (c) the float16 adjacency blocks of simple-graph batches, == dgn_tpu's
      XLA lowering and its Pallas kernel in interpret mode;
  (d) aggregate_decomposed over a float16 edge context, forward and VJP,
      with the cotangent 0 on pad nodes as the models' masks make it;
  (e) the ZINC complex net, the HIV simple net (max/min, no graph norm) and
      the PATTERN complex net (node-level): eval scores, loss, every
      gradient (grad_checks.assert_live) and one Adam step; the eval scores
      and the gradients each held much closer to dgn_tpu's float16 output
      than to its float32 one;
  (f) the flat layout, bit for bit equal under float16 and float32;
  (g) the entry point on the CPU (ZINC and HIV configs);
  (h) overflow: a value past 65504 gives inf in the port's gathers and
      scatters only in the rows that hold it, and NaN across its chunk in
      dgn_tpu's one-hot products (not reproduced); pair_adj_matmul is a
      matmul in both and agrees (NaN where a block entry is 0, inf where it
      is not); a non-zero cotangent on a node whose directional normaliser
      is 0 passes float16's range in both, NaN on that node's edges in the
      port and across the chunks in dgn_tpu.

Tolerances.  (b) and (d): rtol 1e-5 / atol 1e-6, as in bfloat16: both
sides round the same float32 inputs, and a product of two float16 values
(22 significant bits) is exact in float32, so only the order of the
float32 sums differs.  (c): ==, every block entry is one weight rounded
once.  (e): bfloat16's bounds over 8, float16's spacing being 2^-11 where
bfloat16's is 2^-8: rtol 2.5e-3 on scores, loss and Adam's step, gradients
within 2.5e-3 of each leaf's largest entry; the port within half of
dgn_tpu's float16-vs-float32 distance, on the eval scores and on the
gradients' norm.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.ops import aggregators as jagg
from dgn_tpu.ops import mxu as jmxu
from dgn_tpu.ops.pallas import adjacency as jadj

from dgn_tpu_torch.ops import aggregators as tagg
from dgn_tpu_torch.ops import mxu as tmxu
from test_torch_bf16 import (AGG_CASES, FLAT_CASES, H12, NETS, ROUNDING_OPS,
                             check_aggregate_decomposed, check_flat_layout,
                             check_model, check_pair_adj_matmul,
                             check_rounding_primitive, check_run)
from test_torch_edge import _pack

torch.set_num_threads(1)

F16 = torch.float16
FP16_MODEL_TOL = dict(rtol=2.5e-3, grad_rel=2.5e-3, gap_ratio=0.5)
PATTERN_NET = dict(H12, type_net="complex", aggregators="mean dir1-dx dir2-dx",
                   scalers="identity amplification attenuation",
                   num_node_types=3)
FP16_NETS = {"zinc-complex": NETS["zinc-complex"],
             "hiv-simple": NETS["hiv-simple"],
             "pattern-complex": ("sbm", PATTERN_NET)}


# -------------------------------------------------------------- (a) rounding

ROUNDING = {1e-6: 1.0132789611816406e-06, 7e-8: 5.960464477539063e-08,
            2.98e-8: 0.0, 65504.0: 65504.0, 65520.0: np.inf}


def test_float16_rounding_matches_reference_bit_for_bit():
    x = np.array([v for v in ROUNDING] + [-v for v in ROUNDING], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float16))
    got = torch.from_numpy(x).to(F16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    expect = [ROUNDING[v] for v in ROUNDING]
    np.testing.assert_array_equal(got.astype(np.float64),
                                  np.array(expect + [-v for v in expect]))
    # the primitives' rounding keeps float32 and rounds as a cast does
    np.testing.assert_array_equal(
        tmxu._rounded(torch.from_numpy(x), F16).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.float16).astype(jnp.float32)))


# ------------------------------------------------------------ (b) primitives

def test_pair_adj_matmul_fp16_matches_reference():
    check_pair_adj_matmul("float16")


@pytest.mark.parametrize("op", ROUNDING_OPS)
def test_rounding_primitive_fp16_matches_reference(op):
    check_rounding_primitive(op, "float16")


# ---------------------------------------------------------------- (c) blocks

BLOCK_CASES = {
    "zinc_k3": (lambda: jsyn.synthetic_zinc(24, seed=7), 3),
    "sbm_multiblock_k2": (lambda: jsyn.synthetic_sbm(4, seed=11, nodes=150),
                          2),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_float16_blocks_equal_reference(case):
    """Each block entry of a simple graph is one weight rounded once, so
    the port's blocks (f32 sums rounded once) == dgn_tpu's XLA lowering
    (weights rounded, then summed with zeros) == its Pallas kernel in
    interpret mode (f32 accumulator, one astype)."""
    make, k = BLOCK_CASES[case]
    jb, tb = _pack(make())
    w = (np.random.default_rng(41).normal(size=(k, tb.num_edges_padded))
         * tb.edge_mask.numpy()).astype(np.float32)
    got = tmxu.build_pair_adjacency(torch.from_numpy(w), tb.mxu, F16)
    assert got.dtype == F16
    got = got.numpy()
    assert np.count_nonzero(got) == np.count_nonzero(w)
    jw = jnp.asarray(w)
    xla = np.asarray(jmxu.build_pair_adjacency(jw, jb.mxu, "float16"))
    pallas = np.asarray(jadj.build_pair_adjacency(
        jw, jb.mxu, out_dtype=jnp.float16, interpret=True))
    assert xla.dtype == pallas.dtype == np.float16
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)


# ------------------------------------------------ (d) decomposed aggregators

@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_decomposed_fp16_matches_reference(case):
    """The cotangent is 0 on pad nodes, as the models' masks make it: a pad
    node's directional normaliser is 0, and its cotangent / 1e-8 would
    pass float16's range ((h) pins that case)."""
    check_aggregate_decomposed(case, "float16", pad_cotangent=False)


# ------------------------------------------------------------- (e) models

@pytest.mark.parametrize("case", sorted(FP16_NETS))
def test_model_fp16_matches_reference(case):
    check_model(case, *FP16_NETS[case], "float16", **FP16_MODEL_TOL)


# --------------------------------------------------- (f) flat layout, (g) run

@pytest.mark.parametrize("case", FLAT_CASES)
def test_flat_layout_ignores_fp16_bit_for_bit(case):
    check_flat_layout(case, "float16")


@pytest.mark.parametrize("config,metric", [
    ("molecules_graph_regression_DGN_ZINC.json", "mae"),
    ("molecules_graph_classification_DGN_HIV.json", "rocauc")])
def test_run_fp16_on_cpu(config, metric, tmp_path):
    check_run(config, metric, "float16", tmp_path)


# ------------------------------------------------------------- (h) overflow

BIG = 7e4      # past float16's largest value, 65504: rounds to inf


def _overflow_setup():
    """A ZINC batch, a [N, F] table of ones with BIG at one node's first
    feature, and the edges whose src is that node."""
    jb, tb = _pack(jsyn.synthetic_zinc(6, seed=3))
    n, f = tb.num_nodes_padded, 3
    node = int(tb.src[0])
    table = np.ones((n, f), np.float32)
    table[node, 0] = BIG
    hit = tb.src.numpy() == node
    return jb, tb, table, hit


def test_gather_overflow_stays_in_its_rows():
    jb, tb, table, hit = _overflow_setup()
    got = tmxu.gather(torch.from_numpy(table), tb.src, F16).numpy()
    assert np.all(got[hit, 0] == np.inf)
    assert np.all(got[~hit] == 1) and np.all(got[:, 1:] == 1)
    # dgn_tpu's one-hot product: 0 * inf = NaN in the rest of the column for
    # every edge whose chunk reads the node's block
    want = np.asarray(jmxu.gather_src(jnp.asarray(table), jb.mxu, "float16"))
    assert np.all(want[hit, 0] == np.inf)
    assert np.isnan(want[~hit, 0]).sum() > 0
    assert np.all(want[:, 1:] == 1)


def test_scatter_overflow_stays_in_its_row():
    jb, tb, _, _ = _overflow_setup()
    e, f = tb.num_edges_padded, 3
    mask = tb.edge_mask.numpy()
    data = np.ones((e, f), np.float32) * mask[:, None]
    data[0, 0] = BIG
    dst = int(tb.dst[0])
    lay, jlay = tb.mxu, jb.mxu
    got = tmxu.block_scatter_sum(torch.from_numpy(data), lay.local_dst,
                                 lay.edge_chunk_dst, lay.n_node_blocks,
                                 F16).numpy()
    assert got[dst, 0] == np.inf
    others = np.delete(got[:, 0], dst)
    assert np.all(np.isfinite(others)) and np.all(np.isfinite(got[:, 1:]))
    want = np.asarray(jmxu.block_scatter_sum(
        jnp.asarray(data), jlay.local_dst, jlay.edge_chunk_dst,
        jlay.n_node_blocks, compute_dtype="float16"))
    assert want[dst, 0] == np.inf
    assert np.isnan(np.delete(want[:, 0], dst)).sum() > 0
    np.testing.assert_array_equal(want[:, 1:], got[:, 1:])


def test_pair_adj_matmul_overflow_agrees():
    rng = np.random.default_rng(2)
    p, k, t, f = 2, 2, 128, 3
    w = (rng.normal(size=(p, k, t, t))
         * (rng.random((p, k, t, t)) < 0.05)).astype(np.float32)
    gp = rng.normal(size=(p, t, f)).astype(np.float32)
    gp[0, 5, 0] = BIG
    tw = torch.from_numpy(w).to(F16)
    got = tmxu.pair_adj_matmul(tw, torch.from_numpy(gp), F16).numpy()
    want = np.asarray(jmxu.pair_adj_matmul(
        jnp.asarray(tw.float().numpy(), jnp.float16), jnp.asarray(gp),
        "float16"))
    col = got[0, :, :, 0]                           # [K, T] dst rows
    row5 = tw.float().numpy()[0, :, 5, :]           # src 5's weights
    assert np.all(np.isnan(col[row5 == 0]))
    assert np.all(np.isinf(col[row5 != 0]))
    # NaN where NaN; elsewhere the float32 sums' order differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(np.isnan(got), np.isnan(want))


def test_zero_normaliser_overflow():
    """A non-zero cotangent on a node whose directional normaliser S is 0
    (a pad node here) becomes ct / (S + 1e-8), past float16's range: inf
    once rounded.  The port's gather-back turns it into NaN on the edges
    into that node only (inf times their weight 0); dgn_tpu's one-hot
    product spreads the NaN to every edge of the batch's chunks."""
    names = ["mean", "dir1-dx", "dir1-av"]
    jb, tb = _pack(jsyn.synthetic_zinc(10, seed=5))
    rng = np.random.default_rng(17)
    n, e, f = tb.num_nodes_padded, tb.num_edges_padded, 6
    g, q, h_in = (rng.normal(size=(n, f)).astype(np.float32)
                  for _ in range(3))
    c = rng.normal(size=(e, f)).astype(np.float32)
    ct = rng.normal(size=(n, len(names) * f)).astype(np.float32)
    pad_rows = ~tb.node_mask.numpy()
    assert pad_rows.any()
    into_pad = pad_rows[tb.dst.numpy()]
    ctx = tagg.build_edge_context(tb.eig, tb.src, tb.dst, tb.edge_mask,
                                  tb.in_degree, names, mxu_layout=tb.mxu,
                                  adj_dtype=F16)
    tc = torch.tensor(c, requires_grad=True)
    out = tagg.aggregate_decomposed(
        names, ctx, torch.from_numpy(g), torch.from_numpy(q),
        torch.from_numpy(h_in), c_edge=tc, layout=tb.mxu, compute_dtype=F16)
    out.backward(torch.from_numpy(ct))
    got = tc.grad.numpy()
    assert np.all(np.isnan(got[into_pad])) and np.all(np.isfinite(
        got[~into_pad]))
    jctx = jagg.build_edge_context(jb.eig, jb.src, jb.dst, jb.edge_mask,
                                   jb.in_degree, names=names,
                                   need_norms=False, mxu_layout=jb.mxu,
                                   decomposed=True, adj_dtype="float16")
    _, vjp = jax.vjp(lambda c_: jagg.aggregate_decomposed(
        names, jctx, jnp.asarray(g), jnp.asarray(q), jnp.asarray(h_in),
        c_edge=c_, layout=jb.mxu, compute_dtype="float16"), jnp.asarray(c))
    (want,) = vjp(jnp.asarray(ct))
    assert np.isnan(np.asarray(want)[~into_pad]).any()
