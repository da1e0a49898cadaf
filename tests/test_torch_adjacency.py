"""Adjacency-block build of the port == exact oracle == the reference's lowerings.

dgn_tpu_torch.ops.adjacency carries the hand-written CUDA kernel and its
plain PyTorch version.  On the CPU the wrapper takes the plain version; it is
held against the exact f64 scatter oracle (the one of
tests/test_adjacency_kernel.py) and against the reference's Pallas kernel
(interpret mode) and XLA lowering, on ZINC (K=3), multi-block SBM with real
off-diagonal pairs (K=2), a single family (K=1), and bf16 output (f16
output: tests/test_torch_fp16.py).

The kernel runs only on a GPU: its cases are marked `gpu`, skip without
one, and import nothing of JAX, so on the card they run alone with
    python -m pytest --noconftest -m gpu tests/test_torch_adjacency.py

Tolerances: f32 1e-6 — the scatter is exact for simple graphs (each cell
gets at most one nonzero weight), so only the f64 oracle's last-bit
differences remain; bf16 1e-2 and f16 1e-3 (rtol and atol) — one rounding
of each entry, at most 2^-8 and 2^-11 of it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch.data import synthetic as tsyn
from dgn_tpu_torch.data.loader import BatchLoader
from dgn_tpu_torch.ops import adjacency as tadj
from dgn_tpu_torch.ops import mxu as tmxu

torch.set_num_threads(1)


def _oracle(weights, layout):
    """Exact f64 scatter of [K, E] weights into [P, K, T, T] blocks."""
    k, e_pad = weights.shape
    ls = np.asarray(layout.local_src)
    ld = np.asarray(layout.local_dst)
    cp = np.asarray(layout.chunk_pair)
    out = np.zeros((layout.n_pairs, k, 128, 128))
    w64 = np.asarray(weights, np.float64)
    for e in range(e_pad):
        out[cp[e // 128], :, ls[e], ld[e]] += w64[:, e]
    return out


def _pack(graphs, pack_graphs, mxu_bucket_sizes):
    n_pad, e_pad, g_pad = mxu_bucket_sizes(graphs, len(graphs))
    return pack_graphs(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                       mxu_layout=True)


def _weights(k, gb, seed):
    w = np.random.default_rng(seed).normal(
        size=(k, gb.num_edges_padded)).astype(np.float32)
    return w * np.asarray(gb.edge_mask, np.float32)   # pad edges weigh 0


# the kernel's output dtypes and their tolerances (see the docstring)
OUT_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
OUT_IDS = ["f32", "bf16", "f16"]
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2, torch.float16: 1e-3}


def _has_off_diagonal(layout):
    covered = np.asarray(layout.pair_covered)
    return np.any(covered & (np.asarray(layout.pair_src)
                             != np.asarray(layout.pair_dst)))


# ------------------------------------------------------- CPU: plain version

@pytest.fixture(scope="module")
def ref():
    """The reference package's packing, generators and both lowerings."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from dgn_tpu import graph as jgraph
    from dgn_tpu.data import synthetic as jsyn
    from dgn_tpu.ops import mxu as jmxu
    from dgn_tpu.ops.pallas import adjacency as jadj
    return dict(jnp=jnp, jgraph=jgraph, jsyn=jsyn, jmxu=jmxu, jadj=jadj)


CPU_CASES = {
    "zinc_k3": (lambda jsyn: jsyn.synthetic_zinc(24, seed=7), 3),
    "sbm_multiblock_k2": (lambda jsyn: jsyn.synthetic_sbm(4, seed=11,
                                                          nodes=150), 2),
    "zinc_k1": (lambda jsyn: jsyn.synthetic_zinc(8, seed=5), 1),
}


def _both(ref, case):
    make, k = CPU_CASES[case]
    graphs = make(ref["jsyn"])
    jg = ref["jgraph"]
    jb = _pack(graphs, jg.pack_graphs, jg.mxu_bucket_sizes)
    tb = _pack([tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs],
               tgraph.pack_graphs, tgraph.mxu_bucket_sizes)
    return jb, tb, _weights(k, tb, 41)


@pytest.mark.parametrize("case", list(CPU_CASES))
def test_plain_matches_oracle_and_reference(case, ref):
    jb, tb, w = _both(ref, case)
    if case.startswith("sbm"):
        assert _has_off_diagonal(tb.mxu), "no real off-diagonal pairs packed"
    got = tmxu.build_pair_adjacency(torch.from_numpy(w), tb.mxu)
    assert got.dtype == torch.float32
    assert got.shape == (tb.mxu.n_pairs, w.shape[0], 128, 128)
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               _oracle(w, tb.mxu), rtol=1e-6, atol=1e-6)
    jw = ref["jnp"].asarray(w)
    pallas = ref["jadj"].build_pair_adjacency(jw, jb.mxu, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=1e-6, atol=1e-6)
    xla = ref["jmxu"].build_pair_adjacency(jw, jb.mxu)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla),
                               rtol=1e-6, atol=1e-6)


def test_plain_bf16_output(ref):
    jb, tb, w = _both(ref, "zinc_k3")
    got = tmxu.build_pair_adjacency(torch.from_numpy(w), tb.mxu,
                                    out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy().astype(np.float64),
                               _oracle(w, tb.mxu), rtol=1e-2, atol=1e-2)
    pallas = ref["jadj"].build_pair_adjacency(
        ref["jnp"].asarray(w), jb.mxu, out_dtype=ref["jnp"].bfloat16,
        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_cpu_path_counts_no_launch():
    gb = _pack(tsyn.synthetic_zinc(8, seed=5), tgraph.pack_graphs,
               tgraph.mxu_bucket_sizes)
    before = tadj.build_pair_adjacency.launches
    tadj.build_pair_adjacency(torch.from_numpy(_weights(1, gb, 3)), gb.mxu)
    assert tadj.build_pair_adjacency.launches == before


# ------------------------------------- CPU: the kernel's walk of the layout

def _packed(graphs, n_pairs_pad=None):
    """One block-layout batch at the worst-case pads of its graphs, in the
    loader's order (descending node count), as chip_smoke.py packs its
    kernel batches: the pad edges fill all-pad chunks of one pair."""
    graphs = sorted(graphs, key=lambda g: -g.num_nodes)
    n_pad, e_pad, g_pad = tgraph.mxu_bucket_sizes(graphs, len(graphs))
    if n_pairs_pad is None:
        n_pairs_pad = tgraph.mxu_pair_pad(graphs, len(graphs), n_pad, e_pad)
    return tgraph.pack_graphs(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                              mxu_layout=True, n_pairs_pad=n_pairs_pad)


def _loader_batch(graphs, batch_size):
    """The first batch of the port's block-layout loader."""
    return next(iter(BatchLoader(graphs, batch_size=batch_size,
                                 shuffle=False, seed=0, layout="mxu",
                                 geometry="typical")))


# ZINC, a multi-block SBM with real off-diagonal pairs, and a CIFAR10-like
# batch (superpixel graphs of 140-159 nodes, each spanning two node blocks)
WALK_CASES = {
    "zinc": lambda: _packed(tsyn.synthetic_zinc(24, seed=7)),
    "sbm_multiblock": lambda: _loader_batch(
        tsyn.synthetic_sbm(8, seed=11, nodes=150), 4),
    "cifar10_like": lambda: _loader_batch(tsyn.synthetic_superpixels(
        32, seed=3, nodes=150, coord_eig=True), 16),
}


def _walk(weights, layout):
    """NumPy model of the kernel: for each (pair, family, 32-row slab),
    only the pair's range of pair_real_chunk_order, and of its edges those
    of nonzero weight whose local_src falls in the slab."""
    k = weights.shape[0]
    ls = layout.local_src.numpy().reshape(-1, 128)
    ld = layout.local_dst.numpy().reshape(-1, 128)
    w = weights.numpy().reshape(k, -1, 128)
    order = layout.pair_real_chunk_order.numpy()
    start = layout.pair_chunk_start.numpy()
    out = np.zeros((layout.n_pairs, k, 128, 128), np.float32)
    for p in range(layout.n_pairs):
        for f in range(k):
            for slab in range(4):
                for c in order[start[p]:start[p + 1]]:
                    keep = (w[f, c] != 0) & (ls[c] // 32 == slab)
                    np.add.at(out[p, f], (ls[c][keep], ld[c][keep]),
                              w[f, c][keep])
    return out


def _pad_only_pairs(gb):
    """Covered pairs whose every chunk holds only pad edges."""
    lay = gb.mxu
    real = gb.edge_mask.numpy().reshape(-1, 128).any(axis=1)
    cp = lay.chunk_pair.numpy()
    has_real = np.zeros(lay.n_pairs, bool)
    has_real[cp[real]] = True
    return np.nonzero(lay.pair_covered.numpy() & ~has_real)[0]


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_pair_chunk_ranges(case):
    gb = WALK_CASES[case]()
    lay = gb.mxu
    n_chunks, n_pairs = gb.num_edges_padded // 128, lay.n_pairs
    real = gb.edge_mask.numpy().reshape(-1, 128).any(axis=1)
    order = lay.pair_real_chunk_order.numpy()
    start = lay.pair_chunk_start.numpy()
    assert order.dtype == start.dtype == np.int32
    assert order.shape == (n_chunks,) and start.shape == (n_pairs + 1,)
    assert start[0] == 0 and np.all(np.diff(start) >= 0)
    assert start[-1] == real.sum()
    assert sorted(order) == list(range(n_chunks))
    assert not real[order[start[-1]:]].any()       # then the all-pad chunks
    pco = lay.pair_chunk_order.numpy()
    psi = lay.pair_sorted_ids.numpy()
    for p in range(n_pairs):
        lo, hi = np.searchsorted(psi, [p, p + 1])
        want = [c for c in pco[lo:hi] if real[c]]
        assert list(order[start[p]:start[p + 1]]) == want, p
    uncovered = np.nonzero(~lay.pair_covered.numpy())[0]
    pad_only = _pad_only_pairs(gb)
    assert len(uncovered) and len(pad_only) == 1
    assert np.all(start[uncovered] == start[uncovered + 1])
    assert np.all(start[pad_only] == start[pad_only + 1])
    if case != "zinc":
        assert _has_off_diagonal(lay), "no real off-diagonal pairs packed"


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_of_ranges_equals_plain(case):
    """A scatter from the kernel's ranges alone gives the plain version's
    blocks exactly (simple graphs: one edge per cell)."""
    gb = WALK_CASES[case]()
    w = torch.from_numpy(_weights(3, gb, 17))
    want = tadj.build_pair_adjacency_plain(w, gb.mxu)
    np.testing.assert_array_equal(_walk(w, gb.mxu), want.numpy())


def test_layout_to_carries_walk_arrays():
    lay = WALK_CASES["zinc"]().mxu
    moved = lay.to("meta")
    for name in ("pair_real_chunk_order", "pair_chunk_start"):
        got, src = getattr(moved, name), getattr(lay, name)
        assert got.device.type == "meta", name
        assert got.dtype == src.dtype and got.shape == src.shape, name
    back = lay.to("cpu")
    assert torch.equal(back.pair_chunk_start, lay.pair_chunk_start)
    assert torch.equal(back.pair_real_chunk_order, lay.pair_real_chunk_order)


# ------------------------------------------------------------- GPU: kernel

def _multiblock_graphs(n_graphs=4, seed=11):
    """135-170-node random graphs: each spans two 128-node blocks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(135, 171))
        us, vs = np.nonzero(np.triu(rng.random((n, n)) < 0.05, k=1))
        out.append(tgraph.GraphData(
            num_nodes=n, src=np.concatenate([us, vs]).astype(np.int32),
            dst=np.concatenate([vs, us]).astype(np.int32),
            node_feat=np.zeros(n, np.int32),
            eig=rng.normal(size=(n, 2)).astype(np.float32)))
    return out


GPU_CASES = {
    "zinc_k3": (lambda: tsyn.synthetic_zinc(24, seed=7), 3),
    "multiblock_k2": (_multiblock_graphs, 2),
    "zinc_k1": (lambda: tsyn.synthetic_zinc(8, seed=5), 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", OUT_DTYPES, ids=OUT_IDS)
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_cuda_kernel_matches_plain_and_oracle(case, out_dtype):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU")
    make, k = GPU_CASES[case]
    gb = _pack(make(), tgraph.pack_graphs, tgraph.mxu_bucket_sizes)
    if case.startswith("multiblock"):
        assert _has_off_diagonal(gb.mxu)
    w = _weights(k, gb, 41)
    layout = gb.mxu.to("cuda")
    wd = torch.from_numpy(w).cuda()
    before = tadj.build_pair_adjacency.launches
    got = tadj.build_pair_adjacency(wd, layout, out_dtype)
    torch.cuda.synchronize()
    assert tadj.build_pair_adjacency.launches == before + 1
    assert got.dtype == out_dtype and got.is_cuda
    tol = TOL[out_dtype]
    want = tadj.build_pair_adjacency_plain(wd, layout, out_dtype)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().cpu().numpy().astype(np.float64),
                               _oracle(w, gb.mxu), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU")
    gb = _pack(tsyn.synthetic_zinc(8, seed=5), tgraph.pack_graphs,
               tgraph.mxu_bucket_sizes)
    layout = gb.mxu.to("cuda")
    w = torch.from_numpy(_weights(2, gb, 3)).cuda()
    with pytest.raises(ValueError):
        tadj.build_pair_adjacency(w.double(), layout)
    with pytest.raises(ValueError):
        tadj.build_pair_adjacency(w, gb.mxu)              # layout on the CPU
    with pytest.raises(ValueError):
        tadj.build_pair_adjacency(w[:, :-128], layout)    # E mismatch


def _multigraph(n_graphs=16, seed=23):
    """ZINC graphs with every third edge doubled and every fifth tripled:
    several edges add into one cell."""
    out = []
    for g in tsyn.synthetic_zinc(n_graphs, seed=seed):
        extra = np.concatenate([np.arange(0, g.num_edges, 3),
                                np.repeat(np.arange(0, g.num_edges, 5), 2)])
        ef = g.edge_feat
        out.append(dataclasses.replace(
            g, src=np.concatenate([g.src, g.src[extra]]),
            dst=np.concatenate([g.dst, g.dst[extra]]),
            edge_feat=None if ef is None else np.concatenate([ef, ef[extra]])))
    return out


def _pair_pad_4x():
    """A ZINC batch whose pair axis is padded to 4x its covered pairs."""
    graphs = tsyn.synthetic_zinc(24, seed=7)
    n_covered = int(_packed(graphs).mxu.pair_covered.sum())
    return _packed(graphs, n_pairs_pad=4 * n_covered)


# name -> (batch, K); each runs in f32, bf16 and f16
LAYOUT_GPU_CASES = {
    "multigraph_k3": (lambda: _packed(_multigraph()), 3),
    "pair_pad_4x_k3": (_pair_pad_4x, 3),
    "zinc_k1": (lambda: _packed(tsyn.synthetic_zinc(128, seed=41)), 1),
    "zinc_k3": (lambda: _packed(tsyn.synthetic_zinc(128, seed=41)), 3),
    "zinc_k6": (lambda: _packed(tsyn.synthetic_zinc(128, seed=41)), 6),
    "cifar10_like_k3": (WALK_CASES["cifar10_like"], 3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", OUT_DTYPES, ids=OUT_IDS)
@pytest.mark.parametrize("case", list(LAYOUT_GPU_CASES))
def test_cuda_kernel_layout_cases(case, out_dtype):
    """The kernel against the f64 oracle and the plain version on the
    batches whose layouts stress its walk: duplicate edges into one cell
    (f32 within 1e-6 relative of the oracle and of the plain version: the
    atomics' order varies), a pair pad of 4x the covered pairs, K = 1, 3
    and 6, and the pad-only pair of a ZINC batch, whose block must be all
    zeros.  Outside the multigraph, f32, bf16 and f16 blocks equal the
    plain version's exactly."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU")
    make, k = LAYOUT_GPU_CASES[case]
    gb = make()
    lay = gb.mxu
    covered = int(lay.pair_covered.sum())
    if case.startswith("pair_pad"):
        assert lay.n_pairs == 4 * covered
    pad_only = _pad_only_pairs(gb)
    if case.startswith("zinc"):
        assert len(pad_only) == 1
    w = _weights(k, gb, 41)
    layout = lay.to("cuda")
    wd = torch.from_numpy(w).cuda()
    before = tadj.build_pair_adjacency.launches
    got = tadj.build_pair_adjacency(wd, layout, out_dtype)
    torch.cuda.synchronize()
    assert tadj.build_pair_adjacency.launches == before + 1
    assert got.dtype == out_dtype and got.is_cuda
    assert got.shape == (lay.n_pairs, k, 128, 128)
    got = got.float().cpu().numpy()
    oracle = _oracle(w, lay)
    want = tadj.build_pair_adjacency_plain(wd, layout, out_dtype)
    want = want.float().cpu().numpy()
    tol = TOL[out_dtype]
    np.testing.assert_allclose(got.astype(np.float64), oracle, rtol=tol,
                               atol=tol)
    if case.startswith("multigraph"):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        # one f32 sum per cell, rounded once: the plain version's bits
        np.testing.assert_array_equal(got, want)
    assert not got[~lay.pair_covered.numpy()].any()
    assert not got[pad_only].any()


@pytest.mark.gpu
def test_cuda_wrapper_checks_walk_arrays():
    """The wrapper raises on walk arrays of the wrong type, length,
    device or layout in memory."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU")
    gb = _packed(tsyn.synthetic_zinc(24, seed=7))
    layout = gb.mxu.to("cuda")
    w = torch.from_numpy(_weights(3, gb, 3)).cuda()
    order, start = layout.pair_real_chunk_order, layout.pair_chunk_start
    bad = {
        "pair_real_chunk_order": [order.long(), order[:-1], order.cpu(),
                                  torch.stack([order, order], 1)[:, 0]],
        "pair_chunk_start": [start.long(), start[:-1], start.cpu(),
                             torch.stack([start, start], 1)[:, 0]],
    }
    for name, tensors in bad.items():
        for t in tensors:
            with pytest.raises(ValueError, match=name):
                tadj.build_pair_adjacency(
                    w, dataclasses.replace(layout, **{name: t}))
