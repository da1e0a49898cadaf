"""Adjacency-block build of the port == exact oracle == the reference's lowerings.

dgn_tpu_torch.ops.adjacency carries the hand-written CUDA kernel and its
plain PyTorch version.  On the CPU the wrapper takes the plain version; it is
held against the exact f64 scatter oracle (the one of
tests/test_adjacency_kernel.py) and against the reference's Pallas kernel
(interpret mode) and XLA lowering, on ZINC (K=3), multi-block SBM with real
off-diagonal pairs (K=2), a single family (K=1), and bf16 output.

The kernel runs only on a GPU: its cases are marked `gpu`, skip without
one, and import nothing of JAX, so on the card they run alone with
    python -m pytest --noconftest -m gpu tests/test_torch_adjacency.py

Tolerances: f32 1e-6 — the scatter is exact for simple graphs (each cell
gets at most one nonzero weight), so only the f64 oracle's last-bit
differences remain; bf16 1e-2 — one rounding of each entry to bf16.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch.data import synthetic as tsyn
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
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
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
    tol = 1e-6 if out_dtype == torch.float32 else 1e-2
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
