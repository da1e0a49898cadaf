"""Per-destination max/min of the port == dgn_tpu's mxu_segment_extremes.

dgn_tpu_torch.ops.extremes carries the hand-written CUDA kernel pair
(forward and backward) and its plain PyTorch version (scatter_reduce
amax/amin over the real edges).  On the CPU the wrapper takes the plain
version; the same numpy inputs, packed identically by both packages, go
through it and through the reference's scatter-free TPU lowering.  Cases:
random values, quantized values (exact ties, also across edges of one
node), a star of in-degree 119, a star whose run crosses a chunk boundary,
multi-block graphs over 128 nodes (one node's edges in chunks of several
src blocks), isolated nodes beside all-negative values, and one dense
128-node graph whose 40 chunks all belong to one dst block.

Tolerances: forward bit-identical (both pick one of the inputs); gradients
of sum(w1*mx) + sum(sin(w1)*mn) at rtol = atol = 1e-6 (the equal tie split
divides by the tie count on both sides), pad edges exactly 0.

The kernels run only on a GPU: their cases are marked `gpu`, skip without
one, and import nothing of JAX, so on the card they run alone with
    python -m pytest --noconftest -m gpu tests/test_torch_extremes.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch.data import synthetic as tsyn
from dgn_tpu_torch.ops import extremes as text

torch.set_num_threads(1)


# ------------------------------------------------------------------ inputs

def _graph(n, src, dst):
    return dict(num_nodes=n, src=np.asarray(src, np.int32),
                dst=np.asarray(dst, np.int32),
                node_feat=np.zeros(n, np.int32),
                eig=np.zeros((n, 2), np.float32),
                label=np.array([0.0], np.float32))


def _star(n=120, hub=0):
    """The hub gets n-1 in-edges, every leaf one.  With the hub at node 10
    the 10 leaves before it come first in the dst-sorted edges, so the hub's
    run of 119 edges crosses the 128-edge chunk boundary."""
    leaves = np.delete(np.arange(n), hub)
    hubs = np.full(n - 1, hub)
    return _graph(n, np.concatenate([leaves, hubs]),
                  np.concatenate([hubs, leaves]))


def _multiblock(n_graphs=3, seed=11):
    """135-170-node random graphs: each spans two 128-node blocks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(135, 171))
        us, vs = np.nonzero(np.triu(rng.random((n, n)) < 0.05, k=1))
        out.append(_graph(n, np.concatenate([us, vs]),
                          np.concatenate([vs, us])))
    return out


def _isolated():
    """Nodes 2..4 get no edge."""
    return [_graph(5, [0, 1], [1, 0])]


def _dense():
    """One 128-node graph at density 0.3: E = 5120, 40 chunks in one dst
    block (more than the kernels stage at once), in-degree up to 51."""
    rng = np.random.default_rng(5)
    us, vs = np.nonzero(np.triu(rng.random((128, 128)) < 0.3, k=1))
    return [_graph(128, np.concatenate([us, vs]), np.concatenate([vs, us]))]


def _molecules(n, seed):
    import dataclasses
    return [dataclasses.asdict(g) for g in tsyn.synthetic_zinc(n, seed=seed)]


# name -> (graphs as GraphData kwargs, F, value kind)
CASES = {
    "random": (lambda: _molecules(24, 7), 7, "normal"),
    "quantized_ties": (lambda: _molecules(24, 3), 7, "quantized"),
    "star_in_degree_119": (lambda: [_star()], 5, "quantized"),
    "star_run_crosses_chunk": (lambda: [_star(hub=10)], 5, "quantized"),
    "multiblock": (_multiblock, 6, "quantized"),
    "isolated_negative": (_isolated, 4, "negative"),
    "dense_block": (_dense, 6, "quantized"),
}


def _values(kind, e_pad, f, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(e_pad, f)).astype(np.float32)
    if kind == "quantized":             # exact ties, also across edges
        v = np.round(v * 2.0) / 2.0
    elif kind == "negative":
        v = v - 5.0
    return v


def _pack(pack_graphs, graphs):
    return pack_graphs(graphs, mxu_layout=True)


def _loss_weights(n, f, seed=2):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


# ------------------------------------------------------- CPU: plain version

@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from dgn_tpu import graph as jgraph
    from dgn_tpu.ops.extremes import mxu_segment_extremes
    return dict(jax=jax, jnp=jnp, jgraph=jgraph, ext=mxu_segment_extremes)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_reference_forward_and_grad(case, ref):
    make, f, kind = CASES[case]
    graphs = make()
    jb = _pack(ref["jgraph"].pack_graphs,
               [ref["jgraph"].GraphData(**g) for g in graphs])
    tb = _pack(tgraph.pack_graphs, [tgraph.GraphData(**g) for g in graphs])
    n = tb.num_nodes_padded
    v = _values(kind, tb.num_edges_padded, f)
    w1 = _loss_weights(n, f)
    jnp = ref["jnp"]

    def jloss(x):
        mx, mn = ref["ext"](x, jb.mxu, jb.edge_mask, n)
        return jnp.sum(w1 * mx) + jnp.sum(jnp.sin(w1) * mn), (mx, mn)

    (_, (jmx, jmn)), jgrad = ref["jax"].jit(ref["jax"].value_and_grad(
        jloss, has_aux=True))(jnp.asarray(v))

    x = torch.tensor(v, requires_grad=True)
    mx, mn = text.segment_extremes(x, tb.mxu, tb.edge_mask, n)
    (torch.from_numpy(w1) * mx).sum().add(
        (torch.sin(torch.from_numpy(w1)) * mn).sum()).backward()

    np.testing.assert_array_equal(mx.detach().numpy(), np.asarray(jmx))
    np.testing.assert_array_equal(mn.detach().numpy(), np.asarray(jmn))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-6)
    pad = ~tb.edge_mask.numpy()
    assert np.all(x.grad.numpy()[pad] == 0)
    deg = tb.in_degree.numpy()
    assert np.all(mx.detach().numpy()[deg == 0] == 0)
    if kind == "negative":            # negative maxima survive, no 0 clamp
        assert np.all(mx.detach().numpy()[deg > 0] < 0)


def test_plain_gradcheck_f64():
    """The plain path's gradient in f64, on distinct values (no ties)."""
    gb = _pack(tgraph.pack_graphs,
               [tgraph.GraphData(**g) for g in _molecules(3, 5)])
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.permutation(gb.num_edges_padded * 3).reshape(-1, 3)
                     / 7.0, dtype=torch.float64, requires_grad=True)
    n = gb.num_nodes_padded
    assert torch.autograd.gradcheck(
        lambda t: text.segment_extremes(t, gb.mxu, gb.edge_mask, n), (x,))


def test_cpu_path_counts_no_launch():
    gb = _pack(tgraph.pack_graphs,
               [tgraph.GraphData(**g) for g in _molecules(4, 5)])
    before = (text.segment_extremes_fwd.launches,
              text.segment_extremes_bwd.launches)
    x = torch.tensor(_values("normal", gb.num_edges_padded, 3),
                     requires_grad=True)
    mx, mn = text.segment_extremes(x, gb.mxu, gb.edge_mask,
                                   gb.num_nodes_padded)
    (mx.sum() + mn.sum()).backward()
    assert (text.segment_extremes_fwd.launches,
            text.segment_extremes_bwd.launches) == before


# ------------------------------------------------------------ GPU: kernels

def _hiv_batch():
    """The HIV main path's batch: 128 synthetic ogbg-molhiv graphs."""
    import dataclasses
    gs = tsyn.synthetic_ogb_mol(160, seed=41, n_tasks=1, k_eig=4)[:128]
    return [dataclasses.asdict(g) for g in gs]


GPU_CASES = dict(CASES, hiv_f70=(_hiv_batch, 70, "relu"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_cuda_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need a GPU")
    make, f, kind = GPU_CASES[case]
    gb = _pack(tgraph.pack_graphs, [tgraph.GraphData(**g) for g in make()])
    n = gb.num_nodes_padded
    v = _values("normal" if kind == "relu" else kind, gb.num_edges_padded, f)
    if kind == "relu":                  # exact zeros tie, as after a ReLU
        v = np.maximum(v, 0.0)
    layout = gb.mxu.to("cuda")
    mask = gb.edge_mask.cuda()
    w1 = torch.from_numpy(_loss_weights(n, f)).cuda()

    def run(fn):
        x = torch.tensor(v, device="cuda", requires_grad=True)
        mx, mn = fn(x, layout, mask, n)
        ((w1 * mx).sum() + (torch.sin(w1) * mn).sum()).backward()
        torch.cuda.synchronize()
        return mx.detach().cpu().numpy(), mn.detach().cpu().numpy(), \
            x.grad.cpu().numpy()

    before = (text.segment_extremes_fwd.launches,
              text.segment_extremes_bwd.launches)
    got = run(text.segment_extremes)
    assert (text.segment_extremes_fwd.launches,
            text.segment_extremes_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)
    want = run(text.segment_extremes_plain)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)
    assert np.all(got[2][~gb.edge_mask.numpy()] == 0)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need a GPU")
    gb = _pack(tgraph.pack_graphs,
               [tgraph.GraphData(**g) for g in _molecules(4, 5)])
    n = gb.num_nodes_padded
    layout = gb.mxu.to("cuda")
    mask = gb.edge_mask.cuda()
    x = torch.zeros((gb.num_edges_padded, 3), device="cuda")
    with pytest.raises(ValueError):
        text.segment_extremes(x.double(), layout, mask, n)
    with pytest.raises(ValueError):
        text.segment_extremes(x, gb.mxu, mask, n)         # layout on the CPU
    with pytest.raises(ValueError):
        text.segment_extremes(x[:-128], layout, mask, n)  # E mismatch
