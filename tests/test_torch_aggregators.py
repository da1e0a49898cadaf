"""Decomposed aggregators of the port == dgn_tpu's, forward and gradients.

For each aggregator the canonical configs use or the adjacency path covers,
the same block-layout batch and the same node inputs (g, q, h_in from a
seeded numpy generator) go through dgn_tpu's build_edge_context +
aggregate_decomposed and through the port's.  The outputs and the gradients
with respect to g, q and h_in (a vector-Jacobian product with one shared
random cotangent) must agree at rtol 1e-5, atol 1e-6: both are f32, and
only the summation order differs (XLA one-hot products vs index_add_ and
torch.matmul).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgn_tpu import graph as jgraph
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.ops import aggregators as jagg

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch.ops import aggregators as tagg

torch.set_num_threads(1)

NAMES = ["mean", "sum", "var", "std", "dir1-av", "dir1-dx", "dir1-dx-no-abs",
         "dir1-dx-balanced"]
F = 6


def _batches():
    graphs = jsyn.synthetic_zinc(10, seed=5)
    n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(graphs, len(graphs))
    kw = dict(n_pad=n_pad, e_pad=e_pad, g_pad=g_pad, mxu_layout=True)
    return (jgraph.pack_graphs(graphs, **kw),
            tgraph.pack_graphs([tgraph.GraphData(**dataclasses.asdict(g))
                                for g in graphs], **kw))


@pytest.mark.parametrize("name", NAMES)
def test_aggregate_decomposed_matches_reference(name):
    jb, tb = _batches()
    rng = np.random.default_rng(17)
    n = tb.num_nodes_padded
    g, q, h_in, ct = (rng.normal(size=(n, F)).astype(np.float32)
                      for _ in range(4))

    def jax_fn(g_, q_, h_):
        ctx = jagg.build_edge_context(jb.eig, jb.src, jb.dst, jb.edge_mask,
                                      jb.in_degree, names=[name],
                                      need_norms=False, mxu_layout=jb.mxu,
                                      decomposed=True)
        return jagg.aggregate_decomposed([name], ctx, g_, q_, h_,
                                         layout=jb.mxu)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(g), jnp.asarray(q),
                        jnp.asarray(h_in))
    want_grads = vjp(jnp.asarray(ct))

    ctx = tagg.build_edge_context(tb.eig, tb.src, tb.dst, tb.edge_mask,
                                  tb.in_degree, names=[name],
                                  mxu_layout=tb.mxu)
    tg, tq, th = (torch.tensor(x, requires_grad=True) for x in (g, q, h_in))
    got = tagg.aggregate_decomposed([name], ctx, tg, tq, th, layout=tb.mxu)
    got.backward(torch.from_numpy(ct))

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6, err_msg="forward")
    # std's gradient is 1/(2 sqrt(var + 1e-8)): at in-degree-1 nodes var is
    # 0 up to f32 rounding, which that factor amplifies up to 5e3-fold, so
    # its gradient gets atol 1e-5 (measured worst 3.8e-6)
    grad_atol = 1e-5 if name == "std" else 1e-6
    for label, t, w in zip("gqh", (tg, tq, th), want_grads):
        # an input the aggregator does not read gets no torch gradient
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=grad_atol,
                                   err_msg=f"grad wrt {label}")


@pytest.mark.parametrize("name", ["max", "dir1-0.1"])
def test_unported_aggregators_raise(name):
    _, tb = _batches()
    with pytest.raises(NotImplementedError):
        tagg.build_edge_context(tb.eig, tb.src, tb.dst, tb.edge_mask,
                                tb.in_degree, names=[name], mxu_layout=tb.mxu)
