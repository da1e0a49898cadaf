"""Packing parity: dgn_tpu_torch packs the same graphs into the same arrays.

The port keeps its own copy of the reference package's host packing
(graph.py, ops/mxu.py:build_mxu_layout); every GraphBatch field and every
MXULayout array and static field must be IDENTICAL, on ZINC-like batches and
on a multi-block SBM batch whose graphs span two 128-node blocks.  Also
holds the geometry helpers and the loader's batch sequence, and checks that
the port imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from dgn_tpu import graph as jgraph
from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.data.loader import BatchLoader as JBatchLoader

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch.data import synthetic as tsyn
from dgn_tpu_torch.data.loader import BatchLoader as TBatchLoader

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_GB_FIELDS = [f.name for f in dataclasses.fields(tgraph.GraphBatch)
              if f.name not in ("mxu", "edge_ctx")]


def _to_port(graphs):
    """The same graphs as the port's GraphData (same arrays)."""
    return [tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs]


def _assert_same_batch(jb, tb):
    for name in _GB_FIELDS:
        want, got = getattr(jb, name), getattr(tb, name)
        if want is None:
            assert got is None, name
            continue
        want = np.asarray(want)
        got = got.numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
    jl, tl = jb.mxu, tb.mxu
    for f in dataclasses.fields(tl):
        want, got = getattr(jl, f.name), getattr(tl, f.name)
        if isinstance(got, torch.Tensor):
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype, f.name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
        else:
            assert got == want, (f.name, got, want)


def _sbm150(n, seed):
    return jsyn.synthetic_sbm(n, seed=seed, nodes=150)


@pytest.mark.parametrize("case", ["zinc", "zinc_loose_pads", "sbm_multiblock"])
def test_pack_identical(case):
    if case == "sbm_multiblock":
        graphs = _sbm150(4, 11)
    else:
        graphs = jsyn.synthetic_zinc(24, seed=7)
    if case == "zinc_loose_pads":
        kw = {}
    else:
        n_pad, e_pad, g_pad = jgraph.mxu_bucket_sizes(graphs, len(graphs))
        kw = dict(n_pad=n_pad, e_pad=e_pad, g_pad=g_pad)
    jb = jgraph.pack_graphs(graphs, mxu_layout=True, **kw)
    tb = tgraph.pack_graphs(_to_port(graphs), mxu_layout=True, **kw)
    _assert_same_batch(jb, tb)
    if case == "sbm_multiblock":
        covered = tb.mxu.pair_covered.numpy()
        off = tb.mxu.pair_src.numpy() != tb.mxu.pair_dst.numpy()
        assert np.any(off & covered), "no real off-diagonal pairs packed"


def test_synthetic_zinc_identical():
    for jg, tg in zip(jsyn.synthetic_zinc(12, seed=3),
                      tsyn.synthetic_zinc(12, seed=3)):
        for f in dataclasses.fields(tg):
            want, got = getattr(jg, f.name), getattr(tg, f.name)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(np.asarray(got),
                                              np.asarray(want), err_msg=f.name)


def test_geometry_helpers_identical():
    graphs = jsyn.synthetic_zinc(64, seed=9)
    tgs = _to_port(graphs)
    assert tgraph.mxu_bucket_sizes(tgs, 16) == jgraph.mxu_bucket_sizes(graphs, 16)
    assert tgraph.typical_bucket_sizes(tgs, 16, mxu_layout=True,
                                       seed=4) == \
        jgraph.typical_bucket_sizes(graphs, 16, mxu_layout=True, seed=4)
    assert tgraph.pack_requirements(tgs[:16], mxu_layout=True) == \
        jgraph.pack_requirements(graphs[:16], mxu_layout=True)
    assert tgraph.mxu_pair_pad(tgs, 16, 1024, 2048) == \
        jgraph.mxu_pair_pad(graphs, 16, 1024, 2048)
    assert tgraph.mxu_pairs_needed(tgs[:16]) == \
        jgraph.mxu_pairs_needed(graphs[:16])


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_same_batches(shuffle):
    """Same seed -> the same shuffled batch composition in both packages."""
    graphs = jsyn.synthetic_zinc(40, seed=13)
    jl = JBatchLoader(graphs, batch_size=16, shuffle=shuffle, seed=5,
                      layout="mxu", geometry="typical")
    tl = TBatchLoader(_to_port(graphs), batch_size=16, shuffle=shuffle,
                      seed=5, layout="mxu", geometry="typical")
    assert (tl.n_pad, tl.e_pad, tl.pair_pad) == (jl.n_pad, jl.e_pad,
                                                 jl.pair_pad)
    for _ in range(2):          # two epochs: the rng stream advances alike
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == len(tl)
        for jb, tb in zip(jbs, tbs):
            np.testing.assert_array_equal(tb.labels.numpy(),
                                          np.asarray(jb.labels))
            np.testing.assert_array_equal(tb.n_nodes.numpy(),
                                          np.asarray(jb.n_nodes))


def test_flat_pack_identical():
    """The default pack is flat, as in dgn_tpu: the same arrays, no block
    layout (tests/test_torch_flat.py holds the flat layout in full)."""
    graphs = jsyn.synthetic_zinc(24, seed=7)
    n_pad, e_pad = jgraph.bucket_sizes_for(graphs, len(graphs))
    for kw in ({}, dict(n_pad=n_pad, e_pad=e_pad, g_pad=32)):
        jb = jgraph.pack_graphs(graphs, **kw)
        tb = tgraph.pack_graphs(_to_port(graphs), **kw)
        assert jb.mxu is None and tb.mxu is None
        for name in _GB_FIELDS:
            want, got = getattr(jb, name), getattr(tb, name)
            if want is None:
                assert got is None, name
                continue
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)


# ------------------------------------------------------------ import isolation

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dgn_tpu")


def _forbidden_imports(path: Path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            if m.split(".")[0] in _FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}:{node.lineno} {m}")
    return bad


@pytest.mark.parametrize("target", ["dgn_tpu_torch", "chip_smoke.py"])
def test_port_imports_no_jax(target):
    paths = ([REPO / target] if target.endswith(".py")
             else sorted((REPO / target).rglob("*.py")))
    assert paths and all(p.exists() for p in paths)
    bad = [b for p in paths for b in _forbidden_imports(p)]
    assert not bad, bad
