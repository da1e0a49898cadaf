"""The port's native packer (dgn_tpu_torch/runtime) == its numpy flat path
== dgn_tpu's numpy flat path, with ==.

The port's ctypes binding of its own runtime/packer.cpp, built with g++
into dgn_tpu_torch/_build/ (never dgn_tpu/runtime/_build), against
`pack_graphs(native=False)` of both packages for the generators of
tests/test_native_packer.py:22-32 (the synthetic ZINC, SBM, superpixel
and ogbg-mol graphs), plus edge features, positional encodings and node
labels; overflow raises ValueError; an edge-free batch packs; a failed
build logs one warning, leaves `native=None` on the numpy path and makes
`native=True` raise.
"""
from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from test_torch_pack import _GB_FIELDS

from dgn_tpu import graph as jgraph
from dgn_tpu.data import synthetic as jsyn

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch.data import synthetic as tsyn
from dgn_tpu_torch.runtime import native

torch.set_num_threads(1)

PADS = dict(n_pad=2048, e_pad=16384, g_pad=16)


def _assert_same(want, got):
    for name in _GB_FIELDS:
        a, b = getattr(want, name), getattr(got, name)
        if a is None:
            assert b is None, name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_library_builds_into_the_ports_build_directory():
    assert native.available()
    here = os.path.dirname(os.path.abspath(tgraph.__file__))
    assert os.path.dirname(native._LIB) == os.path.join(here, "_build")
    assert os.path.isfile(native._LIB)
    assert native._SRC == os.path.join(here, "runtime", "packer.cpp")


@pytest.mark.parametrize("gen,kw", [
    ("synthetic_zinc", {}),
    ("synthetic_sbm", {}),
    ("synthetic_superpixels", {}),
    ("synthetic_ogb_mol", dict(n_tasks=128, nan_frac=0.2))])
def test_native_matches_numpy_and_reference(gen, kw):
    graphs = getattr(tsyn, gen)(10, seed=3, **kw)
    assert all(np.array_equal(a.src, b.src) for a, b in
               zip(graphs, getattr(jsyn, gen)(10, seed=3, **kw)))
    if gen == "synthetic_zinc":          # edge features and pos_enc too
        for g in graphs:
            g.edge_feat = np.arange(g.num_edges, dtype=np.int32) % 3 + 1
            g.pos_enc = g.eig[:, 1:4]
    want = jgraph.pack_graphs(
        [jgraph.GraphData(**dataclasses.asdict(g)) for g in graphs],
        native=False, **PADS)
    numpy_path = tgraph.pack_graphs(graphs, native=False, **PADS)
    native_path = tgraph.pack_graphs(graphs, native=True, **PADS)
    auto = tgraph.pack_graphs(graphs, **PADS)
    for got in (numpy_path, native_path, auto):
        _assert_same(want, got)


def test_native_exact_pads():
    """Default pads (the exact totals: no pad node, no pad edge)."""
    graphs = tsyn.synthetic_zinc(40, seed=5)
    _assert_same(tgraph.pack_graphs(graphs, native=False),
                 tgraph.pack_graphs(graphs, native=True))


def test_native_overflow_raises():
    graphs = tsyn.synthetic_zinc(4, seed=1)
    with pytest.raises(ValueError, match="overflow"):
        tgraph.pack_graphs(graphs, n_pad=8, e_pad=8, native=True)
    n = np.array([g.num_nodes for g in graphs])
    e = np.array([g.num_edges for g in graphs])
    src = np.concatenate([g.src for g in graphs])
    dst = np.concatenate([g.dst for g in graphs])
    with pytest.raises(ValueError, match="overflow"):
        native.pack_edges(n, e, src, dst, 8, 8, 4)
    bad = dst.copy()
    bad[0] = n[0]                         # past the end of graph 0
    with pytest.raises(ValueError, match="outside its graph"):
        native.pack_edges(n, e, src, bad, 4096, 4096, 4)


@pytest.mark.parametrize("edge_feat", [False, True])
def test_native_empty_edge_batch(edge_feat):
    g = tgraph.GraphData(num_nodes=3, src=np.zeros(0, np.int32),
                         dst=np.zeros(0, np.int32),
                         node_feat=np.zeros(3, np.int32),
                         eig=np.zeros((3, 2), np.float32),
                         edge_feat=(np.zeros((0, 2), np.float32)
                                    if edge_feat else None),
                         label=np.array([0.0], np.float32))
    want = jgraph.pack_graphs([jgraph.GraphData(**dataclasses.asdict(g))],
                              n_pad=8, e_pad=4, native=False)
    for path in (False, True):
        _assert_same(want, tgraph.pack_graphs([g], n_pad=8, e_pad=4,
                                              native=path))


def test_failed_build_warns_once_and_packs_with_numpy(tmp_path, monkeypatch,
                                                      caplog):
    src = tmp_path / "packer.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIB", str(tmp_path / "_build" / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    graphs = tsyn.synthetic_zinc(6, seed=2)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available()
        got = tgraph.pack_graphs(graphs)          # native=None: numpy
        with pytest.raises(RuntimeError, match="not built"):
            tgraph.pack_graphs(graphs, native=True)
    records = [r for r in caplog.records if r.name == native.__name__]
    assert len(records) == 1 and records[0].levelno == logging.WARNING
    assert "g++" in records[0].getMessage()
    assert "error" in records[0].getMessage()
    _assert_same(tgraph.pack_graphs(graphs, native=False), got)
