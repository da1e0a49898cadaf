"""The port's native packer (dgn_tpu_torch/runtime) == its numpy paths
== dgn_tpu's numpy paths, with ==, under both layouts.

The port's ctypes binding of its own runtime/packer.cpp, built with g++
into dgn_tpu_torch/_build/ (never dgn_tpu/runtime/_build), against
`pack_graphs(native=False)` of both packages for the generators of
tests/test_native_packer.py:22-32 (the synthetic ZINC, SBM, superpixel
and ogbg-mol graphs), plus edge features, positional encodings and node
labels; overflow raises ValueError; an edge-free batch packs; a failed
build logs one warning, leaves `native=None` on the numpy path and makes
`native=True` raise.

The block layout (dgn_pack_block): every GraphBatch field and every
MXULayout array of the native pack == the numpy pack == dgn_tpu's
`pack_graphs(mxu_layout=True)` (whose layout lacks the adjacency kernel's
walk), dtypes included, on ZINC-like batches at the loader's and at
loose pads, the 150-node SBM batch, superpixels, ogbg-mol with NaN
labels, edge-free graphs, trailing all-pad chunks, 128 and 129 graphs,
from the list of graphs and from rows of a dataset's GraphTable (which a
dataset whose graphs disagree on a field's dtype or width does not get);
node, graph, edge and pair overflow raise ValueError on both paths; a
tight loader escapes on the same batches either way; the counters
`pack.native` and `pack.numpy` count the block batches each path packs.
"""
from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from test_torch_pack import _GB_FIELDS, _assert_same_batch, _to_port

from dgn_tpu import graph as jgraph
from dgn_tpu.data import synthetic as jsyn

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch import observe
from dgn_tpu_torch import runtime
from dgn_tpu_torch.data import synthetic as tsyn
from dgn_tpu_torch.data.loader import BatchLoader
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


# ------------------------------------------------------------ block layout


def _assert_same_layout(want, got):
    """Every MXULayout field, the adjacency kernel's walk included."""
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, torch.Tensor):
            a, b = a.numpy(), b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (
                f.name, a.dtype, b.dtype, a.shape, b.shape)
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)


def _block_case(case):
    """(dgn_tpu's graphs, pack keywords) of one parity case."""
    if case in ("zinc_loader_pads", "zinc_loose_pads"):
        graphs = jsyn.synthetic_zinc(48, seed=7)
        for g in graphs:             # edge features and pos_enc too
            g.edge_feat = np.arange(g.num_edges, dtype=np.int32) % 3 + 1
            g.pos_enc = g.eig[:, 1:4]
        graphs = sorted(graphs, key=lambda g: -g.num_nodes)
        if case == "zinc_loose_pads":
            return graphs, {}
        tl = BatchLoader(_to_port(graphs), batch_size=48, shuffle=True,
                         layout="mxu", geometry="typical")
        return graphs, dict(n_pad=tl.n_pad, e_pad=tl.e_pad, g_pad=tl.g_pad,
                            n_pairs_pad=tl.pair_pad)
    if case == "sbm_multiblock":
        return jsyn.synthetic_sbm(4, seed=11, nodes=150), {}
    if case == "superpixels":
        return jsyn.synthetic_superpixels(6, seed=2), {}
    if case == "ogb_mol_nan":
        return jsyn.synthetic_ogb_mol(24, seed=3, n_tasks=128,
                                      nan_frac=0.2), {}
    if case == "no_edges":
        graphs = [jgraph.GraphData(
            num_nodes=n, src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
            node_feat=np.arange(n, dtype=np.int32) % 5,
            eig=np.full((n, 3), 0.5, np.float32),
            edge_feat=np.zeros((0, 2), np.float32),
            label=np.array([float(n)], np.float32)) for n in (3, 1, 7)]
        return graphs, {}
    if case == "trailing_pad_chunks":
        return jsyn.synthetic_zinc(12, seed=4), dict(n_pad=1024, e_pad=4096)
    if case == "graphs_128":
        return jsyn.synthetic_zinc(128, seed=5), {}
    if case == "graphs_129":
        return jsyn.synthetic_zinc(129, seed=6), dict(g_pad=256)
    raise KeyError(case)


BLOCK_CASES = ["zinc_loader_pads", "zinc_loose_pads", "sbm_multiblock",
               "superpixels", "ogb_mol_nan", "no_edges",
               "trailing_pad_chunks", "graphs_128", "graphs_129"]


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_native_block_pack_matches_numpy_and_reference(case):
    graphs, kw = _block_case(case)
    want = jgraph.pack_graphs(graphs, mxu_layout=True, **kw)
    numpy_path = tgraph.pack_graphs(_to_port(graphs), mxu_layout=True,
                                    native=False, **kw)
    native_path = tgraph.pack_graphs(_to_port(graphs), mxu_layout=True,
                                     native=True, **kw)
    auto = tgraph.pack_graphs(_to_port(graphs), mxu_layout=True, **kw)
    table = tgraph.GraphTable.over(_to_port(graphs))     # a loader's table
    rows = table.rows(np.arange(len(graphs)))
    from_table = tgraph.pack_graphs(rows, mxu_layout=True, **kw)
    for got in (numpy_path, native_path, auto, from_table):
        _assert_same_batch(want, got)
        _assert_same_layout(numpy_path.mxu, got.mxu)
    lay = native_path.mxu
    if case == "sbm_multiblock":
        off = lay.pair_src.numpy() != lay.pair_dst.numpy()
        assert np.any(off & lay.pair_covered.numpy())
    if case == "trailing_pad_chunks":
        em = native_path.edge_mask.numpy().reshape(-1, 128)
        assert not em[-1].any() and em[0].any()
    if case in ("graphs_128", "graphs_129"):
        assert lay.n_graph_blocks == (1 if case == "graphs_128" else 2)
        assert len(np.unique(lay.node_chunk_graph.numpy())) == \
            lay.n_graph_blocks


def test_table_rows_pack_as_their_graphs():
    """Rows of a dataset's table, in any order and with another k_eig,
    pack as the list of their graphs; a dataset whose graphs disagree on a
    field's dtype or width gets no table."""
    graphs = tsyn.synthetic_zinc(40, seed=8)
    table = tgraph.GraphTable.over(graphs)
    ids = np.array([7, 3, 31, 0, 12, 39, 3])
    rows = table.rows(ids).by_size()
    batch = sorted([graphs[i] for i in ids], key=lambda g: -g.num_nodes)
    assert [g.num_nodes for g in rows] == [g.num_nodes for g in batch]
    assert all(a is b for a, b in zip(rows, batch))
    for part, kw in ((slice(None), {}), (slice(None), dict(k_eig=3)),
                     (slice(None), dict(n_pad=1024, e_pad=2048, g_pad=128)),
                     (slice(1, None, 2), {})):
        want = tgraph.pack_graphs(batch[part], mxu_layout=True,
                                  native=False, **kw)
        got = tgraph.pack_graphs(rows[part], mxu_layout=True, **kw)
        _assert_same(want, got)
        _assert_same_layout(want.mxu, got.mxu)
    mixed = tsyn.synthetic_zinc(4, seed=8)
    mixed[2].eig = mixed[2].eig[:, :3]
    assert tgraph.GraphTable.over(mixed) is None
    mixed = tsyn.synthetic_zinc(4, seed=8)
    mixed[1].node_feat = mixed[1].node_feat.astype(np.float32)
    assert tgraph.GraphTable.over(mixed) is None


def _overflow_case(kind):
    if kind == "nodes":
        return tsyn.synthetic_zinc(24, seed=1), dict(n_pad=128)
    if kind == "graphs":
        return tsyn.synthetic_zinc(129, seed=1), dict(g_pad=128)
    if kind == "edges":
        return tsyn.synthetic_zinc(24, seed=1), dict(e_pad=128)
    if kind == "pairs":
        return tsyn.synthetic_sbm(4, seed=11, nodes=150), dict(n_pairs_pad=1)
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["nodes", "graphs", "edges", "pairs"])
@pytest.mark.parametrize("path", [False, True])
def test_block_overflow_raises(kind, path):
    graphs, kw = _overflow_case(kind)
    with pytest.raises(ValueError, match="overflow"):
        tgraph.pack_graphs(graphs, mxu_layout=True, native=path, **kw)


def test_native_block_rejects_an_endpoint_outside_its_graph():
    graphs = tsyn.synthetic_zinc(3, seed=1)
    graphs[1].dst = graphs[1].dst.copy()
    graphs[1].dst[0] = graphs[1].num_nodes
    with pytest.raises(ValueError, match="outside its graph"):
        tgraph.pack_graphs(graphs, mxu_layout=True, native=True)


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_tight_loader_escapes_alike_on_both_paths(monkeypatch,
                                                  micro_batches):
    """Under pads cut below the typical geometry, the native path raises
    on exactly the batches numpy raises on: the same escapes, the same
    batches."""
    graphs = tsyn.synthetic_zinc(96, seed=21)
    runs = {}
    for path in (False, True):
        monkeypatch.setattr(runtime, "available", lambda p=path: p)
        loader = BatchLoader(graphs, batch_size=16, shuffle=True, seed=3,
                             layout="mxu", geometry="typical",
                             micro_batches=micro_batches)
        loader.n_pad -= 128
        loader.e_pad -= 256
        runs[path] = ([b for _ in range(2) for b in loader],
                      loader.n_escapes)
    (np_batches, np_escapes), (nat_batches, nat_escapes) = runs[False], \
        runs[True]
    assert 0 < nat_escapes == np_escapes < len(np_batches)
    assert len(nat_batches) == len(np_batches)
    for a, b in zip(np_batches, nat_batches):
        for x, y in (zip(a, b) if micro_batches > 1 else [(a, b)]):
            _assert_same(x, y)
            _assert_same_layout(x.mxu, y.mxu)


def test_block_pack_counts_its_path():
    graphs = tsyn.synthetic_zinc(10, seed=2)
    with observe.tracing():
        observe.reset()
        for _ in range(3):
            tgraph.pack_graphs(graphs, mxu_layout=True)
        tgraph.pack_graphs(graphs, mxu_layout=True, native=False)
        tgraph.pack_graphs(graphs)                        # flat: neither
        with pytest.raises(ValueError):                   # nothing packed
            tgraph.pack_graphs(graphs, mxu_layout=True, n_pad=128)
        counters = dict(observe.RECORDER.counters)
    observe.reset()
    assert counters.get("pack.native") == 3
    assert counters.get("pack.numpy") == 1


def test_failed_build_packs_blocks_with_numpy(tmp_path, monkeypatch, caplog):
    src = tmp_path / "packer.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIB", str(tmp_path / "_build" / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    graphs = tsyn.synthetic_zinc(6, seed=2)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        with observe.tracing():
            observe.reset()
            got = tgraph.pack_graphs(graphs, mxu_layout=True)   # numpy
            got2 = tgraph.pack_graphs(graphs, mxu_layout=True)
            counters = dict(observe.RECORDER.counters)
        observe.reset()
        with pytest.raises(RuntimeError, match="not built"):
            tgraph.pack_graphs(graphs, mxu_layout=True, native=True)
    records = [r for r in caplog.records if r.name == native.__name__]
    assert len(records) == 1 and records[0].levelno == logging.WARNING
    assert "g++" in records[0].getMessage()
    assert counters.get("pack.numpy") == 2 and "pack.native" not in counters
    want = tgraph.pack_graphs(graphs, mxu_layout=True, native=False)
    for b in (got, got2):
        _assert_same(want, b)
        _assert_same_layout(want.mxu, b.mxu)


def test_ogb_molecules_take_the_native_block_pack_in_micro_batches(
        monkeypatch):
    """ogbg-molpcba-like graphs (the benchmark's generator: 9 int32 atom
    columns, 3 bond columns, 128 float32 labels of which about 30 % NaN),
    drawn through a shuffled block loader's GraphTable and micro-batched
    in 2, pack natively, each micro-batch counted as `pack.native`, bit
    for bit as the numpy path packs them; every NaN label survives as
    NaN, where its graph sits."""
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.inputs import ogb_molecules
    spec = {"nodes": [9, 43], "atom_values": 8, "bond_values": 4,
            "tasks": 128, "nan_share": 0.3, "k_eig": 3}
    graphs = [tgraph.GraphData(num_nodes=g.num_nodes, src=g.src, dst=g.dst,
                               node_feat=g.node_feat, eig=g.eig,
                               edge_feat=g.edge_feat, label=g.label)
              for g in ogb_molecules.make(spec, 40, 2**31 + 5, 0)]
    assert graphs[0].node_feat.shape[1] == 9
    assert graphs[0].node_feat.dtype == np.int32
    assert graphs[0].edge_feat.shape[1] == 3
    runs = {}
    for path in (False, True):
        monkeypatch.setattr(runtime, "available", lambda p=path: p)
        loader = BatchLoader(graphs, batch_size=16, shuffle=True, seed=3,
                             layout="mxu", geometry="typical",
                             micro_batches=2)
        assert (loader.table is not None) == path
        with observe.tracing():
            observe.reset()
            batches = list(loader)
            counters = dict(observe.RECORDER.counters)
        observe.reset()
        runs[path] = batches, counters
    (np_batches, np_counts), (nat_batches, nat_counts) = runs[False], \
        runs[True]
    micros = [gb for b in nat_batches for gb in b]
    assert [len(b) for b in nat_batches] == [2, 2, 2]
    assert nat_counts.get("pack.native") == len(micros) == 6
    assert "pack.numpy" not in nat_counts
    assert np_counts.get("pack.numpy") == 6
    for a, b in zip(np_batches, nat_batches):
        for x, y in zip(a, b):
            _assert_same(x, y)
            _assert_same_layout(x.mxu, y.mxu)
    # the labels: each real row is one graph's, NaNs where they were
    want = sorted(tuple(np.where(np.isnan(g.label), -1.0, g.label))
                  for g in graphs)
    got = []
    for gb in micros:
        lab = gb.labels.numpy()
        assert lab.dtype == np.float32 and lab.shape[1] == 128
        assert gb.node_feat.shape[1] == 9 and gb.edge_feat.shape[1] == 3
        got += [tuple(np.where(np.isnan(r), -1.0, r))
                for r in lab[gb.graph_mask.numpy()]]
    assert sorted(got) == want
    assert sum(np.isnan(gb.labels.numpy()).sum() for gb in micros) == \
        sum(np.isnan(g.label).sum() for g in graphs) > 0
