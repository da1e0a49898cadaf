"""The FLOP and byte counts against hand counts, and unchanged by more
padding."""
import numpy as np
import pytest

from bench_toy import SEED
from benchmark import counts
from benchmark.inputs import make_splits

TOY = {"hidden_dim": 4, "L": 1, "type_net": "complex",
       "aggregators": "mean dir1-dx", "scalers": "identity amplification"}


def test_families():
    assert counts.families("mean dir1-dx dir1-av".split()) == \
        ["one", "delta1", "abs1"]
    assert counts.families("mean dir1-dx dir2-dx".split()) == \
        ["one", "delta1", "delta2"]
    assert counts.families("max min dir1-dx sum".split()) == \
        ["delta1", "one"]


def test_train_flops_by_hand():
    # N = 10 nodes, E = 30 edges, G = 2 graphs, F = 4, A = 2, S' = 2
    n, e, g, f = 10, 30, 2, 4
    pretrans = 2 * 2 * n * f * f            # two node products
    edge_sum = e * f
    agg = 2 * e * f * 2
    post = 2 * n * (f + 2 * f * 2) * f      # [h || 2 aggregates x 2 scalers]
    mlp = 2 * g * (4 * 2 + 2 * 1 + 1 * 1)   # 4 -> 2 -> 1 -> 1
    pool = n * f
    want = 3 * (pretrans + post + mlp) + 2 * (edge_sum + agg + pool)
    assert counts.train_flops(TOY, "zinc", {}, n, e, g) == want
    simple = dict(TOY, type_net="simple", scalers="identity")
    want = (3 * (2 * n * (2 * f) * f + mlp)
            + 2 * (2 * e * f * 2 + pool)
            + 2 * (2 * n * 5 * f))          # a linear encoder from 5 inputs
    meta = {"n_classes": 1, "in_dim": 5}
    assert counts.train_flops(simple, "superpixels", meta, n, e, g) == want


def test_train_flops_counts_max_and_min_by_hand():
    # max and min: one comparison forward, one gather backward, per edge
    # and feature; the weighted sums as before
    n, e, g, f = 10, 30, 2, 4
    net = dict(TOY, type_net="simple", scalers="identity",
               aggregators="mean max min dir1-dx")
    mlp = 2 * g * (4 * 2 + 2 * 1 + 1 * 1)
    want = (3 * (2 * n * (4 * f) * f + mlp)
            + 2 * (2 * e * f * 2 + e * f * 2 + n * f))
    assert counts.train_flops(net, "zinc", {}, n, e, g) == want


def _train_flops_before(net, task, meta, nodes, edges, graphs):
    """train_flops as it was before the task files and max/min: the count
    that dgn-zinc and dgn-cifar10 must keep bit for bit."""
    f = net["hidden_dim"]
    n_agg = len(net["aggregators"].split())
    n_scal = len(net["scalers"].split())
    n_scal = n_scal if n_scal > 1 else 1
    complex_ = net["type_net"] == "complex"
    products = 0.0
    sums = 0.0
    for _ in range(net["L"]):
        if complex_:
            products += 2 * 2 * nodes * f * f
            sums += edges * f
        sums += 2 * edges * f * n_agg
        width = (f if complex_ else 0) + n_agg * f * n_scal
        products += 2 * nodes * width * f
    n_out = 1 if task == "zinc" else meta["n_classes"]
    dims = [f, f // 2, f // 4, n_out]
    products += sum(2 * graphs * dims[j] * dims[j + 1] for j in range(3))
    sums += nodes * f
    encoder = 2 * nodes * meta["in_dim"] * f if task == "superpixels" else 0
    return 3 * products + 2 * sums + 2 * encoder


@pytest.mark.parametrize("config,task,traffic", [
    ("dgn-zinc", "zinc", "zinc-block"),
    ("dgn-cifar10", "superpixels", "cifar10-block")])
def test_train_flops_keeps_its_count_bit_for_bit(config, task, traffic):
    import json
    from bench_toy import ROOT
    bench = ROOT / "benchmark"
    net = json.loads((bench / f"configs/{config}.json").read_text())[
        "net_params"]
    meta = json.loads((bench / f"traffic/{traffic}.json").read_text())["meta"]
    for n, e, g in ((10, 30, 2), (2963, 6402, 128), (17, 0, 1),
                    (31872, 66560, 1024), (123457, 987654, 4096)):
        new = counts.train_flops(net, task, meta, n, e, g)
        old = _train_flops_before(net, task, meta, n, e, g)
        assert type(new) is type(old) and new.hex() == old.hex(), (n, e, g)


def test_adjacency_bytes_by_hand():
    # 100 real edges, 3 families: 100 * (12 + 8) in, 2 covered pairs out
    assert counts.adjacency_bytes(100, 2, 3) == \
        100 * 20 + 2 * 3 * 128 * 128 * 4


@pytest.mark.parametrize("mxu", [True, False])
def test_counts_ignore_padding(mxu):
    """The same graphs packed at the loader's tight pads and at far wider
    ones give the same real counts and covered pairs."""
    from benchmark import program
    from dgn_tpu_torch.graph import GraphData, pack_graphs, round_up
    data = {"generator": "molecules", "nodes": [9, 37], "atom_types": 28,
            "bond_types": 4, "k_eig": 6,
            "graphs": {"train": 40, "val": 1, "test": 1}}
    graphs = sorted(make_splits(data, SEED)["train"],
                    key=lambda g: -g.num_nodes)
    gd = [GraphData(num_nodes=g.num_nodes, src=g.src, dst=g.dst,
                    node_feat=g.node_feat, eig=g.eig, label=g.label)
          for g in graphs]
    n = sum(g.num_nodes for g in gd)
    e = sum(g.num_edges for g in gd)
    tight = dict(n_pad=round_up(n + 1, 128) + 1024,
                 e_pad=round_up(e, 128) + 128 * 16, g_pad=128)
    wide = dict(n_pad=tight["n_pad"] + 2048, e_pad=tight["e_pad"] + 8192,
                g_pad=256)
    extra = {"n_pairs_pad": 256} if mxu else {}
    a = pack_graphs(gd, mxu_layout=mxu, **tight, **extra)
    b = pack_graphs(gd, mxu_layout=mxu, **wide, **extra)
    for gb in (a, b):
        assert int(gb.node_mask.sum()) == n and int(gb.edge_mask.sum()) == e
        assert int(gb.graph_mask.sum()) == len(gd)
    net = {"hidden_dim": 45, "L": 4, "type_net": "complex",
           "aggregators": "mean dir1-dx dir1-av",
           "scalers": "identity amplification attenuation"}
    fa = counts.train_flops(net, "zinc", {}, int(a.node_mask.sum()),
                            int(a.edge_mask.sum()), int(a.graph_mask.sum()))
    fb = counts.train_flops(net, "zinc", {}, int(b.node_mask.sum()),
                            int(b.edge_mask.sum()), int(b.graph_mask.sum()))
    assert fa == fb
    if mxu:
        sa, sb = program.block_stats([a]), program.block_stats([b])
        assert sa == sb and sa[0][0] == e
        blocks = {(int(d) // 128, int(s) // 128) for s, d in zip(
            np.concatenate([g.src + o for g, o in zip(gd, _offsets(gd))]),
            np.concatenate([g.dst + o for g, o in zip(gd, _offsets(gd))]))}
        assert sa[0][1] == len(blocks)
    else:
        assert program.block_stats([a]) == []


def _offsets(gd):
    """Next-fit offsets of descending-size graphs in 128-node blocks."""
    out, cur = [], 0
    for g in gd:
        if (cur % 128) + g.num_nodes > 128:
            cur = -(-cur // 128) * 128
        out.append(cur)
        cur += g.num_nodes
    return out
