"""The plain reference: what it imports, its TF32 rounding, and its
agreement with the port at toy size on the CPU."""
import ast
import types

import pytest
import torch

from bench_toy import ROOT, TOY_CELLS, run_toy

BENCH = ROOT / "benchmark"
# every toy cell in both layouts, and the micro-batched variant of zinc-block
CASES = [(name, layout) for name in TOY_CELLS + ["zinc-block-micro"]
         for layout in ("", "flat")]


def _top_imports(path):
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(((node.module or "").split(".")[0], node.lineno))
    return out


@pytest.mark.parametrize("part", ["reference", "inputs"])
def test_reference_and_inputs_import_nothing_of_the_program(part):
    bad = [f"{p.relative_to(ROOT)}:{line} {m}"
           for p in sorted((BENCH / part).rglob("*.py"))
           for m, line in _top_imports(p)
           if m in ("jax", "jaxlib", "flax", "dgn_tpu", "dgn_tpu_torch")]
    assert not bad, bad


def test_harness_imports_no_jax():
    """Whole top-level names: dgn_tpu_torch is the program, dgn_tpu not."""
    bad = [f"{p.relative_to(ROOT)}:{line} {m}"
           for p in sorted(BENCH.rglob("*.py"))
           for m, line in _top_imports(p)
           if m in ("jax", "jaxlib", "flax", "dgn_tpu")]
    assert not bad, bad


def test_tf32_rounding():
    from benchmark.reference.dgn import tf32
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 2.0 ** -12, -3.0 - 2.0 ** -12])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                         -3.0])
    assert torch.equal(tf32(x), want)


def test_max_and_min_by_hand():
    """Per destination and feature the max and min of the incoming
    messages, 0 for a node with none; a tie splits the gradient."""
    import numpy as np
    from benchmark.inputs.graph import Graph
    from benchmark.reference import dgn
    # node 0 <- 1, 2 (a tie in feature 0); node 1 <- 2; node 2 has none
    g = Graph(num_nodes=3, src=np.array([1, 2, 2]), dst=np.array([0, 0, 1]),
              node_feat=np.zeros(3, np.int32), eig=np.zeros((3, 2), np.float32),
              edge_feat=None, label=np.zeros(1, np.float32))
    batch = dgn.Batch([g], "cpu")
    msg = torch.tensor([[2.0, -1.0], [2.0, 3.0], [-4.0, 5.0]],
                       requires_grad=True)
    out = dgn._aggregate(["max", "min"], batch, torch.zeros(3, 2), msg)
    assert torch.equal(out.detach(), torch.tensor([
        [2.0, 3.0, 2.0, -1.0], [-4.0, 5.0, -4.0, 5.0], [0.0, 0.0, 0.0, 0.0]]))
    out[0, 0].backward()
    assert torch.equal(msg.grad, torch.tensor([[0.5, 0.0], [0.5, 0.0],
                                               [0.0, 0.0]]))


def test_micro_batch_count_follows_the_configuration():
    from benchmark.reference.follow import first_batches, micro_batch_count
    assert [micro_batch_count("auto", b) for b in (128, 1024, 1025, 2048)] \
        == [1, 1, 2, 2]
    assert micro_batch_count(3, 16) == 3 and micro_batch_count("2", 16) == 2
    sized = [types.SimpleNamespace(num_nodes=n) for n in range(10, 30)]
    steps = first_batches(sized, 7, 5, 2, True, micro_batches=2)
    for step in steps:
        # descending size, then dealt round-robin: 3 graphs and 2
        assert isinstance(step, tuple) and [len(p) for p in step] == [3, 2]
        merged = sorted(step[0] + step[1], key=lambda g: -g.num_nodes)
        assert step[0] == merged[0::2] and step[1] == merged[1::2]
    assert isinstance(first_batches(sized, 7, 5, 2, True)[0], list)


@pytest.mark.parametrize("name,layout", CASES)
def test_reference_matches_the_port_at_toy_size(name, layout):
    r = run_toy(name, layout=layout)
    assert r["correct"], r["check"]
    for k, v in r["check"].items():
        assert v["value"] < 1e-4, (k, v)
    assert r["readings"]["left_out"] == []
