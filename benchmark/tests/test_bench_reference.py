"""The plain reference: what it imports, its TF32 rounding, and its
agreement with the port at toy size on the CPU."""
import ast

import pytest
import torch

from bench_toy import ROOT, TOY_CELLS, run_toy

BENCH = ROOT / "benchmark"


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


@pytest.mark.parametrize("layout", ["", "flat"])
@pytest.mark.parametrize("name", TOY_CELLS)
def test_reference_matches_the_port_at_toy_size(name, layout):
    r = run_toy(name, layout=layout)
    assert r["correct"], r["check"]
    for k, v in r["check"].items():
        assert v["value"] < 1e-4, (k, v)
    assert r["readings"]["left_out"] == []
