"""BENCHMARK.json against its required shape, and every cell found from
its files alone."""
import importlib.util
import json
import re
import shutil
import sys

import pytest

from bench_toy import CELLS, ROOT
from benchmark import cells, check

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_from_its_files(name):
    c = cells.find(name)
    assert c.config["net_params"] and c.traffic["data"]
    assert set(c.limits) == set(check.NUMBERS)
    names = [m["name"] for m in c.end_to_end + c.per_layer]
    assert "setup_s" in names and len(c.end_to_end) >= 2 and c.per_layer
    for m in names:
        assert cells.reader_path(m).exists(), m


def test_benchmark_json_keeps_its_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for key, keys in allowed.items():
        for entry in SPEC[key]:
            assert set(entry) <= keys, entry
            assert NAME.match(entry["name"]), entry["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in e2e for m in SPEC["per_layer"])
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).exists()
    # a full check of 24 cells fits its day
    r = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark with one more cell: a traffic file, a limits
    file and a BENCHMARK.json entry, and no code changed."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "zinc-block-256", "config": "dgn-zinc",
                              "traffic": "zinc-block-256", "chips": 1,
                              "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = tmp_path / "benchmark"
    traffic = json.loads((bench / "traffic/zinc-block.json").read_text())
    traffic["flags"]["batch_size"] = 256
    (bench / "traffic/zinc-block-256.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits/zinc-block.json",
                bench / "limits/zinc-block-256.json")
    spec_ = importlib.util.spec_from_file_location("copied_cells",
                                                   bench / "cells.py")
    mod = importlib.util.module_from_spec(spec_)
    sys.modules["copied_cells"] = mod      # dataclasses look it up there
    try:
        spec_.loader.exec_module(mod)
        c = mod.find("zinc-block-256")
    finally:
        del sys.modules["copied_cells"]
    assert c.traffic["flags"]["batch_size"] == 256
    assert "adjacency_roofline" not in [m["name"] for m in c.per_layer]
    assert c.config_name == "dgn-zinc" and c.limits
