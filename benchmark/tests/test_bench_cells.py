"""BENCHMARK.json against its required shape, and every cell found from
its files alone."""
import importlib.util
import json
import os
import re
import shutil
import subprocess
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


def _run_copied_toy(copy_root, name):
    """A toy run of name from the benchmark copied under copy_root (the
    program from this repository), in a process of its own."""
    script = ("import sys\n"
              f"sys.path[:0] = [{str(copy_root)!r}, "
              f"{str(copy_root / 'benchmark' / 'tests')!r}]\n"
              "import benchmark\n"
              f"assert benchmark.__file__.startswith({str(copy_root)!r})\n"
              "from bench_toy import run_toy\n"
              f"print(run_toy({name!r})['correct'])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", script], cwd=copy_root,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_a_cell_of_a_new_task_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark without superpixels' generator and task
    file refuses the cifar10-block toy, naming the missing file; with the
    generator back, it names the task file; with both back it runs
    correct, and no other file changed."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "benchmark"
    files = ["inputs/superpixels.py", "reference/tasks/superpixels.py"]
    for f in files:
        (bench / f).unlink()
    p = _run_copied_toy(tmp_path, "cifar10-block")
    assert p.returncode != 0 and not p.stdout.strip()
    assert "no generator 'superpixels'" in p.stderr, p.stderr[-2000:]
    assert "benchmark/inputs/superpixels.py" in p.stderr
    shutil.copy(ROOT / "benchmark" / files[0], bench / files[0])
    p = _run_copied_toy(tmp_path, "cifar10-block")
    assert p.returncode != 0 and not p.stdout.strip()
    assert "task 'superpixels' has no reference" in p.stderr, \
        p.stderr[-2000:]
    assert "benchmark/reference/tasks/superpixels.py" in p.stderr
    shutil.copy(ROOT / "benchmark" / files[1], bench / files[1])
    p = _run_copied_toy(tmp_path, "cifar10-block")
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "True"
    copied = sorted(f.relative_to(bench) for f in bench.rglob("*")
                    if f.is_file() and "__pycache__" not in f.parts)
    assert copied == sorted(
        f.relative_to(ROOT / "benchmark")
        for f in (ROOT / "benchmark").rglob("*")
        if f.is_file() and "__pycache__" not in f.parts)
    for f in copied:
        assert (bench / f).read_bytes() == \
            (ROOT / "benchmark" / f).read_bytes(), f
