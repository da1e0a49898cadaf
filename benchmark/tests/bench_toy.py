"""Toy-sized copies of the benchmark's cells, for CPU tests: the cell's own
configuration and traffic files with fewer graphs and a batch of 16.
Beside the cells of BENCHMARK.json, the toy cells hold cifar10-block, whose
files stay under benchmark/ while its spread keeps it out of BENCHMARK.json:
the superpixel inputs, the simple layer and dropout stay tested; and
zinc-block-micro, zinc-block with the traffic's flags set to two
micro-batches, dropout 0.3 and the aggregators mean max min dir1-dx
dir1-av, at a batch of 15, so that its micro-batches hold 8 and 7 graphs:
micro-batched steps and the max and min aggregators stay tested."""
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cells  # noqa: E402

CELLS = [w["name"] for w in cells._load(cells.SPEC)["workloads"]]
TOY_SPEC = cells._load(cells.SPEC)
TOY_SPEC["configs"].append({"name": "dgn-cifar10",
                            "file": "benchmark/configs/dgn-cifar10.json"})
TOY_SPEC["workloads"].append({"name": "cifar10-block", "config": "dgn-cifar10",
                              "traffic": "cifar10-block", "chips": 1})
# name: (the cell it varies, the flags laid over its traffic's, the batch)
VARIANTS = {"zinc-block-micro": (
    "zinc-block", {"micro_batches": 2, "dropout": 0.3,
                   "aggregators": "mean max min dir1-dx dir1-av"}, 15)}
TOY_CELLS = CELLS + ["cifar10-block"]
SEED = 2**31 + 11


def toy_cell(name: str, train: int = 48, batch_size: int = 16,
             layout: str = ""):
    """layout, where given, replaces the cell's: the flat layout's batch
    order in the reference stays tested while no cell runs it."""
    base, flags = name, {}
    if name in VARIANTS:
        base, flags, batch_size = VARIANTS[name]
    c = cells.find(base, TOY_SPEC)
    c.name = name
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic["flags"].update(flags)
    if layout:
        c.traffic["flags"]["layout"] = layout
    c.traffic["data"]["graphs"] = {"train": train, "val": 8, "test": 8}
    c.traffic["flags"]["batch_size"] = batch_size
    return c


def run_toy(name: str, seconds: float = 0.5, **kw):
    import torch
    from benchmark import bench
    torch.set_num_threads(2)
    return bench.execute(toy_cell(name, **kw), SEED, seconds, False, "cpu",
                         log=lambda m: None)
