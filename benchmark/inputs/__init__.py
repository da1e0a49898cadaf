"""The benchmark's inputs, made from the seed: every split of a traffic
mix's dataset, by the generator that the mix names.  A generator is the
module benchmark/inputs/<generator>.py with a function
make(spec, count, seed, split) -> [Graph]; a new kind of inputs is a new
file here.  Numpy and scipy only: nothing here imports the program."""
from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import Dict, List

from .graph import Graph

HERE = Path(__file__).resolve().parent
SPLITS = ("train", "val", "test")
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def generator(name: str):
    """The module benchmark/inputs/<name>.py; ValueError where there is no
    such module or it makes no graphs."""
    path = HERE / f"{name}.py"
    if not _NAME.match(str(name)) or not path.is_file():
        raise ValueError(f"no generator {name!r}: the traffic mix names "
                         f"{path.relative_to(HERE.parents[1])}, which does "
                         "not exist")
    mod = importlib.import_module(f"{__name__}.{name}")
    if not callable(getattr(mod, "make", None)):
        raise ValueError(f"benchmark/inputs/{name}.py is no generator: it "
                         "has no make(spec, count, seed, split)")
    return mod


def make_splits(data: Dict, seed: int) -> Dict[str, List[Graph]]:
    """{"train", "val", "test"} -> graphs, for a traffic mix's "data"
    block: {"generator", "graphs": {split: count}, ...generator spec}."""
    gen = generator(data["generator"])
    return {split: gen.make(data, int(data["graphs"][split]), seed, split_id)
            for split_id, split in enumerate(SPLITS)}
