"""The benchmark's inputs, made from the seed: every split of a traffic
mix's dataset, by the generator that the mix names.  Numpy and scipy
only: nothing here imports the program."""
from __future__ import annotations

from typing import Dict, List

from . import molecules, superpixels
from .graph import Graph

GENERATORS = {"molecules": molecules, "superpixels": superpixels}
SPLITS = ("train", "val", "test")


def make_splits(data: Dict, seed: int) -> Dict[str, List[Graph]]:
    """{"train", "val", "test"} -> graphs, for a traffic mix's "data"
    block: {"generator", "graphs": {split: count}, ...generator spec}."""
    gen = GENERATORS[data["generator"]]
    return {split: gen.make(data, int(data["graphs"][split]), seed, split_id)
            for split_id, split in enumerate(SPLITS)}
