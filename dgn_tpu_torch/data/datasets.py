"""Dataset registry (counterpart of `dgn_tpu/data/datasets.py`).

Only ZINC's synthetic branch is ported: when `data_dir` holds no
`molecules/train.pickle`, three synthetic splits stand in, generated exactly
as the reference package generates them.  A real pickle raises: its reader
waits until a dataset file is available to test it against.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

from ..graph import GraphData
from . import synthetic


@dataclasses.dataclass
class DatasetSplits:
    name: str
    train: List[GraphData]
    val: List[GraphData]
    test: List[GraphData]
    meta: Dict

    @property
    def splits(self):
        return {"train": self.train, "val": self.val, "test": self.test}


def load_zinc(dp) -> DatasetSplits:
    root = os.path.join(dp.data_dir, "molecules") if dp.data_dir else ""
    if root and os.path.exists(os.path.join(root, "train.pickle")):
        raise NotImplementedError("the ZINC pickle reader is not ported yet; "
                                  "leave data_dir empty for synthetic ZINC")
    if dp.pos_enc_dim > 0:
        raise NotImplementedError("pos_enc_dim > 0 is not ported yet")
    k = 6  # molecules.py:199 get_eig(6, norm)
    n = dp.synthetic_size
    return DatasetSplits(
        "ZINC",
        synthetic.synthetic_zinc(n, seed=1, k_eig=k, norm=dp.lap_norm),
        synthetic.synthetic_zinc(max(n // 10, 16), seed=2, k_eig=k,
                                 norm=dp.lap_norm),
        synthetic.synthetic_zinc(max(n // 10, 16), seed=3, k_eig=k,
                                 norm=dp.lap_norm),
        meta={"num_atom_type": 28, "num_bond_type": 4})


def load_dataset(name: str, dp) -> DatasetSplits:
    if name.upper() in ("ZINC", "ZINC-FULL"):
        return load_zinc(dp)
    raise NotImplementedError(f"dataset {name!r} is not ported yet")
