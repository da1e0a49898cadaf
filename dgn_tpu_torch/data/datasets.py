"""Dataset registry (counterpart of `dgn_tpu/data/datasets.py`).

The synthetic branches of ZINC and of ogbg-molhiv/molpcba are ported: when
`data_dir` holds no dataset files, three synthetic splits stand in, generated
exactly as the reference package generates them.  Real files raise: their
readers wait until a dataset file is available to test them against.
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


def load_ogb(name: str, dp) -> DatasetSplits:
    """ogbg-molhiv (1 task, k_eig 4) or ogbg-molpcba (128 tasks, k_eig 3,
    30 % of the labels NaN), synthetic splits with seeds 1/2/3."""
    is_hiv = name.upper() == "HIV"
    ogb_name = "ogbg_molhiv" if is_hiv else "ogbg_molpcba"
    root = os.path.join(dp.data_dir, ogb_name) if dp.data_dir else ""
    if root and os.path.exists(os.path.join(root, "raw")):
        raise NotImplementedError("the OGB csv reader is not ported yet; "
                                  f"leave data_dir empty for synthetic {name}")
    if dp.pos_enc_dim > 0:
        raise NotImplementedError("pos_enc_dim > 0 is not ported yet")
    k = 4 if is_hiv else 3     # HIV.py:66 / PCBA.py:212
    n_tasks = 1 if is_hiv else 128
    n = dp.synthetic_size

    def gen(size, seed):
        return synthetic.synthetic_ogb_mol(
            size, seed=seed, n_tasks=n_tasks, k_eig=k, norm=dp.lap_norm,
            nan_frac=0.0 if is_hiv else 0.3)

    return DatasetSplits(name, gen(n, 1), gen(max(n // 10, 16), 2),
                         gen(max(n // 10, 16), 3), meta={"n_tasks": n_tasks})


def load_dataset(name: str, dp) -> DatasetSplits:
    if name.upper() in ("ZINC", "ZINC-FULL"):
        return load_zinc(dp)
    if name.upper() in ("HIV", "PCBA"):
        return load_ogb(name, dp)
    raise NotImplementedError(f"dataset {name!r} is not ported yet")
