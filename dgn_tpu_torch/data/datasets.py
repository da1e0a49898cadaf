"""Dataset registry (counterpart of `dgn_tpu/data/datasets.py`).

The synthetic branches of ZINC, the SBM datasets (PATTERN, CLUSTER), the
superpixel datasets (MNIST, CIFAR10), ogbg-molhiv/molpcba and ogbl-collab
(`load_collab`) are ported: when `data_dir` holds no dataset files, three
synthetic splits (for COLLAB one graph and its edge splits) stand in,
generated exactly as the reference package generates them.  Real files
raise: their readers wait until a dataset file is available to test them
against.  With pos_enc_dim > 0 ZINC stores pos_enc = eig[:, 1:P+1] per
graph; the other datasets leave the model to slice the batch's eig.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np

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
    k = 6  # molecules.py:199 get_eig(6, norm)
    n = dp.synthetic_size
    splits = [synthetic.synthetic_zinc(size, seed=seed, k_eig=k,
                                       norm=dp.lap_norm)
              for size, seed in ((n, 1), (max(n // 10, 16), 2),
                                 (max(n // 10, 16), 3))]
    if dp.pos_enc_dim > 0:
        # from the eig as loaded, so augmentation never reaches it
        # (reference data/molecules.py:118-121)
        for g in (g for gs in splits for g in gs):
            g.pos_enc = g.eig[:, 1:dp.pos_enc_dim + 1]
    return DatasetSplits("ZINC", *splits,
                         meta={"num_atom_type": 28, "num_bond_type": 4})


def load_sbm(name: str, dp) -> DatasetSplits:
    """SBM_PATTERN (2 classes) or SBM_CLUSTER (6), synthetic splits of
    n//4, n//16 and n//16 graphs with seeds 1/2/3, k_eig 5."""
    root = os.path.join(dp.data_dir, "SBMs") if dp.data_dir else ""
    if root and all(os.path.exists(os.path.join(root, f"{name}_{s}.pkl"))
                    for s in ("train", "val", "test")):
        raise NotImplementedError("the SBM pickle reader is not ported yet; "
                                  f"leave data_dir empty for synthetic {name}")
    k = 5  # SBMs.py:158 _add_eig(5, norm)
    n_classes = 2 if "PATTERN" in name.upper() else 6
    n = dp.synthetic_size

    def gen(size, seed):
        return synthetic.synthetic_sbm(size, seed=seed, n_classes=n_classes,
                                       k_eig=k, norm=dp.lap_norm)

    train = gen(max(n // 4, 8), 1)
    labels = np.concatenate([g.node_labels for g in train])
    feats = np.concatenate([g.node_feat for g in train])
    meta = {"n_classes": int(labels.max()) + 1,
            "num_node_types": max(int(feats.max()) + 1, 2)}
    return DatasetSplits(name, train, gen(max(n // 16, 4), 2),
                         gen(max(n // 16, 4), 3), meta=meta)


def load_superpixels(name: str, dp) -> DatasetSplits:
    """MNIST (75 nodes, 3 features) or CIFAR10 (150 nodes, 5 features)
    superpixels, synthetic splits of n, n//10 and n//10 graphs with seeds
    1/2/3; `proportion` keeps the leading share of the train split."""
    stem = {"MNIST": "mnist_75sp", "CIFAR10": "cifar10_150sp"}[name.upper()]
    root = os.path.join(dp.data_dir, "superpixels") if dp.data_dir else ""
    if root and os.path.exists(os.path.join(root, f"{stem}_train.pkl")):
        raise NotImplementedError(
            "the superpixel pickle reader is not ported yet; leave data_dir "
            f"empty for synthetic {name}")
    mnist = name.upper() == "MNIST"
    n = dp.synthetic_size

    def gen(size, seed):
        return synthetic.synthetic_superpixels(
            size, seed=seed, nodes=75 if mnist else 150,
            feat_dim=3 if mnist else 5, coord_eig=dp.coord_eig)

    train = gen(n, 1)
    val, test = gen(max(n // 10, 8), 2), gen(max(n // 10, 8), 3)
    if dp.proportion < 1.0 - 1e-5:
        train = train[:int(len(train) * dp.proportion)]
    n_classes = int(max(int(g.label) for g in train + val + test)) + 1
    return DatasetSplits(name, train, val, test,
                         meta={"in_dim": train[0].node_feat.shape[-1],
                               "n_classes": n_classes, "edge_dim": 1})


def load_ogb(name: str, dp) -> DatasetSplits:
    """ogbg-molhiv (1 task, k_eig 4) or ogbg-molpcba (128 tasks, k_eig 3,
    30 % of the labels NaN), synthetic splits with seeds 1/2/3."""
    is_hiv = name.upper() == "HIV"
    ogb_name = "ogbg_molhiv" if is_hiv else "ogbg_molpcba"
    root = os.path.join(dp.data_dir, ogb_name) if dp.data_dir else ""
    if root and os.path.exists(os.path.join(root, "raw")):
        raise NotImplementedError("the OGB csv reader is not ported yet; "
                                  f"leave data_dir empty for synthetic {name}")
    k = 4 if is_hiv else 3     # HIV.py:66 / PCBA.py:212
    n_tasks = 1 if is_hiv else 128
    n = dp.synthetic_size

    def gen(size, seed):
        return synthetic.synthetic_ogb_mol(
            size, seed=seed, n_tasks=n_tasks, k_eig=k, norm=dp.lap_norm,
            nan_frac=0.0 if is_hiv else 0.3)

    return DatasetSplits(name, gen(n, 1), gen(max(n // 10, 16), 2),
                         gen(max(n // 10, 16), 3),
                         meta={"n_tasks": n_tasks})


def load_collab(dp, k_eig: int = 3):
    """ogbl-collab link prediction: (one GraphData, edge splits, meta).  The
    synthetic community graph of max(synthetic_size, 128) nodes, seed 1;
    splits map train/valid/test to positive [K, 2] edges and
    valid_neg/test_neg to fixed negatives; meta holds in_dim (the float
    node feature width) and num_nodes."""
    root = os.path.join(dp.data_dir, "ogbl_collab") if dp.data_dir else ""
    if root and os.path.exists(os.path.join(root, "raw")):
        raise NotImplementedError("the ogbl-collab reader is not ported yet; "
                                  "leave data_dir empty for synthetic COLLAB")
    g, splits = synthetic.synthetic_collab(
        num_nodes=max(dp.synthetic_size, 128), seed=1, k_eig=k_eig)
    return g, splits, {"in_dim": g.node_feat.shape[-1],
                       "num_nodes": g.num_nodes}


def load_dataset(name: str, dp) -> DatasetSplits:
    u = name.upper()
    if u in ("ZINC", "ZINC-FULL"):
        return load_zinc(dp)
    if u.startswith("SBM"):
        return load_sbm(u, dp)
    if u in ("MNIST", "CIFAR10"):
        return load_superpixels(u, dp)
    if u in ("HIV", "PCBA"):
        return load_ogb(name, dp)
    raise NotImplementedError(f"dataset {name!r} is not ported yet")
