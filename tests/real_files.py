"""Writers of small dataset files in the reference's real layouts.

No dataset file is in the repo, and none is downloaded: the tests and
chip_smoke.py write seeded random data in the layouts docs/DATA.md
describes and the readers of dgn_tpu/data/datasets.py (and the port's
dgn_tpu_torch/data/datasets.py) parse.  Each writer names the layout it
follows.  The contents are random graphs of the datasets' shapes (node
counts, feature widths, label kinds), not the datasets' values.

Imports neither JAX nor either package: numpy, torch (the benchmarking-gnns
pickles hold torch tensors, ogbl-collab's splits are torch.save files) and
the standard library.
"""
from __future__ import annotations

import contextlib
import csv
import gzip
import os
import pickle
import sys
import types
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

SPLITS = ("train", "val", "test")
# ogbg-mol* raw widths: 9 atom and 3 bond feature columns (OGB's
# get_atom_feature_dims / get_bond_feature_dims; values kept below 8 and 4)
ATOM_COLS, BOND_COLS = 9, 3


def molecule_edges(rng: np.random.Generator, n: int) -> np.ndarray:
    """[B, 2] undirected bonds u < v of a connected molecule-like graph: a
    random tree of degree at most 4 plus about n / 8 ring closures."""
    deg = np.zeros(n, np.int64)
    bonds = set()
    for v in range(1, n):
        free = np.nonzero(deg[:v] < 4)[0]
        u = int(rng.choice(free)) if len(free) else int(rng.integers(0, v))
        bonds.add((u, v))
        deg[[u, v]] += 1
    for _ in range(n // 8):
        u, v = sorted(int(x) for x in rng.integers(0, n, 2))
        if u != v and deg[u] < 4 and deg[v] < 4 and (u, v) not in bonds:
            bonds.add((u, v))
            deg[[u, v]] += 1
    return np.array(sorted(bonds), np.int64).reshape(-1, 2)


@contextlib.contextmanager
def _module_gone_after(name: str, **classes):
    """A module `name` that holds `classes` while the block pickles, and is
    gone afterwards: the pickle then names a class no reader can import
    (the generator scripts' DotDict)."""
    mod = types.ModuleType(name)
    for cls_name, cls in classes.items():
        cls.__module__, cls.__qualname__ = name, cls_name
        setattr(mod, cls_name, cls)
    sys.modules[name] = mod
    try:
        yield mod
    finally:
        del sys.modules[name]


def _dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


# --------------------------------------------------------------------- ZINC

def write_zinc(data_dir: str, sizes: Dict[str, int], seed: int = 0,
               index: bool = True,
               label_key: str = "logP_SA_cycle_normalized") -> None:
    """<data_dir>/molecules/{train,val,test}.pickle (+ .index), the layout of
    docs/DATA.md and dgn_tpu/data/datasets.py:88-114: a pickled list of
    benchmarking-gnns molecule dicts {num_atom, atom_type [N] int64 tensor,
    bond_type [N, N] int64 tensor (bond types 1-3, symmetric), label_key
    [1] float32 tensor}.  With index, each pickle holds a quarter more
    molecules than sizes[split] and {split}.index (one csv row) selects
    sizes[split] of them in a shuffled order."""
    rng = np.random.default_rng(seed)
    root = os.path.join(data_dir, "molecules")
    for split in SPLITS:
        n_keep = sizes[split]
        n_all = n_keep + n_keep // 4 if index else n_keep
        mols = []
        for _ in range(n_all):
            n = int(rng.integers(9, 38))
            bonds = molecule_edges(rng, n)
            adj = np.zeros((n, n), np.int64)
            kind = rng.integers(1, 4, size=len(bonds))
            adj[bonds[:, 0], bonds[:, 1]] = kind
            adj[bonds[:, 1], bonds[:, 0]] = kind
            mols.append({
                "num_atom": n,
                "atom_type": torch.from_numpy(rng.integers(0, 28, size=n)),
                "bond_type": torch.from_numpy(adj),
                label_key: torch.tensor([rng.normal()], dtype=torch.float32),
            })
        _dump(os.path.join(root, f"{split}.pickle"), mols)
        if index:
            keep = rng.permutation(n_all)[:n_keep]
            with open(os.path.join(root, f"{split}.index"), "w",
                      newline="") as f:
                csv.writer(f).writerow(keep.tolist())


# ---------------------------------------------------------------------- SBM

class DotDict(dict):
    """benchmarking-gnns' record class: a dict whose items are also its
    attributes (its __dict__ is itself)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.__dict__ = self


class PlainRecord(dict):
    """A dict subclass without instance attributes."""


class AttrRecord:
    """A record whose fields are attributes only."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


RECORDS = {"dict": dict, "dotdict": DotDict, "plain": PlainRecord,
           "attr": AttrRecord}


def write_sbm(data_dir: str, name: str, sizes: Dict[str, int],
              seed: int = 0, records: str = "dict", nodes: int = 117,
              torch_tensors: bool = True) -> None:
    """<data_dir>/SBMs/{name}_{train,val,test}.pkl, the layout of
    docs/DATA.md and dgn_tpu/data/datasets.py:145-164: a pickled list of
    records with W (dense [N, N] 0/1 uint8 numpy, symmetric, no self
    loop), node_feat ([N] ints in 0-2) and node_label ([N] 0/1: the planted
    pattern's nodes), int64 torch tensors where torch_tensors.  PATTERN-like:
    three background blocks (p 0.5 within, 0.35 across) and a pattern of
    about a sixth of the nodes (p 0.5 within, 0.35 to the rest), N within
    nodes ± 40.  records: "dict", or "dotdict" / "plain" / "attr", the
    RECORDS classes pickled under a module that is then removed."""
    rng = np.random.default_rng(seed)
    cls = RECORDS[records]
    module = (contextlib.nullcontext() if records == "dict" else
              _module_gone_after(f"gen_sbm_{records}", **{cls.__name__: cls}))
    with module:
        for split in SPLITS:
            recs = []
            for _ in range(sizes[split]):
                n = int(rng.integers(nodes - 40, nodes + 40))
                block = rng.integers(0, 3, size=n)
                label = np.zeros(n, np.int64)
                label[rng.permutation(n)[:max(n // 6, 5)]] = 1
                prob = np.where(block[:, None] == block[None, :], 0.5, 0.35)
                pat = label == 1
                prob = np.where(pat[:, None] & pat[None, :], 0.5, prob)
                upper = np.triu(rng.random((n, n)) < prob, k=1)
                W = (upper | upper.T).astype(np.uint8)
                feat = rng.integers(0, 3, size=n)
                if torch_tensors:
                    feat, label = torch.from_numpy(feat), torch.from_numpy(
                        label)
                recs.append(cls(W=W, node_feat=feat, node_label=label))
            _dump(os.path.join(data_dir, "SBMs", f"{name}_{split}.pkl"),
                  recs)


# -------------------------------------------------------------- superpixels

SUPERPIXELS = {"MNIST": ("mnist_75sp", 28, 1), "CIFAR10": ("cifar10_150sp",
                                                          32, 3)}


def write_superpixels(data_dir: str, name: str,
                      node_counts: Dict[str, Sequence[int]],
                      seed: int = 0) -> None:
    """<data_dir>/superpixels/{stem}_{train,test}.pkl, the layout of
    docs/DATA.md and dgn_tpu/data/datasets.py:283-308: a pickled
    (labels, sp_data) pair, labels an int64 array of classes 0-9 and each
    sp_data entry a tuple (mean pixel [N, C] float32 in [0, 1], coordinates
    [N, 2] float32 in pixels, order [N] int64), C = 1 for MNIST and 3 for
    CIFAR10.  node_counts["train"] / ["test"] give each image's superpixel
    count (the reader takes val from the tail of train)."""
    stem, img_size, channels = SUPERPIXELS[name.upper()]
    rng = np.random.default_rng(seed)
    for split in ("train", "test"):
        labels, sp_data = [], []
        for n in node_counts[split]:
            labels.append(int(rng.integers(0, 10)))
            coord = (rng.random((n, 2)) * img_size).astype(np.float32)
            px = rng.random((n, channels)).astype(np.float32)
            sp_data.append((px, coord, rng.permutation(n)))
        _dump(os.path.join(data_dir, "superpixels", f"{stem}_{split}.pkl"),
              (np.array(labels, np.int64), sp_data))


# ----------------------------------------------------------------- OGB raw

def _write_csv(path: str, rows: Iterable[Sequence], gz: bool) -> None:
    """A headerless csv, gzipped where gz (OGB's raw files); NaN becomes an
    empty field."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    opener = gzip.open if gz else open
    with opener(path + (".gz" if gz else ""), "wt", newline="") as f:
        w = csv.writer(f)
        for r in rows:
            w.writerow(["" if isinstance(c, float) and np.isnan(c) else c
                        for c in r])


def write_ogb(data_dir: str, name: str, n_graphs: int, seed: int = 0,
              n_tasks: Optional[int] = None, edge_feat: bool = True,
              gz: bool = True, nan_frac: float = 0.3,
              tiny_every: int = 10) -> Dict[str, np.ndarray]:
    """<data_dir>/ogbg_mol{hiv,pcba}/ in OGB's raw layout (docs/DATA.md,
    dgn_tpu/data/datasets.py:367-410): raw/{num-node-list, num-edge-list,
    edge, node-feat, edge-feat, graph-label}.csv[.gz] (each bond once as
    u, v; 9 atom and 3 bond feature columns; graph-label HIV 0/1, PCBA 128
    columns with empty fields at about nan_frac) and
    split/scaffold/{train,valid,test}.csv[.gz] (80/10/10 of a shuffled
    order).  Every tiny_every-th molecule has 2-5 atoms, which the
    readers drop.  Without edge_feat no edge-feat file is written.
    Returns the split index arrays."""
    is_hiv = name.upper() == "HIV"
    n_tasks = n_tasks or (1 if is_hiv else 128)
    rng = np.random.default_rng(seed)
    root = os.path.join(data_dir, "ogbg_molhiv" if is_hiv else
                        "ogbg_molpcba")
    nn, ne, edges, nfeat, efeat, labels = [], [], [], [], [], []
    for i in range(n_graphs):
        n = (int(rng.integers(2, 6)) if tiny_every and i % tiny_every == 0
             else int(rng.integers(10, 40)))
        bonds = molecule_edges(rng, n)
        nn.append([n])
        ne.append([len(bonds)])
        edges += bonds.tolist()
        nfeat += rng.integers(0, 8, size=(n, ATOM_COLS)).tolist()
        efeat += rng.integers(0, 4, size=(len(bonds), BOND_COLS)).tolist()
        lab = rng.integers(0, 2, size=n_tasks).tolist()
        if not is_hiv:
            lab = [float("nan") if r < nan_frac else c
                   for c, r in zip(lab, rng.random(n_tasks))]
        labels.append(lab)
    raw = os.path.join(root, "raw")
    for fname, rows in (("num-node-list", nn), ("num-edge-list", ne),
                        ("edge", edges), ("node-feat", nfeat),
                        ("graph-label", labels)) + (
            (("edge-feat", efeat),) if edge_feat else ()):
        _write_csv(os.path.join(raw, f"{fname}.csv"), rows, gz)
    order = rng.permutation(n_graphs)
    n_tr, n_va = int(n_graphs * 0.8), int(n_graphs * 0.1)
    split_idx = {"train": order[:n_tr], "valid": order[n_tr:n_tr + n_va],
                 "test": order[n_tr + n_va:]}
    for split, idx in split_idx.items():
        _write_csv(os.path.join(root, "split", "scaffold", f"{split}.csv"),
                   ([int(i)] for i in idx), gz)
    return split_idx


# -------------------------------------------------------------- ogbl-collab

def write_collab(data_dir: str, num_nodes: int, seed: int = 0,
                 split_format: str = "pt", feat_dim: int = 128,
                 avg_deg: int = 8) -> None:
    """<data_dir>/ogbl_collab/ in OGB's layout (docs/DATA.md,
    dgn_tpu/data/datasets.py:435-489): raw/{num-node-list, num-edge-list,
    node-feat, edge}.csv.gz (feat_dim float features per node, as
    ogbl-collab's 128) and, with split_format "pt",
    split/time/{train,valid,test}.pt (torch.save of dicts of tensors:
    'edge' [K, 2] and 'weight', 'year'; valid and test also 'edge_neg'),
    or with "csv" the fixtures {split}-edge.csv and {split}-edge-neg.csv.
    Author communities make held-out edges learnable; 80/10/10 of the
    edges are train/valid/test, each held-out split with as many random
    negatives."""
    rng = np.random.default_rng(seed)
    root = os.path.join(data_dir, "ogbl_collab")
    comm = rng.integers(0, 16, num_nodes)
    und = set()
    while len(und) < num_nodes * avg_deg // 2:
        u = int(rng.integers(0, num_nodes))
        pool = (np.nonzero(comm == comm[u])[0] if rng.random() < 0.8
                else np.arange(num_nodes))
        v = int(rng.choice(pool))
        if u != v:
            und.add((min(u, v), max(u, v)))
    und = np.array(sorted(und), np.int64)
    und = und[rng.permutation(len(und))]
    n_va = len(und) // 10
    pos = {"valid": und[:n_va], "test": und[n_va:2 * n_va],
           "train": und[2 * n_va:]}
    feat = (np.eye(16, feat_dim)[comm] * 0.5
            + rng.normal(0, 0.3, (num_nodes, feat_dim))).astype(np.float32)
    raw = os.path.join(root, "raw")
    _write_csv(os.path.join(raw, "num-node-list.csv"), [[num_nodes]], True)
    _write_csv(os.path.join(raw, "num-edge-list.csv"), [[len(und)]], True)
    _write_csv(os.path.join(raw, "node-feat.csv"), feat.tolist(), True)
    _write_csv(os.path.join(raw, "edge.csv"), und.tolist(), True)
    split_dir = os.path.join(root, "split", "time")
    os.makedirs(split_dir, exist_ok=True)
    for split, edge in pos.items():
        d = {"edge": torch.from_numpy(edge),
             "weight": torch.ones(len(edge), dtype=torch.int64),
             "year": torch.from_numpy(rng.integers(1963, 2018, len(edge)))}
        if split != "train":
            d["edge_neg"] = torch.from_numpy(
                rng.integers(0, num_nodes, (len(edge), 2)))
        if split_format == "pt":
            torch.save(d, os.path.join(split_dir, f"{split}.pt"))
        else:
            _write_csv(os.path.join(split_dir, f"{split}-edge.csv"),
                       d["edge"].tolist(), False)
            if "edge_neg" in d:
                _write_csv(os.path.join(split_dir, f"{split}-edge-neg.csv"),
                           d["edge_neg"].tolist(), False)
