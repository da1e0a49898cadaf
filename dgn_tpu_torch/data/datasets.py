"""Dataset registry (counterpart of `dgn_tpu/data/datasets.py`).

Reads the raw files the reference consumes, laid out under `data_dir` as
docs/DATA.md shows, into `GraphData` lists with the same per-dataset
eigenvector conventions as dgn_tpu, array for array:

  ZINC      molecules/{train,val,test}.pickle (+ optional .index): lists of
            benchmarking-gnns molecule dicts (num_atom, atom_type[N],
            bond_type[N, N], logP_SA_cycle_normalized); eig k=6 per
            `lap_norm`; pos_enc = eig[:, 1:P+1] with pos_enc_dim P.
  SBM_*     SBMs/{name}_{train,val,test}.pkl: records with dense W,
            node_feat and node_label; eig k=5.
  MNIST /   superpixels/{mnist_75sp|cifar10_150sp}_{train,test}.pkl:
  CIFAR10   (labels, sp_data) pairs; a gaussian-kernel k-NN(8) graph over
            coordinate and feature distances, eig k=7 on the sym Laplacian
            with the horizontal/vertical axis sort, or [0, x, y] with
            coord_eig; val is the last min(5000, len // 10) train graphs.
  HIV/PCBA  ogbg_mol{hiv,pcba}/raw/*.csv[.gz] and split/scaffold/: each
            bond stored once and both directions materialised, graphs of
            5 nodes or fewer dropped; eig k=4 / k=3.
  COLLAB    ogbl_collab/raw/*.csv[.gz] and split/time/*.pt (or the csv
            fixtures {split}-edge[-neg].csv): one graph of the train
            positives in both directions (`load_collab`).

When `data_dir` holds no dataset files, synthetic splits stand in,
generated exactly as the reference package generates them.  Every eig of
a real file goes through `spectral.EigCache` (`cache_dir`).
"""
from __future__ import annotations

import csv
import dataclasses
import gzip
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import spectral
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


# --------------------------------------------------------------- unpickling

class _Record(dict):
    """Stands in for a pickled record class (benchmarking-gnns' DotDict)
    whose module cannot be imported: items and attributes both land in the
    dict, and read either way.  dgn_tpu's shim (dgn_tpu/data/datasets.py:59)
    raises KeyError('__setstate__') on a record that pickled attributes,
    as a DotDict with `self.__dict__ = self` does; this one reads it."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setstate__(self, state):
        for part in (state if isinstance(state, tuple) else (state,)):
            self.update(part or {})


class _LenientUnpickler(pickle.Unpickler):
    """Resolves the generator scripts' classes without their modules."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _Record


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return _LenientUnpickler(f).load()


def _to_numpy(x):
    if hasattr(x, "detach"):          # torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _field(rec, name: str):
    return rec[name] if isinstance(rec, dict) else getattr(rec, name)


# --------------------------------------------------------------------- ZINC

def _zinc_split(data_dir: str, split: str, k_eig: int, norm: str,
                cache: spectral.EigCache) -> List[GraphData]:
    """One split's molecules, in the order of its .index file when there is
    one (its first row); edges are the nonzeros of the bond matrix, their
    bond type the entries there."""
    data = _load_pickle(os.path.join(data_dir, f"{split}.pickle"))
    index_path = os.path.join(data_dir, f"{split}.index")
    if os.path.exists(index_path):
        with open(index_path) as f:
            idx = [int(c) for c in next(csv.reader(f))]
        data = [data[i] for i in idx]
    out = []
    for mol in data:
        n = int(mol["num_atom"])
        adj = _to_numpy(mol["bond_type"])
        src, dst = np.nonzero(adj)
        bond = adj[src, dst].astype(np.int32)
        src, dst = src.astype(np.int32), dst.astype(np.int32)
        key = ("logP_SA_cycle_normalized" if "logP_SA_cycle_normalized" in mol
               else "logP_SASA_cycle_normalized")
        label = np.array([_to_numpy(mol[key]).reshape(-1)[0]], np.float32)
        out.append(GraphData(
            num_nodes=n, src=src, dst=dst,
            node_feat=_to_numpy(mol["atom_type"]).astype(np.int32),
            eig=cache.get(n, src, dst, k_eig, norm), edge_feat=bond,
            label=label))
    return out


def load_zinc(dp) -> DatasetSplits:
    root = os.path.join(dp.data_dir, "molecules") if dp.data_dir else ""
    k = 6  # molecules.py:199 get_eig(6, norm)
    if root and os.path.exists(os.path.join(root, "train.pickle")):
        cache = spectral.EigCache(dp.cache_dir or None)
        splits = [_zinc_split(root, s, k, dp.lap_norm, cache)
                  for s in ("train", "val", "test")]
    else:
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


# ---------------------------------------------------------------------- SBM

def _sbm_split(path: str, k_eig: int, norm: str,
               cache: spectral.EigCache) -> List[GraphData]:
    """Records as dicts or attribute objects; edges are the nonzeros of the
    dense W."""
    out = []
    for rec in _load_pickle(path):
        W = _to_numpy(_field(rec, "W"))
        feat = _to_numpy(_field(rec, "node_feat")).astype(np.int32)
        lab = _to_numpy(_field(rec, "node_label")).astype(np.int32)
        src, dst = np.nonzero(W)
        src, dst = src.astype(np.int32), dst.astype(np.int32)
        n = len(feat)
        out.append(GraphData(num_nodes=n, src=src, dst=dst, node_feat=feat,
                             eig=cache.get(n, src, dst, k_eig, norm),
                             node_labels=lab,
                             label=np.array([0.0], np.float32)))
    return out


def load_sbm(name: str, dp) -> DatasetSplits:
    """SBM_PATTERN (2 classes) or SBM_CLUSTER (6), k_eig 5; synthetic splits
    of n//4, n//16 and n//16 graphs with seeds 1/2/3 without files."""
    root = os.path.join(dp.data_dir, "SBMs") if dp.data_dir else ""
    k = 5  # SBMs.py:158 _add_eig(5, norm)
    paths = [os.path.join(root, f"{name}_{s}.pkl")
             for s in ("train", "val", "test")]
    if root and all(os.path.exists(p) for p in paths):
        cache = spectral.EigCache(dp.cache_dir or None)
        train, val, test = (_sbm_split(p, k, dp.lap_norm, cache)
                            for p in paths)
    else:
        n_classes = 2 if "PATTERN" in name.upper() else 6
        n = dp.synthetic_size

        def gen(size, seed):
            return synthetic.synthetic_sbm(size, seed=seed,
                                           n_classes=n_classes, k_eig=k,
                                           norm=dp.lap_norm)

        train, val, test = (gen(max(n // 4, 8), 1), gen(max(n // 16, 4), 2),
                            gen(max(n // 16, 4), 3))
    labels = np.concatenate([g.node_labels for g in train])
    feats = np.concatenate([g.node_feat for g in train])
    meta = {"n_classes": int(labels.max()) + 1,
            "num_node_types": max(int(feats.max()) + 1, 2)}
    return DatasetSplits(name, train, val, test, meta=meta)


# -------------------------------------------------------------- superpixels

def _knn_edges(A: np.ndarray, kth: int = 9
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's k-NN selection (compute_edges_list, reference
    data/superpixels.py:50-69), call for call, so the edge sets are the
    same bytes.  For n > 9 it argpartitions each similarity row and slices
    [new_kth:-1]: 8 of the top 9, dropping whichever one introselect leaves
    in the last slot.  A cleaner top-8 would move every real edge set
    (tests/test_reference_parity.py pins the quirk for dgn_tpu)."""
    n = A.shape[0]
    new_kth = n - kth
    if n > 9:
        knns = np.argpartition(A, new_kth - 1, axis=-1)[:, new_kth:-1]
        knn_values = np.partition(A, new_kth - 1, axis=-1)[:, new_kth:-1]
    else:
        # fewer than kth nodes: fully connected minus the self loop
        knns = np.tile(np.arange(n), n).reshape(n, n)
        knn_values = A
        if n != 1:
            keep = knns != np.arange(n)[:, None]
            knn_values = A[keep].reshape(n, -1)
            knns = knns[keep].reshape(n, -1)
    return knns, knn_values


def _gaussian_knn_graph(coord: np.ndarray, feat: np.ndarray, knn: int = 8
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src, dst, weight): the gaussian-kernel adjacency over coordinate and
    feature distances, k-NN sparsified (reference superpixels.py:17-69)."""
    n = coord.shape[0]
    c_dist = np.linalg.norm(coord[:, None] - coord[None, :], axis=-1)
    f_dist = np.linalg.norm(feat[:, None] - feat[None, :], axis=-1)

    def sigma(d):
        # the mean of the knn+1 smallest distances per row; graphs with
        # n <= knn take the reference's ValueError fallback (:17-29)
        if n <= knn:
            return np.ones((n, 1)) + 1e-8
        kn = np.partition(d, knn, axis=-1)[:, knn::-1]
        return kn.sum(1).reshape(n, 1) / knn + 1e-8

    A = np.exp(-(c_dist / sigma(c_dist)) ** 2 - (f_dist / sigma(f_dist)) ** 2)
    A = 0.5 * (A + A.T)
    np.fill_diagonal(A, 0)
    knns, knn_values = _knn_edges(A, kth=knn + 1)
    srcs, dsts, vals = [], [], []
    for i in range(n):
        nbr, v = knns[i], knn_values[i]
        if n != 1:
            keep = nbr != i     # reference g.add_edges(src, dsts[dsts != src])
            nbr, v = nbr[keep], v[keep]
        srcs += [i] * len(nbr)
        dsts += list(nbr)
        vals += list(v)
    return (np.array(srcs, np.int32), np.array(dsts, np.int32),
            np.array(vals, np.float32))


def _sort_eig(feat: np.ndarray, eig: np.ndarray) -> np.ndarray:
    """Swap eig columns 1 and 2 so column 1 follows the image's horizontal
    axis (reference superpixels.py:371-420); the coordinates are the last
    two feature columns."""
    x, y = feat[:, -2], feat[:, -1]

    def scores(v):
        m = v > 0
        return (abs(int(np.sum(np.where(x[m] > 0.5, 1, -1)))),
                abs(int(np.sum(np.where(y[m] > 0.5, 1, -1)))))

    h1, v1 = scores(eig[:, 1])
    h2, v2 = scores(eig[:, 2])
    top = max(h1, v2, v1, h2)
    if h1 == top or v2 == top:
        return eig
    out = eig.copy()
    out[:, 1], out[:, 2] = eig[:, 2], eig[:, 1]
    return out


def _superpix_split(path: str, img_size: int, coord_eig: bool,
                    cache: spectral.EigCache) -> List[GraphData]:
    """(labels, sp_data) -> graphs with node features [mean pixel,
    coordinates / img_size] and the k-NN weights as a 1-wide edge
    feature."""
    labels, sp_data = _load_pickle(path)
    out = []
    for label, sample in zip(labels, sp_data):
        mean_px, coord = sample[:2]
        coord = _to_numpy(coord) / img_size
        n = coord.reshape(-1, 2).shape[0]
        mean_px = _to_numpy(mean_px).reshape(n, -1)
        coord = coord.reshape(n, 2)
        src, dst, w = _gaussian_knn_graph(coord, mean_px)
        feat = np.concatenate([mean_px, coord], axis=1).astype(np.float32)
        if coord_eig:
            eig = np.concatenate([np.zeros((n, 1), np.float32),
                                  coord.astype(np.float32)], axis=1)
        else:
            # positional_encoding(g, 7): always the sym-normalised
            # Laplacian (superpixels.py:352-354)
            eig = _sort_eig(feat, cache.get(n, src, dst, 7, "sym"))
        out.append(GraphData(num_nodes=n, src=src, dst=dst, node_feat=feat,
                             eig=eig, edge_feat=w[:, None],
                             label=np.array(int(label), np.int32)))
    return out


def load_superpixels(name: str, dp) -> DatasetSplits:
    """MNIST (75 nodes, 3 features) or CIFAR10 (150 nodes, 5 features);
    synthetic splits of n, n//10 and n//10 graphs with seeds 1/2/3 without
    files.  `proportion` keeps the leading share of the train split."""
    stem, img_size = {"MNIST": ("mnist_75sp", 28),
                      "CIFAR10": ("cifar10_150sp", 32)}[name.upper()]
    root = os.path.join(dp.data_dir, "superpixels") if dp.data_dir else ""
    tr_path = os.path.join(root, f"{stem}_train.pkl")
    if root and os.path.exists(tr_path):
        cache = spectral.EigCache(dp.cache_dir or None)
        full = _superpix_split(tr_path, img_size, dp.coord_eig, cache)
        test = _superpix_split(os.path.join(root, f"{stem}_test.pkl"),
                               img_size, dp.coord_eig, cache)
        # benchmarking-gnns protocol: the last train graphs become val
        n_val = min(5000, max(len(full) // 10, 1))
        train, val = full[:-n_val], full[-n_val:]
    else:
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


# ----------------------------------------------------------------- OGB raw

def _read_csv(path: str, dtype=np.int64) -> np.ndarray:
    """A headerless numeric csv(.gz) of OGB's raw layout; with float32 an
    empty field is NaN."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        rows = list(csv.reader(f))
    if dtype is np.float32:
        return np.array([[np.nan if c == "" else float(c) for c in r]
                         for r in rows], np.float32)
    return np.array([[int(c) for c in r] for r in rows], dtype)


def _find(path_base: str) -> Optional[str]:
    for p in (path_base, path_base + ".gz"):
        if os.path.exists(p):
            return p
    return None


def _load_ogb_raw(root: str, k_eig: int, norm: str, n_tasks: int,
                  cache: spectral.EigCache) -> Dict[str, List[GraphData]]:
    """The scaffold splits of an ogbg-mol* raw directory; edge features
    only where raw/edge-feat.csv[.gz] exists."""
    raw = os.path.join(root, "raw")

    def read(name, dtype=np.int64):
        return _read_csv(_find(os.path.join(raw, f"{name}.csv")), dtype)

    nn = read("num-node-list").reshape(-1)
    ne = read("num-edge-list").reshape(-1)
    edges = read("edge")
    nfeat = read("node-feat")
    efp = _find(os.path.join(raw, "edge-feat.csv"))
    efeat = _read_csv(efp) if efp else None
    labels = read("graph-label", np.float32)
    n_off = np.concatenate([[0], np.cumsum(nn)])
    e_off = np.concatenate([[0], np.cumsum(ne)])
    split_dir = os.path.join(root, "split", "scaffold")
    out = {}
    for split, fname in (("train", "train"), ("val", "valid"),
                         ("test", "test")):
        idx = _read_csv(_find(os.path.join(split_dir, f"{fname}.csv")))
        gs = []
        for i in idx.reshape(-1):
            n = int(nn[i])
            if n <= 5:     # the reference drops tiny graphs (HIV.py:55-58)
                continue
            e0, e1 = e_off[i], e_off[i + 1]
            s = edges[e0:e1, 0].astype(np.int32)
            d = edges[e0:e1, 1].astype(np.int32)
            # OGB stores each bond once; both directions are materialised
            src, dst = np.concatenate([s, d]), np.concatenate([d, s])
            ef = (np.concatenate([efeat[e0:e1], efeat[e0:e1]]).astype(
                np.int32) if efeat is not None else None)
            gs.append(GraphData(
                num_nodes=n, src=src, dst=dst,
                node_feat=nfeat[n_off[i]:n_off[i + 1]].astype(np.int32),
                eig=cache.get(n, src, dst, k_eig, norm), edge_feat=ef,
                label=labels[i][:n_tasks]))
        out[split] = gs
    return out


def load_ogb(name: str, dp) -> DatasetSplits:
    """ogbg-molhiv (1 task, k_eig 4) or ogbg-molpcba (128 tasks, k_eig 3);
    synthetic splits with seeds 1/2/3 without files (PCBA's with 30 % of
    the labels NaN)."""
    is_hiv = name.upper() == "HIV"
    ogb_name = "ogbg_molhiv" if is_hiv else "ogbg_molpcba"
    k = 4 if is_hiv else 3     # HIV.py:66 / PCBA.py:212
    n_tasks = 1 if is_hiv else 128
    root = os.path.join(dp.data_dir, ogb_name) if dp.data_dir else ""
    if root and os.path.exists(os.path.join(root, "raw")):
        splits = _load_ogb_raw(root, k, dp.lap_norm, n_tasks,
                               spectral.EigCache(dp.cache_dir or None))
        train, val, test = splits["train"], splits["val"], splits["test"]
    else:
        n = dp.synthetic_size

        def gen(size, seed):
            return synthetic.synthetic_ogb_mol(
                size, seed=seed, n_tasks=n_tasks, k_eig=k, norm=dp.lap_norm,
                nan_frac=0.0 if is_hiv else 0.3)

        train, val, test = (gen(n, 1), gen(max(n // 10, 16), 2),
                            gen(max(n // 10, 16), 3))
    return DatasetSplits(name, train, val, test, meta={"n_tasks": n_tasks})


# -------------------------------------------------------------- ogbl-collab

def _collab_split(split_dir: str, name: str) -> Dict[str, np.ndarray]:
    """split/time/{name}.pt (OGB's dict of tensors: 'edge' and, for valid
    and test, 'edge_neg'), else the csv fixtures {name}-edge.csv and
    {name}-edge-neg.csv."""
    pt = os.path.join(split_dir, f"{name}.pt")
    if os.path.exists(pt):
        import torch
        d = torch.load(pt, map_location="cpu", weights_only=True)
        return {k: _to_numpy(v) for k, v in d.items()}
    out = {"edge": _read_csv(
        _find(os.path.join(split_dir, f"{name}-edge.csv")))}
    neg = _find(os.path.join(split_dir, f"{name}-edge-neg.csv"))
    if neg:
        out["edge_neg"] = _read_csv(neg)
    return out


def load_collab(dp, k_eig: int = 3):
    """ogbl-collab link prediction: (one GraphData, edge splits, meta).

    With ogbl_collab/raw under data_dir: the node count and float node
    features from raw/, the splits from split/time/, and the graph of the
    train positives in both directions (the OGB protocol, reference
    train/train_COLLAB_edge_classification.py:44-52).  Without: the
    synthetic community graph of max(synthetic_size, 128) nodes, seed 1.
    splits maps train/valid/test to positive [K, 2] int32 edges and
    valid_neg/test_neg to the fixed negatives; meta holds in_dim (the
    float node feature width) and num_nodes."""
    root = os.path.join(dp.data_dir, "ogbl_collab") if dp.data_dir else ""
    if root and os.path.exists(os.path.join(root, "raw")):
        raw = os.path.join(root, "raw")
        n = int(_read_csv(_find(os.path.join(raw, "num-node-list.csv"))
                          ).reshape(-1)[0])
        nfeat = _read_csv(_find(os.path.join(raw, "node-feat.csv")),
                          np.float32)
        split_dir = os.path.join(root, "split", "time")
        tr, va, te = (_collab_split(split_dir, s)
                      for s in ("train", "valid", "test"))
        pos = tr["edge"].astype(np.int64)
        src = np.concatenate([pos[:, 0], pos[:, 1]]).astype(np.int32)
        dst = np.concatenate([pos[:, 1], pos[:, 0]]).astype(np.int32)
        eig = spectral.EigCache(dp.cache_dir or None).get(
            n, src, dst, k_eig, dp.lap_norm)
        g = GraphData(num_nodes=n, src=src, dst=dst, node_feat=nfeat,
                      eig=eig, label=np.zeros(1, np.float32))
        splits = {"train": pos.astype(np.int32),
                  "valid": va["edge"].astype(np.int32),
                  "valid_neg": va["edge_neg"].astype(np.int32),
                  "test": te["edge"].astype(np.int32),
                  "test_neg": te["edge_neg"].astype(np.int32)}
    else:
        g, splits = synthetic.synthetic_collab(
            num_nodes=max(dp.synthetic_size, 128), seed=1, k_eig=k_eig)
    return g, splits, {"in_dim": g.node_feat.shape[-1],
                       "num_nodes": g.num_nodes}


# ----------------------------------------------------------------- registry

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
    raise ValueError(f"unknown dataset {name!r}")
