"""ogbg-molpcba: 128 binary tasks a graph, most of them unlabeled, from 9
integer atom columns (the DGN paper's PCBA net, Saro00/DGN
realworld_benchmark/nets/PCBA_graph_classification/dgn_net.py, and its
train_PCBA_graph_classification.py).

The encoder is OGB's AtomEncoder: one embedding table a column, at OGB's
full_atom_feature_dims, the node state the sum of the 9 rows its columns
pick, column 0 first.  The readout is 128 wide.  The loss is binary
cross-entropy with logits over the labeled (graph, task) entries, a NaN
label marking an unlabeled one, averaged over the labeled entries; a
micro-batch's weight is its count of them, so that K micro-batches weigh
as one batch of all their graphs.

Departures from the published description: a column's value indexes its
table as it is (OGB's encoder does too; the program clamps it into the
table, which the benchmark's inputs never need); the BCE is written in
its plain stable form (max(z, 0) - z y + log(1 + exp(-|z|))), where the
published train script calls torch.nn.BCEWithLogitsLoss on the labeled
entries, which computes the same terms; logits are not clipped."""
from __future__ import annotations

import torch

# OGB full_atom_feature_dims (ogb.utils.features)
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)


def encoder_spec(meta, f):
    return [(f"embedding_h.atom.emb_{i}", (d, f))
            for i, d in enumerate(ATOM_FEATURE_DIMS)]


def encode(w, batch, prec):
    x = batch.feat
    out = w["embedding_h.atom.emb_0"][x[:, 0]]
    for i in range(1, len(ATOM_FEATURE_DIMS)):
        out = out + w[f"embedding_h.atom.emb_{i}"][x[:, i]]
    return out


def n_out(meta):
    return meta["n_tasks"]


def loss(scores, batch):
    y = batch.label
    labeled = y == y
    z = scores[labeled]
    t = y[labeled]
    terms = z.clamp_min(0.0) - z * t + torch.log1p(torch.exp(-z.abs()))
    return terms.sum() / max(int(labeled.sum()), 1)


def weight(batch):
    y = batch.label
    return int((y == y).sum())


def encoder_flops(meta, f, nodes):
    return 0                    # table lookups and their sum: no product
