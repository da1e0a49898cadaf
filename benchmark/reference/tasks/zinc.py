"""ZINC: one regression target a graph, from integer atom types.  The
encoder is an embedding table over the atom types; the loss is the mean
absolute error over the batch's graphs."""
from __future__ import annotations


def encoder_spec(meta, f):
    return [("embedding_h.embedding", (meta["num_atom_type"], f))]


def encode(w, batch, prec):
    return w["embedding_h.embedding"][batch.feat]


def n_out(meta):
    return 1


def loss(scores, batch):
    return (scores[:, 0] - batch.label[:, 0]).abs().mean()


def weight(batch):
    return batch.b


def encoder_flops(meta, f, nodes):
    return 0                    # a table lookup
