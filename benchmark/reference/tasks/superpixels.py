"""MNIST and CIFAR10 superpixels: one class a graph, from float node
features.  The encoder is a linear map of the features; the loss is the
mean cross-entropy over the batch's graphs."""
from __future__ import annotations

import torch


def encoder_spec(meta, f):
    return [("embedding_h.kernel", (meta["in_dim"], f)),
            ("embedding_h.bias", (f,))]


def encode(w, batch, prec):
    return prec.mm(batch.feat, w["embedding_h.kernel"]) + w["embedding_h.bias"]


def n_out(meta):
    return meta["n_classes"]


def loss(scores, batch):
    logp = torch.log_softmax(scores, dim=1)
    return -logp.gather(1, batch.label[:, :1]).mean()


def weight(batch):
    return batch.b


def encoder_flops(meta, f, nodes):
    return 2 * nodes * meta["in_dim"] * f
