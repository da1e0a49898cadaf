"""DGN forward pass and loss, per edge, in float32 (or, for the control,
with every matrix product's operands rounded to TF32).

A batch is its graphs laid back to back: node v of graph b is row
offset_b + v.  For an edge e = u -> v and an eig column k,
d_e = eig[u, k] - eig[v, k] and S_k(v) = sum over the edges into v of
|d_e|.  With msg_e the edge's message (h_u for the simple layer, the
linear pretrans of [h_u || h_v] for the complex one) and D(v) v's
in-degree:

  mean       sum_e msg_e / D(v)                         (0 when D(v) = 0)
  max, min   max_e msg_e, min_e msg_e, per feature      (0 when D(v) = 0)
  dir{k}-av  sum_e |d_e| msg_e / (S_k(v) + 1e-8)
  dir{k}-dx  | sum_e d_e (msg_e - h_v) | / (S_k(v) + 1e-8)

The scalers (applied only when more than one is named) multiply the
concatenated aggregates by 1, log(D+1) / avg_log and avg_log / log(D+1)
(0 at D = 0), with avg_log the mean of log(D+1) over the train split's
nodes.  A layer: posttrans over [h || scaled aggregates] (complex) or the
aggregates alone (simple), graph norm (times sqrt(1 / nodes of the
graph)), batch norm over the batch's nodes (biased variance, eps 1e-5),
ReLU, the residual, dropout.  Then the per-graph mean of the nodes and the
readout MLP (Linear, ReLU, Linear, ReLU, Linear at halving widths).

max and min are the published ones (Saro00/DGN nets/aggregators.py: the
max and the min over a node's mailbox of incoming messages), with 0 for a
node with no incoming edge, as dgn_tpu and the port take it (segment max
and min over the real edges); their gradient splits equally among tied
edges, as torch's and XLA's scatter-max do and the port's kernel pair
does.

The encoder, the readout's width and the loss are the task's
(tasks/<task>.py)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import tasks

EPS = 1e-8
BN_EPS = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 stored mantissa bits, nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, forward and backward (the
    backward's two products round theirs too, as cuBLAS's do)."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32(a), tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32(g)
        return rg @ rb.T, ra.T @ rg


class Precision:
    """Matrix products in float32, or on operands rounded to TF32, as a
    tensor core multiplies in TF32 (products of 11-bit mantissas are exact
    in float32, and accumulate in float32)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return _TF32MatMul.apply(a, b)
        return a @ b


def aggregator_names(net: Dict) -> List[str]:
    return net["aggregators"].split()


def scaler_names(net: Dict) -> List[str]:
    return net["scalers"].split()


def param_spec(net: Dict, task: str, meta: Dict) -> List[tuple]:
    """[(name, shape)] of every parameter, named as the program names its
    parameters, for the simple or complex layer (no edge features, no
    positional encoding, one pretrans and one posttrans layer)."""
    f = net["hidden_dim"]
    if net["type_net"] not in ("simple", "complex") \
            or net.get("edge_feat") or net["pretrans_layers"] != 1 \
            or net["posttrans_layers"] != 1 or net["out_dim"] != f:
        raise ValueError("the reference covers the simple and complex "
                         "layers at one width, without edge features")
    n_agg = len(aggregator_names(net))
    n_scal = len(scaler_names(net))
    n_scal = n_scal if n_scal > 1 else 1
    kind = tasks.find(task)
    spec = list(kind.encoder_spec(meta, f))
    n_out = kind.n_out(meta)
    complex_ = net["type_net"] == "complex"
    for i in range(net["L"]):
        p = f"layer_{i}"
        if complex_:
            spec += [(f"{p}.pretrans.kernel", (2 * f, f)),
                     (f"{p}.pretrans.bias", (f,))]
        width = (f if complex_ else 0) + n_agg * f * n_scal
        spec += [(f"{p}.posttrans.kernel", (width, f)),
                 (f"{p}.posttrans.bias", (f,)),
                 (f"{p}.batchnorm_h.scale", (f,)),
                 (f"{p}.batchnorm_h.bias", (f,))]
    dims = [f, f // 2, f // 4, n_out]
    for j in range(3):
        spec += [(f"MLP_layer.Linear_{j}.kernel", (dims[j], dims[j + 1])),
                 (f"MLP_layer.Linear_{j}.bias", (dims[j + 1],))]
    return spec


def avg_log_degree(train_graphs) -> float:
    """mean of log(D + 1) over every node of the train split."""
    d = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                        for g in train_graphs]).astype(np.float64)
    return float(np.mean(np.log(d + 1.0)))


class Batch:
    """Graphs back to back on a device."""

    def __init__(self, graphs: Sequence, device):
        sizes = [g.num_nodes for g in graphs]
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                          device=device)
        self.n = int(sum(sizes))
        self.b = len(graphs)
        self.src = t(np.concatenate([g.src + o for g, o in zip(graphs, offs)]),
                     torch.int64)
        self.dst = t(np.concatenate([g.dst + o for g, o in zip(graphs, offs)]),
                     torch.int64)
        self.graph = t(np.repeat(np.arange(self.b), sizes), torch.int64)
        self.eig = t(np.concatenate([g.eig for g in graphs]), torch.float32)
        feat = np.concatenate([g.node_feat for g in graphs])
        self.feat = t(feat, torch.int64 if feat.dtype.kind in "iu"
                      else torch.float32)
        self.label = t(np.stack([np.asarray(g.label).reshape(-1)
                                 for g in graphs]),
                       torch.float32 if np.asarray(graphs[0].label).dtype.kind
                       == "f" else torch.int64)
        self.sizes = t(sizes, torch.float32)
        self.deg = torch.zeros(self.n, device=device).index_add_(
            0, self.dst, torch.ones_like(self.dst, dtype=torch.float32))

    def to_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """per-edge rows summed into their destination nodes."""
        out = x.new_zeros((self.n,) + tuple(x.shape[1:]))
        return out.index_add_(0, self.dst, x)


def _scaled(agg, batch: Batch, scalers, avg_log):
    if len(scalers) <= 1:
        return agg
    logd = torch.log(batch.deg + 1.0)
    cols = []
    for s in scalers:
        if s == "identity":
            cols.append(agg)
        elif s == "amplification":
            cols.append(agg * (logd / avg_log)[:, None])
        elif s == "attenuation":
            att = torch.where(logd > 0, avg_log / logd.clamp_min(1e-30),
                              torch.zeros_like(logd))
            cols.append(agg * att[:, None])
        else:
            raise ValueError(f"scaler {s!r} has no reference")
    return torch.cat(cols, dim=1)


def _extreme(batch: Batch, msg, reduce: str):
    """Per destination and feature the max ("amax") or min ("amin") of the
    incoming edges' messages, 0 for a node with none.  The rows start at
    -inf / +inf, so no start value joins a tie."""
    start = float("-inf") if reduce == "amax" else float("inf")
    idx = batch.dst[:, None].expand_as(msg)
    out = msg.new_full((batch.n,) + tuple(msg.shape[1:]), start)
    out = out.scatter_reduce(0, idx, msg, reduce, include_self=False)
    return torch.where(batch.deg[:, None] > 0, out, torch.zeros_like(out))


def _aggregate(names, batch: Batch, h, msg):
    """The aggregates of the per-edge messages msg, side by side."""
    outs = []
    hd = h[batch.dst]
    for name in names:
        if name == "mean":
            outs.append(batch.to_nodes(msg) / batch.deg.clamp_min(1.0)[:, None])
            continue
        if name in ("max", "min"):
            outs.append(_extreme(batch, msg, "a" + name))
            continue
        if not name.startswith("dir") or "-" not in name:
            raise ValueError(f"aggregator {name!r} has no reference")
        kind = name.split("-", 1)[1]
        k = int(name.split("-")[0][3:])
        d = batch.eig[batch.src, k] - batch.eig[batch.dst, k]
        s_abs = batch.to_nodes(d.abs())[:, None]
        if kind == "av":
            outs.append(batch.to_nodes(d.abs()[:, None] * msg) / (s_abs + EPS))
        elif kind == "dx":
            outs.append((batch.to_nodes(d[:, None] * (msg - hd))
                         / (s_abs + EPS)).abs())
        else:
            raise ValueError(f"aggregator {name!r} has no reference")
    return torch.cat(outs, dim=1)


def forward(w: Dict[str, torch.Tensor], net: Dict, task: str, batch: Batch,
            avg_log: float, prec: Precision,
            keep: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """[B, n_out] scores in training mode.  keep: one [n, hidden] bool
    mask per layer, the dropout's kept entries (None: no dropout)."""
    h = tasks.find(task).encode(w, batch, prec)
    names, scalers = aggregator_names(net), scaler_names(net)
    snorm = torch.rsqrt(batch.sizes)[batch.graph][:, None]
    rate = net.get("dropout", 0.0)
    for i in range(net["L"]):
        p = f"layer_{i}"
        if net["type_net"] == "complex":
            z = torch.cat([h[batch.src], h[batch.dst]], dim=1)
            msg = prec.mm(z, w[f"{p}.pretrans.kernel"]) + w[f"{p}.pretrans.bias"]
        else:
            msg = h[batch.src]
        agg = _scaled(_aggregate(names, batch, h, msg), batch, scalers,
                      avg_log)
        x = torch.cat([h, agg], dim=1) if net["type_net"] == "complex" \
            else agg
        o = prec.mm(x, w[f"{p}.posttrans.kernel"]) + w[f"{p}.posttrans.bias"]
        if net["graph_norm"]:
            o = o * snorm
        if net["batch_norm"]:
            mu = o.mean(0)
            var = ((o - mu) ** 2).mean(0)
            o = (o - mu) / torch.sqrt(var + BN_EPS) \
                * w[f"{p}.batchnorm_h.scale"] + w[f"{p}.batchnorm_h.bias"]
        o = torch.relu(o)
        if net["residual"]:
            o = h + o
        if keep is not None and rate > 0:
            o = torch.where(keep[i], o / (1.0 - rate), torch.zeros_like(o))
        h = o
    pooled = torch.zeros((batch.b, h.shape[1]), device=h.device).index_add_(
        0, batch.graph, h) / batch.sizes[:, None]
    x = pooled
    for j in range(3):
        x = prec.mm(x, w[f"MLP_layer.Linear_{j}.kernel"]) \
            + w[f"MLP_layer.Linear_{j}.bias"]
        if j < 2:
            x = torch.relu(x)
    return x


def loss(scores: torch.Tensor, batch: Batch, task: str) -> torch.Tensor:
    """The task's loss over the batch (tasks/<task>.py)."""
    return tasks.find(task).loss(scores, batch)


def loss_weight(batch: Batch, task: str) -> float:
    """The task's denominator of one micro-batch's loss."""
    return float(tasks.find(task).weight(batch))


def adam_l2(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
            state: Dict, lr: float, weight_decay: float,
            betas=(0.9, 0.999), eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """One Adam step with L2 (the decay added to the gradient before the
    moments), bias-corrected; returns the gradients as Adam took them."""
    state["t"] = t = state.get("t", 0) + 1
    taken = {}
    for name, p in params.items():
        g = grads[name] + weight_decay * p
        taken[name] = g
        m = state.setdefault(("m", name), torch.zeros_like(p))
        v = state.setdefault(("v", name), torch.zeros_like(p))
        m.mul_(betas[0]).add_((1 - betas[0]) * g)
        v.mul_(betas[1]).add_((1 - betas[1]) * g * g)
        m_hat = m / (1 - betas[0] ** t)
        v_hat = v / (1 - betas[1] ** t)
        params[name] = p - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return taken
