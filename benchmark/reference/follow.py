"""The reference's first training steps, from the benchmark's initial
weights, on the batches the train split's first shuffled epoch holds.

Composition: the train split's indices shuffled once by
numpy.random.default_rng(seed), taken batch_size at a time, as the
loader's documented order gives them (graphs in drawn order; under the
block layout by descending node count, ties in drawn order).

Dropout: the masks are this module's own draws.  A device
torch.Generator seeded with the seed draws, for each step and each layer
in turn, uniforms over the padded [n_pad, hidden] node axis the step's
batch was packed at, and a node keeps an entry where its row's uniform is
below 1 - rate.  `rows` says at which padded row each node sits; it is
the one fact taken from the packed batch, which is where the masks are
indexed, not what they hold."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import dgn


def batch_indices(n_train: int, seed: int, batch_size: int,
                  n_steps: int) -> List[np.ndarray]:
    idx = np.arange(n_train)
    np.random.default_rng(seed).shuffle(idx)
    return [idx[i * batch_size:(i + 1) * batch_size] for i in range(n_steps)]


def in_loader_order(graphs: Sequence, block_layout: bool) -> list:
    graphs = list(graphs)
    if block_layout:
        return sorted(graphs, key=lambda g: -g.num_nodes)
    return graphs


def first_batches(train: Sequence, seed: int, batch_size: int,
                  n_steps: int, block_layout: bool) -> List[list]:
    return [in_loader_order([train[int(j)] for j in b], block_layout)
            for b in batch_indices(len(train), seed, batch_size, n_steps)]


def dropout_keep(gen: torch.Generator, n_pad: int, rows: torch.Tensor,
                 hidden: int, n_layers: int, rate: float
                 ) -> List[torch.Tensor]:
    """One [n, hidden] kept-entries mask per layer, drawn in layer order."""
    out = []
    for _ in range(n_layers):
        u = torch.rand((n_pad, hidden), generator=gen, device=gen.device,
                       dtype=torch.float32)
        out.append(u[rows] < 1.0 - rate)
    return out


def follow(batches: List[list], weights: Dict[str, torch.Tensor], net: Dict,
           task: str, params: Dict, avg_log: float, device,
           precision: str = "float32",
           pads: Optional[List[tuple]] = None, seed: int = 0,
           keep_graphs: Optional[float] = None) -> Dict:
    """Train len(batches) steps from weights; returns each step's loss,
    the first step's gradients as Adam took them, the raw loss gradient of
    the first step, and each parameter's change after the last step.

    pads: per step (n_pad, rows [n] int64), where dropout draws (None
    without dropout).  keep_graphs: a planted fault that keeps the first
    share of each batch's graphs (the mean over the rest) and drops the
    others."""
    prec = dgn.Precision(precision)
    w0 = {k: v.to(device=device, dtype=torch.float32)
          for k, v in weights.items()}
    cur = dict(w0)
    state: Dict = {}
    rate = net.get("dropout", 0.0)
    gen = None
    if rate > 0:
        gen = torch.Generator(device=device).manual_seed(seed)
    out = {"losses": []}
    for step, graphs in enumerate(batches):
        keep = None
        if gen is not None:
            n_pad, rows = pads[step]
            keep = dropout_keep(gen, n_pad, rows.to(device), net["hidden_dim"],
                                net["L"], rate)
        if keep_graphs is not None:
            n_kept = max(1, int(len(graphs) * keep_graphs))
            n_nodes = sum(g.num_nodes for g in graphs[:n_kept])
            graphs = graphs[:n_kept]
            keep = None if keep is None else [k[:n_nodes] for k in keep]
        batch = dgn.Batch(graphs, device)
        leaves = {k: v.detach().requires_grad_(True) for k, v in cur.items()}
        scores = dgn.forward(leaves, net, task, batch, avg_log, prec, keep)
        loss = dgn.loss(scores, batch, task)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))
        out["losses"].append(float(loss.detach()))
        cur = {k: v.detach() for k, v in cur.items()}
        taken = dgn.adam_l2(cur, grads, state, params["init_lr"],
                            params["weight_decay"])
        if step == 0:
            out["grad"] = {k: v.cpu() for k, v in taken.items()}
            out["raw_grad"] = {k: v.cpu() for k, v in grads.items()}
    out["change"] = {k: (cur[k] - w0[k]).cpu() for k in cur}
    return out
