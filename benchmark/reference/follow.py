"""The reference's first training steps, from the benchmark's initial
weights, on the batches the train split's first shuffled epoch holds.

Composition: the train split's indices shuffled once by
numpy.random.default_rng(seed), taken batch_size at a time, as the
loader's documented order gives them (graphs in drawn order; under the
block layout by descending node count, ties in drawn order).

Micro-batches: with K = the configuration's micro_batches ("auto":
ceil(batch_size / 1024), as dgn_tpu_torch.config documents it) above 1,
a step is a tuple of K micro-batches, the batch's graphs in that order
dealt round-robin (graph i to micro-batch i mod K), as the loader deals
them.  The step runs as the trainer documents it: one forward and
backward pass a micro-batch, batch norm on that micro-batch's own nodes,
micro-batch k's loss scaled by w_k / sum(w) (w: the task's loss
denominator, tasks/<task>.py), the gradients summed, then one Adam step.
A step of one batch is a list of graphs, and runs unscaled.

Dropout: the masks are this module's own draws.  A device
torch.Generator seeded with the seed draws, for each step, each of its
micro-batches and each layer in turn, uniforms over the padded
[n_pad, hidden] node axis the micro-batch was packed at, and a node keeps
an entry where its row's uniform is below 1 - rate.  `rows` says at which
padded row each node sits; it is the one fact taken from the packed
batch, which is where the masks are indexed, not what they hold."""
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


def micro_batch_count(micro_batches, batch_size: int) -> int:
    """K of the configuration's micro_batches: "auto" keeps each
    micro-batch at 1024 graphs or fewer."""
    if str(micro_batches) == "auto":
        return max(1, -(-batch_size // 1024))
    return max(1, int(micro_batches))


def first_batches(train: Sequence, seed: int, batch_size: int,
                  n_steps: int, block_layout: bool,
                  micro_batches=1) -> list:
    """Each step's graphs in the loader's order: a list, or with K > 1
    micro-batches a tuple of K lists, dealt round-robin."""
    k = micro_batch_count(micro_batches, batch_size)
    out = []
    for b in batch_indices(len(train), seed, batch_size, n_steps):
        graphs = in_loader_order([train[int(j)] for j in b], block_layout)
        if k > 1:
            graphs = tuple(p for p in (graphs[i::k] for i in range(k)) if p)
        out.append(graphs)
    return out


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


def follow(batches: list, weights: Dict[str, torch.Tensor], net: Dict,
           task: str, params: Dict, avg_log: float, device,
           precision: str = "float32",
           pads: Optional[list] = None, seed: int = 0,
           keep_graphs: Optional[float] = None,
           whole_batch_norm: bool = False) -> Dict:
    """Train len(batches) steps from weights (first_batches' steps);
    returns each step's loss, the first step's gradients as Adam took
    them, the raw loss gradient of the first step, and each parameter's
    change after the last step.

    pads: per step (n_pad, rows [n] int64), a tuple of them for a step of
    micro-batches, where dropout draws (None without dropout).  Planted
    faults: keep_graphs keeps the first share of each (micro-)batch's
    graphs (the mean over the rest) and drops the others;
    whole_batch_norm runs a step of micro-batches as one pass over all of
    their graphs, so that batch norm takes the whole batch's statistics
    (the same dropout masks, the full-batch mean loss)."""
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
    for step, parts in enumerate(batches):
        micro = isinstance(parts, tuple)
        parts = list(parts) if micro else [parts]
        keeps = [None] * len(parts)
        if gen is not None:
            part_pads = pads[step] if micro else (pads[step],)
            keeps = [dropout_keep(gen, n_pad, rows.to(device),
                                  net["hidden_dim"], net["L"], rate)
                     for n_pad, rows in part_pads]
        if micro and whole_batch_norm:
            parts = [[g for p in parts for g in p]]
            keeps = [None if keeps[0] is None else
                     [torch.cat(layer) for layer in zip(*keeps)]]
            micro = False
        # a micro-batch's scale needs every micro-batch's weight first; a
        # single batch is built where it always was, as where its tensors
        # are allocated moves the CPU's float32 products in the last bit
        built = [dgn.Batch(g, device) if micro else None for g in parts]
        scales = [None] * len(parts)
        if micro:
            w = [dgn.loss_weight(b, task) for b in built]
            scales = [x / max(sum(w), 1.0) for x in w]
        leaves = {k: v.detach().requires_grad_(True) for k, v in cur.items()}
        losses, grads = [], None
        for graphs, batch, keep, scale in zip(parts, built, keeps, scales):
            if keep_graphs is not None:
                n_kept = max(1, int(len(graphs) * keep_graphs))
                n_nodes = sum(g.num_nodes for g in graphs[:n_kept])
                graphs, batch = graphs[:n_kept], None
                keep = None if keep is None else [k[:n_nodes] for k in keep]
            if batch is None:
                batch = dgn.Batch(graphs, device)
            scores = dgn.forward(leaves, net, task, batch, avg_log, prec, keep)
            loss = dgn.loss(scores, batch, task)
            if scale is not None:
                loss = loss * scale
            g = torch.autograd.grad(loss, list(leaves.values()))
            grads = dict(zip(leaves, g)) if grads is None else {
                k: grads[k] + x for k, x in zip(leaves, g)}
            losses.append(loss.detach())
        loss = losses[0] if len(losses) == 1 else torch.stack(losses).sum()
        out["losses"].append(float(loss))
        cur = {k: v.detach() for k, v in cur.items()}
        taken = dgn.adam_l2(cur, grads, state, params["init_lr"],
                            params["weight_decay"])
        if step == 0:
            out["grad"] = {k: v.cpu() for k, v in taken.items()}
            out["raw_grad"] = {k: v.cpu() for k, v in grads.items()}
    out["change"] = {k: (cur[k] - w0[k]).cpu() for k in cur}
    return out
