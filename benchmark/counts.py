"""The work a training step needs, counted from the configuration's widths
and a batch's REAL nodes, edges and graphs, so more padding never changes
a count.  These are the yardstick's numerators: `mfu.train` divides
train_flops by the time and the peak, `adjacency_roofline` divides
adjacency_bytes by the HBM rate and the kernel's time."""
from __future__ import annotations

from typing import Dict, List, Sequence

from .reference import tasks

TILE = 128
EXTREMES = ("max", "min")


def families(aggregators: Sequence[str]) -> List[str]:
    """The weight families whose adjacency blocks the aggregators read,
    in first-use order: 'one' for mean/sum/var/std, 'abs{k}' for dir{k}-av,
    'delta{k}' for dir{k}-dx (max, min and the softmax kinds have no
    block of their own here)."""
    out = []
    for name in aggregators:
        if name in ("mean", "sum", "var", "std"):
            fam = "one"
        elif name.startswith("dir") and name.endswith("-av"):
            fam = "abs" + name[3:].split("-")[0]
        elif name.startswith("dir") and name.endswith("-dx"):
            fam = "delta" + name[3:].split("-")[0]
        else:
            continue
        if fam not in out:
            out.append(fam)
    return out


def train_flops(net: Dict, task: str, meta: Dict, nodes: int, edges: int,
                graphs: int) -> float:
    """Floating-point operations of one training step (forward, backward)
    of the published layer equations on nodes / edges / graphs real
    elements.  F = hidden_dim, A aggregators, S' = the scaler count when
    more than one is named (else 1).  Forward, per layer:
      pretrans (complex): the linear map of [h_u || h_v] is
        h_u W1 + h_v W2 + b, two node products, 2 * 2 N F^2, and the
        per-edge sum of the two halves, E F;
      aggregation: every aggregator but max and min a weighted sum over
        the incoming edges, one multiply and one add per edge and feature,
        2 E F a sum; max and min one comparison per edge and feature,
        E F each;
      posttrans: 2 N W F, W = F [complex] + A F S'.
    The encoder: the task's (reference/tasks/<task>.py encoder_flops):
    2 N in F for a linear one, 0 for a table lookup.
    The readout: the mean pool, N F, and the MLP, 2 G sum(d_j d_j+1)
    over its halving widths, d_3 the task's output width.
    Backward: every product twice more (the gradients of its input and of
    its weight), except the encoder's, whose input needs none (once more);
    a weighted sum once more (its transpose; the weights are constants),
    and max and min once more (one gather of the output's gradient per
    edge and feature, to the edge that won); the pretrans' edge sum and
    the pool once more.  Elementwise work (the norms, activations,
    scalers, the loss, Adam) is not counted: it is not what the peak
    counts."""
    f = net["hidden_dim"]
    names = net["aggregators"].split()
    n_agg = len(names)
    n_ext = sum(name in EXTREMES for name in names)
    n_scal = len(net["scalers"].split())
    n_scal = n_scal if n_scal > 1 else 1
    complex_ = net["type_net"] == "complex"
    products = 0.0          # matrix products: 3x in a step
    sums = 0.0              # gathers and scatters of sums: 2x in a step
    for _ in range(net["L"]):
        if complex_:
            products += 2 * 2 * nodes * f * f
            sums += edges * f
        sums += 2 * edges * f * (n_agg - n_ext) + edges * f * n_ext
        width = (f if complex_ else 0) + n_agg * f * n_scal
        products += 2 * nodes * width * f
    kind = tasks.find(task)
    dims = [f, f // 2, f // 4, kind.n_out(meta)]
    products += sum(2 * graphs * dims[j] * dims[j + 1] for j in range(3))
    sums += nodes * f
    encoder = kind.encoder_flops(meta, f, nodes)
    return 3 * products + 2 * sums + 2 * encoder


def adjacency_bytes(real_edges: int, covered_pairs: int, n_families: int,
                    out_bytes: int = 4) -> int:
    """HBM bytes one build of the adjacency blocks needs: each real edge's
    K float32 weights and its int32 local source and destination read once
    (real_edges * (4 K + 8)), and the K 128 x 128 blocks of every covered
    (source block, destination block) pair, one that holds a real edge,
    written once (covered * K * 128 * 128 * out_bytes).  Pad edges,
    uncovered pairs and all-pad chunks count nothing."""
    return (real_edges * (4 * n_families + 8)
            + covered_pairs * n_families * TILE * TILE * out_bytes)
