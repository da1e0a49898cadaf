"""DGN aggregators over linearly decomposed messages, on the block layout.

PyTorch counterpart of `dgn_tpu/ops/aggregators.py`, for the path the
canonical ZINC model runs: a linear pretrans makes every per-edge message
split as msg_e = g[src_e] + q[dst_e], and every directional weight is a
function of the eig deltas alone, hence a batch constant.  So each
aggregator becomes weighted sums of g over incoming edges plus node-local
terms with per-destination weight totals:

    sum_e w_e msg_e = S_w[v] + T_w[v] * q[v],   S_w = scatter(w * g[src])

The weighted sums run as one batched dense product per layer against
per-(src_block, dst_block) adjacency blocks (`mxu.pair_adj_matmul`), built
once per forward pass by `build_edge_context` (`mxu.build_pair_adjacency`).

Formulas (reference nets/aggregators.py:35-71), d_e = eig_u[k] - eig_v[k],
S_k(v) = sum_{e->v} |d_e|:
  mean/sum/var/std   : plain reductions of the messages
  dir{k}-av          : sum_e |d_e| / (S_k(v)+EPS) * msg_e
  dir{k}-dx          : | sum_e d_e msg_e - (sum_e d_e) h_v | / (S_k(v)+EPS)
  dir{k}-dx-no-abs   : same, without the abs
  dir{k}-dx-balanced : the relu(+d) and relu(-d) halves, each normalized

Not ported yet, and raising NotImplementedError rather than falling back:
max/min (the reference's ops/extremes.py), the softmax families
(dir{k}-0.1, dir{k}-neg-0.1), edge features (c_edge), the flat layout and
the edge-partitioned split.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import mxu
from .segment import EPS, gather, segment_sum

_DIR_RE = re.compile(
    r"^dir(?P<k>\d+)-(?P<kind>av|smooth|dx|dx-no-abs|dx-balanced|0\.1|neg-0\.1)$")

_PLAIN = ("mean", "sum", "max", "min", "std", "var")
_PORTED_PLAIN = ("mean", "sum", "var", "std")
_PORTED_DIR = ("av", "smooth", "dx", "dx-no-abs", "dx-balanced")


@dataclasses.dataclass
class EdgeContext:
    """Batch-constant per-edge and per-node quantities shared by all layers.

    fam_w: {key: [E]} edge-mask-folded weights of each family ("one",
    "abs{k}", "delta{k}", "pos{k}", "neg{k}"); fam_tot: {key: [N]} their
    per-destination totals; adj: the [P, K, 128, 128] adjacency blocks of the
    families in adj_keys order."""
    dst: torch.Tensor
    edge_mask: torch.Tensor
    degree: torch.Tensor
    eig_delta: Optional[torch.Tensor]
    num_nodes: int
    fam_w: Dict[str, torch.Tensor]
    fam_tot: Dict[str, torch.Tensor]
    adj: torch.Tensor
    adj_keys: Tuple[str, ...]

    def to(self, device) -> "EdgeContext":
        def mv(x):
            if isinstance(x, dict):
                return {k: v.to(device) for k, v in x.items()}
            return x.to(device) if isinstance(x, torch.Tensor) else x
        return EdgeContext(**{f.name: mv(getattr(self, f.name))
                              for f in dataclasses.fields(self)})


def parse_names(names) -> list[str]:
    """'mean dir1-dx dir1-av' -> validated list."""
    if isinstance(names, str):
        names = names.split()
    names = list(names)
    for n in names:
        if n not in _PLAIN and not _DIR_RE.match(n):
            raise KeyError(f"unknown aggregator {n!r}")
    return names


def _dir_spec(name):
    m = _DIR_RE.match(name)
    if not m:
        return None
    return int(m.group("k")), m.group("kind")


def check_ported(names: Sequence[str]) -> None:
    """Raise NotImplementedError for an aggregator this port lacks."""
    for n in names:
        d = _dir_spec(n)
        if n in _PORTED_PLAIN or (d is not None and d[1] in _PORTED_DIR):
            continue
        raise NotImplementedError(
            f"aggregator {n!r} is not ported yet (max/min and the softmax "
            "families wait for a later slice)")


def _scatter_keys(name: str) -> tuple:
    """Weight-family keys whose FULL feature sums `name` consumes."""
    if name in ("mean", "sum", "var", "std"):
        return ("one",)
    k, kind = _dir_spec(name)
    if kind in ("av", "smooth"):
        return (f"abs{k}",)
    if kind in ("dx", "dx-no-abs"):
        return (f"delta{k}",)
    return (f"pos{k}", f"neg{k}")          # dx-balanced


def _total_keys(name: str) -> tuple:
    """Weight-family keys whose per-dst TOTALS `name` consumes."""
    d = _dir_spec(name)
    if d is None:
        return ()
    k, kind = d
    if kind in ("av", "smooth"):
        return (f"abs{k}",)
    if kind in ("dx", "dx-no-abs"):
        return (f"delta{k}", f"abs{k}")
    return (f"pos{k}", f"neg{k}")          # dx-balanced


def _family_weight(key: str, delta, maskf):
    """Per-edge weight vector for a family key, edge-mask-folded."""
    if key == "one":
        return maskf
    if key.startswith("abs"):
        return delta[:, int(key[3:])].abs() * maskf
    if key.startswith("delta"):
        return delta[:, int(key[5:])] * maskf
    if key.startswith("pos"):
        return torch.relu(delta[:, int(key[3:])]) * maskf
    if key.startswith("neg"):
        return torch.relu(-delta[:, int(key[3:])]) * maskf
    raise KeyError(key)


def _unique(seq):
    out = []
    for k in seq:
        if k not in out:
            out.append(k)
    return out


def build_edge_context(eig: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       edge_mask: torch.Tensor, degree: torch.Tensor,
                       names: Sequence[str], mxu_layout: mxu.MXULayout,
                       decomposed: bool = True,
                       adj_dtype: Optional[torch.dtype] = None
                       ) -> EdgeContext:
    """The per-forward-pass batch constants of the decomposed edge stage:
    eig deltas, family weights and their per-destination totals, and the
    adjacency blocks (one build_pair_adjacency launch).  None of it carries
    a gradient."""
    if not decomposed or mxu_layout is None:
        raise NotImplementedError(
            "only the decomposed edge stage on the block layout is ported")
    names = list(names)
    check_ported(names)
    n = eig.shape[0]
    delta = None
    if any(_dir_spec(x) for x in names):
        delta = (gather(eig, src) - gather(eig, dst)).detach()
    keys = _unique(k for nm in names
                   for k in _scatter_keys(nm) + _total_keys(nm))
    tot_keys = _unique(k for nm in names for k in _total_keys(nm))
    adj_keys = tuple(_unique(k for nm in names for k in _scatter_keys(nm)))
    maskf = edge_mask.to(eig.dtype)
    fam_w = {k: _family_weight(k, delta, maskf) for k in keys}
    fam_tot = {}
    if tot_keys:
        stacked = torch.stack([fam_w[k] for k in tot_keys], dim=1)
        tots = mxu.block_scatter_sum(stacked, mxu_layout.local_dst,
                                     mxu_layout.edge_chunk_dst,
                                     mxu_layout.n_node_blocks)[:n]
        fam_tot = {k: tots[:, i] for i, k in enumerate(tot_keys)}
    adj = mxu.build_pair_adjacency(
        torch.stack([fam_w[k] for k in adj_keys]), mxu_layout,
        out_dtype=adj_dtype)
    return EdgeContext(dst=dst, edge_mask=edge_mask, degree=degree,
                       eig_delta=delta, num_nodes=n, fam_w=fam_w,
                       fam_tot=fam_tot, adj=adj, adj_keys=adj_keys)


def aggregate_decomposed(names: Sequence[str], ctx: EdgeContext,
                         g_node: torch.Tensor, q_node: Optional[torch.Tensor],
                         h_in: torch.Tensor,
                         c_edge: Optional[torch.Tensor] = None,
                         layout: Optional[mxu.MXULayout] = None
                         ) -> torch.Tensor:
    """All aggregators over msg_e = g[src_e] + q[dst_e], concatenated on the
    feature axis -> [N, len(names) * F].  q_node may be None (q = 0)."""
    names = list(names)
    check_ported(names)
    if c_edge is not None:
        raise NotImplementedError("edge features (c_edge) are not ported yet")
    if layout is None:
        raise NotImplementedError("only the block layout is ported")
    f = g_node.shape[-1]
    n = ctx.num_nodes
    need_sq = any(nm in ("var", "std") for nm in names)
    full_keys = tuple(_unique(k for nm in names for k in _scatter_keys(nm)))
    if full_keys != ctx.adj_keys:
        raise ValueError(f"edge context holds adjacency blocks {ctx.adj_keys}"
                         f", these aggregators need {full_keys}: build it "
                         "with the same names")

    nb = layout.n_node_blocks
    gp = g_node.reshape(nb, mxu.TILE, f)[layout.pair_src]       # [P, T, F]
    T = mxu.pair_adj_matmul(ctx.adj, gp)                         # [P, K, T, F]
    Sb = segment_sum(T, layout.pair_dst, nb)                     # [nb, K, T, F]
    Sb = Sb.transpose(0, 1).reshape(len(full_keys), -1, f)
    S = {k: Sb[i][:n] for i, k in enumerate(full_keys)}
    if need_sq:
        one = ctx.adj[:, full_keys.index("one")]
        T2 = mxu.pair_adj_matmul(one[:, None], gp * gp)[:, 0]   # [P, T, F]
        S2 = segment_sum(T2, layout.pair_dst, nb)
        S["one"] = torch.cat([S["one"], S2.reshape(-1, f)[:n]], dim=1)

    deg = ctx.degree.to(g_node.dtype)
    degc = deg.clamp_min(1.0)[:, None]
    has_edge = (deg > 0)[:, None]
    q = q_node
    outs = []
    for name in names:
        if name == "sum":
            s = S["one"][:, :f]
            outs.append(s + deg[:, None] * q if q is not None else s)
        elif name == "mean":
            s = S["one"][:, :f] / degc
            val = s + q if q is not None else s
            outs.append(torch.where(has_edge, val, 0.0))
        elif name in ("var", "std"):
            m1 = torch.where(has_edge, S["one"][:, :f] / degc, 0.0)
            m2 = torch.where(has_edge, S["one"][:, f:2 * f] / degc, 0.0)
            var = torch.relu(m2 - m1 * m1)
            outs.append(var if name == "var" else torch.sqrt(var + EPS))
        else:
            k, kind = _dir_spec(name)
            if kind in ("av", "smooth"):
                key = f"abs{k}"
                tot = ctx.fam_tot[key][:, None]
                s = S[key][:, :f]
                if q is not None:
                    s = s + tot * q
                outs.append(s / (tot + EPS))
            elif kind in ("dx", "dx-no-abs"):
                key = f"delta{k}"
                t = ctx.fam_tot[key][:, None]
                norm = ctx.fam_tot[f"abs{k}"][:, None]
                s = S[key][:, :f] - t * h_in
                if q is not None:
                    s = s + t * q
                val = s / (norm + EPS)
                outs.append(val.abs() if kind == "dx" else val)
            else:                                   # dx-balanced
                tp = ctx.fam_tot[f"pos{k}"][:, None]
                tn = ctx.fam_tot[f"neg{k}"][:, None]
                sp = S[f"pos{k}"][:, :f] - tp * h_in
                sn = S[f"neg{k}"][:, :f] - tn * h_in
                if q is not None:
                    sp = sp + tp * q
                    sn = sn + tn * q
                outs.append((0.5 * (sp / (tp + EPS) + sn / (tn + EPS))).abs())
    return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
