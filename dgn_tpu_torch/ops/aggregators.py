"""DGN aggregators (PyTorch counterpart of `dgn_tpu/ops/aggregators.py`),
on the block layout and on the flat one.

Two paths share the formulas below.

Decomposed (`aggregate_decomposed`): a linear pretrans makes every per-edge
message split as msg_e = g[src_e] + q[dst_e] (+ c_e with edge features),
and every directional weight is a function of the eig deltas alone, hence
a batch constant.  So each aggregator becomes weighted sums of g over
incoming edges plus node-local terms with per-destination weight totals:

    sum_e w_e msg_e = S_w[v] + T_w[v] * q[v],   S_w = scatter(w * g[src])

On the block layout the weighted sums run as one batched dense product per
layer against per-(src_block, dst_block) adjacency blocks
(`mxu.pair_adj_matmul`), built once per forward pass by
`build_edge_context` (`mxu.build_pair_adjacency`).  The edge term c_e adds
one scatter of c_e * w_e for every family (`mxu.weighted_segment_sums`).
With var or std and edge features, (g + c)^2 has a cross term, so the sums
scatter ge = g[src] + c_e and ge^2 instead.  On the flat layout there are
no blocks: the columns ge * w_e of every family (and ge^2 for var/std) go
through one `segment_sum` over dst, and max/min through the joint
`segment.segment_extremes` (one of segment_max / segment_min when only one
is asked for).

Per-edge (`aggregate`): the messages are per-edge tensors (a pretrans MLP
deeper than one layer, or decompose=False).  On the block layout the
weighted-sum aggregators run in one `mxu.weighted_segment_sums` scatter,
max/min through the extremes kernel pair on the messages, the softmax
families through `segment.segment_softmax`.  On the flat layout every
aggregator is its own segment op over the messages (`_agg_xla`), the
directional ones normalised per edge by the context's abs_sum, pos_sum and
neg_sum.  A per-edge context holds no weight families and no adjacency
blocks.

Formulas (reference nets/aggregators.py:35-71), d_e = eig_u[k] - eig_v[k],
S_k(v) = sum_{e->v} |d_e|:
  mean/sum/var/std   : plain reductions of the messages
  max/min            : per-destination max/min of the messages, 0 for
                       nodes without an edge (decomposed: of ge, plus
                       q[v]); the CUDA kernel pair (`ops/extremes.py`) on
                       the block layout, scatter_reduce on the flat one
  dir{k}-av          : sum_e |d_e| / (S_k(v)+EPS) * msg_e
  dir{k}-dx          : | sum_e d_e msg_e - (sum_e d_e) h_v | / (S_k(v)+EPS)
  dir{k}-dx-no-abs   : same, without the abs
  dir{k}-dx-balanced : the relu(+d) and relu(-d) halves, each normalized
  dir{k}-0.1 / -neg-0.1 : sum_e softmax_e(+-0.1 |d_e|) msg_e; the weights
                       sum to 1 at a node with an edge, to 0 without one

compute_dtype (a torch dtype or None) rounds the block layout's products as
dgn_tpu does (`ops/mxu.py` says how): the pair matmuls (gp * gp for
var/std included), the per-edge gather ge that max/min and the scatter
branch read, the c_e scatter and the scatter branch itself, and on the
per-edge path the weighted-sum scatter.  The weight totals, the extremes
(which take the rounded ge as it is) and the softmax families do not
round, and the flat layout rounds nothing, as in dgn_tpu.  The adjacency
blocks come in the dtype build_edge_context's adj_dtype gave them.

Edge-partitioned split (dgn_tpu/ops/aggregators.py:445-530): g_node may
arrive as (g_own, g_halo), a rank's own rows and its freshly exchanged
halo rows (layers/dgn.py).  On an edge-partitioned block layout
(layout.n_pairs_int set) without var/std, the interior pairs multiply own
blocks and the boundary pairs halo blocks, and their two segment sums over
pair_dst add up: the interior products need nothing from the exchange.
max/min read ge from [g_own | g_halo].  Anything else (var/std, or no such
layout) concatenates [g_own | g_halo] and runs as above.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import extremes, mxu, segment
from .segment import EPS, gather, segment_softmax, segment_sum

_DIR_RE = re.compile(
    r"^dir(?P<k>\d+)-(?P<kind>av|smooth|dx|dx-no-abs|dx-balanced|0\.1|neg-0\.1)$")

_PLAIN = ("mean", "sum", "max", "min", "std", "var")
# names the per-edge path reduces as weighted sums in one scatter
_FUSABLE_DIR = ("av", "smooth", "dx", "dx-no-abs", "dx-balanced")


@dataclasses.dataclass
class EdgeContext:
    """Batch-constant per-edge and per-node quantities shared by all layers.

    fam_w: {key: [E]} edge-mask-folded weights of each family ("one",
    "abs{k}", "delta{k}", "pos{k}", "neg{k}", "sm{k}+", "sm{k}-");
    fam_tot: {key: [N]} their per-destination totals; adj: the
    [P, K, 128, 128] adjacency blocks of the families in adj_keys order
    (None when no aggregator needs one, and always on the flat layout).  A
    per-edge context (decomposed off) has fam_w and fam_tot None, adj None
    and adj_keys empty.  abs_sum, pos_sum, neg_sum: [N, K] per-destination
    sums of |d|, relu(d) and relu(-d), the flat per-edge path's
    normalizers (need_norms), else None."""
    src: torch.Tensor
    dst: torch.Tensor
    edge_mask: torch.Tensor
    degree: torch.Tensor
    eig_delta: Optional[torch.Tensor]
    num_nodes: int
    fam_w: Optional[Dict[str, torch.Tensor]]
    fam_tot: Optional[Dict[str, torch.Tensor]]
    adj: Optional[torch.Tensor]
    adj_keys: Tuple[str, ...]
    abs_sum: Optional[torch.Tensor] = None
    pos_sum: Optional[torch.Tensor] = None
    neg_sum: Optional[torch.Tensor] = None

    @property
    def decomposed(self) -> bool:
        return self.fam_w is not None

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


def _softmax_key(k: int, kind: str) -> str:
    return f"sm{k}+" if kind == "0.1" else f"sm{k}-"


def _scatter_keys(name: str) -> tuple:
    """Weight-family keys whose FULL feature sums `name` consumes."""
    if name in ("mean", "sum", "var", "std"):
        return ("one",)
    if name in ("max", "min"):
        return ()
    k, kind = _dir_spec(name)
    if kind in ("av", "smooth"):
        return (f"abs{k}",)
    if kind in ("dx", "dx-no-abs"):
        return (f"delta{k}",)
    if kind == "dx-balanced":
        return (f"pos{k}", f"neg{k}")
    return (_softmax_key(k, kind),)


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
    if kind == "dx-balanced":
        return (f"pos{k}", f"neg{k}")
    return (_softmax_key(k, kind),)


def _family_weight(key: str, delta, mask, maskf, dst, n):
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
    if key.startswith("sm"):
        alpha = 0.1 if key.endswith("+") else -0.1
        w = segment_softmax(alpha * delta[:, int(key[2:-1])].abs(), dst, n,
                            mask)
        return w * maskf
    raise KeyError(key)


def _unique(seq):
    out = []
    for k in seq:
        if k not in out:
            out.append(k)
    return out


def build_edge_context(eig: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       edge_mask: torch.Tensor, degree: torch.Tensor,
                       names: Sequence[str],
                       mxu_layout: Optional[mxu.MXULayout] = None,
                       decomposed: bool = True,
                       adj_dtype: Optional[torch.dtype] = None,
                       need_norms: bool = False) -> EdgeContext:
    """The per-forward-pass batch constants of the edge stage: the eig
    deltas; with need_norms (the flat per-edge path) the directional
    normalizers; and, when decomposed, the family weights and their
    per-destination totals, plus on the block layout (mxu_layout given)
    the adjacency blocks (one build_pair_adjacency launch).  The flat
    layout builds no blocks and launches nothing.  None of it carries a
    gradient."""
    names = parse_names(names)
    n = eig.shape[0]
    delta = None
    norms = {}
    if any(_dir_spec(x) for x in names):
        delta = (gather(eig, src) - gather(eig, dst)).detach()
        if need_norms:
            kinds = {k for _, k in filter(None, map(_dir_spec, names))}
            if kinds - {"dx-balanced"}:
                norms["abs_sum"] = segment_sum(delta.abs(), dst, n, edge_mask)
            if "dx-balanced" in kinds:
                norms["pos_sum"] = segment_sum(torch.relu(delta), dst, n,
                                               edge_mask)
                norms["neg_sum"] = segment_sum(torch.relu(-delta), dst, n,
                                               edge_mask)
    ctx = EdgeContext(src=src, dst=dst, edge_mask=edge_mask, degree=degree,
                      eig_delta=delta, num_nodes=n, fam_w=None, fam_tot=None,
                      adj=None, adj_keys=(), **norms)
    if not decomposed:
        return ctx
    keys = _unique(k for nm in names
                   for k in _scatter_keys(nm) + _total_keys(nm))
    tot_keys = _unique(k for nm in names for k in _total_keys(nm))
    adj_keys = tuple(_unique(k for nm in names for k in _scatter_keys(nm)))
    maskf = edge_mask.to(eig.dtype)
    fam_w = {k: _family_weight(k, delta, edge_mask, maskf, dst, n).detach()
             for k in keys}
    fam_tot = {}
    # the softmax weights of a node sum to 1 when it has an edge: their
    # totals are that indicator, not a scatter
    scat_keys = [k for k in tot_keys if not k.startswith("sm")]
    if scat_keys:
        stacked = torch.stack([fam_w[k] for k in scat_keys], dim=1)
        if mxu_layout is not None:
            tots = mxu.block_scatter_sum(stacked, mxu_layout.local_dst,
                                         mxu_layout.edge_chunk_dst,
                                         mxu_layout.n_node_blocks)[:n]
        else:
            tots = segment_sum(stacked, dst, n)
        fam_tot = {k: tots[:, i] for i, k in enumerate(scat_keys)}
    for k in tot_keys:
        if k.startswith("sm"):
            fam_tot[k] = (degree > 0).to(eig.dtype)
    adj = None
    if adj_keys and mxu_layout is not None:
        adj = mxu.build_pair_adjacency(
            torch.stack([fam_w[k] for k in adj_keys]), mxu_layout,
            out_dtype=adj_dtype)
    return dataclasses.replace(ctx, fam_w=fam_w, fam_tot=fam_tot, adj=adj,
                               adj_keys=adj_keys)


def aggregate_decomposed(names: Sequence[str], ctx: EdgeContext,
                         g_node: torch.Tensor, q_node: Optional[torch.Tensor],
                         h_in: torch.Tensor,
                         c_edge: Optional[torch.Tensor] = None,
                         layout: Optional[mxu.MXULayout] = None,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """All aggregators over msg_e = g[src_e] + q[dst_e] (+ c_edge[e]),
    concatenated on the feature axis -> [N, len(names) * F].  q_node and
    c_edge may be None (0).  layout None: the flat layout, where
    compute_dtype is ignored.  g_node may be (g_own, g_halo), an
    edge-partitioned rank's own and halo rows (module docstring)."""
    names = list(names)
    cd = compute_dtype if layout is not None else None
    if not ctx.decomposed:
        raise ValueError("a per-edge edge context holds no weight families: "
                         "build it with decomposed=True")
    n = ctx.num_nodes
    need_sq = any(nm in ("var", "std") for nm in names)
    split = isinstance(g_node, tuple)
    if split and (layout is None or layout.n_pairs_int is None or need_sq):
        g_node, split = torch.cat(g_node, dim=0), False
    f = (g_node[0] if split else g_node).shape[-1]
    full_keys = tuple(_unique(k for nm in names for k in _scatter_keys(nm)))
    if full_keys != ctx.adj_keys:
        raise ValueError(f"edge context holds adjacency blocks {ctx.adj_keys}"
                         f", these aggregators need {full_keys}: build it "
                         "with the same names")
    # (g + c)^2 has a cross term: var/std with edge features scatter the
    # per-edge values instead of multiplying the adjacency blocks; the flat
    # layout has no blocks
    use_adj = layout is not None and (c_edge is None or not need_sq)
    # the per-edge values ge: for max/min, and for the scatter branch
    ge = None
    if not use_adj or "max" in names or "min" in names:
        ge = mxu.gather(torch.cat(g_node, dim=0) if split else g_node,
                        ctx.src, cd)
        if c_edge is not None:
            ge = ge + c_edge

    S = {}
    if full_keys and use_adj:
        nb = layout.n_node_blocks
        if split:
            # interior pairs read own blocks, boundary pairs halo blocks
            ni, nbo = layout.n_pairs_int, layout.n_own_blocks
            g_own, g_halo = g_node
            src = layout.pair_src.long()
            gp_i = g_own.reshape(nbo, mxu.TILE, f)[src[:ni]]
            gp_b = g_halo.reshape(nb - nbo, mxu.TILE, f)[src[ni:] - nbo]
            Sb = (segment_sum(mxu.pair_adj_matmul(ctx.adj[:ni], gp_i, cd),
                              layout.pair_dst[:ni], nb)
                  + segment_sum(mxu.pair_adj_matmul(ctx.adj[ni:], gp_b, cd),
                                layout.pair_dst[ni:], nb))
        else:
            gp = g_node.reshape(nb, mxu.TILE, f)[layout.pair_src]  # [P,T,F]
            T = mxu.pair_adj_matmul(ctx.adj, gp, cd)              # [P,K,T,F]
            Sb = segment_sum(T, layout.pair_dst, nb)              # [nb,K,T,F]
        Sb = Sb.transpose(0, 1).reshape(len(full_keys), -1, f)
        S = {k: Sb[i][:n] for i, k in enumerate(full_keys)}
        if need_sq:                                 # c_edge is None here
            one = ctx.adj[:, full_keys.index("one")]
            T2 = mxu.pair_adj_matmul(one[:, None], gp * gp, cd)[:, 0]
            S2 = segment_sum(T2, layout.pair_dst, nb)
            S["one"] = torch.cat([S["one"], S2.reshape(-1, f)[:n]], dim=1)
        if c_edge is not None:
            sc, _ = mxu.weighted_segment_sums(
                c_edge, torch.stack([ctx.fam_w[k] for k in full_keys]),
                layout, n, n_full=len(full_keys), compute_dtype=cd)
            for i, k in enumerate(full_keys):
                S[k] = S[k] + sc[i]
    elif full_keys:
        cols, bounds, off = [], {}, 0
        for k in full_keys:
            d = torch.cat([ge, ge * ge], dim=1) if k == "one" and need_sq \
                else ge
            cols.append(d * ctx.fam_w[k][:, None])
            bounds[k] = (off, off + d.shape[1])
            off += d.shape[1]
        wide = torch.cat(cols, dim=1)
        out = (mxu.block_scatter_sum(wide, layout.local_dst,
                                     layout.edge_chunk_dst,
                                     layout.n_node_blocks, cd)[:n]
               if layout is not None else segment_sum(wide, ctx.dst, n))
        S = {k: out[:, a:b] for k, (a, b) in bounds.items()}

    deg = ctx.degree.to(h_in.dtype)
    degc = deg.clamp_min(1.0)[:, None]
    has_edge = (deg > 0)[:, None]
    q = q_node
    # the extremes are not weighted sums: they take the per-edge values ge
    ext = None
    if layout is not None and ("max" in names or "min" in names):
        ext = extremes.segment_extremes(ge, layout, ctx.edge_mask, n)
    elif "max" in names and "min" in names:
        ext = segment.segment_extremes(ge, ctx.dst, n, ctx.edge_mask)
    elif "max" in names:
        ext = (segment.segment_max(ge, ctx.dst, n, ctx.edge_mask), None)
    elif "min" in names:
        ext = (None, segment.segment_min(ge, ctx.dst, n, ctx.edge_mask))
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
            outs.append(_var_std(name, S["one"], f, degc, has_edge))
        elif name in ("max", "min"):
            # both paths already give 0 for nodes without an edge
            s = ext[0] if name == "max" else ext[1]
            outs.append(torch.where(has_edge, s + q, 0.0) if q is not None
                        else s)
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
            elif kind == "dx-balanced":
                tp = ctx.fam_tot[f"pos{k}"][:, None]
                tn = ctx.fam_tot[f"neg{k}"][:, None]
                sp = S[f"pos{k}"][:, :f] - tp * h_in
                sn = S[f"neg{k}"][:, :f] - tn * h_in
                if q is not None:
                    sp = sp + tp * q
                    sn = sn + tn * q
                outs.append((0.5 * (sp / (tp + EPS) + sn / (tn + EPS))).abs())
            else:                   # softmax: the weights sum to 1[deg > 0]
                key = _softmax_key(k, kind)
                s = S[key][:, :f]
                if q is not None:
                    s = s + ctx.fam_tot[key][:, None] * q
                outs.append(s)
    return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]


def _var_std(name, s_one, f, degc, has_edge):
    """var/std from the [N, 2F] first and second moment sums."""
    m1 = torch.where(has_edge, s_one[:, :f] / degc, 0.0)
    m2 = torch.where(has_edge, s_one[:, f:2 * f] / degc, 0.0)
    var = torch.relu(m2 - m1 * m1)
    return var if name == "var" else torch.sqrt(var + EPS)


def _fusable(name: str) -> bool:
    if name in ("mean", "sum", "var", "std"):
        return True
    d = _dir_spec(name)
    return d is not None and d[1] in _FUSABLE_DIR


def _fused_aggregate(names, ctx: EdgeContext, msg, h_in, layout,
                     compute_dtype=None):
    """Every weighted-sum aggregator of `names` over the per-edge messages
    in one weighted_segment_sums scatter (rounded to compute_dtype when
    given) -> {name: [N, F]}."""
    f = msg.shape[1]
    need_sq = any(n in ("var", "std") for n in names)
    specs, full = {}, {}          # row key -> weight [E], needs full sums

    def want(key, vec, need_full):
        if key not in specs:
            specs[key] = vec
            full[key] = need_full
        else:
            full[key] = full[key] or need_full

    for name in names:
        if name in ("mean", "sum", "var", "std"):
            want(("one",), torch.ones_like(msg[:, 0]), True)
            continue
        k, kind = _dir_spec(name)
        d = ctx.eig_delta[:, k]
        if kind in ("av", "smooth"):
            want(("abs", k), d.abs(), True)
        elif kind in ("dx", "dx-no-abs"):
            want(("delta", k), d, True)
            want(("abs", k), d.abs(), False)      # the normaliser S_k only
        else:                                      # dx-balanced
            want(("pos", k), torch.relu(d), True)
            want(("neg", k), torch.relu(-d), True)

    # full-sum rows first, then the rows whose totals alone are read
    keys = sorted(specs, key=lambda k: not full[k])
    n_full = sum(1 for k in keys if full[k])
    msg_aug = torch.cat([msg, msg * msg], dim=1) if need_sq else msg
    mask = ctx.edge_mask.to(msg.dtype)
    W = torch.stack([specs[k] * mask for k in keys])
    sums, totals = mxu.weighted_segment_sums(msg_aug, W, layout,
                                             ctx.num_nodes, n_full=n_full,
                                             compute_dtype=compute_dtype)
    S = {k: (sums[i] if i < n_full else None, totals[i])
         for i, k in enumerate(keys)}

    deg = ctx.degree.to(msg.dtype)
    degc = deg.clamp_min(1.0)[:, None]
    has_edge = (deg > 0)[:, None]
    out = {}
    for name in names:
        if name == "sum":
            out[name] = S[("one",)][0][:, :f]
        elif name == "mean":
            out[name] = torch.where(has_edge, S[("one",)][0][:, :f] / degc,
                                    0.0)
        elif name in ("var", "std"):
            out[name] = _var_std(name, S[("one",)][0], f, degc, has_edge)
        else:
            k, kind = _dir_spec(name)
            if kind in ("av", "smooth"):
                s, tot = S[("abs", k)]
                out[name] = s[:, :f] / (tot[:, None] + EPS)
            elif kind in ("dx", "dx-no-abs"):
                s, tot = S[("delta", k)]
                norm = S[("abs", k)][1]
                val = (s[:, :f] - tot[:, None] * h_in) / (norm[:, None] + EPS)
                out[name] = val.abs() if kind == "dx" else val
            else:                                  # dx-balanced
                sp, tp = S[("pos", k)]
                sn, tn = S[("neg", k)]
                val = 0.5 * ((sp[:, :f] - tp[:, None] * h_in)
                             / (tp[:, None] + EPS)
                             + (sn[:, :f] - tn[:, None] * h_in)
                             / (tn[:, None] + EPS))
                out[name] = val.abs()
    return out


def _softmax_aggregate(name: str, ctx: EdgeContext, msg):
    """sum_e softmax_e(+-0.1 |d_e|) msg_e per destination."""
    k, kind = _dir_spec(name)
    alpha = 0.1 if kind == "0.1" else -0.1
    w = segment_softmax(alpha * ctx.eig_delta[:, k].abs(), ctx.dst,
                        ctx.num_nodes, ctx.edge_mask)
    return segment_sum(msg * w[:, None], ctx.dst, ctx.num_nodes,
                       ctx.edge_mask)


def _agg_xla(name: str, ctx: EdgeContext, msg, h_in):
    """One aggregator as its own masked segment op over the per-edge
    messages (the flat layout; dgn_tpu/ops/aggregators.py:273-322)."""
    n, dst, mask = ctx.num_nodes, ctx.dst, ctx.edge_mask
    if name == "mean":
        return segment.segment_mean(msg, dst, n, mask, ctx.degree)
    if name == "sum":
        return segment_sum(msg, dst, n, mask)
    if name == "max":
        return segment.segment_max(msg, dst, n, mask)
    if name == "min":
        return segment.segment_min(msg, dst, n, mask)
    if name == "var":
        return segment.segment_var(msg, dst, n, mask, ctx.degree)
    if name == "std":
        return segment.segment_std(msg, dst, n, mask, ctx.degree)
    k, kind = _dir_spec(name)
    d = ctx.eig_delta[:, k]
    if kind in ("av", "smooth"):
        w = d.abs() / (ctx.abs_sum[:, k].index_select(0, dst) + EPS)
        return segment_sum(msg * w[:, None], dst, n, mask)
    if kind in ("dx", "dx-no-abs", "dx-balanced"):
        if kind == "dx-balanced":
            front = torch.relu(d) / (ctx.pos_sum[:, k].index_select(0, dst)
                                     + EPS)
            back = torch.relu(-d) / (ctx.neg_sum[:, k].index_select(0, dst)
                                     + EPS)
            w = (front + back) * 0.5
        else:
            w = d / (ctx.abs_sum[:, k].index_select(0, dst) + EPS)
        wh = segment_sum(msg * w[:, None], dst, n, mask)
        wsum = segment_sum(w, dst, n, mask)
        out = wh - wsum[:, None] * h_in
        return out if kind == "dx-no-abs" else out.abs()
    return _softmax_aggregate(name, ctx, msg)


def aggregate(names: Sequence[str], ctx: EdgeContext, msg: torch.Tensor,
              h_in: torch.Tensor,
              layout: Optional[mxu.MXULayout] = None,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """All aggregators over the per-edge messages msg [E, F] (every padded
    edge; pad edges never reach a reduction), concatenated on the feature
    axis -> [N, len(names) * F] (reference nets/dgn_layer.py:94).  layout
    None: the flat layout, one segment op per aggregator, compute_dtype
    ignored; on the block layout it rounds the weighted-sum scatter."""
    names = list(names)
    if layout is None:
        outs = [_agg_xla(n, ctx, msg, h_in) for n in names]
        return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
    fuse = [n for n in names if _fusable(n)]
    out = (_fused_aggregate(fuse, ctx, msg, h_in, layout, compute_dtype)
           if fuse else {})
    if "max" in names or "min" in names:
        out["max"], out["min"] = extremes.segment_extremes(
            msg, layout, ctx.edge_mask, ctx.num_nodes)
    outs = [out[n] if n in out else _softmax_aggregate(n, ctx, msg)
            for n in names]
    return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
