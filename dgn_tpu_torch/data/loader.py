"""Host-side batch loaders (counterpart of `dgn_tpu/data/loader.py`).

Shuffle with numpy's default_rng(seed) (the same stream as the reference
package, so both see the same batches), under the block layout order each
batch by descending node count (block placement is next-fit and
order-sensitive), and pack it at a fixed per-loader geometry: the flat
layout (`layout="flat"`, the default, as in dgn_tpu) or the block one
(`layout="mxu"`).  A batch that overflows that geometry is repacked
at its exact need ("escape").  A block-layout BatchLoader that packs every
epoch, with the native packer built, keeps one `graph.GraphTable` of its
graphs (each field concatenated once) and draws each batch as rows of it,
which the packer reads with no per-graph Python; it packs the same arrays
as the list of those graphs.  With micro_batches=K each batch is yielded as
a list of K packed micro-batches (the trainer accumulates their gradients
into one step).  `BucketedLoader` (`--n_buckets K`) splits the graphs into
K size classes, each packed at its own tight geometry.  Spans (observe.py):
`loader.shuffle` (the epoch's draw), `loader.pack` (one batch) and inside
it `loader.escape` (the repack at the exact need).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .. import observe, runtime
from ..graph import (GraphBatch, GraphData, GraphRows, GraphTable,
                     bucket_sizes_for, mxu_bucket_sizes, mxu_pair_pad,
                     mxu_pairs_needed, pack_graphs, pack_requirements,
                     round_up, typical_bucket_sizes)

LAYOUTS = ("flat", "mxu")


def _worst_geometry(graphs, batch_size: int, layout: str):
    if layout == "mxu":
        return mxu_bucket_sizes(graphs, batch_size)[:2]
    return bucket_sizes_for(graphs, batch_size)


def _exact_geometry(graphs, batch_size: int, layout: str):
    """Max requirement over the FIXED (unshuffled) batch partition."""
    need_n = need_e = 1
    for i in range(0, len(graphs), batch_size):
        n_used, e_used = pack_requirements(graphs[i:i + batch_size],
                                           layout == "mxu")
        need_n = max(need_n, n_used)
        need_e = max(need_e, e_used)
    return round_up(need_n + 1, 128), round_up(need_e, 128)


def _order_for_layout(batch, layout: str):
    """Descending node count under the block layout (placement is next-fit
    and every geometry estimate simulates that order); the flat layout
    keeps the drawn order."""
    if layout == "mxu":
        if isinstance(batch, GraphRows):
            return batch.by_size()
        return sorted(batch, key=lambda g: -g.num_nodes)
    return list(batch)


def _pack_at(batch, layout: str, n_pad: int, e_pad: int, g_pad: int,
             pair_pad) -> GraphBatch:
    return pack_graphs(batch, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                       mxu_layout=layout == "mxu", n_pairs_pad=pair_pad)


def _escape_pad(parts, layout: str, base_n: int, base_e: int):
    """One coarse geometry (n_pad, e_pad, pair pad) that fits every part at
    its EXACT requirement, rounded so repeated escapes reuse a handful of
    shapes."""
    need = [pack_requirements(p, layout == "mxu") for p in parts]
    n_pad = round_up(max(max(n for n, _ in need) + 1, base_n), 512)
    e_pad = round_up(max(max(e for _, e in need), base_e), 512)
    pair_pad = (round_up(max(mxu_pairs_needed(p) for p in parts), 64)
                if layout == "mxu" else None)
    return n_pad, e_pad, pair_pad


class BatchLoader:
    def __init__(self, graphs: Sequence[GraphData], batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 layout: Optional[str] = None, geometry: str = "worst",
                 cache: bool = False, micro_batches: int = 1):
        """layout: 'flat' (None, the default) or 'mxu' (graph.pack_graphs).
        A flat loader's graph axis is the micro-batch size and it has no
        pair pad; a block one's is 128-aligned.

        geometry of the shuffled loader's pads:
          'worst'   — any-subset bound of the layout; every flat batch fits
                      by construction (block placement is order-sensitive,
                      so there it is an estimate);
          'typical' — sized for typical shuffled batches; a rare oversized
                      batch is repacked at its exact need ("escape").
        Unshuffled loaders without micro-batching take the EXACT max over
        their fixed partition.

        cache: unshuffled loaders only — pack each batch once and replay the
        same GraphBatch objects every epoch, so the trainer can keep their
        edge contexts too.

        micro_batches (K > 1): yield each batch as a LIST of K packed
        micro-batches of about batch_size / K graphs, dealt round-robin
        after the size sort so their sizes balance, all at one geometry
        (computed per micro-batch).  Unshuffled (eval) loaders are
        micro-batched too, as dgn_tpu/run.py:162-168 builds them: an eval
        batch then runs as K forward passes, each with the loss of its own
        micro-batch (the reference evaluates a batch as one)."""
        layout = layout or "flat"
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        if geometry not in ("worst", "typical"):
            raise ValueError(f"unknown geometry {geometry!r}")
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.layout = layout
        self.micro_batches = max(int(micro_batches), 1)
        micro = -(-batch_size // self.micro_batches)
        self.g_pad = round_up(micro, 128) if layout == "mxu" else micro
        self.n_escapes = 0
        if not shuffle and self.micro_batches == 1:
            self.n_pad, self.e_pad = _exact_geometry(self.graphs, batch_size,
                                                     layout)
        elif geometry == "typical":
            self.n_pad, self.e_pad = typical_bucket_sizes(
                self.graphs, micro, mxu_layout=layout == "mxu", seed=seed)
        else:
            self.n_pad, self.e_pad = _worst_geometry(self.graphs, micro,
                                                     layout)
        self.pair_pad = (mxu_pair_pad(self.graphs, micro, self.n_pad,
                                      self.e_pad)
                         if layout == "mxu" else None)
        self.cache = cache and not shuffle
        self._cached: Optional[List[GraphBatch]] = None
        self.table = (GraphTable.over(self.graphs)
                      if layout == "mxu" and not self.cache
                      and runtime.available() else None)

    def __len__(self):
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    def _pack_one(self, batch) -> GraphBatch:
        try:
            return _pack_at(batch, self.layout, self.n_pad, self.e_pad,
                            self.g_pad, self.pair_pad)
        except ValueError:
            # a typical geometry is not a bound, and under the block layout
            # neither is the worst-case estimate
            self.n_escapes += 1
            with observe.span("loader.escape"):
                n_pad, e_pad, pair_pad = _escape_pad([batch], self.layout,
                                                     self.n_pad, self.e_pad)
                return _pack_at(batch, self.layout, n_pad, e_pad, self.g_pad,
                                pair_pad)

    def _pack_micros(self, batch) -> List[GraphBatch]:
        """batch (size-sorted under the block layout) -> K packed
        micro-batches dealt round-robin, all at one geometry: the loader's,
        or, when any overflows it, one shared coarse geometry that fits
        every one of them."""
        parts = [p for p in (batch[k::self.micro_batches]
                             for k in range(self.micro_batches)) if p]
        try:
            return [_pack_at(p, self.layout, self.n_pad, self.e_pad,
                             self.g_pad, self.pair_pad) for p in parts]
        except ValueError:
            self.n_escapes += 1
        with observe.span("loader.escape"):
            n_pad, e_pad, pair_pad = _escape_pad(parts, self.layout,
                                                 self.n_pad, self.e_pad)
            return [_pack_at(p, self.layout, n_pad, e_pad, self.g_pad,
                             pair_pad) for p in parts]

    def __iter__(self):
        if self._cached is not None:
            yield from self._cached
            return
        out = [] if self.cache else None
        with observe.span("loader.shuffle"):
            idx = np.arange(len(self.graphs))
            if self.shuffle:
                self.rng.shuffle(idx)
        bs = self.batch_size
        for i in range(0, len(idx), bs):
            with observe.span("loader.pack"):
                batch = _order_for_layout(
                    self.table.rows(idx[i:i + bs]) if self.table is not None
                    else [self.graphs[j] for j in idx[i:i + bs]], self.layout)
                gb = (self._pack_one(batch) if self.micro_batches == 1
                      else self._pack_micros(batch))
            if out is not None:
                out.append(gb)
            yield gb
        if out is not None:
            self._cached = out


class BucketedLoader:
    """Size-bucketed batching (dgn_tpu/data/loader.py:62-179): K tight pad
    geometries instead of one worst-case one.

    The graphs are split into n_buckets equal-count quantiles by node count
    (at most len(graphs) // batch_size of them, so each holds a full
    batch); each bucket takes its own worst-case geometry (the block
    layout's `mxu_bucket_sizes` and `mxu_pair_pad`, or the flat
    `bucket_sizes_for`), and every batch is drawn from one bucket.  With
    shuffle, each bucket's order and then the plan of batches are shuffled
    by default_rng(seed) in dgn_tpu's order of draws, so the same seed
    gives dgn_tpu's batches.  A batch that overflows its bucket (block
    placement is order-sensitive) is repacked at its exact need
    (`n_escapes`).

    Eval metrics are exactly those of one bucket: they weigh real nodes,
    edges and graphs, not batches.  Training sees batches of similar-size
    graphs, which shifts the BatchNorm statistics; the reference shuffles
    uniformly, so this stays opt-in.  Unlike BatchLoader it has no
    micro-batches and no eval cache (as in dgn_tpu), and no drop_last; and
    dgn_tpu's per-bucket `ext_caps` (static metadata of the TPU extremes
    lowering) has no counterpart in the port's block layout."""

    def __init__(self, graphs: Sequence[GraphData], batch_size: int,
                 n_buckets: int = 4, shuffle: bool = False, seed: int = 0,
                 layout: str = "flat"):
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.layout = layout
        self.n_escapes = 0
        self.g_pad = (round_up(batch_size, 128) if layout == "mxu"
                      else batch_size)
        graphs = list(graphs)
        n_buckets = max(1, min(n_buckets, len(graphs) // max(batch_size, 1)))
        order = np.argsort([g.num_nodes for g in graphs], kind="stable")
        self.buckets: List[List[GraphData]] = []
        self.geometry: List[tuple] = []     # (n_pad, e_pad) per bucket
        self.pair_pads: List[Optional[int]] = []
        for part in np.array_split(order, n_buckets):
            if len(part) == 0:
                continue
            gs = [graphs[int(j)] for j in part]
            if layout == "mxu":
                n_pad, e_pad, _ = mxu_bucket_sizes(gs, batch_size)
                pair_pad = mxu_pair_pad(gs, batch_size, n_pad, e_pad)
            else:
                n_pad, e_pad = bucket_sizes_for(gs, batch_size)
                pair_pad = None
            self.buckets.append(gs)
            self.geometry.append((n_pad, e_pad))
            self.pair_pads.append(pair_pad)

    def _n_batches(self, gs) -> int:
        return (len(gs) + self.batch_size - 1) // self.batch_size

    def __len__(self):
        return sum(self._n_batches(gs) for gs in self.buckets)

    def padding_stats(self) -> dict:
        """Node and edge slot efficiency of one epoch (real / padded)."""
        real_n = real_e = pad_n = pad_e = 0
        for gs, (n_pad, e_pad) in zip(self.buckets, self.geometry):
            real_n += sum(g.num_nodes for g in gs)
            real_e += sum(g.num_edges for g in gs)
            pad_n += self._n_batches(gs) * n_pad
            pad_e += self._n_batches(gs) * e_pad
        return {"node_slot_efficiency": real_n / max(pad_n, 1),
                "edge_slot_efficiency": real_e / max(pad_e, 1),
                "n_buckets": len(self.buckets),
                "geometry": list(self.geometry)}

    def __iter__(self):
        with observe.span("loader.shuffle"):
            plan = []       # (bucket, index array into that bucket)
            for b, gs in enumerate(self.buckets):
                idx = np.arange(len(gs))
                if self.shuffle:
                    self.rng.shuffle(idx)
                plan += [(b, idx[i:i + self.batch_size])
                         for i in range(0, len(idx), self.batch_size)]
            if self.shuffle:
                self.rng.shuffle(plan)
        for b, chunk in plan:
            with observe.span("loader.pack"):
                n_pad, e_pad = self.geometry[b]
                batch = _order_for_layout([self.buckets[b][int(j)]
                                           for j in chunk], self.layout)
                try:
                    gb = _pack_at(batch, self.layout, n_pad, e_pad,
                                  self.g_pad, self.pair_pads[b])
                except ValueError:
                    self.n_escapes += 1
                    with observe.span("loader.escape"):
                        n_pad, e_pad, pair_pad = _escape_pad(
                            [batch], self.layout, n_pad, e_pad)
                        gb = _pack_at(batch, self.layout, n_pad, e_pad,
                                      self.g_pad, pair_pad)
            yield gb
