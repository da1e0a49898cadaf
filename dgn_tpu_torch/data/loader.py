"""Host-side batch loader (counterpart of `dgn_tpu/data/loader.py:BatchLoader`,
block layout only).

Shuffle with numpy's default_rng(seed) (the same stream as the reference
package, so both see the same batches), order each batch by descending node
count (block placement is next-fit and order-sensitive), and pack it at a
fixed per-loader geometry.  A batch that overflows that geometry is repacked
at its exact need ("escape").  Micro-batching and the bucketed loader are
not ported yet.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..graph import (GraphBatch, GraphData, mxu_bucket_sizes, mxu_pair_pad,
                     mxu_pairs_needed, pack_graphs, pack_requirements,
                     round_up, typical_bucket_sizes)


def _exact_geometry(graphs, batch_size: int):
    """Max requirement over the FIXED (unshuffled) batch partition."""
    need_n = need_e = 1
    for i in range(0, len(graphs), batch_size):
        n_used, e_used = pack_requirements(graphs[i:i + batch_size])
        need_n = max(need_n, n_used)
        need_e = max(need_e, e_used)
    return round_up(need_n + 1, 128), round_up(need_e, 128)


def _escape_pack(batch, g_pad: int, base_n: int, base_e: int) -> GraphBatch:
    """Repack an oversized batch at its EXACT requirement (never fails),
    rounded coarsely so repeated escapes reuse a handful of shapes."""
    n_req, e_req = pack_requirements(batch)
    return pack_graphs(batch, n_pad=round_up(max(n_req + 1, base_n), 512),
                       e_pad=round_up(max(e_req, base_e), 512), g_pad=g_pad,
                       mxu_layout=True,
                       n_pairs_pad=round_up(mxu_pairs_needed(batch), 64))


class BatchLoader:
    def __init__(self, graphs: Sequence[GraphData], batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 geometry: str = "worst", cache: bool = False):
        """geometry of the shuffled loader's pads:
          'worst'   — any-subset bound; every batch fits by construction;
          'typical' — sized for typical shuffled batches; a rare oversized
                      batch is repacked at its exact need.
        Unshuffled loaders take the EXACT max over their fixed partition.

        cache: unshuffled loaders only — pack each batch once and replay the
        same GraphBatch objects every epoch, so the trainer can keep their
        edge contexts too."""
        if geometry not in ("worst", "typical"):
            raise ValueError(f"unknown geometry {geometry!r}")
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.g_pad = round_up(batch_size, 128)
        self.n_escapes = 0
        if not shuffle:
            self.n_pad, self.e_pad = _exact_geometry(self.graphs, batch_size)
        elif geometry == "typical":
            self.n_pad, self.e_pad = typical_bucket_sizes(
                self.graphs, batch_size, seed=seed)
        else:
            self.n_pad, self.e_pad = mxu_bucket_sizes(self.graphs,
                                                      batch_size)[:2]
        self.pair_pad = mxu_pair_pad(self.graphs, batch_size, self.n_pad,
                                     self.e_pad)
        self.cache = cache and not shuffle
        self._cached: Optional[List[GraphBatch]] = None

    def __len__(self):
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    def _pack_one(self, batch) -> GraphBatch:
        try:
            return pack_graphs(batch, n_pad=self.n_pad, e_pad=self.e_pad,
                               g_pad=self.g_pad, mxu_layout=True,
                               n_pairs_pad=self.pair_pad)
        except ValueError:
            # block placement is order-sensitive, so even the worst-case
            # estimate is not a true bound
            self.n_escapes += 1
            return _escape_pack(batch, self.g_pad, self.n_pad, self.e_pad)

    def __iter__(self):
        if self._cached is not None:
            yield from self._cached
            return
        out = [] if self.cache else None
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(idx)
        bs = self.batch_size
        for i in range(0, len(idx), bs):
            batch = sorted((self.graphs[j] for j in idx[i:i + bs]),
                           key=lambda g: -g.num_nodes)
            gb = self._pack_one(batch)
            if out is not None:
                out.append(gb)
            yield gb
        if out is not None:
            self._cached = out
