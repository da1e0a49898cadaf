"""What the window drives and times: the iterable handed to the trainer's
train_epoch, over the program's own train loader.

Each request for a batch is an iteration boundary: an iteration runs from
one batch's request to the next one's, so it holds the host pack (the
loader's next()), the train step and the readback of the loss and
scores that train_epoch does.  A request at or past the window's close
yields nothing, which ends the epoch; the close is that request's time."""
from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, List, Optional

import numpy as np


def micro_batches(batch) -> list:
    """The packed micro-batches of one loader batch: a list of K of them,
    or the one packed batch."""
    return list(batch) if isinstance(batch, (list, tuple)) else [batch]


def real_sizes(batch) -> list:
    """(real nodes, real edges, real graphs) of each micro-batch of one
    loader batch."""
    return [(int(gb.node_mask.sum()), int(gb.edge_mask.sum()),
             int(gb.graph_mask.sum())) for gb in micro_batches(batch)]


class Window:
    """Host clock over the requests of one window (seconds long; None: no
    close, the warm-up epoch)."""

    def __init__(self, seconds: Optional[float] = None,
                 span: Callable = contextlib.nullcontext):
        self.seconds = seconds
        self.span = span
        self.starts: List[float] = []     # request time of each batch
        self.pack_s: List[float] = []
        self.graphs: List[int] = []
        self.nodes: List[int] = []
        self.edges: List[int] = []
        self.batches: List = []           # the first keep_batches batches
        self.keep_batches = 0
        self.closed_at: Optional[float] = None
        self.failed = 0

    @property
    def closed(self) -> bool:
        return self.closed_at is not None

    def feed(self, loader) -> "Feed":
        return Feed(loader, self)

    def stats(self) -> dict:
        seconds = self.closed_at - self.starts[0]
        iters = np.diff(np.asarray(self.starts + [self.closed_at]))
        return {"seconds": seconds, "steps": len(self.starts),
                "iter_s": iters, "graphs": int(sum(self.graphs))}


class Feed:
    """train_epoch's loader: forwards the loader's n_escapes counter.  A
    batch of K micro-batches (a list of packed batches) counts the real
    graphs, nodes and edges of all of them."""

    def __init__(self, loader, window: Window):
        self.loader = loader
        self.window = window

    @property
    def n_escapes(self) -> int:
        return self.loader.n_escapes

    def __iter__(self):
        w = self.window
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            if w.seconds is not None and w.starts \
                    and t - w.starts[0] >= w.seconds:
                w.closed_at = t
                return
            with w.span("pack"):
                gb = next(it, None)
            if gb is None:
                return
            w.pack_s.append(time.perf_counter() - t)
            w.starts.append(t)
            nodes, edges, graphs = (sum(x) for x in zip(*real_sizes(gb)))
            w.graphs.append(graphs)
            w.nodes.append(nodes)
            w.edges.append(edges)
            if len(w.batches) < w.keep_batches:
                w.batches.append(gb)
            yield gb


def run_window(trainer, loader, window: Window) -> Window:
    """Epoch after epoch of train_epoch until the window closes (one epoch
    for a window without a close); an epoch whose mean loss is not finite
    counts its steps as failed."""
    while True:
        before = len(window.starts)
        result = trainer.train_epoch(window.feed(loader))
        if not math.isfinite(result.get("loss", 0.0)):
            window.failed += len(window.starts) - before
        if window.closed or window.seconds is None:
            return window
