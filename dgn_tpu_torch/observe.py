"""Observability (counterpart of `dgn_tpu/observe.py`): metric stream,
throughput counters, profiler capture and two debug checks.

  MetricStream     append-only JSONL, one {"t", "kind", ...} record per
                   call, line-buffered; the record shape is dgn_tpu's, so
                   `tools/report.py` of either package reads either's.
  Throughput       edges/s, nodes/s and graphs/s over the REAL (unpadded)
                   elements, plus padding efficiencies.  It reads the
                   loader's CPU batch: a sum over a device copy's masks
                   would wait for the card on every step.
  profile_steps    torch.profiler capture of n calls of a step function,
                   with the program's spans, written as a Chrome trace.
  poison_padding   NaN in every float pad lane of a GraphBatch.  A
                   reduction that lets a pad lane in turns the output NaN.
                   In both packages the flat layout's eval forward stays
                   finite under it; training mode (batch norm's masked
                   statistics) and the block layout (its dense block
                   products) multiply pad rows by 0, and 0 * NaN is NaN.
  step_fingerprint order-sensitive hash of a module's state_dict, to compare
                   runs or processes that should hold the same weights.
  span, count      the span and counter recorder (below).

The recorder.  `span(name)` is a context manager around one piece of host
work, `count(name, n)` adds to a named counter.  Off (the default), span
returns one shared no-op context and count returns at once: no
allocation, no clock read.  On (`tracing()`, or `enable()` / `disable()`),
each span records its name, its start and end (time.perf_counter_ns), its
parent (the innermost span open when it started) and the step index the
trainer advances (`next_step`), so one iteration's spans share an
identifier.  Per name the recorder keeps the count, the total ns and the
self ns (the duration less what its child spans cover); the raw records go
to a buffer of RECORD_CAPACITY, the oldest dropped first.  While a
torch.profiler is active each span is also a record_function range named
"dgn." + name, on the profiler's clock beside the device activity.  Spans
never synchronise the device: they time the host, which issues the work.
While the recorder is on, every garbage collection is a span "gc" and
counts `gc.gen<g>`.  `summary()` reads the totals, the counters and the
kernels' own launch counters (`build_pair_adjacency.launches`,
`segment_extremes_fwd/bwd.launches`: their growth while the recorder was
on), which it does not count again.  They count kernel executions: a
replayed CUDA graph adds the launches its capture recorded
(`add_launches`).

Where the spans are (names are part of the record): data/loader.py
`loader.shuffle`, `loader.pack` (one batch, from next() to its yield) and
inside it `loader.escape` (the repack at the exact need); graph.py
`pack.arrays` (pack_graphs) and inside it, on the numpy block path,
`pack.block_layout` (build_mxu_layout), with counters `pack.native` and
`pack.numpy` (the block batches each path packed); train/trainer.py
`step` with `step.optimizer`
(zero_grad and the learning rate before the passes, Adam's step after
them), `step.h2d`, `step.forward`, `step.backward`, `step.grad_sync`, and
per batch of train_epoch `epoch.readback` and `epoch.account`, then
`epoch.finish`; models/dgn_net.py `model.edge_context`, `model.encode`,
`model.layer_<i>`, `model.readout` (on an eager step; a replayed step,
train/graphs.py, runs no Python inside the model), and on a captured
step `step.capture`.  Counters `h2d.copies` and `h2d.bytes`
(`to_device` and `copy_into`: one per tensor whose device changes), and
`step.eager`, `step.graph_captures` and `step.graph_replays` (how each
train step ran), `epoch.readback_deferred` and `epoch.readback_ready`
(train_epoch's steps read back after the next batch's pack, and those of
them already on the host by then).  train_epoch turns the
recorder on for an epoch that runs under an active torch.profiler
(`following_profiler`), so any profile of the training loop holds the
program's ranges.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import os
import time
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from .graph import GraphBatch

RECORD_CAPACITY = 1 << 16
PROFILER_PREFIX = "dgn."


class MetricStream:
    """Append-only JSONL metric log at path.  One record per call,
    timestamped in seconds since the stream was opened."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, kind: str, **fields):
        rec = {"t": round(time.time() - self._t0, 3), "kind": kind, **fields}
        self._fh.write(json.dumps(rec, default=float) + "\n")
        return rec

    def close(self) -> None:
        self._fh.close()


class Throughput:
    """edges/s (and nodes/s, graphs/s) over real elements, and padding
    efficiencies, since construction."""

    def __init__(self):
        self.edges = self.nodes = self.graphs = 0
        self.pad_edges = self.pad_nodes = 0
        self.steps = 0
        self._t0 = time.perf_counter()

    def add_batch(self, gb: GraphBatch) -> None:
        """Count one packed batch, from its masks on the CPU."""
        if gb.edge_mask.device.type != "cpu":
            raise ValueError("Throughput.add_batch takes the loader's CPU "
                             "batch, not its device copy")
        em, nm = gb.edge_mask.numpy(), gb.node_mask.numpy()
        e, n = int(em.sum()), int(nm.sum())
        self.edges += e
        self.nodes += n
        self.graphs += int(gb.graph_mask.numpy().sum())
        self.pad_edges += em.size - e
        self.pad_nodes += nm.size - n
        self.steps += 1

    def result(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        tot_e = self.edges + self.pad_edges
        tot_n = self.nodes + self.pad_nodes
        return {
            "seconds": dt,
            "steps": self.steps,
            "edges_per_s": self.edges / dt,
            "nodes_per_s": self.nodes / dt,
            "graphs_per_s": self.graphs / dt,
            "edge_padding_efficiency": self.edges / tot_e if tot_e else 1.0,
            "node_padding_efficiency": self.nodes / tot_n if tot_n else 1.0,
        }


def profile_steps(step_fn, n_steps: int, trace_dir: str, *args, **kwargs):
    """Run step_fn(*args, **kwargs) n_steps times under torch.profiler, with
    the recorder on (the "dgn." ranges of the program's spans sit beside
    the operations), and write the Chrome trace to trace_dir/trace.json.
    With a card the CUDA activity is captured too: the capture opens and
    closes with SENTINELS launches of torch's spin kernel and a
    synchronise, as the profiler has dropped device activities at a
    window's edges.  Returns the last call's output."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    out = None
    with profile(activities=activities) as prof, tracing():
        _sentinels(cuda)
        for _ in range(n_steps):
            out = step_fn(*args, **kwargs)
        _sentinels(cuda)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return out


SENTINELS = 8


def _sentinels(cuda: bool) -> None:
    if cuda:
        for _ in range(SENTINELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()


def poison_padding(gb: GraphBatch) -> GraphBatch:
    """gb with NaN in every padded node/edge lane of its float arrays (eig,
    snorm_n, snorm_e, float node and edge features, pos_enc).  Integer
    feature arrays cannot hold NaN and stay as they are.  An attached
    EdgeContext is dropped: it was built from the clean arrays."""
    nan = float("nan")

    def poison(arr, mask):
        if arr is None or not arr.is_floating_point():
            return arr
        m = mask.reshape(mask.shape + (1,) * (arr.dim() - 1))
        return torch.where(m, arr, nan)

    return dataclasses.replace(
        gb, eig=poison(gb.eig, gb.node_mask),
        snorm_n=poison(gb.snorm_n, gb.node_mask),
        snorm_e=poison(gb.snorm_e, gb.edge_mask),
        node_feat=poison(gb.node_feat, gb.node_mask),
        edge_feat=poison(gb.edge_feat, gb.edge_mask),
        pos_enc=poison(gb.pos_enc, gb.node_mask), edge_ctx=None)


def step_fingerprint(module_or_state) -> int:
    """Order-sensitive 32-bit fingerprint of a module's state_dict (or of a
    mapping of tensors), over its entries in order.  Each word (a float's
    bits) is scaled by an odd multiplier derived from its (entry, element)
    position before the entry's sum, and the entries are chained with an
    FNV-style multiply-xor, so swapped elements or swapped entries change
    it.  Computed on the host."""
    state = (module_or_state.state_dict()
             if isinstance(module_or_state, torch.nn.Module)
             else module_or_state)
    prime = np.uint32(16777619)
    total = np.uint32(0)
    with np.errstate(over="ignore"):
        for li, t in enumerate(state.values()):
            a = t.detach().cpu()
            if a.is_floating_point():
                bits = a.float().numpy().view(np.uint32)
            else:
                bits = a.numpy().astype(np.uint32)
            bits = bits.reshape(-1)
            idx = (np.arange(bits.size, dtype=np.uint32)
                   + np.uint32((li * 2654435761) & 0xFFFFFFFF))
            mult = (idx * np.uint32(2654435761)
                    + np.uint32(2246822519)) | np.uint32(1)
            word = np.sum(bits * mult + mult, dtype=np.uint32)
            total = np.uint32((total * prime) ^ word)
    return int(total)


# ------------------------------------------------------------- the recorder
class _NoSpan:
    """The one context span() returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Recorder:
    """The process's spans and counters (module docstring)."""

    def __init__(self, capacity: int = RECORD_CAPACITY):
        self.on = False
        self.step = 0
        self.open: list = []            # the open spans, innermost last
        self.totals: Dict[str, list] = {}   # name -> [count, ns, self ns]
        self.counters: Dict[str, int] = {}
        self.records = collections.deque(maxlen=capacity)
        self.top_ns = 0                 # spans that had no parent
        self.on_ns = 0                  # time the recorder was on
        self._since: Optional[int] = None
        self._launch0: Dict[str, int] = {}  # launch counters when turned on
        self._ids = 0
        self._gc: list = []             # the collection in progress

    def close(self, sp: "_Span", end: int) -> None:
        dur = end - sp.start
        parent = sp.parent
        if parent is None:
            self.top_ns += dur
        else:
            parent.child_ns += dur
        t = self.totals.get(sp.name)
        if t is None:
            t = self.totals[sp.name] = [0, 0, 0]
        t[0] += 1
        t[1] += dur
        t[2] += dur - sp.child_ns
        self.records.append((sp.id, sp.name, sp.start, end,
                             None if parent is None else parent.id, sp.step))


RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "id", "start", "child_ns", "parent", "step", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.child_ns = 0
        self._rf = None

    def __enter__(self):
        r = RECORDER
        r._ids += 1
        self.id = r._ids
        self.parent = r.open[-1] if r.open else None
        self.step = r.step
        r.open.append(self)
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.autograd.profiler.record_function(
                PROFILER_PREFIX + self.name)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        r = RECORDER
        if r.open and r.open[-1] is self:
            r.open.pop()
        elif self in r.open:        # a collection on another thread
            r.open.remove(self)
        r.close(self, end)
        return False


def span(name: str):
    """A context manager that records one span of host work as name (the
    shared no-op while the recorder is off)."""
    if not RECORDER.on:
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter name (nothing while the recorder is off)."""
    if RECORDER.on:
        c = RECORDER.counters
        c[name] = c.get(name, 0) + n


def next_step() -> None:
    """Advance the step index that the spans opened from now on carry."""
    RECORDER.step += 1


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """t.to(device), counted as one of `h2d.copies` and its bytes in
    `h2d.bytes` when the recorder is on and the tensor changes device."""
    out = t.to(device)
    if RECORDER.on and out is not t:
        count("h2d.copies")
        count("h2d.bytes", t.numel() * t.element_size())
    return out


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst.copy_(src), counted as to_device counts a copy when the two
    live on different devices."""
    dst.copy_(src)
    if RECORDER.on and dst.device != src.device:
        count("h2d.copies")
        count("h2d.bytes", src.numel() * src.element_size())


def _on_gc(phase: str, info: dict) -> None:
    r = RECORDER
    if phase == "start":
        sp = _Span("gc")
        sp.__enter__()
        r._gc.append(sp)
        count(f"gc.gen{info.get('generation', 0)}")
    elif r._gc:
        r._gc.pop().__exit__(None, None, None)


def enable() -> None:
    """Turn the recorder on (the totals and records kept so far stay)."""
    r = RECORDER
    if r.on:
        return
    r.on = True
    r._since = time.perf_counter_ns()
    r._launch0 = launch_counts()
    gc.callbacks.append(_on_gc)


def disable() -> None:
    r = RECORDER
    if not r.on:
        return
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    r.on = False
    r.on_ns += time.perf_counter_ns() - r._since
    r._since = None
    for k, v in _launches_since(r._launch0).items():
        r.counters[k] = r.counters.get(k, 0) + v


def reset() -> None:
    """Drop every total, counter and record (the on/off state stays)."""
    r = RECORDER
    r.totals, r.counters = {}, {}
    r.records.clear()
    r.top_ns = r.on_ns = 0
    if r.on:
        r._since = time.perf_counter_ns()
        r._launch0 = launch_counts()


@contextlib.contextmanager
def tracing():
    """The recorder on inside the block; a block inside another leaves it
    on for the outer one."""
    was = RECORDER.on
    enable()
    try:
        yield RECORDER
    finally:
        if not was:
            disable()


def following_profiler():
    """tracing() while a torch.profiler is active, else the no-op."""
    if torch._C._autograd._profiler_enabled():
        return tracing()
    return _NO_SPAN


def _counted_kernels() -> dict:
    """The kernel wrappers that count their launches, by counter name."""
    from .ops import adjacency, extremes
    return {"build_pair_adjacency.launches": adjacency.build_pair_adjacency,
            "segment_extremes_fwd.launches": extremes.segment_extremes_fwd,
            "segment_extremes_bwd.launches": extremes.segment_extremes_bwd}


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters now, by counter name."""
    return {k: fn.launches for k, fn in _counted_kernels().items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add counts (by counter name) to the kernels' launch counters: the
    launches a replayed CUDA graph runs, which no Python call counts, or
    minus those a capture recorded without running them."""
    fns = _counted_kernels()
    for k, n in counts.items():
        fns[k].launches += n


def _launches_since(base: Dict[str, int]) -> Dict[str, int]:
    return {k: v - base.get(k, 0) for k, v in launch_counts().items()}


def snapshot() -> dict:
    """The recorder's totals and counters now, for summary(since=...);
    the kernels' launch counters count the launches made while it was
    on."""
    r = RECORDER
    on, counters = r.on_ns, dict(r.counters)
    if r.on:
        on += time.perf_counter_ns() - r._since
        for k, v in _launches_since(r._launch0).items():
            counters[k] = counters.get(k, 0) + v
    return {"totals": {k: list(v) for k, v in r.totals.items()},
            "counters": counters, "top_ns": r.top_ns, "on_ns": on}


def summary(since: Optional[dict] = None) -> dict:
    """Per span name its count, ms and self ms, the counters (the kernels'
    launch counters among them), the ms that spans without a parent cover
    and the ms the recorder was on; since a snapshot(), what came after
    it."""
    now = snapshot()
    old = since or {"totals": {}, "counters": {}, "top_ns": 0, "on_ns": 0}
    spans = {}
    for name, (n, ns, self_ns) in now["totals"].items():
        n0, ns0, self0 = old["totals"].get(name, (0, 0, 0))
        if n > n0:
            spans[name] = {"count": n - n0, "ms": (ns - ns0) / 1e6,
                           "self_ms": (self_ns - self0) / 1e6}
    counters = {k: v - old["counters"].get(k, 0)
                for k, v in now["counters"].items()}
    counters = {k: v for k, v in counters.items()
                if v or k.endswith(".launches")}
    return {"spans": spans, "counters": counters,
            "top_level_ms": (now["top_ns"] - old["top_ns"]) / 1e6,
            "on_ms": (now["on_ns"] - old["on_ns"]) / 1e6}


def per_step(s: dict) -> dict:
    """A summary() as the metric stream records it: per span its count and
    ms and self ms per train step (`step` spans), then the counters."""
    steps = s["spans"].get("step", {}).get("count", 0)
    div = max(steps, 1)
    return {"steps": steps,
            "spans": {k: {"count": v["count"],
                          "ms_per_step": round(v["ms"] / div, 4),
                          "self_ms_per_step": round(v["self_ms"] / div, 4)}
                      for k, v in sorted(s["spans"].items())},
            "counters": s["counters"]}
