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
                   written as a Chrome trace.
  poison_padding   NaN in every float pad lane of a GraphBatch.  A
                   reduction that lets a pad lane in turns the output NaN.
                   In both packages the flat layout's eval forward stays
                   finite under it; training mode (batch norm's masked
                   statistics) and the block layout (its dense block
                   products) multiply pad rows by 0, and 0 * NaN is NaN.
  step_fingerprint order-sensitive hash of a module's state_dict, to compare
                   runs or processes that should hold the same weights.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from .graph import GraphBatch


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
    """Run step_fn(*args, **kwargs) n_steps times under torch.profiler (the
    CUDA activity too when a card is present, synchronised before the
    capture ends) and write the Chrome trace to trace_dir/trace.json.
    Returns the last call's output."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    out = None
    with profile(activities=activities) as prof:
        for _ in range(n_steps):
            out = step_fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return out


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
