"""The traced window: torch.profiler over a short stretch of the training
loop, and its reduction to device busy time, idle gaps and operations.

The profiler window opens and closes with launches of torch's spin kernel,
which the reduction leaves out: on this card the profiler has dropped
activities at a window's edges.  The benchmark's own spans (bench.pack
around the loader's next(), bench.train_step around the trainer's step,
bench.window around the whole stretch) are record_function ranges; an idle
gap of the device is labelled by the span its middle falls in, and
`readback` outside both (train_epoch reading the loss and scores back)."""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

SENTINELS = 8
SPAN = "bench."
SPIN = "spin_kernel"


def record(torch, name: str):
    return torch.profiler.record_function(SPAN + name)


def _sentinels(torch):
    for _ in range(SENTINELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def profiled(torch, out: Dict):
    """Profile the body; out receives the device events and the spans."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sentinels(torch)
        yield
        torch.cuda.synchronize()
        _sentinels(torch)
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans = [], []
    for e in prof.events():
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) or SPIN in e.name:
                continue
            dev.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name.startswith(SPAN):
            spans.append((e.name[len(SPAN):], e.time_range.start,
                          e.time_range.end))
    out["device"] = dev
    out["spans"] = spans


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def reduce(out: Dict, top: int = 10) -> Dict:
    """busy and window seconds, device operations in the window, the top
    operations by time and the longest idle gaps by what the host did."""
    windows = [(a, b) for n, a, b in out["spans"] if n == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    w0, w1 = windows[0]
    dev = [(n, max(a, w0), min(b, w1)) for n, a, b in out["device"]
           if b > w0 and a < w1]
    busy = union([(a, b) for _, a, b in dev])
    busy_us = sum(b - a for a, b in busy)
    gaps, cur = [], w0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < w1:
        gaps.append((cur, w1))
    host = [(n, a, b) for n, a, b in out["spans"] if n != "window"]

    def label(mid):
        for n, a, b in host:
            if a <= mid <= b:
                return n
        return "readback"

    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    by_name: Dict[str, float] = {}
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "n_ops": len(dev),
            "kernel_s": {n: t / 1e6 for n, t in by_name.items()},
            "device_ops": [[n[:160], t / 1e6] for n, t in ops],
            "idle_gaps": [[label((a + b) / 2), (b - a) / 1e6]
                          for a, b in gaps]}
