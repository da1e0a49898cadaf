"""Readings of the host over the timed window, printed on standard error
beside the window's line: what a spread of rates between runs has to be
traced to.

  cpu_s, main_s    the process's and its main thread's CPU seconds in the
                   window: the same CPU seconds doing less work is a
                   slower host, fewer of them is a process held off its
                   core
  gc               the interpreter's collections in the window
  seg_graphs_per_s the rate in each SEGMENT_S of the window: within a run
                   against between runs"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

SEGMENT_S = 5.0


def snapshot() -> Dict:
    return {"cpu": time.process_time(), "main": time.thread_time(),
            "gc": sum(s["collections"] for s in gc.get_stats())}


def segment_rates(starts: List[float], graphs: List[int],
                  closed_at: float) -> List[float]:
    """graphs/s over each SEGMENT_S of the window, by request times."""
    out, t0, k = [], starts[0], 0
    while t0 + SEGMENT_S <= closed_at:
        n = 0
        while k < len(starts) and starts[k] < t0 + SEGMENT_S:
            n += graphs[k]
            k += 1
        out.append(n / SEGMENT_S)
        t0 += SEGMENT_S
    return out


def describe(a: Dict, b: Dict, window) -> str:
    """One stderr line on the host over the window, a and b its ends."""
    seg = segment_rates(window.starts, window.graphs, window.closed_at)
    return (f"benchmark: host cpu_s {b['cpu'] - a['cpu']:.3f} "
            f"main_s {b['main'] - a['main']:.3f} gc {b['gc'] - a['gc']} "
            "seg_graphs_per_s " + ",".join(f"{v:.0f}" for v in seg))
