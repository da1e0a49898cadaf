"""The program's own spans and counters (dgn_tpu_torch/observe.py), as the
benchmark reads them, and the trace's reduction by them.

Readers.  A traced run's profiled stretch runs train_epoch under
torch.profiler, and the program turns its recorder on for an epoch it
runs under an active profiler: the per-layer metrics loader_pack_ms,
h2d_ms_per_step, h2d_copies_per_step, forward_ms_per_step,
backward_ms_per_step, optimizer_ms_per_step and readback_ms_per_step read
the recorder's totals over that stretch (`recorded`, kept on the run as
run.spans), per `step` span.  A program without the recorder, an untraced
run, or a stretch that recorded no step gives None, and each of them reads
nothing.  The first reader prints one stderr line: each span's count, ms
and self ms per step, the counters per step, and the share of the
recorder's time that spans without a parent cover.

Reduction.  `label_gaps` labels an idle gap of the device by the
benchmark's span at its middle, as devtrace.reduce does, followed by the
innermost program span open there ("pack/pack.block_layout");
`ops_by_span` puts each device operation in the innermost program span
open when the host called the CUDA runtime to launch it (their
correlation ids tie the two), the rest in a remainder.

    python3 benchmark/spans.py --workload zinc-block --seed <n>
        [--seconds 10] [--pairs 3] [--trace_seconds 1.5]

sets the cell up as a run does, then runs windows of --seconds with the
recorder off and on in turns (--pairs of each: the cost of the spans),
prints the span table and its coverage of the last window with the
recorder on and that window's mean pack beside loader.pack's, and then
profiles --trace_seconds of the loop and prints the ten longest idle gaps
so labelled and the device operations per program span.  It needs a card
and is no part of a benchmark run."""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]


def recorded(run) -> Optional[dict]:
    """The program's span summary over the traced stretch (run.spans once
    read), or None where there is none to read."""
    if not hasattr(run, "spans"):
        run.spans = _read(run)
        if run.spans is not None:
            print(describe(run.spans), file=sys.stderr, flush=True)
    return run.spans


def _read(run) -> Optional[dict]:
    if getattr(run, "trace", None) is None:
        return None
    from dgn_tpu_torch import observe
    summary = getattr(observe, "summary", None)
    if summary is None:
        return None
    s = summary()
    if not s["spans"].get("step", {}).get("count"):
        return None
    return s


def steps(s: dict) -> int:
    return s["spans"]["step"]["count"]


def ms_per_step(run, name: str) -> Optional[float]:
    """ms of span name per step of the stretch; None where it never ran."""
    s = recorded(run)
    if s is None or name not in s["spans"]:
        return None
    return s["spans"][name]["ms"] / steps(s)


def counter_per_step(run, name: str) -> Optional[float]:
    s = recorded(run)
    if s is None or name not in s["counters"]:
        return None
    return s["counters"][name] / steps(s)


def describe(s: dict) -> str:
    n = steps(s)
    table = {k: [v["count"], round(v["ms"] / n, 4), round(v["self_ms"] / n, 4)]
             for k, v in sorted(s["spans"].items())}
    counters = {k: round(v / n, 3) for k, v in sorted(s["counters"].items())}
    return ("benchmark: spans per step (count, ms, self ms) over "
            f"{n} steps {json.dumps(table)} counters per step "
            f"{json.dumps(counters)} top-level {s['top_level_ms']:.3f} of "
            f"{s['on_ms']:.3f} ms on, uncovered "
            f"{s['on_ms'] - s['top_level_ms']:.3f} ms")


# ------------------------------------------------------------- reduction
def innermost(spans: Sequence[Interval]) -> Callable[[float], Optional[str]]:
    """A lookup of the innermost of spans (name, start, end) open at a
    time: the span opened last of those open, found by bisection."""
    ev = []
    for i, (_, a, b) in enumerate(spans):
        ev += [(a, 1, -b, i), (b, 0, 0, i)]
    ev.sort()
    stack: List[int] = []
    times: List[float] = []
    names: List[Optional[str]] = []
    for t, opens, _, i in ev:
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
        top = spans[stack[-1]][0] if stack else None
        if times and times[-1] == t:
            names[-1] = top
        else:
            times.append(t)
            names.append(top)

    def at(t: float) -> Optional[str]:
        k = bisect.bisect_right(times, t) - 1
        return names[k] if k >= 0 else None
    return at


def label_gaps(gaps: Sequence[Tuple[float, float]],
               bench: Sequence[Interval],
               program: Sequence[Interval]) -> List[list]:
    """[label, seconds] of each gap (start, end in microseconds): the first
    benchmark span holding its middle ("readback" where none does), then
    "/" and the innermost program span there, where one is open."""
    inner_at = innermost(program)
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        label = next((n for n, s, e in bench if s <= mid <= e), "readback")
        inner = inner_at(mid)
        out.append([label if inner is None else f"{label}/{inner}",
                    (b - a) / 1e6])
    return out


def ops_by_span(ops: Sequence[int], launches: Dict[int, float],
                program: Sequence[Interval]) -> Tuple[Dict[str, int], int]:
    """Device operations (their correlation ids) per innermost program
    span open at their launch call's host time (launches: correlation ->
    time); the operations outside every span, or with no launch call in
    the trace, are the remainder."""
    inner_at = innermost(program)
    per: Dict[str, int] = {}
    rest = 0
    for c in ops:
        t = launches.get(c)
        name = None if t is None else inner_at(t)
        if name is None:
            rest += 1
        else:
            per[name] = per.get(name, 0) + 1
    return per, rest


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_chrome(events: List[dict], top: int = 10) -> dict:
    """The window's device operations, gaps and program spans from a
    Chrome trace of torch.profiler: the ten longest gaps labelled, the
    operations per program span and their remainder."""
    from benchmark import devtrace
    bench, program, launches, dev = [], [], {}, []
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if e.get("ph") != "X":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat == "user_annotation" and name.startswith(devtrace.SPAN):
            bench.append((name[len(devtrace.SPAN):], a, b))
        elif cat == "user_annotation" and name.startswith("dgn."):
            program.append((name[4:], a, b))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = a
        elif cat in DEVICE_CATS and devtrace.SPIN not in name:
            dev.append((e.get("args", {}).get("correlation"), a, b))
    windows = [(a, b) for n, a, b in bench if n == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    w0, w1 = windows[0]
    dev = [(c, max(a, w0), min(b, w1)) for c, a, b in dev
           if b > w0 and a < w1]
    busy = devtrace.union([(a, b) for _, a, b in dev])
    gaps, cur = [], w0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < w1:
        gaps.append((cur, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    per, rest = ops_by_span([c for c, _, _ in dev], launches, program)
    host = [s for s in bench if s[0] != "window"]
    return {"n_ops": len(dev), "ops_by_span": per, "ops_outside": rest,
            "idle_gaps": label_gaps(gaps, host, program)}


# ------------------------------------------------------------- the study
def _windows(torch, trainer, loader, seconds: float, pairs: int, log):
    """pairs of windows, recorder off then on (on then off in every other
    pair); the last window with the recorder on is returned with its
    summary."""
    from dgn_tpu_torch import observe
    from benchmark.window import Window, run_window
    last = None
    for i in range(2 * pairs):
        on = (i % 2 == 1) != (i // 2 % 2 == 1)
        observe.reset()
        w = Window(seconds)
        with observe.tracing() if on else contextlib.nullcontext():
            run_window(trainer, loader, w)
        torch.cuda.synchronize()
        st = w.stats()
        pack_ms = 1e3 * sum(w.pack_s) / len(w.pack_s)
        log(f"spans: window {i} recorder {'on' if on else 'off'} "
            f"graphs/s {st['graphs'] / st['seconds']:.1f} steps "
            f"{st['steps']} pack_ms {pack_ms:.4f}")
        if on:
            last = (w, observe.summary())
    return last


def _span_cost(on: bool, n: int = 200_000) -> float:
    """ns per span() call and its with-block, the recorder off or on."""
    from dgn_tpu_torch import observe
    with observe.tracing() if on else contextlib.nullcontext():
        t = time.perf_counter_ns()
        for _ in range(n):
            with observe.span("x"):
                pass
        ns = (time.perf_counter_ns() - t) / n
    observe.reset()
    return ns


def study(cell, seed: int, seconds: float, pairs: int,
          trace_seconds: float, log) -> dict:
    import torch
    from dgn_tpu_torch import observe
    from benchmark import devtrace
    from benchmark.program import CellRun
    from benchmark.window import Window, run_window
    prog = CellRun(cell, seed, "cuda", log)
    prog.warm_up()
    trainer, loader = prog.trainer, prog.loader
    torch.cuda.synchronize()
    w, s = _windows(torch, trainer, loader, seconds, pairs, log)
    log(describe(s))
    per_step = steps(s)
    pack = 1e3 * sum(w.pack_s) / len(w.pack_s)
    loader_pack = s["spans"]["loader.pack"]["ms"] / s["spans"][
        "loader.pack"]["count"]
    log(f"spans: same window pack_ms {pack:.4f} loader.pack ms "
        f"{loader_pack:.4f} ratio {loader_pack / pack:.4f}; coverage "
        f"{s['top_level_ms'] / s['on_ms']:.4f} of {s['on_ms']:.1f} ms, "
        f"uncovered {s['on_ms'] - s['top_level_ms']:.1f} ms "
        f"({(s['on_ms'] - s['top_level_ms']) / per_step:.4f} ms a step)")
    spans_per_step = sum(v["count"] for v in s["spans"].values()) / per_step
    cost = {on: _span_cost(on) for on in (False, True)}
    log(f"spans: span() off {cost[False]:.1f} ns, on {cost[True]:.1f} ns, "
        f"{spans_per_step:.2f} spans a step: "
        f"{cost[False] * spans_per_step / 1e3:.3f} us a step off, "
        f"{cost[True] * spans_per_step / 1e3:.3f} us on")

    inner = trainer.train_step

    def step(gb, aug=None):
        with devtrace.record(torch, "train_step"):
            return inner(gb, aug)

    trainer.train_step = step
    tw = Window(trace_seconds, span=lambda n: devtrace.record(torch, n))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        devtrace._sentinels(torch)
        with devtrace.record(torch, "window"):
            run_window(trainer, loader, tw)
        torch.cuda.synchronize()
        devtrace._sentinels(torch)
    del trainer.train_step
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.remove(path)
    r = reduce_chrome(events)
    r["steps"] = len(tw.starts)
    # the operations as devtrace.reduce counts them, from the same profile
    cuda = torch.autograd.DeviceType.CUDA
    raw = {"device": [], "spans": []}
    for e in prof.events():
        if e.device_type == cuda:
            if not (getattr(e, "is_user_annotation", False)
                    or devtrace.SPIN in e.name):
                raw["device"].append((e.name, e.time_range.start,
                                      e.time_range.end))
        elif e.name.startswith(devtrace.SPAN):
            raw["spans"].append((e.name[len(devtrace.SPAN):],
                                 e.time_range.start, e.time_range.end))
    r["devtrace_n_ops"] = devtrace.reduce(raw)["n_ops"]
    log("spans: idle gaps " + json.dumps(r["idle_gaps"]))
    log(f"spans: device ops {r['n_ops']} over {r['steps']} steps "
        f"({r['n_ops'] / r['steps']:.2f} a step); by span "
        + json.dumps(dict(sorted(r["ops_by_span"].items())))
        + f"; outside every span {r['ops_outside']}; sum "
        f"{sum(r['ops_by_span'].values()) + r['ops_outside']}; devtrace "
        f"counts {r['devtrace_n_ops']}")
    return {"summary": s, "trace": r, "span_ns": cost}


def main(argv=None) -> int:
    from benchmark import cells
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--trace_seconds", type=float, default=1.5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("spans: no CUDA device is available")
    study(cells.find(args.workload), args.seed, args.seconds, args.pairs,
          args.trace_seconds,
          lambda m: print(m, file=sys.stderr, flush=True))
    return 0


if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
        sys.path[0] = str(ROOT)
    sys.exit(main())
