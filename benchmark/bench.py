"""One run of one cell of the benchmark of dgn_tpu_torch.

    python3 benchmark/bench.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (timed as setup_s, from this file's first statement to the first
timed request for a batch): the cell's inputs made from the seed
(benchmark/inputs), the config built through dgn_tpu_torch.config from the
cell's configuration and traffic files, the program's precision settings,
dgn_tpu_torch.run.prepare on the card with datasets.load_dataset handing it
those inputs, the weights drawn from the seed on the card (weights.py) and
loaded into the model, and one warm-up epoch, whose first three steps are
the ones the correctness check follows.  Then train_epoch runs epoch after
epoch over the shuffled train loader for --seconds (window.py), each step
packing its batch, stepping and reading the loss and scores back.  With
--trace 1 a short profiled stretch follows the window (devtrace.py) and the
run reports the per-layer metrics instead of the end-to-end ones.

Once the window has closed and the peak memory is read, the program is
freed and the plain reference (benchmark/reference) follows the first
three steps on the card; check.py decides `correct`.  The last line of
standard output is one JSON object; the numbers compared, with their
limits, are the last lines of standard error and the result's last key.
Without a card, or with fewer than the cell asks for, the run exits with
an error and prints no result."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the repository root, not this directory, heads the path: the package's
# module names would otherwise shadow others of the same name
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cells, counts, devtrace, hostload  # noqa: E402
from benchmark.window import Window, real_sizes, run_window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dgn_tpu")
TRACE_SECONDS = 3.0


def forbidden_modules():
    """Top-level names of loaded modules that a run may not hold, each
    compared whole (dgn_tpu_torch is not dgn_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_cards(torch, n: int) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("benchmark: no CUDA device is available; the "
                         "benchmark measures the card and runs nowhere else")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"benchmark: the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} are visible")


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        cells.reader_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def execute(cell, seed: int, seconds: float, traced: bool, device: str,
            t0: float = T0, log=None) -> dict:
    """One run of cell; returns the result object (printed by main)."""
    import torch
    from benchmark import check
    from benchmark.program import CellRun

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    log(f"benchmark: set-up imports {time.perf_counter() - t0:.3f} s")
    prog = CellRun(cell, seed, device, log)
    prog.warm_up()
    trainer, loader = prog.trainer, prog.loader
    if device == "cuda":
        torch.cuda.synchronize()

    loader_geometry = (loader.n_pad, loader.e_pad, loader.pair_pad)
    escapes = loader.n_escapes
    host = hostload.snapshot()
    window = run_window(trainer, loader, Window(seconds))
    host = hostload.describe(host, hostload.snapshot(), window)
    escapes = loader.n_escapes - escapes
    memory_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else 0)
    tr, stretch = None, {}
    if traced:
        tr, stretch = traced_stretch(torch, prog, seconds)
    readings = prog.readings()
    case = prog.reference_case()
    del trainer, loader
    prog.free()
    ref = prog.follow(case)
    numbers = check.readings(readings, ref)
    correct, shown = check.judge(numbers, cell.limits)

    wstats = window.stats()
    wstats.update(pack_s=window.pack_s, nodes=window.nodes,
                  edges=window.edges, graphs_per_step=window.graphs,
                  escapes=escapes)
    log(describe(wstats, loader_geometry))
    log(host)
    if tr is not None:
        log(f"benchmark: traced stretch {tr['steps']} steps, "
            f"{len(stretch['sizes'])} micro-batches, kernel launches "
            f"{json.dumps(stretch['launches'], sort_keys=True)}")
    run = types.SimpleNamespace(
        cell=cell, net=prog.net, task=prog.task, meta=cell.traffic["meta"],
        compute_dtype=prog.net.get("compute_dtype") or "float32",
        setup_s=window.starts[0] - t0, window=wstats, trace=tr,
        traced_blocks=stretch.get("blocks", []),
        launches=stretch.get("launches", {}),
        traced_sizes=stretch.get("sizes", []),
        device_kind=(torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
        peaks=json.loads((cells.HERE / "peaks.json").read_text()),
        counts=counts)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": wstats["steps"],
        "failed": window.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": run.device_kind, "count": cell.chips,
                   "memory_peak_bytes": int(memory_peak)},
    }
    if tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["readings"] = {k: numbers[k] for k in (
        "grad_at", "change_gap_worst", "change_at", "left_out")}
    result["check"] = shown
    check.print_lines(shown)
    return result


def describe(w: dict, geometry) -> str:
    """One stderr line on the window: what a spread between runs needs."""
    import numpy as np
    it = np.asarray(w["iter_s"]) * 1e3
    pack = np.asarray(w["pack_s"]) * 1e3
    return (f"benchmark: window {w['seconds']:.3f} s, {w['steps']} steps, "
            f"iteration ms median {np.median(it):.3f} p95 "
            f"{np.percentile(it, 95):.3f} max {it.max():.3f}, pack ms median "
            f"{np.median(pack):.3f} mean {pack.mean():.3f}, escapes "
            f"{w['escapes']}, geometry (n_pad, e_pad, pairs) {geometry}")


def traced_stretch(torch, prog, seconds: float):
    """A profiled stretch of the same loop after the window: the trace's
    reduction, with its step count and build_pair_adjacency's launches
    ("launches"), and what a kernel's reader needs of the stretch:
      launches  every launch counter the program's kernels keep
                (observe.launch_counts), by kernel name: its launches in
                the stretch, replayed ones included;
      sizes     (real nodes, real edges, real graphs) of each traced
                micro-batch (a batch without micro-batches is one);
      blocks    (real edges, covered pairs) of each traced block-layout
                micro-batch."""
    from dgn_tpu_torch import observe
    from benchmark.program import block_stats
    trainer = prog.trainer
    tw = Window(min(TRACE_SECONDS, seconds),
                span=lambda n: devtrace.record(torch, n))
    tw.keep_batches = 1 << 30
    inner = trainer.train_step

    def step(gb, aug=None):
        with devtrace.record(torch, "train_step"):
            return inner(gb, aug)

    trainer.train_step = step
    before = observe.launch_counts()
    raw = {}
    try:
        with devtrace.profiled(torch, raw):
            with devtrace.record(torch, "window"):
                run_window(trainer, prog.loader, tw)
    finally:
        del trainer.train_step
    launches = {k.removesuffix(".launches"): n - before.get(k, 0)
                for k, n in observe.launch_counts().items()}
    tr = devtrace.reduce(raw)
    tr["steps"] = len(tw.starts)
    tr["launches"] = launches.get("build_pair_adjacency", 0)
    return tr, {"launches": launches,
                "sizes": [s for b in tw.batches for s in real_sizes(b)],
                "blocks": block_stats(tw.batches)}


def main(argv=None) -> int:
    args = parse(argv)
    cell = cells.find(args.workload)
    import torch
    require_cards(torch, cell.chips)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: the run loaded {found}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
