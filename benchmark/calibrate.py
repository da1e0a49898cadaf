"""The readings that the correctness limits are set from, on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3
        [--control-seeds 1,2,3] [--out FILE]

For each seed, the cell is set up as a run sets it up and its warm-up
epoch trains the checked steps; the reference then follows them in float32
(the sound reading: the program against it), in TF32 (the control, put in
the program's place) and with half of each batch left out, the mean taken
over the rest (a planted fault, in the program's place).  A state left
unchanged reads change_gap 1 and needs no run.  One JSON line per seed."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from benchmark import cells, check
    from benchmark.bench import require_cards
    from benchmark.program import CellRun
    cell = cells.find(args.workload)
    require_cards(torch, cell.chips)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = CellRun(cell, seed, "cuda", log=lambda m: None)
        run.warm_up()
        prog = run.readings()
        case = run.reference_case()
        run.free()
        ref = run.follow(case)
        row = {"workload": cell.name, "seed": seed}
        r = check.readings(prog, ref)
        row["sound"] = dict(r)
        if seed in controls:
            for name, kw in (("control_tf32", {"precision": "tf32"}),
                             ("half_batch", {"keep_graphs": 0.5})):
                r = check.readings(run.follow(case, **kw), ref)
                row[name] = dict(r)
        row["seconds"] = time.perf_counter() - t
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
