"""A cell of BENCHMARK.json and the files it names, found by name alone.
A new configuration, of any task the program trains, brings these files
and its entries in BENCHMARK.json, and edits none that is there:

  benchmark/configs/<config>.json      the configuration as it is run
  benchmark/traffic/<traffic>.json     the inputs ("data": the generator
                                       and its parameters; "meta") and
                                       the run's flags laid over the
                                       configuration (micro_batches too)
  benchmark/limits/<cell>.json         the correctness limits
  benchmark/reference/tasks/<task>.py  the reference's encoder, readout
                                       width, loss and loss denominator,
                                       and the encoder's FLOPs, for a task
                                       (the program's cfg.task) with no
                                       file yet
  benchmark/inputs/<generator>.py      make(spec, count, seed, split),
                                       for inputs no generator makes yet
  benchmark/metrics/<metric>.py        read(run), for each new metric

A reader's run holds the window's steps (each step's real graphs, nodes
and edges, summed over its micro-batches) and, in a traced run, the
trace's reduction, `launches` (each kernel launch counter's growth over
the traced stretch, by kernel name), `traced_sizes` (each traced
micro-batch's real nodes, edges and graphs) and `traced_blocks` (each
traced block-layout micro-batch's real edges and covered pairs)."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config_file: Path
    config: Dict            # the configuration file, as written
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]  # the metrics this cell reports
    per_layer: List[Dict]


def _load(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(name: str, spec: Optional[Dict] = None) -> Cell:
    """The cell called name; KeyError if BENCHMARK.json has none."""
    spec = spec if spec is not None else _load(SPEC)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if m["moves"] in moved and _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config_name=conf["name"],
                config_file=ROOT / conf["file"],
                config=_load(ROOT / conf["file"]),
                traffic=_load(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_load(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader_path(metric: str) -> Path:
    return HERE / "metrics" / f"{metric}.py"
