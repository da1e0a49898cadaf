"""Share of the traced stretch's train steps replayed from CUDA graphs, in
%: 100 x the program's `step.graph_replays` counter per `step` span
(dgn_tpu_torch/train/graphs.py).  0 where the program counted its eager
steps (`step.eager`) and replayed none; nothing where it recorded no span
or counts neither (a program without the graph path; benchmark/spans.py)."""
from benchmark import spans


def read(run):
    s = spans.recorded(run)
    if s is None:
        return None
    c = s["counters"]
    if "step.graph_replays" not in c and "step.eager" not in c:
        return None
    return 100.0 * c.get("step.graph_replays", 0) / spans.steps(s)
