"""Host ms per step of the program's `step.h2d` span (the batch's and the
augmentation draws' .to(device)) over the traced stretch.  Nothing where
the program recorded no span (benchmark/spans.py)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(run, "step.h2d")
