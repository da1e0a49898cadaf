"""Host ms per step of the program's `step.optimizer` span (zero_grad and the
learning rate before the passes, Adam's step after them) over the traced
stretch.  Nothing where the program recorded no span (benchmark/spans.py)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(run, "step.optimizer")
