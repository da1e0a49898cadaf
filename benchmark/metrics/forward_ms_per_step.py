"""Host ms per step of the program's `step.forward` span (the forward pass,
the loss and, where on, the augmentation) over the traced stretch.
Nothing where the program recorded no span (benchmark/spans.py)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(run, "step.forward")
