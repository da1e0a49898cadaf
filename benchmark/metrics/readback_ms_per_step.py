"""Host ms per step of the program's `epoch.readback` span (train_epoch
reading the scores and the loss back to the host) over the traced stretch.
Nothing where the program recorded no span (benchmark/spans.py)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(run, "epoch.readback")
