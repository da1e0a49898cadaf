"""Tensors copied to the device per step of the traced stretch: the
program's `h2d.copies` counter (observe.to_device, one per tensor whose
device changes: the batch's fields, its block layout's, the augmentation
draws).  Nothing where the program recorded no span (benchmark/spans.py)."""
from benchmark import spans


def read(run):
    return spans.counter_per_step(run, "h2d.copies")
