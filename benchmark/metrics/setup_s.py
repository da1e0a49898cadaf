"""Seconds from the harness's first statement to the first timed request
for a batch: inputs, prepare, weights, the warm-up epoch (and, in a
checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
