"""Device activities in the traced window (the spin kernels that bracket
it left out) per step."""


def read(run):
    if run.trace is None or not run.trace["steps"]:
        return None
    return run.trace["n_ops"] / run.trace["steps"]
