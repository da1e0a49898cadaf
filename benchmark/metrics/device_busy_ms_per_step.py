"""The union of the device's activity intervals in the traced window, in
ms per step."""


def read(run):
    if run.trace is None or not run.trace["steps"]:
        return None
    return 1e3 * run.trace["busy_s"] / run.trace["steps"]
