"""Share of the traced stretch's train steps whose loss and scores were
already on the host when train_epoch came to read them, in %: 100 x the
program's `epoch.readback_ready` counter per `step` span
(dgn_tpu_torch/train/trainer.py, which reads step n back after it has
packed batch n+1).  0 where the program deferred its readbacks
(`epoch.readback_deferred`) and none was ready; nothing where it recorded
no span or counts neither (a program that reads each step back at once;
benchmark/spans.py)."""
from benchmark import spans


def read(run):
    s = spans.recorded(run)
    if s is None:
        return None
    c = s["counters"]
    if "epoch.readback_ready" not in c \
            and "epoch.readback_deferred" not in c:
        return None
    return 100.0 * c.get("epoch.readback_ready", 0) / spans.steps(s)
