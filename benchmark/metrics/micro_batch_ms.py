"""Host ms of the program's `step.micro` span per micro-batch (one
micro-batch's copy to the card, forward and backward, issued from
Python; dgn_tpu_torch/train/trainer.py train_step) over the traced
stretch.  Nothing where the program recorded no such span: a program
without it, or a cell whose steps are not micro-batched
(benchmark/spans.py)."""
from benchmark import spans


def read(run):
    s = spans.recorded(run)
    if s is None or not s["spans"].get("step.micro", {}).get("count"):
        return None
    micro = s["spans"]["step.micro"]
    return micro["ms"] / micro["count"]
