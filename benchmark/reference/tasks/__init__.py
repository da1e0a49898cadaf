"""What the reference's training step does differently from one task to
another, one file per task, named as the program's configuration names the
task (its `cfg.task`: zinc, superpixels, hiv, pcba, sbm, ...).  A task file
gives:

  encoder_spec(meta, f)  [(name, shape)] of the encoder's parameters, named
                         as the program names them;
  encode(w, batch, prec) the encoder's forward pass: [n, f] node states;
  n_out(meta)            the readout's output width;
  loss(scores, batch)    the batch's loss, a mean over weight(batch)
                         entries;
  weight(batch)          that mean's denominator for one micro-batch: a
                         step of micro-batches scales micro-batch k's loss
                         by weight_k / sum(weight);
  encoder_flops(meta, f, nodes)
                         the encoder's forward floating-point operations on
                         nodes real nodes (counts.train_flops doubles them
                         for the backward).

A task with no file has no reference, and a run of it is refused.  Nothing
here imports the program."""
from __future__ import annotations

import functools
import importlib
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


@functools.cache
def find(task: str):
    """The module benchmark/reference/tasks/<task>.py; ValueError where
    there is none."""
    if not _NAME.match(str(task)) or not (HERE / f"{task}.py").is_file():
        raise ValueError(f"task {task!r} has no reference: "
                         f"benchmark/reference/tasks/{task}.py does not "
                         "exist")
    return importlib.import_module(f"{__name__}.{task}")
