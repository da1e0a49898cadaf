"""The plain reference of the benchmark: a DGN training step written per
edge in plain PyTorch, from the published layer equations (Beaini et al.,
arXiv:2010.02863, and the reference implementation Saro00/DGN), with Adam
and L2 written out.  It imports nothing of the program and takes nothing
that the program made: it works out the degree statistics, the
directional weights and their normalisers, the scalers, the batch's
composition and the dropout masks itself, from the benchmark's inputs,
weights and seed.

  dgn.py           the layer math every task shares: the simple and
                   complex layers, the aggregators (mean, max, min,
                   dir{k}-av, dir{k}-dx), the scalers, graph and batch
                   norm, dropout, the readout MLP, Adam with L2
  tasks/<task>.py  what one task adds: the encoder, the readout's width,
                   the loss and its denominator for one micro-batch, the
                   encoder's FLOPs; a new task is a new file there
  follow.py        the first training steps, one batch or K micro-batches
                   a step, as the program's trainer documents them

A new configuration brings, beside its configuration, traffic and limits
files (benchmark/cells.py), the task file where its task has none yet."""
