"""The plain reference of the benchmark: a DGN training step written per
edge in plain PyTorch, from the published layer equations (Beaini et al.,
arXiv:2010.02863, and the reference implementation Saro00/DGN), with Adam
and L2 written out.  It imports nothing of the program and takes nothing
that the program made: it works out the degree statistics, the
directional weights and their normalisers, the scalers, the batch's
composition and the dropout masks itself, from the benchmark's inputs,
weights and seed."""
