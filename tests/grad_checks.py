"""A check the parity tests share (it holds no test): that a comparison of
gradients compares live ones (ROADMAP C7).

A net whose ReLUs are all off at its initial weights (a dead readout MLP)
gives every parameter but a few biases a gradient of exactly 0, on both
sides, and an allclose of zeros with zeros holds nothing.  A bias may
rightly get an exact 0: an L1 loss whose residuals split evenly in sign
gives the readout's last bias sum(sign) / G = 0."""
from __future__ import annotations

import numpy as np

from dgn_tpu_torch.convert import flax_paths


def assert_live(got_named, want_flat) -> None:
    """dgn_tpu's gradient (want_flat: {flax path: array}) has a non-zero
    entry for every kernel and embedding, and the port's (got_named:
    (torch name, gradient tensor or None) pairs; None is 0) has one for
    every parameter where dgn_tpu's has."""
    dead = sorted(p for p, g in want_flat.items()
                  if not np.any(g) and not p.endswith("bias"))
    assert dead == [], f"dgn_tpu's gradients are 0 for {dead}"
    got = dict(got_named)
    paths = flax_paths(got)
    got_dead = sorted(k for k, g in got.items()
                      if np.any(want_flat[paths[k]])
                      and (g is None or not bool(g.detach().ne(0).any())))
    assert got_dead == [], f"the port's gradients are 0 for {got_dead}"
