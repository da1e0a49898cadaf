"""Vector-field (eigenvector) augmentations (PyTorch counterpart of
`dgn_tpu/ops/field.py`).

Reference:
  * elementwise random sign flip of the whole eig matrix
    (train_molecules_graph_regression.py:29-33; per ELEMENT, not per
    eigenvector, as there);
  * per-node random rotation of the (eig1, eig2) plane by at most
    max_degrees (train_superpixels_graph_classification.py:29-37);
  * per-element sign flip of eig2 only (superpixels :38-42);
  * additive distortion col += dist * mean(|col|) (superpixels :44-48, in
    the intended per-column form, as dgn_tpu implements it).

Each function takes its uniform draws in [0, 1) as a tensor `u` in place of
dgn_tpu's PRNG key, so the same draws can go through both packages (the two
frameworks' random streams cannot match).  `u` has the shape dgn_tpu draws
for the same call.  Means are over real nodes only (node_mask).
"""
from __future__ import annotations

from typing import Optional

import torch


def sign_flip(eig: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Elementwise +-1 flip of all eig entries; u: eig's shape."""
    return eig * torch.where(u >= 0.5, 1.0, -1.0)


def sign_flip_column(eig: torch.Tensor, u: torch.Tensor,
                     col: int = 2) -> torch.Tensor:
    """Per-node +-1 flip of column col; u: [N]."""
    out = eig.clone()
    out[:, col] = eig[:, col] * torch.where(u >= 0.5, 1.0, -1.0)
    return out


def rotate_field(eig: torch.Tensor, u: torch.Tensor, max_degrees: float,
                 cols=(1, 2)) -> torch.Tensor:
    """Per-node rotation of the (cols[0], cols[1]) plane by the angle
    (u - 0.5) * 2 * max_degrees; u: [N].  The reference's sin/cos
    construction (cos = sqrt(1 - sin^2))."""
    angle = (u - 0.5) * 2 * max_degrees
    sine = torch.sin(angle * torch.pi / 180.0)
    cos = torch.sqrt(1.0 - sine ** 2)
    a, b = cols
    e1, e2 = eig[:, a], eig[:, b]
    out = eig.clone()
    out[:, a] = cos * e1 + sine * e2
    out[:, b] = cos * e2 - sine * e1
    return out


def distort_field(eig: torch.Tensor, u: torch.Tensor, amount: float,
                  cols=(1, 2),
                  node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """col += dist * mean(|col|) with per-node dist = (u - 0.5) * 2 * amount
    in [-amount, amount]; u: [N].  The mean is over node_mask's rows."""
    dist = (u - 0.5) * 2 * amount
    out = eig.clone()
    for c in cols:
        col = eig[:, c]
        if node_mask is not None:
            m = node_mask.to(col.dtype)
            mean_abs = (col.abs() * m).sum() / m.sum().clamp_min(1.0)
        else:
            mean_abs = col.abs().mean()
        out[:, c] = out[:, c] + dist * mean_abs
    return out
