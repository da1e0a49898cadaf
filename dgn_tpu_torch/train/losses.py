"""Task losses, masked for padding (counterpart of `dgn_tpu/train/losses.py`).

Only the L1 loss of ZINC (reference nets/molecules_graph_regression/
dgn_net.py:90-92) is ported.  Means are over real graphs only, which matches
the reference exactly because its batches are never padded."""
from __future__ import annotations

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def l1_loss(scores: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """nn.L1Loss over real graphs; scores [G, 1] or [G], targets same."""
    diff = (scores.squeeze(-1) - targets.squeeze(-1)
            if targets.ndim == scores.ndim else scores.squeeze(-1) - targets)
    return _masked_mean(diff.abs(), mask)
