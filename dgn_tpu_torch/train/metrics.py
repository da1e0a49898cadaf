"""Host-side task metrics (counterpart of `dgn_tpu/train/metrics.py`).
Arrays hold REAL (unpadded) elements; the trainer strips padding."""
from __future__ import annotations

import numpy as np


def mae(scores: np.ndarray, targets: np.ndarray) -> float:
    """reference train/metrics.py:14-16 (F.l1_loss)."""
    return float(np.mean(np.abs(scores.reshape(-1) - targets.reshape(-1))))
