"""PNA-style degree scalers (PyTorch counterpart of `dgn_tpu/ops/scalers.py`).

identity / amplification / attenuation over the true in-degree D with the
training-set average avg_d['log'] (reference nets/scalers.py), plus the
linear pair of the dense research path.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def scale_identity(h, deg, avg_d):
    return h


def scale_amplification(h, deg, avg_d):
    return h * (torch.log(deg + 1.0) / avg_d["log"])[:, None]


def scale_attenuation(h, deg, avg_d):
    # degree-0 nodes aggregate to 0; guard the division by log(1) = 0
    logd = torch.log(deg + 1.0)
    return h * torch.where(logd > 0, avg_d["log"] / logd.clamp_min(1e-30),
                           0.0)[:, None]


def scale_linear(h, deg, avg_d):
    return h * (deg / avg_d["lin"])[:, None]


def scale_inverse_linear(h, deg, avg_d):
    return h * torch.where(deg > 0, avg_d["lin"] / deg.clamp_min(1),
                           0.0)[:, None]


SCALERS = {
    "identity": scale_identity,
    "amplification": scale_amplification,
    "attenuation": scale_attenuation,
    "linear": scale_linear,
    "inverse_linear": scale_inverse_linear,
}


def parse_names(names) -> list[str]:
    if isinstance(names, str):
        names = names.split()
    names = list(names)
    for n in names:
        if n not in SCALERS:
            raise KeyError(f"unknown scaler {n!r}")
    return names


def scaler_columns(names: Sequence[str], deg: torch.Tensor,
                   avg_d: Dict[str, float],
                   dtype=torch.float32) -> torch.Tensor:
    """[N, S] per-node scalar factor of each scaler (identity -> 1).

    Every scaler is a per-node scalar, so it commutes with the posttrans
    matmul; the decomposed layer (layers/dgn.py) folds the scaler concat
    into the posttrans weights with these columns."""
    deg = deg.to(dtype)
    ones = torch.ones_like(deg)[:, None]
    return torch.stack([SCALERS[n](ones, deg, avg_d)[:, 0] for n in names],
                       dim=1)


def degree_stats(degrees) -> Dict[str, float]:
    """avg_d over concatenated train in-degrees (reference
    main_molecules.py:300-304): lin = mean(D), exp = mean(exp(1/D) - 1),
    log = mean(log(D + 1))."""
    d = np.asarray(degrees, dtype=np.float64)
    with np.errstate(over="ignore"):   # d=0 -> inf, same as the torch formula
        exp = float(np.mean(np.exp(1.0 / np.maximum(d, 1e-30)) - 1.0))
    return {
        "lin": float(np.mean(d)),
        "exp": exp,
        "log": float(np.mean(np.log(d + 1.0))),
    }
