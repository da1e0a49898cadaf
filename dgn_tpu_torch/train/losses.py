"""Task losses, masked for padding (counterpart of `dgn_tpu/train/losses.py`).

L1 (ZINC, reference nets/molecules_graph_regression/dgn_net.py:90-92),
class-weighted CE (SBM, SBMs dgn_net.py:67-81), plain CE (superpixels,
:75-78), BCE with logits (HIV, :87-89) and NaN-masked 128-task BCE (PCBA
dgn_net.py:99-102, train_PCBA_graph_classification.py:32-33).  Means are
over real elements only, which matches the reference exactly because its
batches are never padded."""
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


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row -log softmax(logits)[label]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).squeeze(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy, masked mean (superpixels)."""
    return _masked_mean(_nll(logits, labels), mask)


def weighted_cross_entropy_sbm(logits: torch.Tensor, labels: torch.Tensor,
                               mask: torch.Tensor,
                               n_classes: int) -> torch.Tensor:
    """SBM class-balanced CE (reference SBMs dgn_net.py:67-81):
    weight_c = (V - count_c) / V * [count_c > 0] over the V real nodes, and,
    as torch's weighted CE does, the sum divided by the sum of the
    per-sample weights."""
    m = mask.to(logits.dtype)
    v = m.sum()
    counts = (torch.nn.functional.one_hot(labels.long(), n_classes)
              .to(logits.dtype) * m[:, None]).sum(0)
    weight = (v - counts) / v.clamp_min(1.0) * (counts > 0)
    w = weight[labels.long()] * m
    return (_nll(logits, labels) * w).sum() / w.sum().clamp_min(1e-12)


def _bce_terms(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits in the stable form
    relu(z) - z*y + log1p(exp(-|z|)), logits clipped to [-60, 60]."""
    z = z.clamp(-60.0, 60.0)
    return torch.relu(z) - z * labels + torch.log1p(torch.exp(-z.abs()))


def bce_with_logits(scores: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits, masked mean (HIV)."""
    if scores.ndim > labels.ndim:
        scores = scores.squeeze(-1)
    return _masked_mean(_bce_terms(scores, labels), mask)


def masked_bce_multitask(scores: torch.Tensor, labels: torch.Tensor,
                         graph_mask: torch.Tensor) -> torch.Tensor:
    """PCBA: BCE over the tasks, NaN labels excluded (is_labeled = labels ==
    labels, reference train_PCBA:32-33), mean over labeled entries."""
    is_labeled = (labels == labels) & graph_mask[:, None]
    safe = torch.where(is_labeled, labels, 0.0)
    m = is_labeled.to(scores.dtype)
    return (_bce_terms(scores, safe) * m).sum() / m.sum().clamp_min(1.0)
