"""Host-side task metrics (counterpart of `dgn_tpu/train/metrics.py`).

MAE (ZINC), balanced node accuracy (SBM), accuracy (superpixels), ROC-AUC
(ogbg-molhiv), mean per-task average precision (ogbg-molpcba) and Hits@K
(ogbl-collab), the last three replacing the OGB Evaluator's scoring
rules.  Arrays hold
REAL (unpadded) elements; the trainer strips padding."""
from __future__ import annotations

import numpy as np
import scipy.stats


def mae(scores: np.ndarray, targets: np.ndarray) -> float:
    """reference train/metrics.py:14-16 (F.l1_loss)."""
    return float(np.mean(np.abs(scores.reshape(-1) - targets.reshape(-1))))


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    """Argmax accuracy x 100 over the samples (superpixels; reference
    metrics.py:19-28 returns the count, its training loops divide by n)."""
    return float((logits.argmax(-1) == labels).mean() * 100.0)


def accuracy_sbm(logits: np.ndarray, labels: np.ndarray) -> float:
    """Balanced accuracy x 100 (reference metrics.py:37-54): the mean, over
    the classes present in `labels`, of each class's recall."""
    pred = logits.argmax(-1)
    return float(np.mean([(pred[labels == c] == c).mean()
                          for c in np.unique(labels)]) * 100.0)


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based ROC-AUC with tied scores sharing their mean rank
    (OGB Evaluator('ogbg-molhiv')); NaN when one class is absent."""
    s = scores.reshape(-1).astype(np.float64)
    y = labels.reshape(-1).astype(np.int64)
    pos = int(y.sum())
    neg = len(y) - pos
    if pos == 0 or neg == 0:
        return float("nan")
    ranks = scipy.stats.rankdata(s, method="average")
    return float((ranks[y == 1].sum() - pos * (pos + 1) / 2.0) / (pos * neg))


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary AP (area under precision-recall by step interpolation,
    sklearn/OGB convention); NaN without a positive."""
    s = scores.reshape(-1).astype(np.float64)
    y = labels.reshape(-1).astype(np.int64)
    npos = int(y.sum())
    if npos == 0:
        return float("nan")
    order = np.argsort(-s, kind="mergesort")
    y_sorted = y[order]
    tp = np.cumsum(y_sorted)
    precision = tp / np.arange(1, len(y) + 1)
    return float((precision * y_sorted).sum() / npos)


def multitask_ap(scores: np.ndarray, labels: np.ndarray) -> float:
    """OGB Evaluator('ogbg-molpcba'): mean AP over the tasks that have at
    least one positive and one negative label; NaN labels ignored per task."""
    aps = []
    for t in range(labels.shape[1]):
        col = labels[:, t]
        valid = col == col
        yv = col[valid]
        if valid.sum() == 0 or yv.sum() == 0 or yv.sum() == valid.sum():
            continue
        aps.append(average_precision(scores[valid, t], yv))
    return float(np.mean(aps)) if aps else float("nan")


def hits_at_k(pos_scores: np.ndarray, neg_scores: np.ndarray, k: int) -> float:
    """OGB link-prediction Hits@K (reference
    train_COLLAB_edge_classification.py:115-145): the fraction of positive
    edges scored above the K-th best negative; 1 with fewer than K
    negatives."""
    if len(neg_scores) < k:
        return 1.0
    kth = np.sort(neg_scores.reshape(-1))[-k]
    return float((pos_scores.reshape(-1) > kth).mean())
