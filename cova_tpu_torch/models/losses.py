"""Training losses (PyTorch port of cova_tpu/models/losses.py; reference:
utils/train-blobnet.py:45-53)."""

from __future__ import annotations

import torch


def jaccard_distance_loss(y_true, y_pred, smooth: float = 100.0):
    """Smoothed Jaccard distance, averaged over the batch; exactly the
    reference's formulation (sum over the last two spatial axes)."""
    intersection = torch.sum(y_true * y_pred, dim=(-2, -1))
    total = torch.sum(y_true + y_pred, dim=(-2, -1))
    jac = (intersection + smooth) / (total - intersection + smooth)
    return torch.mean((1.0 - jac) * smooth)


def precision_recall_counts(y_true, y_pred, threshold: float = 0.5) -> torch.Tensor:
    """(true positives, predicted positives, true positives + false
    negatives) as one int64 tensor of 3: what precision and recall are
    ratios of, and what a data-parallel step sums over its ranks."""
    pred = y_pred > threshold
    truth = y_true > 0.5
    return torch.stack([torch.sum(pred & truth), torch.sum(pred), torch.sum(truth)])


def precision_recall_from_counts(counts: torch.Tensor):
    """(precision, recall) float32 from `precision_recall_counts`."""
    tp, npred, ntrue = counts
    precision = tp / torch.clamp(npred, min=1)
    recall = tp / torch.clamp(ntrue, min=1)
    return precision.to(torch.float32), recall.to(torch.float32)


def precision_recall(y_true, y_pred, threshold: float = 0.5):
    """Binary precision/recall metrics matching Keras defaults: float32
    ratios of integer counts."""
    return precision_recall_from_counts(precision_recall_counts(y_true, y_pred, threshold))
