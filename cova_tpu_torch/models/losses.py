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


def precision_recall(y_true, y_pred, threshold: float = 0.5):
    """Binary precision/recall metrics matching Keras defaults: float32
    ratios of integer counts."""
    pred = y_pred > threshold
    truth = y_true > 0.5
    tp = torch.sum(pred & truth)
    precision = tp / torch.clamp(torch.sum(pred), min=1)
    recall = tp / torch.clamp(torch.sum(truth), min=1)
    return precision.to(torch.float32), recall.to(torch.float32)
