"""IoU geometry ops (PyTorch port of cova_tpu/ops/iou.py).

Boxes are ``(left, top, width, height)`` float tensors on half-open
rectangles: ``right = left + width``.
"""

from __future__ import annotations

import torch


def iou_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of two broadcastable (..., 4) ltwh box tensors."""
    ax1, ay1 = a[..., 0], a[..., 1]
    ax2, ay2 = ax1 + a[..., 2], ay1 + a[..., 3]
    bx1, by1 = b[..., 0], b[..., 1]
    bx2, by2 = bx1 + b[..., 2], by1 + b[..., 3]

    ix = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    iy = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    inter = ix * iy
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return torch.where(
        union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros_like(inter)
    )


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) ltwh -> (..., N, M) IoU matrix."""
    return iou_pairwise(a[..., :, None, :], b[..., None, :, :])
