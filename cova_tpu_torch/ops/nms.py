"""Greedy class-aware non-maximum suppression (PyTorch port of
cova_tpu/ops/nms.py), the plain version.

Replaces the DeepStream nvinfer cluster-mode=2 NMS applied to YOLO
detections (reference: config/dnn/yolov4_b2.txt `nms-iou-threshold=0.2`).
`batched_nms` works on one image with fixed shapes, exactly as the JAX
function does: a stable descending sort by score, the same-class IoU
suppression swept in index order, and the survivors compacted in index
order. The CUDA kernel that runs it on the card, a cluster per image, is
csrc/nms_kernel.cu behind ops/cuda/nms_kernel.py, which takes this
function for a CPU tensor.
"""

from __future__ import annotations

import torch

from cova_tpu_torch.ops.iou import iou_matrix


def batched_nms(
    ltwh: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    iou_threshold: float = 0.2,
    score_threshold: float = 0.25,
    max_out: int = 64,
):
    """Greedy class-aware NMS of one image.

    Args:
      ltwh: (N, 4) float32 boxes; scores: (N,) float32; class_ids: (N,)
      int32.

    Returns:
      (keep_ltwh (max_out, 4), keep_scores (max_out,), keep_classes
      (max_out,) int32, keep_valid (max_out,) bool): the survivors in
      descending score order, padded with zeros, class -1, valid False.
    """
    n = ltwh.shape[0]
    dev = ltwh.device
    order = torch.argsort(-scores, stable=True)
    ltwh = ltwh[order]
    scores = scores[order]
    class_ids = class_ids[order]
    alive = scores > score_threshold

    iou = iou_matrix(ltwh, ltwh)
    same_class = class_ids[:, None] == class_ids[None, :]
    # suppress_pair[i, j]: box i, if alive, kills the lower-scored box j.
    later = torch.arange(n, device=dev)[None, :] > torch.arange(n, device=dev)[:, None]
    suppress_pair = (iou > iou_threshold) & same_class & later
    for i in range(n):
        alive = alive & ~(suppress_pair[i] & alive[i])

    # Compact the survivors to the front, in index order.
    keep = torch.nonzero(alive).reshape(-1)[:max_out]
    k = keep.numel()
    out_ltwh = torch.zeros((max_out, 4), dtype=ltwh.dtype, device=dev)
    out_scores = torch.zeros((max_out,), dtype=scores.dtype, device=dev)
    out_cls = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
    valid = torch.zeros((max_out,), dtype=torch.bool, device=dev)
    out_ltwh[:k] = ltwh[keep]
    out_scores[:k] = scores[keep]
    out_cls[:k] = class_ids[keep].to(torch.int32)
    valid[:k] = True
    return out_ltwh, out_scores, out_cls, valid
