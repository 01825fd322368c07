"""Batched 8-connected components + region stats (PyTorch port of
cova_tpu/ops/cc.py).

Labelling goes through `ops.cuda.cc_kernel.connected_components` (the
CUDA kernel on the card, its plain version on the CPU) and runs every
frame to convergence. Region stats stay plain torch and are exact:
component areas from one scatter-add over the label grid, eligible roots
compacted in raster order with a top-k, and box extents from
scatter-reduce min/max over the root index.

Component order matches OpenCV's connected_components_with_stats: box K
of a frame is the K-th eligible component by raster order of its first
pixel.
"""

from __future__ import annotations

import torch

from cova_tpu_torch.ops.cuda.cc_kernel import connected_components, connected_components_plain
from cova_tpu_torch.types import INVALID_ID, MAX_BOXES_PER_FRAME, Boxes


def _stats_from_labels(
    mask: torch.Tensor,  # (N, H, W) bool
    labels: torch.Tensor,  # (N, H, W) int32, background = H*W
    area_threshold: int,
    max_boxes: int,
) -> Boxes:
    """Fixed-capacity boxes of the components with at least
    `area_threshold` pixels, in raster order of their roots."""
    nb, h, w = mask.shape
    n = h * w
    dev = mask.device
    flat_lab = labels.reshape(nb, n).long()
    fg = mask.reshape(nb, n)
    pix = torch.arange(n, device=dev)
    is_root = fg & (flat_lab == pix)

    # Pixel count per root (background pixels land in bucket n).
    area_by_root = torch.zeros((nb, n + 1), dtype=torch.int32, device=dev)
    area_by_root.scatter_add_(1, flat_lab, fg.to(torch.int32))
    eligible = is_root & (area_by_root[:, :n] >= area_threshold)

    # Compact eligible roots in raster order (keys are unique among them).
    order_key = torch.where(eligible, pix, n)
    root_idx = torch.topk(-order_key, max_boxes, dim=1).indices
    valid = torch.gather(eligible, 1, root_idx)

    # Box extents: min/max row and column over each root's pixels.
    rows = (pix // w).expand(nb, n)
    cols = (pix % w).expand(nb, n)

    def reduce(vals, op, init):
        out = torch.full((nb, n + 1), init, dtype=torch.long, device=dev)
        out.scatter_reduce_(1, flat_lab, vals, reduce=op, include_self=True)
        return torch.gather(out, 1, root_idx)

    min_r = reduce(rows, "amin", n)
    max_r = reduce(rows, "amax", -1)
    min_c = reduce(cols, "amin", n)
    max_c = reduce(cols, "amax", -1)

    ltwh = torch.stack(
        [min_c, min_r, max_c - min_c + 1, max_r - min_r + 1], dim=-1
    ).to(torch.float32)
    ltwh = torch.where(valid[..., None], ltwh, 0.0)
    return Boxes(
        ltwh=ltwh,
        valid=valid,
        # Boxes carry area = w*h, not the pixel count.
        area=torch.where(valid, ltwh[..., 2] * ltwh[..., 3], 0.0),
        class_id=torch.full((nb, max_boxes), INVALID_ID, dtype=torch.int32, device=dev),
        conf=torch.zeros((nb, max_boxes), dtype=torch.float32, device=dev),
        track_id=torch.full((nb, max_boxes), INVALID_ID, dtype=torch.int32, device=dev),
    )


def mask_to_boxes(
    mask: torch.Tensor,
    area_threshold: int = 1,
    max_boxes: int = MAX_BOXES_PER_FRAME,
    backend: str = "auto",
) -> Boxes:
    """Label a (..., H, W) boolean mask batch and return fixed-capacity
    per-frame boxes of the components with area >= area_threshold.

    backend: "auto" labels through `connected_components` (the CUDA
    kernel on the card, its plain version on the CPU); "cuda" insists on
    the kernel (a CPU mask raises); "plain" runs
    `connected_components_plain` on any device (as the JAX package's
    backend="xla" does beside "pallas")."""
    batch_shape = mask.shape[:-2]
    flat = mask.reshape((-1,) + mask.shape[-2:]).contiguous()
    if backend == "plain":
        labels = connected_components_plain(flat)
    elif backend == "auto" or (backend == "cuda" and flat.device.type == "cuda"):
        labels = connected_components(flat)
    else:
        raise ValueError(f"cc backend {backend!r} on a {flat.device.type} mask")
    out = _stats_from_labels(flat, labels, area_threshold, max_boxes)
    return out.map(lambda x: x.reshape(batch_shape + x.shape[1:]))
