"""Multi-scale deformable attention (RT-DETR's `MSDeformableAttention`
core) in plain PyTorch: the version the CPU and train mode run, and the
one the hand-written kernel (K11, ops/cuda/msda_kernel.py) is held to.

Upstream (lyuwenyu/RT-DETR, rtdetr_pytorch/src/zoo/rtdetr) splits the
work in two: `MSDeformableAttention.forward` turns the raw sampling
offsets and attention logits into sampling locations and softmax
weights, and `utils.deformable_attention_core_func` samples every level
with `F.grid_sample` (bilinear, zero padding, align_corners False) and
sums the samples by their weights. `ms_deform_attn_plain` is both halves
in that order of operations, from the four inputs K11 takes:

  value    (B, Lv, H, C)  the projected memory, levels concatenated
  boxes    (B, Lq, 4)     reference boxes, cx cy w h in [0, 1]
  offsets  (B, Lq, H * L * P * 2)  the sampling_offsets Linear's output
  logits   (B, Lq, H * L * P)      the attention_weights Linear's output

and returns (B, Lq, H * C), head-major, what `output_proj` takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sampling_locations(boxes, offsets, heads: int, levels: int, points: int):
    """(B, Lq, H, L, P, 2) locations in [0, 1] map coordinates:
    box centre + offset / points * box size * 0.5, as upstream computes
    them for 4-d reference points."""
    b, lq = offsets.shape[:2]
    off = offsets.reshape(b, lq, heads, levels, points, 2)
    ref = boxes[:, :, None, :]  # the decoder's ref_points_detach.unsqueeze(2)
    return ref[:, :, None, :, None, :2] + off / points * ref[:, :, None, :, None, 2:] * 0.5


def attention_weights(logits, heads: int, levels: int, points: int):
    """(B, Lq, H, L, P) softmax over each head's levels x points."""
    b, lq = logits.shape[:2]
    w = F.softmax(logits.reshape(b, lq, heads, levels * points), dim=-1)
    return w.reshape(b, lq, heads, levels, points)


def deformable_attention_core(value, spatial_shapes, locations, weights,
                              align_corners: bool = False):
    """upstream's deformable_attention_core_func: value (B, Lv, H, C),
    spatial_shapes [(h, w)] a level, locations (B, Lq, H, L, P, 2),
    weights (B, Lq, H, L, P) -> (B, Lq, H * C)."""
    bs, _, n_head, c = value.shape
    _, len_q, _, n_levels, n_points, _ = locations.shape
    value_list = value.split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2 * locations - 1
    sampled = []
    for level, (h, w) in enumerate(spatial_shapes):
        value_l = value_list[level].flatten(2).permute(0, 2, 1).reshape(bs * n_head, c, h, w)
        grid_l = grids[:, :, :, level].permute(0, 2, 1, 3, 4).flatten(0, 1)
        sampled.append(F.grid_sample(value_l, grid_l, mode="bilinear", padding_mode="zeros",
                                     align_corners=align_corners))
    weights = weights.permute(0, 2, 1, 3, 4).reshape(bs * n_head, 1, len_q, n_levels * n_points)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * weights).sum(-1)
    return out.reshape(bs, n_head * c, len_q).permute(0, 2, 1)


def ms_deform_attn_plain(value, spatial_shapes, boxes, offsets, logits, levels: int,
                         points: int, align_corners: bool = False):
    """The whole core from K11's four inputs: (B, Lq, H * C)."""
    heads = value.shape[2]
    loc = sampling_locations(boxes, offsets, heads, levels, points)
    w = attention_weights(logits, heads, levels, points)
    return deformable_attention_core(value, spatial_shapes, loc, w, align_corners)
