"""Multi-scale deformable attention (K11): the CUDA kernel's wrapper.

`ms_deform_attn(value, spatial_shapes, boxes, offsets, logits, levels,
points)` computes RT-DETR's deformable cross-attention core from its
four raw inputs (ops/msda.py gives the layouts) and returns (B, Lq,
H * C). A CUDA tensor goes to the hand-written kernel
(csrc/msda_kernel.cu: the softmax, the sampling locations, the bilinear
gathers and the weighted sum in one launch); a CPU tensor goes to
`ms_deform_attn_plain`, upstream's sequence of torch ops. There is no
fallback between the two: what the kernel does not take raises. It has
no backward; the model's train mode runs the plain version.

The kernel computes the sampling coordinates as the plain version's torch
ops and `grid_sample` round them; its softmax and its sum over the
samples round in another order, so the two agree to a few ulps of the
output, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from cova_tpu_torch import trace
from cova_tpu_torch.ops.cuda import _build
from cova_tpu_torch.ops.msda import ms_deform_attn_plain

# csrc/msda_kernel.cu's kChannels, kMaxLevels, kMaxSamples.
KERNEL_CHANNELS = 32
KERNEL_MAX_LEVELS = 4
KERNEL_MAX_SAMPLES = 32
# Operations a sample and channel: the four corners' multiply-adds and the
# weighted add, 2 a multiply-add.
MSDA_OPS = 10


class _Args(ctypes.Structure):
    """csrc/msda_kernel.cu's MsdaArgs, field for field."""

    _fields_ = [
        ("value", ctypes.c_void_p), ("boxes", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
        ("logits", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("batch", ctypes.c_int), ("lq", ctypes.c_int), ("lv", ctypes.c_int),
        ("heads", ctypes.c_int), ("levels", ctypes.c_int), ("points", ctypes.c_int),
        ("map_h", ctypes.c_int * KERNEL_MAX_LEVELS), ("map_w", ctypes.c_int * KERNEL_MAX_LEVELS),
        ("start", ctypes.c_int * KERNEL_MAX_LEVELS), ("align_corners", ctypes.c_int),
    ]


def _lib() -> ctypes.CDLL:
    lib = _build.load("msda_kernel")
    lib.cova_ms_deform_attn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.cova_ms_deform_attn.restype = ctypes.c_int
    return lib


def _refusal(value, spatial_shapes, boxes, offsets, logits, levels, points) -> str | None:
    """Why `ms_deform_attn` does not take these arguments, or None if it
    does: float32 tensors on one device (the CPU or CUDA), value (B, Lv,
    H, C) with Lv the sum of the levels' h * w, boxes (B, Lq, 4), offsets
    (B, Lq, H * L * P * 2), logits (B, Lq, H * L * P), `levels` (h, w)
    pairs; no gradient asked for. On CUDA besides: every tensor
    contiguous, C = 32, at most 4 levels and 32 samples a head, fewer than
    2**31 elements a tensor (the kernel's 32-bit sizes)."""
    tensors = {"value": value, "boxes": boxes, "offsets": offsets, "logits": logits}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            return f"{name} must be float32, got {t.dtype}"
        if t.device != value.device:
            return f"{name} is on {t.device}, value on {value.device}"
    if value.device.type not in ("cpu", "cuda"):
        return f"unsupported device {value.device}"
    if value.dim() != 4:
        return f"value must be (B, Lv, H, C), got {tuple(value.shape)}"
    b, lv, heads, c = value.shape
    if len(spatial_shapes) != levels or levels < 1 or points < 1:
        return f"{levels} levels of {points} points, {len(spatial_shapes)} spatial shapes"
    if sum(h * w for h, w in spatial_shapes) != lv:
        return f"the levels hold {sum(h * w for h, w in spatial_shapes)} tokens, value {lv}"
    if boxes.dim() != 3 or boxes.shape[0] != b or boxes.shape[2] != 4:
        return f"boxes must be (B, Lq, 4) with B {b}, got {tuple(boxes.shape)}"
    lq, n = boxes.shape[1], heads * levels * points
    if tuple(offsets.shape) != (b, lq, 2 * n):
        return f"offsets must be {(b, lq, 2 * n)}, got {tuple(offsets.shape)}"
    if tuple(logits.shape) != (b, lq, n):
        return f"logits must be {(b, lq, n)}, got {tuple(logits.shape)}"
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        return "the kernel has no backward: run it under torch.no_grad()"
    if value.device.type == "cuda":
        if c != KERNEL_CHANNELS:
            return f"the kernel takes {KERNEL_CHANNELS} channels a head, got {c}"
        if levels > KERNEL_MAX_LEVELS or levels * points > KERNEL_MAX_SAMPLES:
            return (f"the kernel takes at most {KERNEL_MAX_LEVELS} levels and "
                    f"{KERNEL_MAX_SAMPLES} samples a head, got {levels} x {points}")
        for name, t in tensors.items():
            if not t.is_contiguous():
                return f"{name} must be contiguous"
            if t.numel() >= 2**31:
                return f"{name} holds {t.numel()} elements; the kernel takes < 2**31"
        if b * lq * heads * c >= 2**31:
            return f"{b * lq * heads * c} output elements; the kernel takes < 2**31"
    return None


def ms_deform_attn(value, spatial_shapes, boxes, offsets, logits, levels: int, points: int,
                   align_corners: bool = False) -> torch.Tensor:
    """The deformable attention core: (B, Lq, H * C) float32, contiguous.
    Raises ValueError on what it does not take (`_refusal`).

    On CUDA this launches the kernel once on the current stream, counts
    the launch in `ms_deform_attn.launches` and the tracer's
    `msda.launches`, and raises if the kernel cannot build or launch. On
    the CPU it runs `ms_deform_attn_plain`. `align_corners` is
    grid_sample's; RT-DETR samples with it False."""
    why = _refusal(value, spatial_shapes, boxes, offsets, logits, levels, points)
    if why is not None:
        raise ValueError(why)
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, boxes, offsets, logits, levels,
                                    points, align_corners)
    b, lv, heads, c = value.shape
    lq = boxes.shape[1]
    out = torch.empty((b, lq, heads * c), dtype=torch.float32, device=value.device)
    pad = [0] * (KERNEL_MAX_LEVELS - levels)
    starts, total = [], 0
    for h, w in spatial_shapes:
        starts.append(total)
        total += h * w
    args = _Args(
        value.data_ptr(), boxes.data_ptr(), offsets.data_ptr(), logits.data_ptr(),
        out.data_ptr(), b, lq, lv, heads, levels, points,
        (ctypes.c_int * KERNEL_MAX_LEVELS)(*[int(h) for h, _ in spatial_shapes], *pad),
        (ctypes.c_int * KERNEL_MAX_LEVELS)(*[int(w) for _, w in spatial_shapes], *pad),
        (ctypes.c_int * KERNEL_MAX_LEVELS)(*starts, *pad), int(bool(align_corners)),
    )
    stream = torch.cuda.current_stream(value.device).cuda_stream
    with torch.cuda.device(value.device):
        rc = _lib().cova_ms_deform_attn(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_attn launch failed: cudaError {rc}")
    ms_deform_attn.launches += 1
    trace.count("msda.launches")
    return out


ms_deform_attn.launches = 0


def msda_ops(queries: int, samples: int, channels: int) -> int:
    """The kernel's operations for one launch: MSDA_OPS a sample (a
    query's head, level and point) and channel."""
    return MSDA_OPS * queries * samples * channels


def msda_work(value_shape, shapes, boxes, offsets, levels: int, points: int) -> tuple:
    """(operations, bytes) of one launch, from its inputs: the value rows
    (token, head) that the samples' in-map bilinear corners touch, each
    read once, the boxes, offsets and logits read once and the output
    written once, 4 bytes a float; locations as grid_sample unnormalises
    them (align_corners false). The work depends on where the samples
    fall, so it is counted from each launch's own boxes and offsets."""
    b, lv, heads, c = value_shape
    lq = boxes.shape[1]
    off = offsets.reshape(b, lq, heads, levels, points, 2)
    ref = boxes[:, :, None, None, None, :]
    loc = ref[..., :2] + off / points * ref[..., 2:] * 0.5
    rows = torch.zeros(b, lv, heads, dtype=torch.bool, device=boxes.device)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        head = torch.arange(heads, device=boxes.device).reshape(1, 1, heads, 1).expand_as(x)
        batch = torch.arange(b, device=boxes.device).reshape(b, 1, 1, 1).expand_as(x)
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            cx, cy = x0 + dx, y0 + dy
            ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            tok = start + (cy * w + cx).long()
            rows[batch[ok], tok[ok], head[ok]] = True
        start += h * w
    n = heads * levels * points
    floats = int(rows.sum()) * c + boxes.numel() + 3 * b * lq * n + b * lq * heads * c
    return msda_ops(b * lq, n, c), 4 * floats
