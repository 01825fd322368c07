"""Greedy class-aware NMS of a batch of images: the CUDA kernel's wrapper.

`nms(ltwh, scores, class_ids, ...)` takes (B, N, 4) float32 boxes, (B, N)
float32 scores and (B, N) int32 classes and returns, per image, the
outputs of `cova_tpu_torch.ops.nms.batched_nms`: (B, max_out, 4) boxes,
(B, max_out) scores, (B, max_out) int32 classes and (B, max_out) bool
valid flags. A CUDA tensor goes to the hand-written kernel
(csrc/nms_kernel.cu: per image, a suppression bitmask built by a cluster
of 8 blocks and a one-warp greedy scan that stops at max_out); a CPU
tensor goes to `nms_plain`, the plain version image by image. There is
no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from cova_tpu_torch.ops.cuda import _build
from cova_tpu_torch.ops.nms import batched_nms

# Candidates a block holds (one thread each in its first phase).
MAX_CANDIDATES = 1024


def nms_plain(ltwh, scores, class_ids, iou_threshold=0.2, score_threshold=0.25,
              max_out=64):
    """`batched_nms` image by image, stacked: the plain version of the
    kernel, on any device."""
    outs = [
        batched_nms(ltwh[i], scores[i], class_ids[i], iou_threshold,
                    score_threshold, max_out)
        for i in range(ltwh.shape[0])
    ]
    if not outs:
        dev = ltwh.device
        return (torch.zeros((0, max_out, 4), dtype=torch.float32, device=dev),
                torch.zeros((0, max_out), dtype=torch.float32, device=dev),
                torch.zeros((0, max_out), dtype=torch.int32, device=dev),
                torch.zeros((0, max_out), dtype=torch.bool, device=dev))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _lib() -> ctypes.CDLL:
    lib = _build.load("nms_kernel")
    lib.cova_nms.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.cova_nms.restype = ctypes.c_int
    return lib


def nms(ltwh: torch.Tensor, scores: torch.Tensor, class_ids: torch.Tensor,
        iou_threshold: float = 0.2, score_threshold: float = 0.25,
        max_out: int = 64):
    """Class-aware NMS of B images of N candidates each.

    On CUDA this launches the kernel on the current stream and counts the
    launch in `nms.launches`; it raises if the kernel cannot build or
    launch. On the CPU it runs `nms_plain`."""
    if ltwh.dim() != 3 or ltwh.shape[-1] != 4:
        raise ValueError(f"ltwh must be (B, N, 4), got {tuple(ltwh.shape)}")
    b, n, _ = ltwh.shape
    if tuple(scores.shape) != (b, n) or tuple(class_ids.shape) != (b, n):
        raise ValueError(
            f"scores {tuple(scores.shape)} and class_ids {tuple(class_ids.shape)} "
            f"must be ({b}, {n})"
        )
    if ltwh.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("ltwh and scores must be float32")
    if class_ids.dtype != torch.int32:
        raise TypeError(f"class_ids must be int32, got {class_ids.dtype}")
    if ltwh.device.type == "cpu":
        return nms_plain(ltwh, scores, class_ids, iou_threshold, score_threshold,
                         max_out)
    if ltwh.device.type != "cuda":
        raise ValueError(f"unsupported device {ltwh.device}")
    if not (scores.device == class_ids.device == ltwh.device):
        raise ValueError("ltwh, scores and class_ids must be on one device")
    if n > MAX_CANDIDATES:
        raise ValueError(f"{n} candidates; the kernel holds at most {MAX_CANDIDATES}")
    ltwh, scores, class_ids = (t.contiguous() for t in (ltwh, scores, class_ids))
    dev = ltwh.device
    out_ltwh = torch.empty((b, max_out, 4), dtype=torch.float32, device=dev)
    out_scores = torch.empty((b, max_out), dtype=torch.float32, device=dev)
    out_cls = torch.empty((b, max_out), dtype=torch.int32, device=dev)
    out_valid = torch.empty((b, max_out), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().cova_nms(
            ltwh.data_ptr(), scores.data_ptr(), class_ids.data_ptr(), b, n,
            iou_threshold, score_threshold, max_out, out_ltwh.data_ptr(),
            out_scores.data_ptr(), out_cls.data_ptr(), out_valid.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"nms_kernel launch failed: cudaError {rc}")
    nms.launches += 1
    return out_ltwh, out_scores, out_cls, out_valid


nms.launches = 0
