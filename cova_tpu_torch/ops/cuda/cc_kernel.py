"""Connected-components labelling: the CUDA kernel's wrapper and its
plain PyTorch version.

`connected_components(masks)` labels a (B, H, W) bool/uint8 mask batch
with 8-connectivity and returns (B, H, W) int32: each foreground pixel
holds the linear index of its component's raster-first pixel, background
holds H*W — the convention of the TPU kernel it replaces
(cova_tpu/ops/pallas/cc_kernel.py). A CUDA tensor goes to the
hand-written kernel (csrc/cc_kernel.cu, a block union-find in shared
memory, 4 bytes a pixel); a CPU tensor goes to
`connected_components_plain`. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cova_tpu_torch.ops.cuda import _build

# Largest shared memory a frame may take in one block on Hopper (bytes):
# 227 KB less the block's 8 KB of union queues (csrc/cc_kernel.cu).
MAX_SMEM_BYTES = 232_448 - 8_192


def connected_components_plain(masks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch labelling, batched: an 8-neighbour min by padded
    shifts, then two pointer-jump gathers, repeated until nothing
    changes."""
    if masks.dim() != 3:
        raise ValueError(f"masks must be (B, H, W), got {tuple(masks.shape)}")
    b, h, w = masks.shape
    n = h * w
    fg = masks != 0
    idx = torch.arange(n, dtype=torch.int32, device=masks.device).reshape(h, w)
    big = torch.tensor(n, dtype=torch.int32, device=masks.device)
    lab = torch.where(fg, idx, big)
    # One trailing slot holding `n`, so background labels gather to `n`.
    tail = torch.full((b, 1), n, dtype=torch.int32, device=masks.device)
    for _ in range(max(n, 1)):
        p = F.pad(lab, (1, 1, 1, 1), value=n)
        hop = lab
        for dy in range(3):
            for dx in range(3):
                hop = torch.minimum(hop, p[:, dy : dy + h, dx : dx + w])
        flat = torch.cat([hop.reshape(b, n), tail], dim=1)
        j1 = torch.gather(flat, 1, flat[:, :n].long())
        j2 = torch.gather(flat, 1, j1.long()).reshape(b, h, w)
        new = torch.where(fg, torch.minimum(hop, j2), big)
        if torch.equal(new, lab):
            break
        lab = new
    return lab


def _lib() -> ctypes.CDLL:
    lib = _build.load("cc_kernel")
    lib.cova_cc_label.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.cova_cc_label.restype = ctypes.c_int
    return lib


def connected_components(masks: torch.Tensor) -> torch.Tensor:
    """Label a (B, H, W) bool/uint8 mask batch; returns (B, H, W) int32.

    On CUDA this launches the kernel (one block per frame) on the current
    stream and counts the launch in `connected_components.launches`; it
    raises if the kernel cannot build or launch. On the CPU it runs
    `connected_components_plain`."""
    if masks.dim() != 3:
        raise ValueError(f"masks must be (B, H, W), got {tuple(masks.shape)}")
    if masks.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"masks must be bool or uint8, got {masks.dtype}")
    if masks.device.type == "cpu":
        return connected_components_plain(masks)
    if masks.device.type != "cuda":
        raise ValueError(f"unsupported device {masks.device}")
    if not masks.is_contiguous():
        raise ValueError("masks must be contiguous")
    b, h, w = masks.shape
    if h * w * 4 > MAX_SMEM_BYTES:
        raise ValueError(
            f"a {h}x{w} frame needs {h * w * 4} bytes of shared memory; "
            f"the kernel holds at most {MAX_SMEM_BYTES}"
        )
    labels = torch.empty((b, h, w), dtype=torch.int32, device=masks.device)
    stream = torch.cuda.current_stream(masks.device).cuda_stream
    with torch.cuda.device(masks.device):
        rc = _lib().cova_cc_label(
            masks.data_ptr(), labels.data_ptr(), b, h, w, stream
        )
    if rc != 0:
        raise RuntimeError(f"cc_kernel launch failed: cudaError {rc}")
    connected_components.launches += 1
    return labels


connected_components.launches = 0
