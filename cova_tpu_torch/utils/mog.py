"""Background-subtraction label generation (PyTorch port of
cova_tpu/utils/mog.py).

Replaces the reference's OpenCV MOG2 pseudo-label pipeline (reference:
utils/generate-mog.py: MOG2(history=9000, varThreshold=32, no shadows)
on 640x360 frames, fgMask>0, morph close 4x4, open 6x6, contour fill,
then [::8,::8] downsample to the 80x45 macroblock grid).

The Gaussian-mixture update (Zivkovic 2004, the algorithm behind cv2's
MOG2) runs chunk by chunk through `ops/cuda/mog2_kernel.mog2_chunk`: on
the card the hand-written kernel K6 (one thread per pixel, the K = 4
components in registers), on the CPU the plain step frame by frame; the
mixture state is carried across chunks. Morphology is expressed with max
pools; hole filling happens on the host with scipy.ndimage. Luma-only
input, as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cova_tpu_torch.ops.cuda.mog2_kernel import Mog2Params, mog2_chunk, mog2_init


def mog2_scan(
    frames: torch.Tensor,  # (F, H, W) uint8 luma
    k: int = 4,
    history: int = 9000,
    var_threshold: float = 32.0,
    bg_ratio: float = 0.9,
    var_init: float = 15.0,
    var_min: float = 4.0,
    var_max: float = 75.0,
) -> torch.Tensor:
    """Run MOG2 over a frame sequence from a state initialised on its
    first frame; returns (F, H, W) bool foreground."""
    mog = _StatefulMog2(k, history, var_threshold, bg_ratio, var_init, var_min, var_max)
    return mog.run(frames)


def _binary_pool(x: torch.Tensor, kh: int, kw: int, op: str) -> torch.Tensor:
    """Morphological dilate (max) / erode (min) of (F, H, W) masks with a
    kh x kw window, padded (k//2, k-1-k//2) with -inf (max) or +inf (min)
    as the JAX package's reduce_window; erode is -max(-x)."""
    sign = 1.0 if op == "max" else -1.0
    y = sign * x.to(torch.float32)[:, None]
    pads = (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2)
    y = F.max_pool2d(F.pad(y, pads, value=-float("inf")), (kh, kw), stride=1)
    return (sign * y)[:, 0] > 0.5


def morph_close_open(fg: torch.Tensor) -> torch.Tensor:
    """close(4x4) then open(6x6) (reference kernels)."""
    x = _binary_pool(fg, 4, 4, "max")
    x = _binary_pool(x, 4, 4, "min")
    x = _binary_pool(x, 6, 6, "min")
    x = _binary_pool(x, 6, 6, "max")
    return x


def generate_labels(
    luma_frames: np.ndarray,  # (F, H/2, W/2) uint8 (downscaled luma)
    chunk: int = 256,
    device="cuda",
) -> np.ndarray:
    """Full reference label pipeline -> (F, ceil(H/16), ceil(W/16))
    uint8 {0,1} — the MB grid (45x80 at 720p, 68x120 at 1080p). MOG2 and
    the morphology run on `device` a chunk of frames at a time; the holes
    are filled on the host, frame by frame."""
    import scipy.ndimage

    f, hh, hw = luma_frames.shape
    out = np.empty((f, (hh + 7) // 8, (hw + 7) // 8), np.uint8)
    pos = 0
    mog = _StatefulMog2()
    for start in range(0, f, chunk):
        part = torch.from_numpy(np.ascontiguousarray(luma_frames[start : start + chunk]))
        fg = morph_close_open(mog.run(part.to(device)))
        fg_np = fg.cpu().numpy()
        for i in range(fg_np.shape[0]):
            filled = scipy.ndimage.binary_fill_holes(fg_np[i])
            out[pos] = filled[::8, ::8].astype(np.uint8)
            pos += 1
    return out


class _StatefulMog2:
    """Chunked MOG2 keeping the mixture state between calls; the state is
    initialised from the first chunk's first frame."""

    def __init__(self, k=4, history=9000, var_threshold=32.0, bg_ratio=0.9,
                 var_init=15.0, var_min=4.0, var_max=75.0):
        self.params = Mog2Params(k, history, var_threshold, bg_ratio, var_init,
                                 var_min, var_max)
        self.state = None

    def run(self, frames: torch.Tensor) -> torch.Tensor:
        if self.state is None:
            self.state = mog2_init(frames[0], self.params)
        return mog2_chunk(frames, *self.state, self.params)
