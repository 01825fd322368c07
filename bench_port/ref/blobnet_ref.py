"""The plain reference of the masks step: the metadata's wire format
unpacked, the temporal windows stacked and normalised, and BlobNet's
forward pass in float32, from the committed Flax weight file (npz) as it
lies on disk, in plain torch operations. Nothing of the program is
imported.

BlobNet (CoVA's compressed-domain segmenter): four encoder stages, each a
3x3 convolution per timestep with relu, BatchNorm (running statistics),
2x2 max-pooling padded top/left to the odd size, and a residual temporal
mix (two T x T mixes with relu, added to the input, relu); a decoder of
four 4x4 stride-2 transposed convolutions (Flax's VALID
ConvTranspose without kernel flip: a correlation over the input dilated
by 2 and padded by 3), each after a relu and followed by a centre
crop/pad to the skip's size, BatchNorm and the skip concatenated (but the
last); a 1x1 head and a sigmoid.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5


def load(path, device) -> dict:
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files if k != "__meta__"}


def unpack(meta: torch.Tensor, use_nnz: bool, signed_mv: bool) -> torch.Tensor:
    """(..., H, W, 2) u8 wire cells -> (..., H, W, C) float inputs in
    [0, 1] (or [-1, 1] for signed motion): byte 0 = class | nnz << 3,
    byte 1 = mv_x | mv_y << 4, each clipped to 0..6 (signed: -6..6) / 6."""
    b0 = meta[..., 0].to(torch.int32)
    b1 = meta[..., 1].to(torch.int32)
    chans = [(b0 & 7).float().clamp(0, 6) / 6]
    for mv in (b1 & 15, b1 >> 4):
        if signed_mv:
            chans.append((mv.float() - 8).clamp(-6, 6) / 6)
        else:
            chans.append(mv.float().clamp(0, 6) / 6)
    if use_nnz:
        chans.append(((b0 >> 3) & 7).float().clamp(0, 6) / 6)
    return torch.stack(chans, -1)


def windows(frames: torch.Tensor, t: int) -> torch.Tensor:
    """(N, H, W, C) frames -> (N - t + 1, t, H, W, C), newest first."""
    n = frames.shape[0] - t + 1
    return torch.stack([frames[k + t - 1 - torch.arange(t, device=frames.device)]
                        for k in range(n)])


def _bn(x, p, i):
    s = p[f"params/BatchNorm_{i}/scale"]
    b = p[f"params/BatchNorm_{i}/bias"]
    m = p[f"batch_stats/BatchNorm_{i}/mean"]
    v = p[f"batch_stats/BatchNorm_{i}/var"]
    return (x - m[:, None, None]) / torch.sqrt(v[:, None, None] + EPS) * s[:, None, None] \
        + b[:, None, None]


def _conv(x, p, name, pad):
    k = p[f"params/{name}/kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    return F.conv2d(x, k, p[f"params/{name}/bias"], padding=pad)


def _convt(x, p, i):
    n, c, h, w = x.shape
    d = x.new_zeros((n, c, 2 * h - 1, 2 * w - 1))
    d[:, :, ::2, ::2] = x
    return _conv(F.pad(d, (3, 3, 3, 3)), p, f"ConvTranspose_{i}", 0)


def _fit(x, th, tw):
    h, w = x.shape[-2:]
    for axis, size, target in ((-2, h, th), (-1, w, tw)):
        diff = size - target
        if diff > 0:
            x = x.narrow(axis, diff - diff // 2, target)
        elif diff < 0:
            d = -diff
            pad = [0, 0, 0, 0]
            at = 0 if axis == -1 else 2
            pad[at], pad[at + 1] = d - d // 2, d // 2
            x = F.pad(x, pad)
    return x


@torch.no_grad()
def forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) float -> (B, H, W) probabilities."""
    b, t, h0, w0, c = x.shape
    x = x.permute(0, 1, 4, 2, 3)
    skips = []
    for i in range(4):
        y = x.reshape((b * t,) + x.shape[2:])
        y = _bn(F.relu(_conv(y, p, f"Conv_{i}", 1)), p, i)
        hh, ww = y.shape[-2:]
        y = F.pad(F.max_pool2d(y, 2), (ww % 2, 0, hh % 2, 0))
        y = y.reshape((b, t) + y.shape[1:])
        hmix = y
        for j in range(2):
            mix = p[f"params/PointWiseTemporal_{i}/mix_{j}"]
            hmix = F.relu(torch.einsum("btchw,ts->bschw", hmix, mix))
        x = F.relu(hmix + y)
        skips.append(x)
    feats = [s[:, 0] for s in reversed(skips)]
    targets = [f.shape[-2:] for f in feats[1:]] + [(h0, w0)]
    x = feats[0]
    for i in range(4):
        x = _fit(_convt(F.relu(x), p, i), *targets[i])
        if i < 3:
            x = torch.cat([_bn(x, p, 4 + i), feats[i + 1]], 1)
    return torch.sigmoid(_conv(x, p, "Conv_4", 0))[:, 0]


@torch.no_grad()
def chunk_probs(p: dict, meta: np.ndarray, t: int, use_nnz: bool, signed_mv: bool,
                device, block: int = 256) -> torch.Tensor:
    """One chunk's metadata (R, F+T-1, H, W, 2) u8 -> (R, F, H, W)
    probabilities, in blocks of windows."""
    out = []
    for r in range(meta.shape[0]):
        x = windows(unpack(torch.from_numpy(meta[r]).to(device), use_nnz, signed_mv), t)
        out.append(torch.cat([forward(p, x[k : k + block])
                              for k in range(0, x.shape[0], block)]))
    return torch.stack(out)
