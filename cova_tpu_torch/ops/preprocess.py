"""Metadata preprocessing (PyTorch port of cova_tpu/ops/preprocess.py).

Each frame's per-macroblock metadata grid is stacked with the previous
`timestep - 1` frames, newest first, emitting one of every `gamma` stacks,
then clip-normalized into BlobNet's float input. Layouts are the JAX
package's: (..., F, H, W, C) u8 in, (..., N, T, H, W, C) float32 out.
"""

from __future__ import annotations

import torch


def clip6_normalize(x: torch.Tensor, signed_mv: bool = False) -> torch.Tensor:
    """clip(x, 0, 6) / 6.

    With signed_mv, channels 1 and 2 carry mean signed MVs offset-128
    and normalize as clip(x-128, -6, 6)/6 in [-1, 1]; other channels keep
    the plain normalization."""
    xf = x.to(torch.float32)
    plain = torch.clamp(xf, 0.0, 6.0) / 6.0
    if not signed_mv:
        return plain
    c = x.shape[-1]
    ch = torch.arange(c, device=x.device)
    is_mv = (ch == 1) | (ch == 2)
    signed = torch.clamp(xf - 128.0, -6.0, 6.0) / 6.0
    return torch.where(is_mv, signed, plain)


def unpack_wire16(x: torch.Tensor, use_nnz: bool, signed_mv: bool) -> torch.Tensor:
    """Inverse of the codec's 2-byte/cell wire format (entdec.cc
    export_packed16: byte0 = mb_class|nnz<<3, byte1 = mv_x|mv_y<<4) into
    the (..., H, W, C) u8 channel layout. Each wire field saturates exactly
    at the clip boundaries, so clip6_normalize of the result is
    bit-identical to the 3/4-channel path."""
    b0 = x[..., 0]
    b1 = x[..., 1]
    ch0 = b0 & 7
    mvx = b1 & 15
    mvy = b1 >> 4
    if signed_mv:
        # stored = clamp(full-pel, -8, 7) + 8 -> offset-128 u8 layout
        mvx = mvx + 120
        mvy = mvy + 120
    chans = [ch0, mvx, mvy]
    if use_nnz:
        chans.append((b0 >> 3) & 7)
    return torch.stack(chans, dim=-1).to(torch.uint8)


def temporal_stack(
    frames: torch.Tensor, timestep: int = 4, gamma: int = 1
) -> torch.Tensor:
    """Stack sliding temporal windows, newest first.

    frames: (..., F, H, W, C). Returns (..., N, T, H, W, C) with
    N = (F - T) // gamma + 1; window n covers source frames
    [n*gamma, n*gamma + T), so out[..., n, 0] is frame n*gamma + T - 1.
    """
    f = frames.shape[-4]
    n = (f - timestep) // gamma + 1
    starts = torch.arange(n, device=frames.device) * gamma
    offs = torch.arange(timestep - 1, -1, -1, device=frames.device)
    idx = starts[:, None] + offs[None, :]  # (N, T)
    lead = frames.dim() - 4
    return frames[(slice(None),) * lead + (idx,)]


def metapreprocess(
    frames: torch.Tensor,
    timestep: int = 4,
    gamma: int = 1,
    signed_mv: bool = False,
) -> torch.Tensor:
    """Temporal stack + clip normalization -> model-ready float input."""
    return clip6_normalize(temporal_stack(frames, timestep, gamma), signed_mv)
