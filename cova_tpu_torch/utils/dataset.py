"""Per-macroblock metadata packing and half-resolution luma decoding
(the functions of cova_tpu/utils/dataset.py that the port's pipelines
and its stand-in oracle need; the rest of that module builds BlobNet
training sets).

`pack_metadata` and `decode_luma_halfres` are function-level copies of
the originals, held equal to them by tests/test_torch_port.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cova_tpu_torch.codec import Mp4Demuxer, PixelDecoder


def decode_luma_halfres(
    path: str, max_frames: Optional[int] = None, log=print
) -> np.ndarray:
    """Full-decode the video (display order) and return (F, H/2, W/2) u8
    luma (the reference's cv.resize to 640x360 before MOG2; decimation
    rather than area filtering — labels are pseudo-ground-truth)."""
    demux = Mp4Demuxer(path)
    n = demux.num_samples if max_frames is None else min(
        demux.num_samples, max_frames
    )
    dec = PixelDecoder(demux.extradata())
    frames = {}
    for i in range(n):
        dec.send(demux.read_sample(i), demux.sample(i).pts)
        got = dec.pop(demux.width, demux.height)
        while got is not None:
            pts, y, u, v = got
            frames[pts] = y[::2, ::2].copy()
            got = dec.pop(demux.width, demux.height)
    dec.flush()
    got = dec.pop(demux.width, demux.height)
    while got is not None:
        pts, y, u, v = got
        frames[pts] = y[::2, ::2].copy()
        got = dec.pop(demux.width, demux.height)
    order = sorted(frames)
    out = np.stack([frames[p] for p in order])
    log(f"decoded {len(out)} luma frames at {out.shape[2]}x{out.shape[1]}")
    return out


def pack_metadata(
    meta: dict, use_nnz: bool = False, signed_mv: bool = False
) -> np.ndarray:
    """Per-MB metadata dict -> (F, H, W, C) u8 [mb_class, |mv_x|, |mv_y|]
    with quarter-pel MVs scaled to full-pel (the BlobNet normalization
    clips at 6, so full-pel units keep small motions resolvable).

    use_nnz adds the residual nonzero-coefficient count as a 4th channel,
    scaled by 1/4 so the clip(0,6)/6 normalization resolves 0-24
    coefficients/MB before saturating (texture change density).

    signed_mv packs mean SIGNED full-pel MVs offset-128 (the
    reference's contract feeds signed mv, utils/data/parse.py:5-31);
    normalize with clip6_normalize(x, signed_mv=True). Matches the
    codec's fused packed layout (csrc/api.cc) byte-for-byte."""
    if signed_mv:
        # arithmetic >> 2 (floor) to match the C packing exactly
        mv = [
            np.clip(128 + (meta["mv_sx"] >> 2), 0, 255).astype(np.uint8),
            np.clip(128 + (meta["mv_sy"] >> 2), 0, 255).astype(np.uint8),
        ]
    else:
        mv = [
            np.clip(np.abs(meta["mv_x"]) // 4, 0, 255).astype(np.uint8),
            np.clip(np.abs(meta["mv_y"]) // 4, 0, 255).astype(np.uint8),
        ]
    chans = [meta["mb_class"].astype(np.uint8)] + mv
    if use_nnz:
        chans.append(np.clip(meta["nnz"] // 4, 0, 255).astype(np.uint8))
    return np.stack(chans, axis=-1)
