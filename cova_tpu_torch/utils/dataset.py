"""BlobNet training-set construction (PyTorch port of
cova_tpu/utils/dataset.py): per-macroblock metadata packing,
half-resolution luma decoding, MOG2 labels, sliding windows,
augmentation and an epoch iterator.

Every function and class here is a copy of its original, held equal to
it by tests/test_torch_port.py. The one difference: `build_training_set`
takes the `device` the MOG2 labels are made on (the card by default) and
hands it to the port's `generate_labels`.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np

from cova_tpu_torch.codec import Mp4Demuxer, PixelDecoder
from cova_tpu_torch.utils.mog import generate_labels


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


def _negate_mv_channel(x: np.ndarray, chan: int, signed_mv: bool):
    """In-place mv negation for geometric augmentation: signed channels
    are offset-128 u8 (v' = 256-v, saturated — the clip6 normalization
    clips at 128±6 so the saturation corner is inert); |mv| channels
    are flip-invariant."""
    if signed_mv:
        v = x[..., chan].astype(np.int16)
        x[..., chan] = np.clip(256 - v, 0, 255).astype(np.uint8)


def augment_training_set(
    x: np.ndarray, y: np.ndarray, *, signed_mv: bool,
    hflip: bool = True, vflip: bool = True,
):
    """Geometric augmentation of metadata windows (x (N,T,H,W,C) u8
    [mb_class, mv_x, mv_y, (nnz)], y (N,H,W)) for generalization: the
    reference trains on a single day's MOG2 labels and evaluates other
    days (parse/accuracy.py) — offline, mirroring substitutes for
    content diversity (ACCURACY.md held-out). hflip mirrors W and
    negates mv_x; vflip mirrors H and negates mv_y; together they give
    4 exactly-label-consistent views (a time-reversal variant was
    rejected: the reversed stack's newest frame is a different frame
    than the window's label). Returns concatenated (x, y), original
    first."""
    xs, ys = [x], [y]
    if hflip:
        xf = x[:, :, :, ::-1].copy()
        _negate_mv_channel(xf, 1, signed_mv)
        xs.append(xf)
        ys.append(y[:, :, ::-1].copy())
    if vflip:
        for xv, yv in list(zip(xs, ys)):
            xt = xv[:, :, ::-1].copy()
            _negate_mv_channel(xt, 2, signed_mv)
            xs.append(xt)
            ys.append(yv[:, ::-1].copy())
    return np.concatenate(xs), np.concatenate(ys)


def build_training_set(
    video_path: str,
    out_path: Optional[str] = None,
    timestep: int = 4,
    stride: Optional[int] = None,
    max_frames: Optional[int] = None,
    threads: int = 8,
    use_nnz: bool = False,
    signed_mv: bool = False,
    log=print,
    device="cuda",
):
    """Returns (x (N, T, 45, 80, C) u8, y (N, 45, 80) u8); optionally
    saves an npz shard. use_nnz adds the residual-density 4th channel;
    signed_mv packs signed offset-128 MV channels (ablation)."""
    stride = stride if stride is not None else timestep  # slide skip=True

    demux = Mp4Demuxer(video_path)
    n = demux.num_samples if max_frames is None else min(
        demux.num_samples, max_frames
    )
    order = demux.display_order(0, n)
    meta = demux.entropy_decode_indices(
        order, threads=threads, signed_mv=signed_mv
    )
    x_frames = pack_metadata(meta, use_nnz, signed_mv)  # display order

    luma = decode_luma_halfres(video_path, max_frames=n, log=log)
    labels = generate_labels(luma, device=device)
    f = min(len(x_frames), len(labels))
    x_frames, labels = x_frames[:f], labels[:f]

    starts = np.arange(0, f - timestep + 1, stride)
    # newest-first stack; label of the window's newest frame.
    idx = starts[:, None] + np.arange(timestep - 1, -1, -1)[None, :]
    x = x_frames[idx]  # (N, T, H, W, C)
    y = labels[starts + timestep - 1]
    log(f"training set: x {x.shape} y {y.shape} (fg rate {y.mean():.4f})")

    if out_path:
        pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out_path, x=x, y=y)
        log(f"saved {out_path}")
    return x, y


class ArrayDataset:
    """Minimal epoch iterator with shuffling (reference batches 4,
    train-blobnet.py:92-97)."""

    def __init__(self, x, y, batch: int = 4, seed: int = 0):
        self.x, self.y = x, y
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.steps_per_epoch = len(x) // batch

    def __iter__(self):
        order = self.rng.permutation(len(self.x))
        for i in range(self.steps_per_epoch):
            sel = order[i * self.batch : (i + 1) * self.batch]
            yield (
                self.x[sel].astype(np.float32),
                self.y[sel].astype(np.float32),
            )
