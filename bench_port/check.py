"""The comparison that decides `correct`: every job of the window, each
layer held to the reference given what that layer received.

  chunks     every chunk the clip's ranges need captured, metadata and
             masks (exact count)
  metadata   each frame's entropy-decoded cells against the reference
             decoder's digest (exact)
  masks      each live window's mask bits against the plain BlobNet's
             probabilities: a bit may differ only where the reference's
             probability lies within `mask_gap`'s limit of the threshold
  tracks     the tracks the aggregator received (ids, times, boxes) and
             the selector's schedule (decoded dependency and inference
             frames, drops, dead tracks) against the reference's (exact)
  pictures   each frame the oracle received against libavcodec's
             decode of the same sample (exact), and the set of them
             against the reference's schedule
  oracle     each of those frames through the oracle's own numbers
             (oracles/<arch>.py): what its network produced and the
             boxes it gave, against its plain reference
  csvs       the aggregator's four CSVs against the plain associator
             replayed on the calls the aggregator received (exact)

The limits of a cell are LIMITS and its oracle module's.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch

from bench_port import digests
from bench_port.ref import associator_ref

# Limits, each set between the readings of sound runs and of the
# control (PERF.md gives the readings); the oracle's are its module's.
LIMITS = {
    "jobs_failed": 0,
    "chunks_off": 0,
    "metadata_frames_off": 0,
    "mask_gap": 1e-4,
    "schedule_jobs_off": 0,
    "track_jobs_off": 0,
    "pictures_off": 0,
    "csv_files_off": 0,
}
CSVS = ("track.csv", "dnn.csv", "assoc.csv", "stationary.csv")


def range_bounds(gop_lengths, num_ranges):
    """(first sample, count) of each range: the GoPs split into
    num_ranges contiguous runs of ceil(n / num_ranges), as the pipeline
    splits a stream."""
    per = max(1, math.ceil(len(gop_lengths) / num_ranges))
    starts = np.concatenate([[0], np.cumsum(gop_lengths)])
    out = []
    for i in range(0, len(gop_lengths), per):
        out.append((int(starts[i]), int(sum(gop_lengths[i : i + per]))))
    while len(out) < num_ranges:
        out.append((int(starts[-1]), 0))
    return out[:num_ranges]


def chunk_frames(counts, f, t, g=1):
    """Per chunk that the pipeline runs over ranges of `counts` frames,
    the frames of each range it entropy-decodes into the chunk, counted as
    CovaPipeline._run counts them (0 where a range has no window left)."""
    wmax = [max(0, (c - t) // g + 1) for c in counts]
    nf = (f - 1) * g + t
    chunks = -(-max(wmax, default=0) // f)
    return [[max(0, min(nf, c - k * f * g)) if k * f < w else 0 for c, w in zip(counts, wmax)]
            for k in range(chunks)]


def display_pts(samples, bounds):
    """Per range, the source-stream pts of its frames in display order."""
    return [sorted(s.pts for s in samples[a : a + n]) for a, n in bounds]


def metadata_off(chunks, range_pts, rotation, expected, f, t) -> int:
    """Frames of the captured chunks whose cells differ from the
    reference's digest (by the source pts the rotated frame came from)."""
    off = 0
    nf = f + t - 1
    for c, meta in enumerate(chunks):
        base = c * f
        for r, pts in enumerate(range_pts):
            for i in range(min(nf, len(pts) - base)):
                src = rotation.source_pts(pts[base + i])
                off += digests.sha(meta[r, i].tobytes()) != expected[str(src)]
    return off


def live_windows(range_pts, chunk, f, t):
    """(range, window) of the chunk's windows that describe real frames."""
    for r, pts in enumerate(range_pts):
        n = max(0, len(pts) - t + 1)
        for k in range(max(0, min(f, n - chunk * f))):
            yield r, k


def mask_gap(bits: np.ndarray, probs: torch.Tensor, live, threshold: float) -> tuple:
    """(widest gap, count): of the live windows' bits that differ from
    `probs > threshold`, the largest |prob - threshold|."""
    ref = probs > threshold
    got = torch.from_numpy(np.ascontiguousarray(bits)).to(probs.device).bool()
    mask = torch.zeros_like(ref)
    for r, k in live:
        mask[r, k] = True
    diff = (ref != got) & mask
    n = int(diff.sum())
    if n == 0:
        return 0.0, 0
    return float((probs[diff] - threshold).abs().max()), n


def unpack_bits(packed: torch.Tensor, shape) -> np.ndarray:
    r, f, h, w = shape
    buf = packed.cpu().numpy().reshape(r * f, h, w // 8)
    return np.unpackbits(buf, axis=-1).reshape(r, f, h, w)


def head_gap(got, ref) -> float:
    """max |got - ref| over max |ref|, the widest over the three heads."""
    return max(float((g.float() - r.float()).abs().max() / r.abs().max().clamp_min(1e-30))
               for g, r in zip(got, ref))


class Box:
    """A reference detection in the shape of the program's BoxRec."""

    def __init__(self, class_id, confidence, left, top, width, height):
        self.class_id, self.confidence = class_id, confidence
        self.left, self.top, self.width, self.height = left, top, width, height


def detections_off(prog_recs, ref_dets, tol_px: float = 1e-3, tol_score: float = 1e-5) -> int:
    """Boxes of one frame without a counterpart on the other side, both
    in descending score order."""
    got = sorted(((b.class_id, b.confidence, b.left, b.top, b.width, b.height)
                  for b in prog_recs), key=lambda d: -d[1])
    ref = sorted(ref_dets, key=lambda d: -d[1])
    off = abs(len(got) - len(ref))
    for a, b in zip(got, ref):
        same = (a[0] == b[0] and abs(a[1] - b[1]) <= tol_score
                and all(abs(x - y) <= tol_px for x, y in zip(a[2:], b[2:])))
        off += not same
    return off


def replay_csvs(calls, out_dir) -> dict:
    """The plain associator over the recorded calls; its CSVs' bytes."""
    agg = associator_ref.Associator(out_dir)
    for name, args in calls:
        if name == "update_dnn":
            args = ([associator_ref.BoxRec(**vars(b)) for b in args[0]],)
        getattr(agg, name)(*args)
    agg.terminate()
    return {n: (pathlib.Path(out_dir) / n).read_bytes() for n in CSVS}


def csv_files_off(job_dir, ref_csvs) -> int:
    return sum((pathlib.Path(job_dir) / n).read_bytes() != ref_csvs[n] for n in CSVS)


def fold(total: dict, numbers: dict, folds: dict) -> None:
    """Fold one frame's `numbers` into `total`, each by its `folds` entry."""
    for k, v in numbers.items():
        total[k] = folds[k](total[k], v)


def oracle_numbers(oracle, reference, frames, outputs_of: dict) -> dict:
    """The oracle module's numbers over frames [(key, y, u, v, boxes,
    outputs)]: each frame's captured outputs and boxes against the
    reference on its picture, whose outputs are made once a key
    (`outputs_of` keeps them), folded over the frames."""
    total = dict.fromkeys(oracle.LIMITS, 0)
    for key, y, u, v, recs, outs in frames:
        if key not in outputs_of:
            outputs_of[key] = reference.outputs(y, u, v)
        fold(total, reference.numbers(outputs_of[key], outs, recs, y.shape), oracle.FOLD)
    return total


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in numbers)


def lines(numbers: dict, limits: dict) -> list:
    return [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in numbers]
