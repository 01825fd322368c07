"""A run's range plan: how the streams of a run are cut into GoP-aligned
ranges, and everything that follows from that cut.

* The split: each stream's GoPs become cfg.parallel.num_ranges
  contiguous ranges of whole GoPs (entropy decode is sequential within
  a GoP, so a range that straddled GoPs would decode the straddled
  prefix again). A stream with too few GoPs is padded with empty ranges
  at its end, and `max_frames` clamps every range.
* Display order: the temporal stack sees a range's frames in
  presentation order, while the frame selector takes them in decode
  order with their display rank.
* The container clock: the aggregator associates oracle detections with
  track boxes by EXACT timestamp equality, and detections carry
  container pts, so every timestamp that reaches the aggregator comes
  from each stream's sorted pts, not from rank/fps. The selectors and
  trackers keep working in the rank/fps domain.
* Windows and chunks: window j of a range covers its display frames
  [j*gamma, j*gamma + T) and is attributed to its NEWEST frame
  j*gamma + T - 1. Chunk i holds windows [i*F, (i+1)*F) of every range;
  the chunk count follows the longest range, and a shorter range stops
  contributing (its slots hold zero-filled metadata that no window
  reads).
* One range's host side (`RangeHost`): its tracker, its selector and
  the frames it schedules for the pixel stage.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional

import numpy as np

from cova_tpu_torch import trace
from cova_tpu_torch.scheduler import FrameSelector


@dataclasses.dataclass
class RangePlan:
    """The ranges of one run, in device batch order: stream after stream,
    num_ranges each. Build with `RangePlan.build`; `dataclasses.replace`
    with other t/gamma/f re-derives the windows and chunks over the same
    split."""

    # (stream, first sample, samples) a range.
    bounds: list
    # Display-order sample indices a range.
    disp: list
    # Decode-order (sample, display rank / fps, keyframe) a range: the
    # selector's pre-feed.
    frame_info: list
    # A stream's sorted container pts in seconds, extrapolated past EOS
    # at 1/fps for the empty ranges' placeholder starts.
    pts_sec: list
    # Container seconds of each range's first display rank.
    range_starts: list
    # A stream's GoP first samples.
    gop_starts: list
    t: int
    gamma: int
    f: int
    with_nnz: bool
    signed_mv: bool
    # Windows a range; the chunk count; source frames a chunk holds.
    windows: list = dataclasses.field(init=False)
    n_chunks: int = dataclasses.field(init=False)
    nf_chunk: int = dataclasses.field(init=False)

    def __post_init__(self):
        self.windows = [max(0, (c - self.t) // self.gamma + 1) for _, _, c in self.bounds]
        self.n_chunks = -(-max(self.windows, default=0) // self.f)
        self.nf_chunk = (self.f - 1) * self.gamma + self.t

    @classmethod
    def build(cls, demuxers, cfg, max_frames: Optional[int] = None) -> "RangePlan":
        """The plan of `demuxers` (one a stream) under `cfg`'s range count,
        T, gamma, F, fps and metadata contract; `max_frames` caps the
        samples of every range."""
        r, fps = cfg.parallel.num_ranges, cfg.video.fps
        bounds, gop_starts = [], []
        for sx, d in enumerate(demuxers):
            gops = d.gops()
            gop_starts.append([g.first_sample for g in gops])
            per = max(1, math.ceil(len(gops) / r))
            sb = [(sx, gops[i].first_sample, sum(g.num_samples for g in gops[i : i + per]))
                  for i in range(0, len(gops), per)]
            sb += [(sx, d.num_samples, 0)] * (r - len(sb))
            bounds += sb[:r]
        if max_frames:
            bounds = [(sx, s, min(c, max_frames)) for sx, s, c in bounds]

        pts_sec = []
        for d in demuxers:
            ps = np.sort(np.array([d.sample(i).pts for i in range(d.num_samples)],
                                  dtype=np.int64)) / float(d.timescale)
            if len(ps) == 0:
                ps = np.zeros(1)
            pts_sec.append(np.concatenate([ps, ps[-1] + np.arange(1, len(bounds) + 2) / fps]))

        disp, frame_info = [], []
        for sx, s, c in bounds:
            d = demuxers[sx]
            order = d.display_order(s, c) if c else np.zeros(0, np.int32)
            rank = {int(si): s + rel for rel, si in enumerate(order)}
            disp.append(order)
            frame_info.append([(si, rank[si] / fps, d.sample(si).keyframe)
                               for si in range(s, s + c)])
        c = cfg.compressed
        return cls(
            bounds, disp, frame_info, pts_sec,
            [float(pts_sec[sx][s]) for sx, s, _ in bounds], gop_starts,
            cfg.video.timestep, c.gamma, c.batch_frames, c.use_nnz_channel, c.signed_mv)

    def seconds(self, ri: int, frame_idx: float) -> float:
        """Container seconds of range `ri`'s display frame `frame_idx`
        (range-relative, rounded to a frame)."""
        sx, start, _ = self.bounds[ri]
        ps = self.pts_sec[sx]
        return float(ps[min(start + int(round(frame_idx)), len(ps) - 1)])

    def chunk_windows(self, i: int) -> list:
        """Real windows of chunk `i`, a range (0 past a range's end)."""
        win0 = i * self.f
        return [max(0, min(self.f, w - win0)) for w in self.windows]

    def live_windows(self, i: int) -> Iterator[tuple]:
        """(range, window of the chunk, range-relative display index of
        the window's newest frame, the frame its mask describes) for
        every real window of chunk `i`, range after range."""
        win0 = i * self.f
        for ri, n in enumerate(self.chunk_windows(i)):
            for k in range(n):
                yield ri, k, (win0 + k) * self.gamma + self.t - 1

    def chunk_frames(self, i: int) -> tuple:
        """(first display index, frames a range) of chunk `i`: 0 frames
        for a range with no window left."""
        off = i * self.f * self.gamma
        return off, [min(self.nf_chunk, c - off) if n else 0
                     for (_, _, c), n in zip(self.bounds, self.chunk_windows(i))]

    def decode_chunk(self, i: int, demuxers, out: np.ndarray, threads: int) -> list:
        """Entropy-decode chunk `i` into `out` (R, nf_chunk, H, W, 2),
        range by range in display order, with the demuxers the plan was
        built from; frames past a range's extent are left as they are.
        Returns the frames written a range (0 for a range skipped)."""
        off, counts = self.chunk_frames(i)
        for ri, n in enumerate(counts):
            if not n:
                continue
            sx = self.bounds[ri][0]
            indices = self.disp[ri][off : off + n]
            with trace.span("cova.entdec.range") as sp:
                demuxers[sx].entropy_decode_packed16(
                    indices, with_nnz=self.with_nnz, signed_mv=self.signed_mv,
                    threads=threads, out=out[ri, :n])
                if trace.enabled():
                    sp.set(frames=int(n), gops=int(np.unique(np.searchsorted(
                        self.gop_starts[sx], indices, side="right")).size))
            trace.count("entdec.frames", int(n))
        return counts

    def hosts(self, cfg, make_tracker: Callable, aggregators) -> list:
        """Hand each stream's aggregator its ranges' starts, then build
        every range's host side: `make_tracker(on_dead=...)` makes its
        tracker, and its retired tracks go to `aggregators[stream]`."""
        for sx, agg in enumerate(aggregators):
            agg.set_ranges([rs for rs, (s, _, _) in zip(self.range_starts, self.bounds)
                            if s == sx])
        return [RangeHost(self, ri, cfg, make_tracker, aggregators[sx])
                for ri, (sx, _, _) in enumerate(self.bounds)]


class RangeHost:
    """One range's host side: a tracker in range-relative frame indices,
    a FrameSelector in rank/fps seconds pre-fed with the range's frames
    in decode order, and `jobs`, the frames the selector scheduled for
    the pixel stage. Retired tracks reach the aggregator in container
    seconds."""

    def __init__(self, plan: RangePlan, ri: int, cfg, make_tracker: Callable, aggregator):
        self.plan, self.ri, self.aggregator = plan, ri, aggregator
        self.start = plan.bounds[ri][1]
        self.fps = cfg.video.fps
        self.dead = 0
        self.jobs: list = []
        self.tracker = make_tracker(on_dead=self._on_dead)
        self.selector = FrameSelector(cfg.selector, cfg.sort, fps=self.fps,
                                      mark_seen=self._mark_seen, emit=self.jobs.extend)
        for si, rank_s, key in plan.frame_info[ri]:
            self.selector.push_frame(si, rank_s, key)

    def _mark_seen(self, pts: float) -> None:
        self.tracker.mark_seen(round(pts * self.fps) - self.start)

    def _on_dead(self, rec) -> None:
        self.dead += 1
        oldest = self.tracker.oldest

        def sec(frame_idx):
            return self.plan.seconds(self.ri, frame_idx)

        rec = dataclasses.replace(
            rec, start_ts=sec(rec.start_ts), end_ts=sec(rec.end_ts),
            history=[(sec(fi), box) for fi, box in rec.history])
        self.aggregator.submit_track(self.plan.range_starts[self.ri],
                                     sec(oldest) if math.isfinite(oldest) else 1e18, rec)

    def feed(self, frame_idx: int, min_required_frame) -> None:
        """The selector's step for the window whose newest frame is
        `frame_idx`, with the tracker's min_required frame (None when
        nothing died)."""
        min_required = (None if min_required_frame is None
                        else (self.start + min_required_frame) / self.fps)
        self.selector.on_mask_frame((self.start + frame_idx) / self.fps, min_required)

    def finish(self, *finalize_args) -> None:
        """EOS: flush the selector, then finalize the tracker."""
        self.selector.finish()
        self.tracker.finalize(*finalize_args)
