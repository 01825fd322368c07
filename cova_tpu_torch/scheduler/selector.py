"""The cova frame-selection state machine (host side).

Port of the reference cova element's scheduling logic (reference:
cova-rs/gst-plugins/src/cova/imp.rs:89-360):

* `push_frame` mirrors sink_enc_chain: an IDR opens a new GoP entry
  (min_pts, max_pts, pending deque, out deque, finalized); delta frames
  extend the current GoP.
* `on_mask_frame` mirrors sink_mask_chain: given the tracker's
  `min_required` (max start-ts of dead unseen tracks), walk buffered
  GoPs intersecting [min_track_pts, pts - (max_age+10)/fps] in reverse;
  if a frame past min_track_pts is already scheduled, stop; otherwise
  pop frames off the GoP head into the out list, marking every frame
  before min_track_pts droppable (decode-only dependency) until the
  first frame >= min_track_pts, which is scheduled for inference and
  reported via `mark_seen`. The alpha/beta extra-decode pass spaces beta
  inference frames among alpha extra decodes per touched GoP.
* GoPs finalized and older than 250 frames are flushed: their scheduled
  frames are emitted (plus the I frame when infer_i), the rest counted
  dropped.
* `finish` mirrors the EOS path: emit all outstanding out lists, count
  the rest dropped.

Emitted work items are (sample_index, pts, droppable) triples; the
pipeline feeds them to the selective pixel decoder, dropping
`droppable` frames after decode exactly like the reference's
`identity drop-buffer-flags=DROPPABLE` element
(pipeline/cova/pipeline.py:304-316).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

from cova_tpu_torch.config import SelectorConfig, SortConfig


@dataclasses.dataclass
class FrameRef:
    sample_index: int
    pts: float
    keyframe: bool
    droppable: bool = False


@dataclasses.dataclass
class SelectorCounts:
    """Reference: cova element's readonly properties dropped /
    decoded-dependency / decoded-inference (imp.rs:537-639)."""

    dropped: int = 0
    decoded_dependency: int = 0
    decoded_inference: int = 0

    @property
    def total(self) -> int:
        return self.dropped + self.decoded_dependency + self.decoded_inference

    def decode_filter_rate(self) -> float:
        t = self.total
        return 1.0 - (self.decoded_dependency + self.decoded_inference) / t if t else 0.0

    def inference_filter_rate(self) -> float:
        t = self.total
        return 1.0 - self.decoded_inference / t if t else 0.0


@dataclasses.dataclass
class _Gop:
    min_pts: float
    max_pts: float
    pending: deque  # deque[FrameRef] not yet scheduled
    out: deque  # deque[FrameRef] scheduled, awaiting flush
    finalized: bool


class FrameSelector:
    def __init__(
        self,
        selector_cfg: SelectorConfig,
        sort_cfg: SortConfig,
        fps: float = 30.0,
        mark_seen: Optional[Callable[[float], None]] = None,
        emit: Optional[Callable[[list], None]] = None,
    ):
        self.cfg = selector_cfg
        self.sort_cfg = sort_cfg
        self.fps = fps
        self.mark_seen = mark_seen or (lambda ts: None)
        self.emit = emit or (lambda frames: None)
        self.gops: deque[_Gop] = deque()
        self.counts = SelectorCounts()

    # ---- sink_enc equivalent ---------------------------------------------
    def push_frame(self, sample_index: int, pts: float, keyframe: bool):
        ref = FrameRef(sample_index, pts, keyframe)
        if keyframe or not self.gops:
            if self.gops:
                self.gops[-1].finalized = True
            self.gops.append(_Gop(pts, pts, deque([ref]), deque(), False))
        else:
            g = self.gops[-1]
            g.min_pts = min(g.min_pts, pts)
            g.max_pts = max(g.max_pts, pts)
            g.pending.append(ref)

    # ---- sink_mask equivalent --------------------------------------------
    def on_mask_frame(self, pts: float, min_required: Optional[float]):
        """Process one compressed-domain frame result at `pts` with the
        tracker's min_required (None = no deaths)."""
        margin = (self.sort_cfg.max_age + self.cfg.window_margin_frames) / self.fps
        max_track_pts = max(pts - margin, 0.0)

        if min_required is not None:
            min_track_pts = min_required
            track_inferenced = 0
            dep = 0
            inf = 0
            window = [
                g
                for g in self.gops
                if min_track_pts <= g.max_pts and g.min_pts <= max_track_pts
            ]
            for g in reversed(window):
                # Frame past min_track_pts already scheduled?
                if any(min_track_pts < f.pts for f in g.out):
                    track_inferenced += 1
                    continue
                while g.pending:
                    if track_inferenced > 0:
                        break
                    f = g.pending.popleft()
                    if min_track_pts <= f.pts:
                        self.mark_seen(f.pts)
                        inf += 1
                        g.out.append(f)
                        track_inferenced += 1
                        break
                    else:
                        f.droppable = True
                        dep += 1
                        g.out.append(f)

            # alpha/beta extra decoding (imp.rs:200-246)
            if track_inferenced < self.cfg.beta:
                for g in reversed(window):
                    if not g.out:
                        continue
                    extra_decode = min(len(g.pending), self.cfg.alpha)
                    extra_infer = min(
                        extra_decode, self.cfg.beta - track_inferenced
                    )
                    if extra_decode == 0 or extra_infer <= 0:
                        continue
                    step = extra_decode // extra_infer
                    remainder = extra_decode % extra_infer
                    for _ in range(remainder):
                        f = g.pending.popleft()
                        f.droppable = True
                        dep += 1
                        g.out.append(f)
                    for _ in range(extra_infer):
                        for _ in range(max(step - 1, 0)):
                            f = g.pending.popleft()
                            f.droppable = True
                            dep += 1
                            g.out.append(f)
                        f = g.pending.popleft()
                        self.mark_seen(f.pts)
                        inf += 1
                        g.out.append(f)
                        track_inferenced += 1
            self.counts.decoded_inference += inf
            self.counts.decoded_dependency += dep

        # ---- flush old finalized GoPs (imp.rs:255-300) --------------------
        horizon = self.cfg.flush_horizon_frames / self.fps
        droppable_pts = max(pts - horizon, 0.0)
        keep = deque()
        for g in self.gops:
            if not (g.finalized and g.max_pts <= droppable_pts):
                keep.append(g)
                continue
            if self.cfg.infer_i and g.pending:
                f = g.pending.popleft()
                if f.keyframe:
                    self.counts.decoded_inference += 1
                    g.out.append(f)
                else:
                    self.counts.dropped += 1
            if g.out:
                self.emit(list(g.out))
                g.out.clear()
            self.counts.dropped += len(g.pending)
        self.gops = keep

    # ---- EOS equivalent ---------------------------------------------------
    def finish(self):
        for g in self.gops:
            self.counts.dropped += len(g.pending)
            if g.out:
                self.emit(list(g.out))
                g.out.clear()
        self.gops.clear()
