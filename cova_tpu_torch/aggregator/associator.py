"""In-process analysis aggregator.

Port of the reference's analysis-aggregator process (reference:
cova-rs/analysis-aggregator/src/server/assoc.rs) with the TCP plumbing
dissolved: the cova pipeline calls `update_track` / `update_dnn`
directly (the reference's track/dnn servers fed an mpsc channel from
localhost sockets; §5.8 of SURVEY.md).

Semantics preserved:
 * compressed-domain tracks arrive as box histories in macroblock units
   and are scaled x16 to pixels, with track ids offset by range_start for
   cross-range uniqueness (track.rs:58-66);
 * each oracle detection is matched against buffered track boxes at the
   same timestamp after inflating the track box by scale_factor around
   its center; IoU >= moving_iou votes the detection's class onto the
   track (assoc.rs:279-350) — the symmetric pass when a track arrives
   uses strict > (assoc.rs:352-411), asymmetry kept;
 * tracks are finalized once a detection timestamp inside their range
   passes their end; the written class is the majority vote plus every
   class seen >= 2 (or all classes when the max frequency is 1)
   (assoc.rs:124-205);
 * unmatched detections become stationary candidates merged by IoU >=
   stationary_iou within the same range and class; candidates unrefreshed
   for stationary_maxage seconds finalize, materialized as boxes in 2 of
   3 slots per 100 ms and given fresh track ids at termination
   (assoc.rs:210-270, 40-58, 414-446);
 * four CSV outputs: track.csv, dnn.csv, assoc.csv, stationary.csv
   (main.rs:85-98) with the same column set as the reference's serde
   serialization of Bbox.

Timestamps are float seconds (the reference uses nanosecond PTS; the
query layer's 100 ms / 33.3 ms grid is preserved proportionally).
"""

from __future__ import annotations

import csv
import dataclasses
import math
import pathlib
from collections import Counter
from typing import Optional

from cova_tpu_torch.config import AggregatorConfig

MB_TO_PIXEL = 16.0


@dataclasses.dataclass
class BoxRec:
    """CSV row — mirrors the reference Bbox serde fields
    (cova-rs/bbox/src/bbox.rs)."""

    left: float
    top: float
    width: float
    height: float
    area: float
    track_id: Optional[int]
    timestamp: Optional[float]
    class_id: Optional[int]
    confidence: Optional[float]

    def iou(self, o: "BoxRec") -> float:
        ix = max(0.0, min(self.left + self.width, o.left + o.width) - max(self.left, o.left))
        iy = max(0.0, min(self.top + self.height, o.top + o.height) - max(self.top, o.top))
        inter = ix * iy
        union = self.width * self.height + o.width * o.height - inter
        return inter / union if union > 0 else 0.0

    def scaled(self, f: float) -> "BoxRec":
        """Grow around center (reference bbox.rs `scale`)."""
        cx = self.left + self.width / 2.0
        cy = self.top + self.height / 2.0
        w, h = self.width * f, self.height * f
        return dataclasses.replace(
            self, left=cx - w / 2.0, top=cy - h / 2.0, width=w, height=h,
            area=self.area * f * f,
        )


FIELDS = [
    "left", "top", "width", "height", "area",
    "track_id", "timestamp", "class_id", "confidence",
]


class _Writer:
    def __init__(self, path):
        self.f = open(path, "w", newline="")
        self.w = csv.writer(self.f)
        self.w.writerow(FIELDS)

    def row(self, b: BoxRec):
        self.w.writerow(
            [
                b.left, b.top, b.width, b.height, b.area,
                b.track_id if b.track_id is not None else "",
                b.timestamp if b.timestamp is not None else "",
                b.class_id if b.class_id is not None else "",
                b.confidence if b.confidence is not None else "",
            ]
        )

    def close(self):
        self.f.close()


@dataclasses.dataclass
class _Stationary:
    range_start: float
    range_end: float
    start: float
    end: float
    box: BoxRec
    class_id: int
    track_id: Optional[int] = None

    def materialize(self) -> list[BoxRec]:
        """2 of 3 33ms slots per 100ms (assoc.rs:40-58)."""
        out = []
        k = 0
        while self.start + k * 0.1 < self.end - 1e-9:
            t = self.start + k * 0.1
            for i in range(2):
                ts = t + i * (1.0 / 30.0)
                out.append(
                    dataclasses.replace(
                        self.box, timestamp=ts, track_id=self.track_id
                    )
                )
            k += 1
        return out


class Associator:
    def __init__(self, output_dir, config: AggregatorConfig = AggregatorConfig()):
        out = pathlib.Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.cfg = config
        self.track_writer = _Writer(out / "track.csv")
        self.dnn_writer = _Writer(out / "dnn.csv")
        self.assoc_writer = _Writer(out / "assoc.csv")
        self.stationary_writer = _Writer(out / "stationary.csv")
        self.tracker_range: dict[float, float] = {}
        self.tracks: list[tuple[float, float, list[BoxRec]]] = []
        self.dnns: list[list] = []  # [matched_flag, BoxRec]
        self.stationary: list[_Stationary] = []
        self.finalized_stationary: list[_Stationary] = []
        self.track2class: dict[int, list[int]] = {}
        self.max_track_id = 0
        self._closed = False

    def set_ranges(self, range_starts: list[float]):
        """Build the [start, end) map once every range is known
        (assoc.rs:474-494; the reference gathers these with a Barrier)."""
        rs = sorted(range_starts) + [math.inf]
        self.tracker_range = {rs[i]: rs[i + 1] for i in range(len(rs) - 1)}

    # ------------------------------------------------------------------
    def _finalize_trk(self, timestamp: float):
        remaining = []
        for range_start, range_end, trk in self.tracks:
            if (
                range_start <= timestamp < range_end
                and trk[-1].timestamp < timestamp
            ):
                tid = trk[0].track_id
                class_ids = self._vote_classes(tid)
                for class_id in class_ids:
                    for b in trk:
                        self.assoc_writer.row(
                            dataclasses.replace(b, class_id=class_id)
                        )
            else:
                remaining.append((range_start, range_end, trk))
        self.tracks = remaining

    def _vote_classes(self, tid) -> list[int]:
        class_ids = self.track2class.pop(tid, None)
        if not class_ids:
            return []
        count = Counter(class_ids)
        (best, freq), = count.most_common(1)
        del count[best]
        out = [best]
        if freq != 1:
            out += [c for c, f in count.items() if f >= 2]
        else:
            out += list(count.keys())
        return out

    def _finalize_dnn(self, range_start: float, range_end: float, timestamp: float):
        remaining = []
        for entry in self.dnns:
            matched, box = entry
            ts = box.timestamp
            if range_start <= ts < range_end and ts < timestamp:
                if not matched:
                    best = None
                    best_iou = -1.0
                    for s in self.stationary:
                        if s.range_start != range_start:
                            continue
                        if s.class_id != box.class_id:
                            continue
                        iou = s.box.iou(box)
                        if iou >= self.cfg.stationary_iou and iou > best_iou:
                            best, best_iou = s, iou
                    if best is not None:
                        best.end = ts
                    else:
                        self.stationary.append(
                            _Stationary(
                                range_start, range_end, ts, ts, box, box.class_id
                            )
                        )
            else:
                remaining.append(entry)
        self.dnns = remaining

    def _finalize_stationary(self, dnn_timestamp: float):
        keep = []
        for s in self.stationary:
            if (
                s.range_start <= dnn_timestamp < s.range_end
                and self.cfg.stationary_maxage + s.end < dnn_timestamp
            ):
                # Reference filters on range_start != range_end (its
                # comment says "at least two detections", i.e. s.start !=
                # s.end, but the code compares the tracker range bounds —
                # we reproduce the code, assoc.rs:266-268).
                if s.range_start != s.range_end:
                    self.finalized_stationary.append(s)
            else:
                keep.append(s)
        self.stationary = keep

    # ------------------------------------------------------------------
    def update_dnn(self, detections: list[BoxRec]):
        """Oracle detections (pixel units, timestamps in seconds).

        Processed in ascending-timestamp groups: the reference receives
        detections as a monotonic per-range stream and finalizes tracks
        at each arriving timestamp BEFORE matching that timestamp's
        detections (assoc.rs:279-350). A caller handing one big batch
        (our pipeline runs the whole pixel stage after the compressed
        stage) must not let finalization at late timestamps run ahead of
        matching at early ones — that would finalize every track
        voteless."""
        by_ts: dict[float, list[BoxRec]] = {}
        for d in detections:
            by_ts.setdefault(d.timestamp, []).append(d)

        for ts in sorted(by_ts):
            self._finalize_stationary(ts)
            self._finalize_trk(ts)
            for det in by_ts[ts]:
                self.dnn_writer.row(det)
                matched = False
                for range_start, range_end, trk in self.tracks:
                    if not (range_start <= det.timestamp < range_end):
                        continue
                    if trk[0].timestamp > det.timestamp:
                        continue
                    tb = next(
                        (b for b in trk if b.timestamp == det.timestamp), None
                    )
                    if tb is None:
                        continue
                    inflated = tb.scaled(self.cfg.scale_factor)
                    if inflated.iou(det) >= self.cfg.moving_iou:
                        self.track2class.setdefault(tb.track_id, []).append(
                            det.class_id
                        )
                        matched = True
                self.dnns.append([matched, det])

    def update_track(self, range_start: float, oldest: float, history: list[BoxRec]):
        """A dead compressed-domain track (already in pixels with globally
        unique ids — see `submit_track` for the MB-unit entry point)."""
        range_end = self.tracker_range.get(range_start, math.inf)
        for b in history:
            self.track_writer.row(b)
        self.max_track_id = max(self.max_track_id, history[0].track_id)

        start_ts, end_ts = history[0].timestamp, history[-1].timestamp
        for entry in self.dnns:
            det = entry[1]
            if not (start_ts <= det.timestamp <= end_ts):
                continue
            tb = next(
                (b for b in history if b.timestamp == det.timestamp), None
            )
            if tb is None:
                continue
            inflated = tb.scaled(self.cfg.scale_factor)
            if inflated.iou(det) > self.cfg.moving_iou:  # strict (assoc.rs:391)
                self.track2class.setdefault(tb.track_id, []).append(det.class_id)
                entry[0] = True
        self.tracks.append((range_start, range_end, history))
        self._finalize_dnn(range_start, range_end, oldest)

    def submit_track(self, range_start: float, oldest: float, record):
        """Entry point for a TrackRecord in macroblock units: applies the
        x16 scale and the range_start id offset (track.rs:58-66; the id
        offset uses an integer derived from range_start)."""
        offset = int(range_start * 1_000_000)  # unique per range
        history = [
            BoxRec(
                left=l * MB_TO_PIXEL,
                top=t * MB_TO_PIXEL,
                width=w * MB_TO_PIXEL,
                height=h * MB_TO_PIXEL,
                area=w * h * MB_TO_PIXEL * MB_TO_PIXEL,
                track_id=record.track_id + offset,
                timestamp=ts,
                class_id=None,
                confidence=None,
            )
            for ts, (l, t, w, h) in record.history
        ]
        if history:
            self.update_track(range_start, oldest, history)

    # ------------------------------------------------------------------
    def terminate(self):
        if self._closed:
            return
        for range_start, range_end in list(self.tracker_range.items()):
            # Drain as of "just before the range end": the finalizers
            # gate on `timestamp < range_end`, so passing range_end
            # itself would strand every remaining track/candidate of the
            # range (frame timestamps are all strictly below range_end,
            # and their spacing is far above one ulp).
            cap = (
                math.nextafter(range_end, -math.inf)
                if math.isfinite(range_end)
                else 1e18
            )
            self._finalize_trk(cap)
            self._finalize_dnn(range_start, range_end, cap)
            self._finalize_stationary(cap)
        new_id = self.max_track_id + 1
        for s in self.finalized_stationary:
            s.track_id = new_id
            new_id += 1
            for b in s.materialize():
                self.stationary_writer.row(b)
        for w in (
            self.track_writer,
            self.dnn_writer,
            self.assoc_writer,
            self.stationary_writer,
        ):
            w.close()
        self._closed = True
