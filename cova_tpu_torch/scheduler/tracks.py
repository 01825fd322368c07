"""Host-side track bookkeeping.

The device-side SORT (cova_tpu_torch.tracker.sort) is a pure feed-forward scan
that emits fixed-shape per-frame outputs; this module consumes them and
maintains the variable-length state the reference keeps inside its
tracker: per-track histories, seen timestamps and death reporting
(reference: cova-rs/gst-plugins/src/cova/tracker.rs and
cova-rs/sort/src/tracker/mod.rs history/seen logic).

Timestamps are float seconds here (the reference uses nanosecond PTS).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from cova_tpu_torch.types import TrackRecord


@dataclasses.dataclass
class _Live:
    track_id: int
    start_ts: float
    history: list  # [(ts, (l,t,w,h))]
    seen_ts: list
    active: bool = False


class HostTracker:
    """Mirrors device SORT emissions into host-side track records.

    on_dead: callback receiving a TrackRecord when an active track dies
    (the reference streams these to the analysis aggregator,
    tracker.rs:62-81).
    """

    def __init__(self, on_dead: Optional[Callable[[TrackRecord], None]] = None):
        self.live: dict[int, _Live] = {}
        self.on_dead = on_dead
        self.range_start: Optional[float] = None
        self.finalized = False

    @property
    def oldest(self) -> float:
        """Min start over live tracks (tracker.rs get_oldest_timestamp)."""
        if not self.live:
            return float("inf")
        return min(t.start_ts for t in self.live.values())

    def update(self, ts: float, outputs) -> Optional[float]:
        """Consume one frame's SortOutputs (numpy pytree view).

        Returns min_required — the max start-ts over dead-and-unseen
        tracks, or None when no track died this frame (tracker.rs:43-60).
        """
        if self.range_start is None:
            self.range_start = ts

        track_id = np.asarray(outputs.track_id)
        ltwh = np.asarray(outputs.track_ltwh)
        predicted = np.asarray(outputs.predicted)
        death = np.asarray(outputs.death)
        death_active = np.asarray(outputs.death_active)
        death_id = np.asarray(outputs.death_id)
        death_start = np.asarray(outputs.death_start)
        death_last_match = np.asarray(outputs.death_last_match)
        death_tsu = np.asarray(outputs.death_tsu)
        exists = np.asarray(outputs.exists)

        # Histories: every predicted slot pushes its predicted bbox
        # (reference predict() pushes to history each frame).
        for slot in np.nonzero(predicted)[0]:
            tid = int(track_id[slot])
            if tid < 0:
                continue
            t = self.live.get(tid)
            if t is None:
                t = _Live(tid, ts, [], [])
                self.live[tid] = t
            t.history.append((ts, tuple(float(x) for x in ltwh[slot])))

        # Deaths.
        min_required: Optional[float] = None
        any_death = False
        for slot in np.nonzero(death)[0]:
            tid = int(death_id[slot])
            any_death = True
            t = self.live.pop(tid, None)
            start = float(death_start[slot])
            last_match = float(death_last_match[slot])
            tsu = int(death_tsu[slot])
            if not bool(death_active[slot]):
                continue  # inactive deaths are silently discarded
            history = t.history if t else []
            if tsu > 0:
                history = history[: max(0, len(history) - tsu)]
            seen = (
                any(start <= s <= last_match for s in (t.seen_ts if t else []))
            )
            rec = TrackRecord(
                track_id=tid,
                start_ts=start,
                end_ts=last_match,
                seen=seen,
                history=history,
            )
            if not seen:
                min_required = max(min_required or 0.0, start)
            if self.on_dead:
                self.on_dead(rec)
        if any_death and min_required is None:
            # Dead tracks existed but all were seen: reference folds over
            # 0, yielding Some(0) (tracker.rs:50-58).
            min_required = 0.0

        # Births: slots that exist now with unseen ids were born at `ts`
        # (their first history entry arrives with next frame's predict).
        active_arr = np.asarray(outputs.active)
        track_id_post = np.asarray(outputs.track_id_post)
        live_ids = set()
        for slot in np.nonzero(exists)[0]:
            tid = int(track_id_post[slot])
            live_ids.add(tid)
            t = self.live.get(tid)
            if t is None:
                self.live[tid] = _Live(tid, ts, [], [])
            else:
                t.active = bool(active_arr[slot])
        # Drop stale entries for ids that no longer exist (e.g. inactive
        # deaths freed without reporting).
        for tid in list(self.live):
            if tid not in live_ids:
                del self.live[tid]
        return min_required

    def mark_seen(self, ts: float) -> None:
        """A decode was scheduled at `ts`: all live tracks record it
        (reference: Sort::mark_seen, lib.rs:198-201)."""
        for t in self.live.values():
            t.seen_ts.append(ts)

    def finalize(self, min_hits: int) -> list[TrackRecord]:
        """End of stream: report remaining active-ish tracks with
        history > min_hits (reference: Sort::finalize, lib.rs:207-213).
        The device no longer distinguishes active slots here, so use
        history length as the reference does."""
        out = []
        for t in self.live.values():
            if t.active and len(t.history) > min_hits:
                rec = TrackRecord(
                    track_id=t.track_id,
                    start_ts=t.start_ts,
                    end_ts=t.history[-1][0],
                    seen=bool(t.seen_ts),
                    history=t.history,
                )
                out.append(rec)
                if self.on_dead:
                    self.on_dead(rec)
        self.live.clear()
        self.finalized = True
        return out
