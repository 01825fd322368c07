"""Host-side CC + SORT (ctypes over csrc/cctrack.cc).

The compressed-domain stage's dense FLOPs (BlobNet) run on the TPU; the
branchy integer control logic — connected components over the 80x45
macroblock mask and the SORT lifecycle — runs here, exactly where the
reference runs it (bboxcc's OpenCV CC and the cova-rs/sort crate are
CPU code; reference: cova-rs/gst-plugins/src/bboxcc/process.rs,
cova-rs/sort/src/lib.rs, cova/tracker.rs).

The JAX implementations (cova_tpu.ops.cc, cova_tpu.tracker.sort) remain
the all-device variants used by the sharded multi-chip program;
tests/test_cctrack.py pins this module against them differentially.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np

from cova_tpu_torch.codec import lib
from cova_tpu_torch.config import SortConfig
from cova_tpu_torch.types import TrackRecord

_decl_done = False


def _lib():
    global _decl_done
    l = lib()
    if not _decl_done:
        l.cova_cc_boxes.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        l.cova_sort_new.restype = ctypes.c_void_p
        l.cova_sort_new.argtypes = [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        l.cova_sort_free.argtypes = [ctypes.c_void_p]
        l.cova_sort_update.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double),
        ]
        l.cova_sort_update_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ]
        l.cova_sort_mark_seen.argtypes = [ctypes.c_void_p, ctypes.c_double]
        l.cova_sort_oldest.restype = ctypes.c_double
        l.cova_sort_oldest.argtypes = [ctypes.c_void_p]
        l.cova_sort_finalize.argtypes = [ctypes.c_void_p]
        l.cova_sort_dead_count.argtypes = [ctypes.c_void_p]
        l.cova_sort_dead_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        l.cova_sort_dead_history.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        l.cova_sort_drain.argtypes = [ctypes.c_void_p]
        _decl_done = True
    return l


def cc_boxes(
    masks: np.ndarray, area_threshold: int = 1, max_boxes: int = 16
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """8-connected components over (F, H, W) u8/bool masks.

    Returns (ltwh (F, K, 4) f32, area (F, K) f32 box w*h, valid (F, K)
    bool) in OpenCV label order with pixel area >= area_threshold —
    the bboxcc contract (process.rs:5-49).
    """
    masks = np.ascontiguousarray(masks, np.uint8)
    f, h, w = masks.shape
    ltwh = np.empty((f, max_boxes, 4), np.float32)
    area = np.empty((f, max_boxes), np.float32)
    valid = np.empty((f, max_boxes), np.uint8)
    rc = _lib().cova_cc_boxes(
        masks.ctypes.data_as(ctypes.c_void_p), f, h, w,
        int(area_threshold), int(max_boxes),
        ltwh.ctypes.data_as(ctypes.c_void_p),
        area.ctypes.data_as(ctypes.c_void_p),
        valid.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise RuntimeError(f"cova_cc_boxes failed rc={rc}")
    return ltwh, area, valid.astype(bool)


class HostSort:
    """Native SORT + the cova element's seen/min_required bookkeeping —
    the drop-in host replacement for device SORT + HostTracker mirror.

    on_dead: callback receiving a TrackRecord whenever an active track
    dies (or at finalize), like scheduler.tracks.HostTracker.
    """

    def __init__(
        self,
        cfg: SortConfig,
        on_dead: Optional[Callable[[TrackRecord], None]] = None,
    ):
        self._h = _lib().cova_sort_new(
            float(cfg.iou_threshold), int(cfg.max_age), int(cfg.min_hits),
            1 if cfg.reproduce_from_x_quirk else 0,
        )
        self.on_dead = on_dead
        self.finalized = False

    def close(self):
        if self._h:
            _lib().cova_sort_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def oldest(self) -> float:
        return float(_lib().cova_sort_oldest(self._h))

    def _drain_dead(self, n=None):
        l = _lib()
        if n is None:
            n = l.cova_sort_dead_count(self._h)
        for i in range(n):
            tid = ctypes.c_int32()
            start = ctypes.c_double()
            end = ctypes.c_double()
            seen = ctypes.c_int32()
            hlen = ctypes.c_int32()
            l.cova_sort_dead_info(
                self._h, i, ctypes.byref(tid), ctypes.byref(start),
                ctypes.byref(end), ctypes.byref(seen), ctypes.byref(hlen),
            )
            ts = np.empty(hlen.value, np.float64)
            ltwh = np.empty((hlen.value, 4), np.float32)
            l.cova_sort_dead_history(
                self._h, i,
                ts.ctypes.data_as(ctypes.c_void_p),
                ltwh.ctypes.data_as(ctypes.c_void_p),
            )
            rec = TrackRecord(
                track_id=int(tid.value),
                start_ts=float(start.value),
                end_ts=float(end.value),
                seen=bool(seen.value),
                history=[
                    (float(ts[k]), tuple(float(x) for x in ltwh[k]))
                    for k in range(hlen.value)
                ],
            )
            if self.on_dead:
                self.on_dead(rec)
        if n:
            l.cova_sort_drain(self._h)

    def update(self, ltwh: np.ndarray, ts: float) -> Optional[float]:
        """One frame: ltwh (N, 4) f32 detections. Returns min_required
        (max start-ts over dead-and-unseen tracks; 0.0 when tracks died
        but all were seen; None when nothing died)."""
        ltwh = np.ascontiguousarray(ltwh, np.float32).reshape(-1, 4)
        mr = ctypes.c_double()
        ndead = _lib().cova_sort_update(
            self._h, ltwh.ctypes.data_as(ctypes.c_void_p), len(ltwh),
            float(ts), ctypes.byref(mr),
        )
        # cova_sort_update returns the dead count — skip the extra
        # ctypes crossing on the (common) no-death frames.
        if ndead:
            self._drain_dead(ndead)
        return None if np.isnan(mr.value) else float(mr.value)

    def update_batch(
        self, ltwh: np.ndarray, valid: np.ndarray, ts0: float,
        step: float = 1.0,
    ) -> None:
        """Chunked updates for callers without per-frame scheduling
        feedback (bench / standalone tracking): frame i of the (F, K)
        fixed-capacity grid updates at ts0 + i*step. Equivalent to F
        update() calls (one ABI crossing instead of F; min_required is
        the selector's channel and is not surfaced here)."""
        ltwh = np.ascontiguousarray(ltwh, np.float32)
        valid = np.ascontiguousarray(valid, np.uint8)
        f, k = valid.shape
        ndead = _lib().cova_sort_update_batch(
            self._h, ltwh.ctypes.data_as(ctypes.c_void_p),
            valid.ctypes.data_as(ctypes.c_void_p), f, k,
            float(ts0), float(step),
        )
        if ndead:
            self._drain_dead(ndead)

    def mark_seen(self, ts: float) -> None:
        _lib().cova_sort_mark_seen(self._h, float(ts))

    def finalize(self) -> None:
        _lib().cova_sort_finalize(self._h)
        self._drain_dead()
        self.finalized = True
